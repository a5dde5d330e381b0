"""Weights for the port: from a Flax ``BEVNet`` variables tree, or random.

:func:`state_dict_from_flax` maps a nested dict of numpy arrays
(``{'params': ..., 'batch_stats': ...}``, as ``BEVNet.init`` returns it,
converted with ``np.asarray``) onto :class:`~vsta_tpu_torch.models.BEVNet`
names:

* conv kernels HWIO -> OIHW (a depthwise ``[k, k, 1, C]`` -> ``[C, 1, k, k]``);
  the ``simple`` backbone's ``Conv_0`` / ``Conv_1`` -> ``conv0`` / ``conv1``;
* BatchNorm ``scale``/``bias`` from params, ``mean``/``var`` from
  batch_stats; GroupNorm ``scale``/``bias``;
* a ResNet block's ``Conv_k`` and ``BatchNorm_k`` (or ``GroupNorm_k``
  under ``MODEL.NORM: group``, with no batch_stats) -> ``convs.k`` and
  ``norms.k`` of ``stages.i.j`` for ``stage{i}_block{j}``;
* ``view_proj`` [V, F, C_out] and ``view_proj_bias`` (concat), or
  ``query_proj`` and ``query_proj_bias`` (deform_attn), stay raw tensors;
* the deformable fusion's ``Dense`` kernels [in, out] -> ``Linear``
  weights [out, in]; likewise the two ``Dense`` layers of the attention
  fusion (Flax names them ``AttentionFusion_0/Dense_0`` and ``Dense_1``)
  and ``bev_proj``, a 1x1 ``Conv`` whose kernel [1, 1, C, C_out] becomes a
  ``Linear`` weight [C_out, C]. ``SimpleFusion`` has no parameters.

A top-level key of the params tree that the port does not know raises.

:func:`params_from_flax` maps a ``params`` tree alone (or a gradient tree,
which has its shape) and :func:`batch_stats_from_flax` a ``batch_stats``
tree alone, so that a test can hold the port's gradients, updated
parameters and statistics to the JAX package's.

Flax names sub-modules by creation order (``Conv_0``, ``BatchNorm_1``,
``SqueezeExcite_0``, ...); the walk below follows that order in ``MBConv``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .config import Config
from .models.bevnet import BEVNet
from .models.encoders.efficientnet import B0_STAGES
from .models.encoders.resnet import ResNetFeatures

StateDict = Dict[str, torch.Tensor]


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(p: Mapping, out: StateDict, name: str) -> None:
    out[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _dense(p: Mapping, out: StateDict, name: str) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = _t(p["bias"])


def _bn(p: Optional[Mapping], s: Optional[Mapping], out: StateDict, name: str) -> None:
    if p is not None:
        out[f"{name}.weight"] = _t(p["scale"])
        out[f"{name}.bias"] = _t(p["bias"])
    if s is not None:
        out[f"{name}.running_mean"] = _t(s["mean"])
        out[f"{name}.running_var"] = _t(s["var"])
        out[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _mbconv(p: Optional[Mapping], s: Optional[Mapping], out: StateDict, name: str) -> None:
    # Flax creation order: [expand conv, bn], dw conv, bn, SE, project conv, bn
    expand = "Conv_2" in p if p is not None else "BatchNorm_2" in s
    convs = ["expand_conv", "dw_conv", "project_conv"] if expand else ["dw_conv", "project_conv"]
    bns = [c.replace("conv", "bn") for c in convs]
    for i, (c, b) in enumerate(zip(convs, bns)):
        if p is not None:
            _conv(p[f"Conv_{i}"], out, f"{name}.{c}")
        _bn(p and p[f"BatchNorm_{i}"], s and s[f"BatchNorm_{i}"], out, f"{name}.{b}")
    if p is not None:
        se = p["SqueezeExcite_0"]
        _conv(se["Conv_0"], out, f"{name}.se.reduce")
        _conv(se["Conv_1"], out, f"{name}.se.expand")


def _resnet(p: Optional[Mapping], s: Optional[Mapping], out: StateDict, name: str) -> None:
    # a block's Conv_k and its BatchNorm_k (or GroupNorm_k) -> convs.k, norms.k
    if p is not None:
        _conv(p["stem_conv"], out, f"{name}.stem_conv")
    _bn(p and p["stem_bn"], s and s["stem_bn"], out, f"{name}.stem_bn")
    for key in (p if p is not None else s):
        if not key.startswith("stage"):
            continue
        i, j = key[len("stage"):].split("_block")
        prefix = f"{name}.stages.{i}.{j}"
        for sub in (p if p is not None else s)[key]:
            kind, k = sub.rsplit("_", 1)
            if kind == "Conv":
                _conv(p[key][sub], out, f"{prefix}.convs.{k}")
            else:  # BatchNorm_k or GroupNorm_k
                _bn(p and p[key][sub], s and s[key][sub], out, f"{prefix}.norms.{k}")


_TOP_LEVEL = {
    "encoder", "detector", "view_proj", "view_proj_bias", "query_proj", "query_proj_bias",
    "deform_fusion", "AttentionFusion_0", "bev_proj",
}


def _from_flax(params: Optional[Mapping], stats: Optional[Mapping]) -> StateDict:
    """The port's names for a params tree, a batch_stats tree, or both."""
    out: StateDict = {}
    bb = None if params is None else params["encoder"]["backbone"]
    bb_s = None if not stats else stats["encoder"]["backbone"]
    tree = bb if bb is not None else bb_s
    if bb is not None and "Conv_0" in bb:  # the simple backbone: two convs, no BatchNorm
        _conv(bb["Conv_0"], out, "encoder.backbone.conv0")
        _conv(bb["Conv_1"], out, "encoder.backbone.conv1")
    elif tree is not None and "stage4_block0" not in tree:  # a ResNet: four stages
        _resnet(bb, bb_s, out, "encoder.backbone")
    elif tree is not None:
        if bb is not None:
            _conv(bb["stem_conv"], out, "encoder.backbone.stem_conv")
        _bn(bb and bb["stem_bn"], bb_s and bb_s["stem_bn"], out, "encoder.backbone.stem_bn")
        for si, (_, _, repeats, _, _) in enumerate(B0_STAGES):
            for r in range(repeats):
                key = f"stage{si}_block{r}"
                _mbconv(bb and bb[key], bb_s and bb_s[key], out, f"encoder.backbone.stages.{si}.{r}")
    if params is None:
        return out
    unknown = sorted(set(params) - _TOP_LEVEL)
    if unknown:
        raise KeyError(f"params tree has keys the port does not map: {unknown}")
    _conv(params["encoder"]["proj"], out, "encoder.proj")
    for fusion in ("view", "query"):
        if f"{fusion}_proj" in params:
            out[f"{fusion}_proj"] = _t(params[f"{fusion}_proj"])
            out[f"{fusion}_proj_bias"] = _t(params[f"{fusion}_proj_bias"])
    if "deform_fusion" in params:
        for layer in ("value", "offsets", "attn", "out"):
            _dense(params["deform_fusion"][layer], out, f"deform_fusion.{layer}")
    if "AttentionFusion_0" in params:
        _dense(params["AttentionFusion_0"]["Dense_0"], out, "attn_fusion.hidden")
        _dense(params["AttentionFusion_0"]["Dense_1"], out, "attn_fusion.logit")
    if "bev_proj" in params:
        bp = params["bev_proj"]
        _dense({"kernel": np.asarray(bp["kernel"])[0, 0], "bias": bp["bias"]}, out, "bev_proj")
    det = params["detector"]
    for i in range(3):
        _conv(det[f"stem{i}"], out, f"detector.stem{i}")
        out[f"detector.gn{i}.weight"] = _t(det[f"GroupNorm_{i}"]["scale"])
        out[f"detector.gn{i}.bias"] = _t(det[f"GroupNorm_{i}"]["bias"])
    for head in ("heatmap_head", "offset_head", "size_head"):
        _conv(det[head], out, f"detector.{head}")
    return out


def state_dict_from_flax(variables: Mapping) -> StateDict:
    """Flax ``BEVNet`` variables (numpy leaves) -> the port's state_dict
    (a model without BatchNorm, as the ``simple`` backbone's, has no
    ``batch_stats``)."""
    return _from_flax(variables["params"], variables.get("batch_stats"))


def params_from_flax(params: Mapping) -> StateDict:
    """A Flax ``params`` tree, or a gradient tree of its shape -> the
    port's parameter names (conv kernels transposed to OIHW)."""
    return _from_flax(params, None)


def batch_stats_from_flax(stats: Mapping) -> StateDict:
    """A Flax ``batch_stats`` tree -> the port's BatchNorm buffer names."""
    return _from_flax(None, stats)


def init_state_dict(cfg: Config, seed: int = 0) -> StateDict:
    """Random weights for ``BEVNet.from_config(cfg)`` from ``seed``.

    Kernels are LeCun-normal truncated at 2 sigma (Flax's default init),
    biases 0, norm scales 1 (0 for the norm that closes each ResNet
    block's main branch, as Flax's ``scale_init=zeros``), BatchNorm
    statistics (0, 1), with the head's
    CenterNet constants and, for ``deform_attn``, the sampling heads' zero
    kernels and ring bias. ``bev_proj`` and the attention fusion's layers
    start as Flax's ``Conv`` and ``Dense`` do (fan-in the input channels).
    Built on the CPU.
    """
    g = torch.Generator().manual_seed(seed)
    model = BEVNet.from_config(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in ("view_proj", "query_proj"):  # [V, F, C_out]: fan-in V * F
                fan_in = p.shape[0] * p.shape[1]
            elif p.ndim == 4:  # OIHW
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            elif p.ndim == 2:  # a Dense layer's [out, in]
                fan_in = p.shape[1]
            else:
                p.fill_(1.0 if name.rsplit(".", 1)[-1] == "weight" else 0.0)
                continue
            std = 1.0 / (fan_in ** 0.5) / 0.87962566  # truncation-corrected
            # standard normal truncated to [-2, 2] by its inverse CDF
            lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
            u = lo + (1.0 - 2.0 * lo) * torch.rand(p.shape, generator=g, dtype=torch.float64)
            p.copy_((torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0) * std).float())
        if isinstance(model.encoder.backbone, ResNetFeatures):  # Flax's scale_init=zeros
            for block in model.encoder.backbone.blocks():
                block.last_norm.weight.zero_()
        model.detector.init_centernet_()
        if model.fusion == "deform_attn":
            model.deform_fusion.init_sampling_()
    return model.state_dict()

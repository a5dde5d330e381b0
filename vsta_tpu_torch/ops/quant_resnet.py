"""int8 post-training quantization of the ResNet encoder (serving), the
twin of ``vsta_tpu/ops/quant_resnet.py``.

BatchNorm folds into each convolution (f32 ``rsqrt(var + 1e-5)``), every
folded convolution but the 7x7 stem runs s8 x s8 -> s32 through
:func:`~vsta_tpu_torch.ops.quant.conv_int8` (per-output-channel weight
scales, per-tensor calibrated activation scales), and ReLU, the residual
adds, the max pool and the stem stay f32. The walk mirrors
:class:`~vsta_tpu_torch.models.encoders.resnet.ResNetFeatures` and
:class:`~vsta_tpu_torch.models.encoders.encoder.ViewEncoder`: torch's
padding, the pyramid levels, a multi-scale ``OUT_INDEX`` resized by
:func:`~vsta_tpu_torch.ops.resize.resize_bilinear` and concatenated, and
the ``fold_proj`` contract, so ``BEVNet.forward(..., quant_encoder=qe)``
swaps it in for serving.

Sites are keyed by the JAX package's names (``'stem'``,
``'stage{i}_block{j}/Conv_{k}'``, ``Conv_k`` the port's ``convs.k``), so
the two packages' trees map one to one (``convert.quant_encoder_from_jax``).
Maps are channels-last [N, H, W, C].
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.encoders.resnet import RESNET_EPS, RESNET_SPECS
from .quant import CONV_IMPL, _nchw, _nhwc, conv_int8, percentile, quantize_act, quantize_weight_per_cout
from .resize import resize_bilinear

Folded = Tuple[torch.Tensor, torch.Tensor]


def _fold_bn(kernel: torch.Tensor, sd: Mapping[str, torch.Tensor], bn: str) -> Folded:
    """conv (no bias) + the BatchNorm ``bn`` of state dict ``sd`` -> folded
    (OIHW kernel, bias)."""
    s = sd[f"{bn}.weight"].float() * torch.rsqrt(sd[f"{bn}.running_var"].float() + RESNET_EPS)
    return (
        kernel.float() * s[:, None, None, None],
        sd[f"{bn}.bias"].float() - sd[f"{bn}.running_mean"].float() * s,
    )


def _block_convs(variant: str) -> Tuple[List[Tuple[str, int, bool]], str]:
    """A block's main-path convolutions (name, kernel, takes the stride?)
    and its residual projection's name."""
    if RESNET_SPECS[variant][0]:  # bottleneck: 1x1, 3x3 (strided), 1x1
        return [("Conv_0", 1, False), ("Conv_1", 3, True), ("Conv_2", 1, False)], "Conv_3"
    return [("Conv_0", 3, True), ("Conv_1", 3, False)], "Conv_2"


def _fold_backbone(variant: str, sd: Mapping[str, torch.Tensor]) -> Dict[str, Folded]:
    """Folded f32 (kernel, bias) of every convolution of the backbone whose
    state dict is ``sd`` (``model.encoder.backbone.state_dict()``)."""
    _, stage_sizes = RESNET_SPECS[variant]
    main, down = _block_convs(variant)
    folded = {"stem": _fold_bn(sd["stem_conv.weight"], sd, "stem_bn")}
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            for k in range(len(main) + 1):
                prefix = f"stages.{i}.{j}"
                if f"{prefix}.convs.{k}.weight" in sd:
                    folded[f"stage{i}_block{j}/Conv_{k}"] = _fold_bn(
                        sd[f"{prefix}.convs.{k}.weight"], sd, f"{prefix}.norms.{k}"
                    )
    return folded


def _forward_backbone(
    variant: str, x: torch.Tensor, site: Callable[[str, torch.Tensor, int, int], torch.Tensor],
    has_site: Callable[[str], bool],
) -> List[torch.Tensor]:
    """The trunk's walk, shared by the float calibration and the int8 apply.

    ``site(key, x, stride, kernel_size)`` returns the convolution + folded
    BatchNorm (before the activation); ``has_site(key)`` says whether a
    block has its residual projection. Returns the five levels.
    """
    _, stage_sizes = RESNET_SPECS[variant]
    main, down = _block_convs(variant)
    y = F.relu(site("stem", x.float(), 2, 7))
    feats = [y]
    y = _nhwc(F.max_pool2d(_nchw(y), 3, 2, 1))  # pads with -inf
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            blk = f"stage{i}_block{j}"
            stride = 2 if (i > 0 and j == 0) else 1
            z = y
            for idx, (cname, ksize, strided) in enumerate(main):
                z = site(f"{blk}/{cname}", z, stride if strided else 1, ksize)
                if idx < len(main) - 1:
                    z = F.relu(z)
            r = site(f"{blk}/{down}", y, stride, 1) if has_site(f"{blk}/{down}") else y
            y = F.relu(z + r)
        feats.append(y)
    return feats


def _conv_f32(x: torch.Tensor, kernel: torch.Tensor, stride: int, ksize: int) -> torch.Tensor:
    return _nhwc(F.conv2d(_nchw(x), kernel, None, stride, (ksize - 1) // 2))


def _levels(out_index: Any) -> Tuple[int, ...]:
    return tuple(out_index) if isinstance(out_index, (tuple, list)) else (out_index,)


def quantize_encoder(
    variant: str,
    enc: Mapping[str, torch.Tensor],
    calib_images: Sequence[torch.Tensor],
    out_index: Any,
    fold_proj: bool,
    clip_percentile: float = 99.99,
) -> Dict:
    """Int8 serving parameters of the ViewEncoder.

    ``enc``: the encoder's state dict (``model.encoder.state_dict()``:
    ``backbone.*`` and ``proj.*``); ``calib_images``: a few normalized
    [N, H, W, 3] image tensors (B*V flattened). Returns the
    ``quant_encoder`` tree for ``BEVNet.forward`` / :func:`apply_quant_encoder`.
    """
    if not calib_images:
        raise ValueError("need at least one calibration batch")
    backbone = {k[len("backbone."):]: v for k, v in enc.items() if k.startswith("backbone.")}
    folded = _fold_backbone(variant, backbone)

    amax: Dict[str, float] = {}

    def site(key, xin, stride, ksize):
        if key != "stem":  # the stem conv stays f32
            amax[key] = max(amax.get(key, 0.0), float(percentile(xin.abs(), clip_percentile)))
        w, b = folded[key]
        return _conv_f32(xin, w, stride, ksize) + b

    with torch.no_grad():
        for x in calib_images:
            _forward_backbone(variant, x, site, lambda k: k in folded)

    sites = {}
    for key, (w, b) in folded.items():
        if key == "stem":
            continue
        w_i8, w_scale = quantize_weight_per_cout(w)
        sites[key] = {
            "w_i8": w_i8,
            "w_scale": w_scale,
            "b": b,
            "x_scale": torch.tensor(max(amax[key], 1e-8) / 127.0, dtype=torch.float32, device=w.device),
        }
    return {
        "variant": variant,
        "stem": {"w": folded["stem"][0], "b": folded["stem"][1]},
        "sites": sites,
        "proj": {"kernel": enc["proj.weight"][:, :, 0, 0].t().float().contiguous(), "bias": enc["proj.bias"].float().clone()},
        "out_index": list(_levels(out_index)) if isinstance(out_index, (tuple, list)) else out_index,
        "fold_proj": bool(fold_proj),
        "impl": CONV_IMPL,
    }


def apply_quant_encoder(qe: Dict, images: torch.Tensor):
    """Int8 twin of ``ViewEncoder.forward`` (same output contract).

    images [B, V, H, W, 3], normalized -> [B, V, Hf, Wf, feat_dim] f32, or
    (raw map, proj kernel [C_raw, F], proj bias [F]) when the tree was made
    with ``fold_proj`` (concat under the fused warps folds the 1x1
    projection into the warp).
    """
    B, V, H, W, C = images.shape
    x = images.reshape(B * V, H, W, C)
    sites = qe["sites"]

    def site(key, xin, stride, ksize):
        if key == "stem":
            return _conv_f32(xin, qe["stem"]["w"], stride, ksize) + qe["stem"]["b"]
        qs = sites[key]
        y = conv_int8(quantize_act(xin, qs["x_scale"]), qs["w_i8"], stride=stride)
        return y.float() * (qs["x_scale"] * qs["w_scale"]) + qs["b"]

    pyramid = _forward_backbone(qe["variant"], x, site, lambda k: k in sites)
    feats = [pyramid[i] for i in _levels(qe["out_index"])]
    if len(feats) > 1:
        size = (max(f.shape[1] for f in feats), max(f.shape[2] for f in feats))
        feat = torch.cat([_nhwc(resize_bilinear(_nchw(f), size)) for f in feats], dim=-1)
    else:
        feat = feats[0]
    _, Hf, Wf, Cf = feat.shape
    kernel, bias = qe["proj"]["kernel"], qe["proj"]["bias"]
    if qe["fold_proj"]:
        return feat.reshape(B, V, Hf, Wf, Cf), kernel, bias
    feat = torch.einsum("nhwc,cf->nhwf", feat, kernel) + bias
    return feat.reshape(B, V, Hf, Wf, kernel.shape[-1])

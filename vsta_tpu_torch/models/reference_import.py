"""Import a reference-framework BEVNet checkpoint into the port's
:class:`~vsta_tpu_torch.models.BEVNet`: the twin of
``vsta_tpu/models/reference_import.py``.

The reference is a torch model (NCHW convs, a lazily built 1x1 ``proj``
over the concat fusion's output, a lazily built detector). Its
``state_dict`` is first named as the JAX package's parameter tree names
it, then merged into the port's model seen under those names
(:func:`model_targets`), so both packages find the same targets, skip the
same tensors with the same warnings and count the same:

  encoder.backbone.0 / .2          -> encoder/backbone/Conv_0 / Conv_1
      (the reference's fallback conv stack; the port's ``simple``)
  encoder.backbone.<torchvision>   -> encoder/backbone/** via
      :func:`~vsta_tpu_torch.models.encoders.pretrained.convert_torch_resnet`
  encoder.proj                     -> encoder/proj; the identity where
      the reference had none (the fallback path)
  proj [C_out, V*C, 1, 1]          -> view_proj [V, C, C_out] (+ bias)
  detector.stem.{0,3,6}            -> detector/stem{0,1,2}
  detector.stem.{1,4,7} (GN)       -> detector/GroupNorm_{0,1,2}
  detector.{heatmap,offset,size}_head -> detector/*_head

The tensors keep torch's layout (OIHW), which is the port's. An
EfficientNet backbone offers no target to the importer's backbone names.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch

from .bevnet import BEVNet
from .encoders.pretrained import Tree, backbone_targets, convert_torch_resnet, merge
from .encoders.resnet import ResNetFeatures
from .encoders.simple import SimpleConvFeatures


def convert_reference_state_dict(sd: Mapping[str, Any], views: int, feat_dim: int) -> Tree:
    """Reference BEVNet state_dict -> a partial params tree under the JAX
    package's names (``encoder/__batch_stats__`` holds a ResNet's
    statistics), float32 tensors in torch's layout."""
    sd = {k: torch.as_tensor(v).float() for k, v in sd.items()}
    params: Tree = {}

    enc: Tree = {}
    if "encoder.backbone.0.weight" in sd:  # the fallback conv stack
        enc["backbone"] = {
            "Conv_0": {"kernel": sd["encoder.backbone.0.weight"], "bias": sd["encoder.backbone.0.bias"]},
            "Conv_1": {"kernel": sd["encoder.backbone.2.weight"], "bias": sd["encoder.backbone.2.bias"]},
        }
        # the fallback has no 1x1 proj; the port always has one -> identity
        C = sd["encoder.backbone.2.weight"].shape[0]
        enc["proj"] = {"kernel": torch.eye(C)[:, :, None, None], "bias": torch.zeros(C)}
    elif any(k.startswith("encoder.backbone.conv1") for k in sd):  # timm/torchvision naming
        bb_sd = {k[len("encoder.backbone."):]: v for k, v in sd.items() if k.startswith("encoder.backbone.")}
        bb_params, bb_stats = convert_torch_resnet(bb_sd, _guess_resnet_variant(bb_sd))
        enc["backbone"] = bb_params
        enc["__batch_stats__"] = bb_stats
        if "encoder.proj.weight" in sd:
            enc["proj"] = {"kernel": sd["encoder.proj.weight"], "bias": sd["encoder.proj.bias"]}
    if enc:
        params["encoder"] = enc

    # the concat fusion + 1x1 conv is the per-view projection
    if "proj.weight" in sd:
        w = sd["proj.weight"]  # [C_out, V*C, 1, 1]
        c_out, vc = w.shape[0], w.shape[1]
        if vc % views == 0:
            params["view_proj"] = w[:, :, 0, 0].reshape(c_out, views, vc // views).permute(1, 2, 0).contiguous()
            params["view_proj_bias"] = sd["proj.bias"]
        else:
            print(f"[reference-import] proj in_ch {vc} not divisible by V={views}; skipped")

    det: Tree = {}
    for i, src in enumerate((0, 3, 6)):
        w = sd.get(f"detector.stem.{src}.weight")
        if w is not None:
            det[f"stem{i}"] = {"kernel": w}
        gw, gb = sd.get(f"detector.stem.{src + 1}.weight"), sd.get(f"detector.stem.{src + 1}.bias")
        if gw is not None and gb is not None:
            det[f"GroupNorm_{i}"] = {"scale": gw, "bias": gb}
    for head in ("heatmap_head", "offset_head", "size_head"):
        w, b = sd.get(f"detector.{head}.weight"), sd.get(f"detector.{head}.bias")
        if w is not None and b is not None:
            det[head] = {"kernel": w, "bias": b}
    if det:
        params["detector"] = det
    return params


def _guess_resnet_variant(bb_sd: Mapping[str, Any]) -> str:
    n_layer1 = len({k.split(".")[1] for k in bb_sd if k.startswith("layer1.")})
    if any("conv3" in k for k in bb_sd):  # bottlenecks
        n_layer3 = len({k.split(".")[1] for k in bb_sd if k.startswith("layer3.")})
        return "resnet101" if n_layer3 > 10 else "resnet50"
    return "resnet34" if n_layer1 > 2 else "resnet18"


def model_targets(model: BEVNet) -> Tuple[Tree, Tree]:
    """The model's tensors that the importer can fill, under the JAX
    package's names: (params, the backbone's batch_stats)."""
    bb = model.encoder.backbone
    stats: Tree = {}
    if isinstance(bb, ResNetFeatures):
        backbone, stats = backbone_targets(bb)
    elif isinstance(bb, SimpleConvFeatures):
        backbone = {f"Conv_{i}": {"kernel": c.weight, "bias": c.bias} for i, c in enumerate((bb.conv0, bb.conv1))}
    else:
        backbone = {}
    proj = model.encoder.proj
    params: Tree = {"encoder": {"backbone": backbone, "proj": {"kernel": proj.weight, "bias": proj.bias}}}
    if model.fusion == "concat":
        params["view_proj"], params["view_proj_bias"] = model.view_proj, model.view_proj_bias
    d = model.detector
    det: Tree = {}
    for i in range(3):
        det[f"stem{i}"] = {"kernel": getattr(d, f"stem{i}").weight}
        gn = getattr(d, f"gn{i}")
        det[f"GroupNorm_{i}"] = {"scale": gn.weight, "bias": gn.bias}
    for head in ("heatmap_head", "offset_head", "size_head"):
        det[head] = {"kernel": getattr(d, head).weight, "bias": getattr(d, head).bias}
    params["detector"] = det
    return params, stats


def load_reference_weights(model: BEVNet, sd: Mapping[str, Any], views: int, feat_dim: int) -> Tuple[BEVNet, int]:
    """Merge a reference state_dict into ``model`` in place. Returns (the
    model, the number of tensors loaded). Mismatched shapes are skipped with
    a warning (the reference's own strict=False load)."""
    converted = convert_reference_state_dict(sd, views, feat_dim)
    bstats = converted["encoder"].pop("__batch_stats__", None) if "encoder" in converted else None
    params, stats = model_targets(model)
    n = merge(params, converted, "reference-import")
    if bstats is not None and stats:
        n += merge(stats, bstats, "reference-import")
    print(f"[reference-import] loaded {n} tensors from reference checkpoint")
    return model, n

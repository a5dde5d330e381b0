"""Pretrained ResNet weights from a local torch ``state_dict``: the twin of
``vsta_tpu/models/encoders/pretrained.py``.

A torchvision/timm-style ResNet ``.pth`` (nothing is downloaded) goes into
the port's :class:`~vsta_tpu_torch.models.encoders.resnet.ResNetFeatures`
with the JAX package's warn-don't-crash semantics and messages. The
weights are first named as the Flax tree names them, then merged into the
port's backbone seen under those names (:func:`backbone_targets`), so both
packages find the same targets, skip the same tensors and count the same:

  conv1 / bn1                  -> stem_conv / stem_bn
  layer{i+1}.{j}.conv{k+1}     -> stage{i}_block{j}.Conv_{k}
  layer{i+1}.{j}.bn{k+1}       -> stage{i}_block{j}.BatchNorm_{k}
  layer{i+1}.{j}.downsample.0  -> stage{i}_block{j}.Conv_{n_convs}
  layer{i+1}.{j}.downsample.1  -> stage{i}_block{j}.BatchNorm_{n_convs}

The tensors keep torch's layout (OIHW), which is the port's.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from .resnet import RESNET_SPECS, ResNetFeatures

Tree = Dict[str, Any]


def convert_torch_resnet(state_dict: Mapping[str, Any], variant: str = "resnet18") -> Tuple[Tree, Tree]:
    """A torch ResNet state_dict -> (params, batch_stats) trees under the
    Flax names, float32 tensors in torch's layout. Extra keys (fc.*) are
    ignored; missing ones are skipped with a warning."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    bottleneck, stage_sizes = RESNET_SPECS[variant]
    n_convs = 3 if bottleneck else 2
    params: Tree = {}
    stats: Tree = {}
    missing = []

    def take(key):
        if key not in sd:
            missing.append(key)
            return None
        return sd[key].float()

    def put_bn(dst_p: Tree, dst_s: Tree, name: str, prefix: str) -> None:
        w, b = take(f"{prefix}.weight"), take(f"{prefix}.bias")
        m, v = take(f"{prefix}.running_mean"), take(f"{prefix}.running_var")
        if w is None or b is None or m is None or v is None:
            return
        dst_p[name] = {"scale": w, "bias": b}
        dst_s[name] = {"mean": m, "var": v}

    w = take("conv1.weight")
    if w is not None:
        params["stem_conv"] = {"kernel": w}
    put_bn(params, stats, "stem_bn", "bn1")
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            bp: Tree = {}
            bs: Tree = {}
            t = f"layer{i + 1}.{j}"
            for k in range(n_convs):
                cw = take(f"{t}.conv{k + 1}.weight")
                if cw is not None:
                    bp[f"Conv_{k}"] = {"kernel": cw}
                put_bn(bp, bs, f"BatchNorm_{k}", f"{t}.bn{k + 1}")
            if f"{t}.downsample.0.weight" in sd:
                bp[f"Conv_{n_convs}"] = {"kernel": take(f"{t}.downsample.0.weight")}
                put_bn(bp, bs, f"BatchNorm_{n_convs}", f"{t}.downsample.1")
            params[f"stage{i}_block{j}"] = bp
            stats[f"stage{i}_block{j}"] = bs
    if missing:
        print(f"[pretrained] {len(missing)} torch keys missing, skipped: {missing[:5]}...")
    return params, stats


def backbone_targets(backbone: ResNetFeatures) -> Tuple[Tree, Tree]:
    """The backbone's tensors under their Flax names: (params, batch_stats)
    trees whose leaves are the port's parameters and buffers. A norm is
    ``BatchNorm_k`` or ``GroupNorm_k`` as Flax names it (the stem's is
    ``stem_bn`` either way); with GroupNorm the stats tree is empty."""
    norm = "GroupNorm" if backbone.norm == "group" else "BatchNorm"

    def put(dst_p: Tree, dst_s: Tree, name: str, mod) -> None:
        dst_p[name] = {"scale": mod.weight, "bias": mod.bias}
        if norm == "BatchNorm":
            dst_s[name] = {"mean": mod.running_mean, "var": mod.running_var}

    params: Tree = {"stem_conv": {"kernel": backbone.stem_conv.weight}}
    stats: Tree = {}
    put(params, stats, "stem_bn", backbone.stem_bn)
    for i, stage in enumerate(backbone.stages):
        for j, block in enumerate(stage):
            bp: Tree = {}
            bs: Tree = {}
            for k, (c, n) in enumerate(zip(block.convs, block.norms)):
                bp[f"Conv_{k}"] = {"kernel": c.weight}
                put(bp, bs, f"{norm}_{k}", n)
            params[f"stage{i}_block{j}"] = bp
            if bs:
                stats[f"stage{i}_block{j}"] = bs
    return params, stats


def merge(dst: Tree, src: Tree, tag: str, path: str = "") -> int:
    """Copy ``src``'s leaves into the tensors of ``dst`` (same tree), in
    place; a key with no target or a shape that differs is skipped with a
    warning. Returns the number of tensors copied."""
    n = 0
    for k, v in src.items():
        if k not in dst:
            print(f"[{tag}] no target for {path}{k}, skipped")
            continue
        if isinstance(v, dict):
            n += merge(dst[k], v, tag, path=f"{path}{k}/")
            continue
        if tuple(dst[k].shape) != tuple(v.shape):
            print(f"[{tag}] shape mismatch at {path}{k}: {tuple(dst[k].shape)} vs {tuple(v.shape)}, skipped")
            continue
        with torch.no_grad():
            dst[k].copy_(v)
        n += 1
    return n


def load_pretrained_backbone(backbone: ResNetFeatures, path: str, variant: str) -> Tuple[int, int]:
    """Load a torch ResNet ``.pth`` into ``backbone`` in place; returns the
    counts of parameters and statistics loaded. Raises where the JAX
    package raises (a variant that is no ResNet, a file that does not
    load), for the caller's tolerant load."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    new_params, new_stats = convert_torch_resnet(sd, variant)
    dst_params, dst_stats = backbone_targets(backbone)
    n_p = merge(dst_params, new_params, "pretrained")
    n_s = merge(dst_stats, new_stats, "pretrained") if dst_stats else 0
    print(f"[pretrained] loaded {n_p} param + {n_s} batch-stat tensors from {path}")
    return n_p, n_s

"""Plain PyTorch reference of the detector on a ResNet trunk.

The trunk follows ResNet (He et al., arXiv:1512.03385) as the program
builds it: a 7x7 stem of stride 2, BatchNorm, ReLU and a 3x3 max-pool of
stride 2, then four stages of basic blocks (two 3x3, ResNet-18/34) or
bottlenecks (1x1, 3x3, 1x1 to four times the width, ResNet-50/101), the
stride on the 3x3, the residual projected by a strided 1x1 and a norm
where the shape changes. Padding is symmetric (3 for the stem, 1 for a 3x3
and the max-pool, none for a 1x1); BatchNorm has eps 1e-5, running
statistics in eval mode, the batch's in train mode. The trunk stops at
pyramid level ``OUT_INDEX`` of [stem/2, C2/4, C3/8, C4/16, C5/32], then the
encoder's 1x1 projection to ``FEAT_DIM``. ``MODEL.NORM: group`` raises
``ValueError``: no configuration here runs it.

Everything after the encoder (geometry, warp, fusions, positional
encoding, head) is ``model.py``'s, by import. ``param_specs`` lists every
stage the program builds, the stages past ``OUT_INDEX`` too: the serving
artifact loads the whole state dict. Float32, TF32 off; it imports
nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch.nn.functional as F

from . import model
from .model import bev_specs, bn_specs, proj_specs
from .model import normalise, project_cells, tf32_off  # noqa: F401 (the contract: model.py's, unchanged)
from .precision import exact

# variant -> (bottleneck blocks, blocks a stage)
VARIANTS = {"resnet18": (False, (2, 2, 2, 2)), "resnet34": (False, (3, 4, 6, 3)),
            "resnet50": (True, (3, 4, 6, 3)), "resnet101": (True, (3, 4, 23, 3))}
WIDTH = 64
EPS = 1e-5


def _variant(m: Dict) -> str:
    if m.get("NORM", "batch") != "batch":
        raise ValueError(f"the ResNet reference has BatchNorm only, not MODEL.NORM {m['NORM']!r}")
    if m["BACKBONE"] not in VARIANTS:
        raise ValueError(f"no ResNet {m['BACKBONE']!r}: one of {sorted(VARIANTS)}")
    return m["BACKBONE"]


def level_channels(variant: str) -> Tuple[int, ...]:
    """Channels of the five pyramid levels."""
    expansion = 4 if VARIANTS[variant][0] else 1
    return (WIDTH,) + tuple(WIDTH * 2**i * expansion for i in range(4))


def blocks(variant: str):
    """(prefix, stage, convs as (in, out, kernel, stride), projected) of
    every block, in order; a projected block's last conv is the residual's."""
    bottleneck, sizes = VARIANTS[variant]
    out, in_ch = [], WIDTH
    for i, n in enumerate(sizes):
        width = WIDTH * 2**i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            if bottleneck:
                out_ch = 4 * width
                convs = [(in_ch, width, 1, 1), (width, width, 3, stride), (width, out_ch, 1, 1)]
            else:
                out_ch = width
                convs = [(in_ch, width, 3, stride), (width, width, 3, 1)]
            projected = stride != 1 or in_ch != out_ch
            if projected:
                convs.append((in_ch, out_ch, 1, stride))
            out.append((f"encoder.backbone.stages.{i}.{j}.", i, convs, projected))
            in_ch = out_ch
    return out


def param_specs(m: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight (``model.param_specs``' kinds):
    the stem, every block's convs and norms (the residual's last), the
    encoder's projection, then ``model.py``'s fusion and head."""
    variant = _variant(m)
    specs = [("encoder.backbone.stem_conv.weight", (WIDTH, 3, 7, 7), "conv")]
    specs += bn_specs("encoder.backbone.stem_bn.", WIDTH)
    for p, _, convs, _ in blocks(variant):
        for k, (cin, cout, ks, _) in enumerate(convs):
            specs.append((f"{p}convs.{k}.weight", (cout, cin, ks, ks), "conv"))
        for k, (_, cout, _, _) in enumerate(convs):
            specs += bn_specs(f"{p}norms.{k}.", cout)
    return specs + proj_specs(m, level_channels(variant)[m["OUT_INDEX"]]) + bev_specs(m)


class Trunk(model.Trunk):
    """The ResNet up to pyramid level ``level``, then the encoder's 1x1
    projection. ``train``: BatchNorm from the batch."""

    eps = EPS

    def __init__(self, w, variant: str, level: int, q=exact, train: bool = False, stats=None):
        super().__init__(w, level, q, train, stats)
        self.variant = variant

    def conv(self, x, name, stride=1, bias=None):
        wt = self.w[name]
        b = None if bias is None else self.w[bias]
        return F.conv2d(self.q(x), self.q(wt), b, stride, wt.shape[-1] // 2)

    def block(self, x, p, convs, projected):
        n_main = len(convs) - projected
        y = x
        for k in range(n_main):
            y = self.bn(self.conv(y, f"{p}convs.{k}.weight", convs[k][3]), f"{p}norms.{k}.")
            if k < n_main - 1:
                y = F.relu(y)
        if projected:
            x = self.bn(self.conv(x, f"{p}convs.{n_main}.weight", convs[n_main][3]), f"{p}norms.{n_main}.")
        return F.relu(y + x)

    def __call__(self, x):
        """x [N, 3, H, W] normalised -> the projected level [N, FEAT_DIM, h, w]."""
        y = F.relu(self.bn(self.conv(x, "encoder.backbone.stem_conv.weight", 2), "encoder.backbone.stem_bn."))
        if self.level > 0:
            y = F.max_pool2d(y, 3, 2, 1)
            for p, stage, convs, projected in blocks(self.variant):
                if stage == self.level:
                    break
                y = self.block(y, p, convs, projected)
        return self.conv(y, "encoder.proj.weight", bias="encoder.proj.bias")


class Reference(model.Reference):
    """``model.Reference`` on a ResNet trunk (``MODEL.BACKBONE``)."""

    def __init__(self, cfg: Dict, weights, q=exact):
        super().__init__(cfg, weights, q)
        self.variant = _variant(cfg["MODEL"])

    def trunk(self, train: bool = False, stats=None) -> Trunk:
        return Trunk(self.w, self.variant, self.level, self.q, train, stats)

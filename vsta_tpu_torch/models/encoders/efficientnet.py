"""EfficientNet-B0 feature trunk (pyramid levels in timm order).

Levels are [16@s2, 24@s4, 40@s8, 112@s16, 320@s32]; the map of each
level is banked right before each stride-2 stage, as in the JAX trunk.
Convolutions use TensorFlow/Flax ``'SAME'`` padding, which is
asymmetric on stride 2 (e.g. 270 -> 135 with a 3x3 pads (0, 1)), so it
is applied with :func:`same_pad`, not ``Conv2d(padding=k // 2)``.

Parameters are float32; every op runs in the module's compute dtype
(weights cast at use, as Flax's ``dtype=`` does). BatchNorm has Flax's
semantics, eps 1e-3: the running statistics in eval mode, the batch's in
training mode.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm

# (expand, out_ch, repeats, strides, kernel) per stage
B0_STAGES: Sequence[Tuple[int, int, int, int, int]] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
BN_EPS = 1e-3


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Pad an NCHW map as ``'SAME'`` would for a k x k conv of stride s:
    output ceil(n / s), the odd pixel of padding at the end."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: W first, then H
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def conv(x: torch.Tensor, c: nn.Conv2d, stride: int = 1) -> torch.Tensor:
    """``c`` applied with SAME padding, its weights cast to x's dtype."""
    k = c.weight.shape[-1]
    b = None if c.bias is None else c.bias.to(x.dtype)
    return F.conv2d(same_pad(x, k, stride), c.weight.to(x.dtype), b, stride, 0, 1, c.groups)


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, reduce_ch: int):
        super().__init__()
        self.reduce = nn.Conv2d(ch, reduce_ch, 1)
        self.expand = nn.Conv2d(reduce_ch, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.silu(conv(s, self.reduce))
        return x * torch.sigmoid(conv(s, self.expand))


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand: int, kernel: int, stride: int):
        super().__init__()
        mid = in_ch * expand
        self.stride = stride
        self.residual = stride == 1 and in_ch == out_ch
        if expand != 1:
            self.expand_conv = nn.Conv2d(in_ch, mid, 1, bias=False)
            self.expand_bn = BatchNorm(mid, BN_EPS)
        else:
            self.expand_conv = None
        self.dw_conv = nn.Conv2d(mid, mid, kernel, stride, groups=mid, bias=False)
        self.dw_bn = BatchNorm(mid, BN_EPS)
        self.se = SqueezeExcite(mid, max(1, int(in_ch * 0.25)))
        self.project_conv = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.project_bn = BatchNorm(out_ch, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand_conv is not None:
            y = F.silu(self.expand_bn(conv(y, self.expand_conv)))
        y = F.silu(self.dw_bn(conv(y, self.dw_conv, self.stride)))
        y = self.project_bn(conv(self.se(y), self.project_conv))
        return y + x if self.residual else y


class EfficientNetFeatures(nn.Module):
    """B0 trunk; ``forward(x, levels)`` returns pyramid levels 0..levels-1.

    The stages after the last requested level are built (so converted
    checkpoints load whole). In eval mode they are not run. In training
    mode they run without gradient, for their BatchNorm statistics only:
    the JAX trunk runs all seven stages, so its train step moves those
    statistics too.
    """

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = nn.Conv2d(3, 32, 3, 2, bias=False)
        self.stem_bn = BatchNorm(32, BN_EPS)
        self.stages = nn.ModuleList()
        in_ch = 32
        for expand, out_ch, repeats, strides, kernel in B0_STAGES:
            blocks = nn.ModuleList()
            for r in range(repeats):
                blocks.append(MBConv(in_ch, out_ch, expand, kernel, strides if r == 0 else 1))
                in_ch = out_ch
            self.stages.append(blocks)

    def forward(self, x: torch.Tensor, levels: int = 5) -> List[torch.Tensor]:
        """x [N, 3, H, W] -> the first ``levels`` pyramid maps (NCHW)."""
        y = F.silu(self.stem_bn(conv(x.to(self.dtype), self.stem_conv, 2)))
        feats: List[torch.Tensor] = []
        stats_only = False
        for (_, _, _, strides, _), blocks in zip(B0_STAGES, self.stages):
            if strides == 2:
                feats.append(y)
                if len(feats) == levels:
                    if not self.training:
                        return feats
                    stats_only = True
            with torch.set_grad_enabled(torch.is_grad_enabled() and not stats_only):
                for block in blocks:
                    y = block(y)
        feats.append(y)
        return feats[:levels]

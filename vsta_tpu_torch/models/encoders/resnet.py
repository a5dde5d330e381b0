"""ResNet feature trunk (18/34/50/101), the twin of
``vsta_tpu/models/encoders/resnet.py``.

Levels are [stem/2, C2/4, C3/8, C4/16, C5/32] (timm's order): 64 channels
after the stem, then 64 * 2^i for the basic blocks of ResNet-18/34 and
four times that for the bottlenecks of ResNet-50/101 (C3 = 512 for
ResNet-50). Padding is torch's, symmetric: (3, 3) for the 7x7 stem,
(1, 1) for every 3x3 and for the max-pool (with -inf), none for a 1x1.

``dilation`` is torchvision's ``replace_stride_with_dilation`` for
stages 2 to 4 (MVDet's ResNet-18: ``(False, True, True)``): a dilated
stage keeps its input's stride, the stride its first block would take
multiplies the dilation instead, and, as torchvision's ``_make_layer``,
the stage's first block keeps the dilation before it while the later ones
take the new one. Every 3x3 of a block takes the block's dilation, padded
by it; the 1x1s take none. The default dilates nothing.

``norm`` is ``'batch'`` (Flax-style BatchNorm, eps 1e-5) or ``'group'``
(GroupNorm-32, eps 1e-5). A block's convolutions and norms sit in
``convs`` / ``norms`` in Flax's creation order (``Conv_k`` ->
``convs.k``), the residual projection last, where the block has one.
Parameters are float32; the convolutions run in the module's compute
dtype.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm, GroupNorm

# variant -> (bottleneck blocks, blocks a stage)
RESNET_SPECS: Dict[str, Tuple[bool, Tuple[int, ...]]] = {
    "resnet18": (False, (2, 2, 2, 2)),
    "resnet34": (False, (3, 4, 6, 3)),
    "resnet50": (True, (3, 4, 6, 3)),
    "resnet101": (True, (3, 4, 23, 3)),
}
RESNET_EPS = 1e-5
WIDTH = 64


def resnet_channels(variant: str) -> Tuple[int, ...]:
    """Channels of the five pyramid levels."""
    expansion = 4 if RESNET_SPECS[variant][0] else 1
    return (WIDTH,) + tuple(WIDTH * 2**i * expansion for i in range(4))


def make_norm(kind: str, ch: int) -> nn.Module:
    if kind == "group":
        return GroupNorm(ch, RESNET_EPS)
    return BatchNorm(ch, RESNET_EPS)


def _conv(x: torch.Tensor, c: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding, c.dilation)


class Block(nn.Module):
    """A basic block (two 3x3) or a bottleneck (1x1, 3x3, 1x1 to four
    times ``filters``); the stride sits on the 3x3, and ``dilation`` on
    every 3x3. The residual is projected by a strided 1x1 and a norm where
    the shape changes."""

    def __init__(self, in_ch: int, filters: int, stride: int, bottleneck: bool, norm: str, dilation: int = 1):
        super().__init__()
        if bottleneck:
            out_ch = 4 * filters
            specs = [(in_ch, filters, 1, 1), (filters, filters, 3, stride), (filters, out_ch, 1, 1)]
        else:
            out_ch = filters
            specs = [(in_ch, filters, 3, stride), (filters, filters, 3, 1)]
        self.n_main = len(specs)
        self.project = stride != 1 or in_ch != out_ch
        if self.project:
            specs.append((in_ch, out_ch, 1, stride))
        self.convs = nn.ModuleList()
        for i, o, k, s in specs:
            d = dilation if k == 3 else 1  # the 3x3s take the block's dilation
            self.convs.append(nn.Conv2d(i, o, k, s, d * (k // 2), d, bias=False))
        self.norms = nn.ModuleList(make_norm(norm, o) for _, o, _, _ in specs)

    @property
    def last_norm(self) -> nn.Module:
        """The norm that closes the main branch (Flax starts its scale at 0)."""
        return self.norms[self.n_main - 1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.n_main):
            y = self.norms[i](_conv(y, self.convs[i]))
            if i < self.n_main - 1:
                y = F.relu(y)
        res = self.norms[-1](_conv(x, self.convs[-1])) if self.project else x
        return F.relu(y + res)


class ResNetFeatures(nn.Module):
    """``forward(x, levels)`` returns pyramid levels 0..levels-1.

    Every stage is built (so converted checkpoints load whole). In eval
    mode the stages past the last requested level are not run. In
    training mode with BatchNorm they run without gradient, for their
    statistics only: the JAX trunk runs all four stages, so its train step
    moves those statistics too. GroupNorm keeps no statistics, so there
    the trunk stops at the last requested level in training as well.
    """

    def __init__(
        self, variant: str = "resnet18", dtype: torch.dtype = torch.float32, norm: str = "batch",
        dilation: Tuple[bool, bool, bool] = (False, False, False),
    ):
        super().__init__()
        bottleneck, stage_sizes = RESNET_SPECS[variant]
        self.dtype, self.norm = dtype, norm
        self.stem_conv = nn.Conv2d(3, WIDTH, 7, 2, 3, bias=False)
        self.stem_bn = make_norm(norm, WIDTH)
        self.stages = nn.ModuleList()
        in_ch, rate = WIDTH, 1
        for i, n_blocks in enumerate(stage_sizes):
            stride, first = (2 if i > 0 else 1), rate
            if i > 0 and dilation[i - 1]:  # the stride becomes dilation
                stride, rate = 1, rate * stride
            blocks = nn.ModuleList()
            for j in range(n_blocks):
                blocks.append(Block(in_ch, WIDTH * 2**i, stride if j == 0 else 1, bottleneck, norm,
                                    first if j == 0 else rate))
                in_ch = WIDTH * 2**i * (4 if bottleneck else 1)
            self.stages.append(blocks)

    def blocks(self) -> List[Block]:
        return [b for stage in self.stages for b in stage]

    def forward(self, x: torch.Tensor, levels: int = 5) -> List[torch.Tensor]:
        """x [N, 3, H, W] -> the first ``levels`` pyramid maps (NCHW)."""
        y = F.relu(self.stem_bn(_conv(x.to(self.dtype), self.stem_conv)))
        feats: List[torch.Tensor] = [y]
        more = self.training and self.norm == "batch"
        if levels == 1 and not more:
            return feats
        y = F.max_pool2d(y, 3, 2, 1)
        for blocks in self.stages:
            with torch.set_grad_enabled(torch.is_grad_enabled() and len(feats) < levels):
                for block in blocks:
                    y = block(y)
            feats.append(y)
            if len(feats) == levels and not more:
                break
        return feats[:levels]

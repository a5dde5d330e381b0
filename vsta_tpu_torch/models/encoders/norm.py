"""The backbones' normalisations, with Flax's semantics.

:class:`BatchNorm` (EfficientNet-B0 at eps 1e-3, the ResNets at 1e-5) and
:class:`GroupNorm` (``MODEL.NORM: group``, ResNets only: 32 groups, eps
1e-5). Both compute in float32 and return the input's dtype, as Flax's
norms do under ``dtype=bfloat16``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9  # Flax's: running = 0.9 * running + 0.1 * batch
GN_GROUPS = 32


class BatchNorm(nn.BatchNorm2d):
    """Flax's BatchNorm: f32 statistics, the input's dtype out.

    In eval mode it normalises with the running statistics. In training
    mode it normalises with the batch's mean and *biased* variance,
    ``max(E[x^2] - mean^2, 0)`` in f32 as flax's ``_compute_stats``, and
    moves the running statistics by ``0.9 * running + 0.1 * batch``.
    (``F.batch_norm(training=True)`` would store the unbiased variance.)
    """

    def __init__(self, ch: int, eps: float):
        super().__init__(ch, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x.float(), self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            ).to(x.dtype)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = BN_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """Flax's GroupNorm(32): statistics over each group's channels and the
    map, in f32; the input's dtype out. It keeps no state."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__(GN_GROUPS, ch, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)

"""The backbones' normalisations, with Flax's semantics.

:class:`BatchNorm` (EfficientNet-B0 at eps 1e-3, the ResNets at 1e-5) and
:class:`GroupNorm` (``MODEL.NORM: group``, ResNets only: 32 groups, eps
1e-5). Both compute in float32 and return the input's dtype, as Flax's
norms do under ``dtype=bfloat16``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import bn_act_cuda
from ...parallel.collectives import all_reduce_sum

BN_MOMENTUM = 0.9  # Flax's: running = 0.9 * running + 0.1 * batch
GN_GROUPS = 32


class BatchNorm(nn.BatchNorm2d):
    """Flax's BatchNorm: f32 statistics, the input's dtype out.

    In eval mode it normalises with the running statistics. In training
    mode it normalises with the batch's mean and *biased* variance,
    ``max(E[x^2] - mean^2, 0)`` in f32 as flax's ``_compute_stats``, and
    moves the running statistics by ``0.9 * running + 0.1 * batch``.
    (``F.batch_norm(training=True)`` would store the unbiased variance.)

    The sums of x and x^2 accumulate in float64, and the mean and E[x^2]
    are rounded to f32 from them: up to a rounding tie, the same f32
    statistics come out whatever the order of the summation. Summed in
    f32, the order moved them by an ulp, and ``E[x^2] - mean^2`` and
    the bf16 output turned that into gradients 9e-2 apart
    (``tests/test_torch_parallel.py``, the bf16 mesh case).

    ``mesh`` (set by a sharded ``BEVNet``): in training the statistics
    cover the 'data' axis, as JAX's compiled mesh program sums them: every
    view rank of a data group encodes the same B/n_data x V images, so one
    differentiable all-reduce of the float64 sums over 'data', over a
    count of the local count times ``n_data``. The statistics come out as
    one device's, and the running statistics equal on every rank.
    """

    mesh = None

    def __init__(self, ch: int, eps: float):
        super().__init__(ch, eps=eps)

    def fused(self, x: torch.Tensor) -> bool:
        """Whether eval mode takes the one-pass kernel for x: the kernel
        takes x (:func:`~vsta_tpu_torch.ops.bn_act_cuda.takes`: bfloat16,
        a dense layout) and no gradient is wanted (grad mode off, or
        neither x nor the affine parameters require one)."""
        args = (x, self.running_mean, self.running_var, self.weight, self.bias)
        wants_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, self.weight, self.bias))
        return not wants_grad and bn_act_cuda.takes(*args)

    def forward(self, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
        """x [N, C, H, W] -> normalised, then ``act`` (None or ``"silu"``),
        in x's dtype. In eval mode a CUDA tensor that :meth:`fused` admits
        takes one kernel (``ops/bn_act_cuda.py``) for both; anything else
        takes its plain version, the f32 BatchNorm, the cast, the SiLU."""
        if act not in bn_act_cuda.ACTS:
            raise ValueError(f"BatchNorm: act must be one of {bn_act_cuda.ACTS}, got {act!r}")
        if not self.training:
            args = (x, self.running_mean, self.running_var, self.weight, self.bias, self.eps, act)
            if x.is_cuda and self.fused(x):
                return bn_act_cuda.bn_act(*args)
            return bn_act_cuda.bn_act_ref(*args)
        xf = x.float()
        dims, f64 = (0, 2, 3), torch.float64
        sums = torch.stack([xf.sum(dim=dims, dtype=f64), (xf * xf).sum(dim=dims, dtype=f64)])
        count = xf.numel() // xf.shape[1]
        if self.mesh is not None:
            sums, count = all_reduce_sum(sums, self.mesh, "data"), count * self.mesh.n_data
        mean, sq = (sums / count).float()
        var = torch.clamp(sq - mean * mean, min=0.0)
        with torch.no_grad():
            m = BN_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]).to(x.dtype)
        return F.silu(y) if act == "silu" else y


class GroupNorm(nn.GroupNorm):
    """Flax's GroupNorm(32): statistics over each group's channels and the
    map, in f32; the input's dtype out. It keeps no state."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__(GN_GROUPS, ch, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)

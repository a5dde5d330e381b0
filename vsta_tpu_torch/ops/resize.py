"""Bilinear resizing as ``jax.image.resize(..., "bilinear")`` upsamples:
two products with fixed matrices of JAX's own weights, one an axis.

Their backward is two more products, with no atomics, so two runs on the
card give the same bits (``F.interpolate``'s backward adds with atomics).
:func:`resize_bilinear` serves both the encoder's multi-scale levels (in
the map's dtype, as JAX computes them) and the deformable fusion's f32
residual (an NHWC map seen as NCHW).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_INTERP: Dict[Tuple[int, int, str], torch.Tensor] = {}


def interp_matrix(src: int, dst: int, device=None) -> torch.Tensor:
    """[dst, src] float32 weights of half-pixel bilinear resampling along
    one axis, as ``jax.image.resize(..., "bilinear")`` computes them for an
    upsampling (its ``compute_weight_mat``, in float32: a triangle kernel
    at ``(i + 0.5) * src / dst - 0.5``, each row divided by its sum, which
    clamps at the edges). Built once per sizes and device, on the CPU."""
    key = (src, dst, str(torch.device(device) if device is not None else "cpu"))
    if key not in _INTERP:
        f32 = torch.float32
        inv_scale = torch.tensor(1.0 / (dst / src), dtype=f32)  # a double rounded once, as in JAX
        sample = (torch.arange(dst, dtype=f32) + 0.5) * inv_scale - 0.5
        w = (1.0 - (sample[:, None] - torch.arange(src, dtype=f32)[None, :]).abs()).clamp(min=0.0)
        total = w.sum(dim=1, keepdim=True)
        w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps, w / torch.where(total != 0, total, 1.0), 0.0)
        inside = (sample >= -0.5) & (sample <= src - 0.5)
        _INTERP[key] = torch.where(inside[:, None], w, 0.0).to(device)
    return _INTERP[key]


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsampling of an NCHW map [N, C, h, w] to [N, C, H, W] in
    its dtype, as ``jax.image.resize(x_nhwc, ..., "bilinear")`` computes it
    for any dtype: the weights of :func:`interp_matrix` rounded to x's
    dtype, the product along W first and then along H, each rounded to
    x's dtype (for bf16: two bf16 products, each summed in f32 and
    rounded once). An axis whose size does not change is left alone."""
    H, W = size
    if x.shape[3] != W:
        x = torch.einsum("wj,ncij->nciw", interp_matrix(x.shape[3], W, x.device).to(x.dtype), x)
    if x.shape[2] != H:
        x = torch.einsum("hi,nciw->nchw", interp_matrix(x.shape[2], H, x.device).to(x.dtype), x)
    return x

"""Bilinear homography warp of per-view feature maps onto the BEV grid.

Bilinear warping under a fixed calibration is a fixed linear map: each
BEV cell reduces to 4 (flat source index, weight) taps per view, with
``grid_sample(padding_mode='zeros', align_corners=False)`` semantics.
:func:`precompute_warp_lut` builds those taps; :func:`warp_lut_sum` is the
plain sum over them, and the CUDA kernel in
:mod:`vsta_tpu_torch.ops.warp_cuda` computes the same sum.
"""

from __future__ import annotations

from typing import Tuple

import torch


def precompute_warp_lut(
    coords: torch.Tensor, feat_hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index, weight) taps of the bilinear warp.

    coords: (..., 2) float (x, y) feature-pixel coordinates.
    Returns idx (..., 4) int32 flat indices into the ``Hf*Wf`` map
    (clamped in range) and wts (..., 4) float32, tap order
    (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1). Out-of-image taps get
    weight 0; a non-finite coordinate zeroes all 4 weights and indices.
    """
    Hf, Wf = feat_hw
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0).to(torch.float32)
    dy = (y - y0).to(torch.float32)
    # float -> int32 of a non-finite or huge value is undefined: non-finite
    # samples are zeroed below, and clamping to one cell outside the map
    # leaves every tap's mask and clamped index as they were
    finite = torch.isfinite(coords).all(dim=-1)
    x0i = torch.where(finite, x0, torch.zeros_like(x0)).clamp(-2, Wf).to(torch.int32)
    y0i = torch.where(finite, y0, torch.zeros_like(y0)).clamp(-2, Hf).to(torch.int32)

    def corner(xi, yi, w):
        inb = (xi >= 0) & (xi < Wf) & (yi >= 0) & (yi < Hf)
        flat = yi.clamp(0, Hf - 1) * Wf + xi.clamp(0, Wf - 1)
        return flat, w * inb.to(torch.float32)

    i00, w00 = corner(x0i, y0i, (1.0 - dx) * (1.0 - dy))
    i01, w01 = corner(x0i + 1, y0i, dx * (1.0 - dy))
    i10, w10 = corner(x0i, y0i + 1, (1.0 - dx) * dy)
    i11, w11 = corner(x0i + 1, y0i + 1, dx * dy)
    idx = torch.stack([i00, i01, i10, i11], dim=-1)
    wts = torch.stack([w00, w01, w10, w11], dim=-1)
    keep = finite[..., None]
    wts = torch.where(keep, wts, torch.zeros_like(wts))
    idx = torch.where(keep, idx, torch.zeros_like(idx))
    return idx.to(torch.int32), wts


def warp_lut_sum(
    feats_vpk: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor
) -> torch.Tensor:
    """``out[n, k] = sum_v sum_t wts[v,n,t] * feats[v, idx[v,n,t], k]`` in f32.

    feats_vpk [V, P, K]; idx/wts [V, N, 4]. Returns [N, K] float32.
    """
    V, _, K = feats_vpk.shape
    N = idx.shape[1]
    out = torch.zeros((N, K), dtype=torch.float32, device=feats_vpk.device)
    for v in range(V):
        fv = feats_vpk[v]
        for t in range(4):
            rows = fv.index_select(0, idx[v, :, t].long()).to(torch.float32)
            out.addcmul_(wts[v, :, t, None], rows)
    return out


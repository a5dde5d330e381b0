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


def tap_weights(wts: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The float32 tap weights as the kernels multiply them: rounded to
    ``dtype`` first (the TPU kernels cast their one-hot weight matrix to
    the compute dtype before the matmul), then widened to float32."""
    return wts.to(dtype).to(torch.float32)


def warp_lut_sum(
    feats_vpk: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor
) -> torch.Tensor:
    """``out[n, k] = sum_v sum_t wts[v,n,t] * feats[v, idx[v,n,t], k]`` in f32.

    feats_vpk [V, P, K]; idx/wts [V, N, 4]. Returns [N, K] float32. Each
    weight is rounded to the dtype of ``feats_vpk`` before the product
    (:func:`tap_weights`); the sum is float32.
    """
    V, _, K = feats_vpk.shape
    N = idx.shape[1]
    w = tap_weights(wts, feats_vpk.dtype)
    out = torch.zeros((N, K), dtype=torch.float32, device=feats_vpk.device)
    for v in range(V):
        fv = feats_vpk[v]
        for t in range(4):
            rows = fv.index_select(0, idx[v, :, t].long()).to(torch.float32)
            out.addcmul_(w[v, :, t, None], rows)
    return out


# -- taps on the padded map (the training backward's sampler) -------------
#
# The forward warp builds its LUT on the unpadded Hf*Wf map
# (precompute_warp_lut). The training backward reruns the warp through the
# grouped sampler, whose taps are a 2x2 patch anchored in a map padded by
# one zero row and column: (Hf+1)*(Wf+1) rows. Both equal grid_sample's
# zeros padding; they differ in which row a masked tap points at.


def anchored_taps(
    coords: torch.Tensor, feat_hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2-patch anchor and per-tap bilinear weights.

    coords: (..., 2) float (x, y). Returns (anchor (..., 2) int32 as
    (ya, xa) clamped in-image, weights (..., 4) float32), tap order
    (ya,xa), (ya,xa+1), (ya+1,xa), (ya+1,xa+1). A tap's weight is the
    bilinear hat max(0, 1 - |tap - coord|) per axis, so taps the clamp
    moved off the true floor weigh 0, and taps on the zero pad row/column
    read zeros. A non-finite coordinate is moved far outside the map, which
    zeroes its weights. The weights are differentiable in the coordinates
    (the anchors are integers and carry no gradient); where a hat touches
    0 exactly the gradient is the mean of its two sides, as the JAX
    package's ``maximum`` gives it.
    """
    Hf, Wf = feat_hw
    x, y = coords[..., 0], coords[..., 1]
    finite = torch.isfinite(x) & torch.isfinite(y)
    far = torch.full((), -10.0, dtype=torch.float32, device=coords.device)
    xs = torch.where(finite, x.float(), far)
    ys = torch.where(finite, y.float(), far)
    ya = torch.floor(ys).clamp(0, Hf - 1).to(torch.int32)
    xa = torch.floor(xs).clamp(0, Wf - 1).to(torch.int32)

    zero = torch.zeros((), dtype=torch.float32, device=coords.device)

    def tri(a, f):
        return torch.maximum(zero, 1.0 - torch.abs(a.to(torch.float32) - f))

    wy0, wy1 = tri(ya, ys), tri(ya + 1, ys)
    wx0, wx1 = tri(xa, xs), tri(xa + 1, xs)
    w = torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], dim=-1)
    return torch.stack([ya, xa], dim=-1), w


def pad_feat_br(feat: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., H+1, W+1, C], one zero row (bottom) and one
    zero column (right)."""
    return torch.nn.functional.pad(feat, (0, 0, 0, 1, 0, 1))


def flat_taps(anchors: torch.Tensor, Wp: int) -> torch.Tensor:
    """[G, N, 2] (ya, xa) anchors -> [G, N, 4] int32 flat taps into the
    padded, Wp-wide row-major map, in :func:`anchored_taps`' tap order."""
    p00 = anchors[..., 0] * Wp + anchors[..., 1]
    return torch.stack([p00, p00 + 1, p00 + Wp, p00 + Wp + 1], dim=-1).to(torch.int32)


def gather_taps(maps: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The 4 tap rows of every sample: maps [G, P, K], idx [G, N, 4] flat
    taps in [0, P) -> [G, N, 4, K] in the dtype of ``maps``."""
    G, P, K = maps.shape
    base = torch.arange(G, device=maps.device, dtype=torch.int64)[:, None, None] * P
    rows = (base + idx.long()).reshape(-1)
    return maps.reshape(G * P, K).index_select(0, rows).reshape(idx.shape + (K,))


# -- an upsample folded into the warp's taps ------------------------------
#
# MVDet resizes every view's map bilinearly (F.interpolate, half-pixel
# centres, align_corners False) and then warps the resized map. Both are
# fixed, separable linear maps, so their product is one: along an axis
# the warp's 2 taps land on resized pixels whose 2 source pixels each lie
# in a window of 3 source pixels where the axis is upsampled. A BEV cell is
# then a sum over at most 3 x 3 pixels of the map before the resize.

FOLD_AXIS_TAPS = 3  # source pixels an axis where it is upsampled


def _folded_axis(s: torch.Tensor, n_src: int, n_dst: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One axis of :func:`folded_taps`: s (...) float32 coordinates on the
    resized axis of ``n_dst`` pixels -> (first source pixel (...) int64,
    weights (..., 3) float32 of it and the next two)."""
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    scale = torch.tensor(float(n_src)) / n_dst  # in float32, as F.interpolate computes it
    a = torch.floor(s).clamp(0, n_dst - 1)
    w = [torch.zeros_like(s) for _ in range(FOLD_AXIS_TAPS)]
    for d in (0, 1):  # the warp's resized pixels a and a + 1
        j = a + d
        hat = torch.where(j < n_dst, torch.maximum(zero, 1.0 - torch.abs(j - s)), zero)  # none past the edge
        # F.interpolate's half-pixel source index, clamped at 0; the far edge repeats its pixel
        f = (scale * (j.clamp(max=n_dst - 1) + 0.5) - 0.5).clamp(min=0.0)
        i0 = torch.floor(f)
        i1 = torch.where(i0 < n_src - 1, i0 + 1, i0)
        if d == 0:
            base = i0
        for i, lam in ((i0, 1.0 - (f - i0)), (i1, f - i0)):
            for k in range(FOLD_AXIS_TAPS):
                w[k] = w[k] + torch.where(i - base == k, hat * lam, zero)
    return base.long(), torch.stack(w, dim=-1)


def folded_taps(
    coords: torch.Tensor, feat_hw: Tuple[int, int], size_hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bilinear warp of a map resized from ``feat_hw`` to ``size_hw``
    (``F.interpolate``, bilinear, ``align_corners`` False), as taps into
    the map before the resize.

    coords: (..., 2) float (x, y) pixel coordinates on the resized map, as
    :func:`~vsta_tpu_torch.geometry.bev_sample_coords_with_depth` gives
    them for ``size_hw``. Returns idx (..., T) int32 flat rows of the
    unpadded ``Hf * Wf`` map and wts (..., T) float32, T = 9 (the 3 x 3
    source pixels from the cell's first, row-major). The weights are the
    warp's bilinear hats times the resize's half-pixel weights (clamped at
    0 and at the far edge), summed by source pixel; a warp tap outside the
    resized map weighs 0 (grid_sample's zeros), as does every tap of a
    non-finite coordinate. T is 9 wherever each axis keeps or grows its
    size; a shape that shrinks an axis (up to 4 source pixels an axis)
    raises ``ValueError``. Equal, in real arithmetic, to resizing and then
    sampling; in float32 within a few ulp of it.
    """
    Hf, Wf = feat_hw
    H, W = size_hw
    if H < Hf or W < Wf:
        raise ValueError(f"folded_taps folds an upsample: {feat_hw} -> {size_hw} shrinks an axis")
    x, y = coords[..., 0], coords[..., 1]
    finite = torch.isfinite(x) & torch.isfinite(y)
    far = torch.full((), -10.0, dtype=torch.float32, device=coords.device)  # every hat 0
    bx, wx = _folded_axis(torch.where(finite, x.float(), far), Wf, W)
    by, wy = _folded_axis(torch.where(finite, y.float(), far), Hf, H)
    k = torch.arange(FOLD_AXIS_TAPS, device=coords.device)
    rows = (by[..., None] + k).clamp(max=Hf - 1)  # past the edge only where the weight is 0
    cols = (bx[..., None] + k).clamp(max=Wf - 1)
    idx = rows[..., :, None] * Wf + cols[..., None, :]
    wts = wy[..., :, None] * wx[..., None, :]
    lead = coords.shape[:-1]
    return idx.reshape(*lead, -1).to(torch.int32), wts.reshape(*lead, -1)

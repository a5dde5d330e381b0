"""BEV grid construction and meters <-> cells conversion.

BEV cell (iy, ix) has its centre at
``x = x_min + (ix + 0.5) * res_x``, ``y = y_min + (iy + 0.5) * res_y``.
A feature-space sample coordinate is the image pixel coordinate scaled
by ``feat / image`` size, so bilinear sampling at it with zeros padding
equals ``grid_sample(align_corners=False)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .homography import compute_homography, project_points

Bounds = Tuple[float, float, float, float]  # (x_min, x_max, y_min, y_max)


def ground_grid(
    bev_h: int, bev_w: int, bounds: Bounds, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """Homogeneous world coordinates of BEV cell centres: [H, W, 3] f32."""
    x_min, x_max, y_min, y_max = bounds
    res_x = (x_max - x_min) / bev_w
    res_y = (y_max - y_min) / bev_h
    xs = torch.linspace(x_min + 0.5 * res_x, x_max - 0.5 * res_x, bev_w, device=device)
    ys = torch.linspace(y_min + 0.5 * res_y, y_max - 0.5 * res_y, bev_h, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)


def meters_to_bev_indices(
    xy: torch.Tensor, bounds: Bounds, bev_size: Tuple[int, int]
) -> torch.Tensor:
    """World meters (..., 2) -> fractional (ix, iy) cell indices, clamped."""
    x_min, x_max, y_min, y_max = bounds
    H, W = bev_size
    res_x = (x_max - x_min) / float(W)
    res_y = (y_max - y_min) / float(H)
    ix = torch.clamp((xy[..., 0] - x_min) / res_x, 0.0, W - 1)
    iy = torch.clamp((xy[..., 1] - y_min) / res_y, 0.0, H - 1)
    return torch.stack([ix, iy], dim=-1)


def bev_indices_to_meters(
    idx: torch.Tensor, bounds: Bounds, bev_size: Tuple[int, int]
) -> torch.Tensor:
    """(ix, iy) cell indices (..., 2) -> world meters at cell centres."""
    x_min, x_max, y_min, y_max = bounds
    H, W = bev_size
    res_x = (x_max - x_min) / float(W)
    res_y = (y_max - y_min) / float(H)
    x = x_min + (idx[..., 0] + 0.5) * res_x
    y = y_min + (idx[..., 1] + 0.5) * res_y
    return torch.stack([x, y], dim=-1)


def bev_sample_coords(
    K: torch.Tensor,
    Rt: torch.Tensor,
    img_size: Tuple[int, int],
    feat_size: Tuple[int, int],
    grid: torch.Tensor,
) -> torch.Tensor:
    """Feature-space sample coordinates (..., Hb, Wb, 2) of every BEV
    cell: :func:`bev_sample_coords_with_depth` without the depth."""
    return bev_sample_coords_with_depth(K, Rt, img_size, feat_size, grid)[0]


def bev_sample_coords_with_depth(
    K: torch.Tensor,
    Rt: torch.Tensor,
    img_size: Tuple[int, int],
    feat_size: Tuple[int, int],
    grid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feature-space sample coordinates of every BEV cell, and depth sign.

    K: (..., 3, 3); Rt: (..., 4, 4); grid [Hb, Wb, 3] from :func:`ground_grid`.
    Returns ((..., Hb, Wb, 2) (x_feat, y_feat), (..., Hb, Wb) homogeneous
    w; w > 0 means the ground point is in front of the camera).
    Out-of-image samples are not masked: the sampler's zeros padding does.
    """
    H_img, W_img = img_size
    Hf, Wf = feat_size
    Hb, Wb = grid.shape[0], grid.shape[1]
    H_w2i = compute_homography(K, Rt)
    uv, w = project_points(H_w2i, grid.reshape(-1, 3))
    # filled on the device: a tensor built from a list, or an element set
    # from a Python number, would copy from the host
    scale = torch.stack([torch.full((), r, dtype=uv.dtype, device=uv.device)
                         for r in (Wf / float(W_img), Hf / float(H_img))])
    lead = H_w2i.shape[:-2]
    return (uv * scale).reshape(lead + (Hb, Wb, 2)), w.reshape(lead + (Hb, Wb))

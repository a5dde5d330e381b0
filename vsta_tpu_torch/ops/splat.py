"""CenterNet training targets, vectorised over padded object slots.

The twin of ``vsta_tpu/ops/splat.py``: the 3-case CenterNet radius,
sigma = (2r + 1) / 6, Gaussians truncated to the Chebyshev-radius box and
composited by elementwise max, so every centre is exactly 1.0 (the focal
loss tests ``gt == 1``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Bounds = Tuple[float, float, float, float]


def gaussian_radius(
    width_cells: torch.Tensor,
    height_cells: torch.Tensor,
    min_overlap: float = 0.7,
    min_radius: int = 2,
) -> torch.Tensor:
    """CenterNet Gaussian radius in cells, int32 (floored)."""
    w = torch.clamp(width_cells, min=1.0)
    h = torch.clamp(height_cells, min=1.0)

    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 * b1 - 4.0 * c1, min=0.0))) / 2.0

    a2 = 4.0
    b2 = 2.0 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - 4.0 * a2 * c2, min=0.0))) / (2.0 * a2)

    if min_overlap == 0:
        r3 = torch.full_like(w, float("inf"))
    else:
        a3 = 4.0 * min_overlap
        b3 = -2.0 * min_overlap * (h + w)
        c3 = (min_overlap - 1.0) * w * h
        r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4.0 * a3 * c3, min=0.0))) / (2.0 * a3)

    radius = torch.minimum(torch.minimum(r1, r2), r3)
    return torch.floor(torch.clamp(radius, min=float(min_radius))).to(torch.int32)


def draw_gaussians(
    centers_xy: torch.Tensor, radii: torch.Tensor, valid: torch.Tensor, bev_hw: Tuple[int, int]
) -> torch.Tensor:
    """Max-composite truncated Gaussians: centers_xy [..., N, 2] int cells
    (gx, gy), radii [..., N] int, valid [..., N] bool -> [..., H, W] f32."""
    H, W = bev_hw
    dev = centers_xy.device
    if centers_xy.shape[-2] == 0:
        return torch.zeros(centers_xy.shape[:-2] + (H, W), device=dev)
    xs = torch.arange(W, device=dev, dtype=torch.int32)[None, :]
    ys = torch.arange(H, device=dev, dtype=torch.int32)[:, None]
    gx = centers_xy[..., 0, None, None]
    gy = centers_xy[..., 1, None, None]
    r = radii[..., None, None]
    dx = xs - gx
    dy = ys - gy
    sigma = (2.0 * r.to(torch.float32) + 1.0) / 6.0
    g = torch.exp(-(dx.to(torch.float32) ** 2 + dy.to(torch.float32) ** 2) / (2.0 * sigma * sigma))
    ok = valid[..., None, None] & (dx.abs() <= r) & (dy.abs() <= r) & (r > 0)
    return torch.where(ok, g, torch.zeros((), device=dev)).amax(dim=-3)


def build_targets(
    boxes_world: torch.Tensor,
    num_boxes: torch.Tensor,
    *,
    bounds: Bounds,
    bev_hw: Tuple[int, int],
    min_overlap: float = 0.7,
    min_radius: int = 2,
) -> Dict[str, torch.Tensor]:
    """Heatmap/offset/size/index targets from padded world boxes.

    boxes_world [B, N, 4] (cx, cy, w, h) metres; num_boxes [B]. Returns
    'heatmap' [B, H, W, 1], 'indices' [B, N] int32 (flat gy * W + gx),
    'mask' [B, N], 'offset' [B, N, 2], 'size_log' [B, N, 2]. Objects
    outside the BEV bounds and slots past ``num_boxes`` are masked out.
    """
    B, N, _ = boxes_world.shape
    H, W = bev_hw
    x_min, x_max, y_min, y_max = bounds
    res_x = (x_max - x_min) / float(W)
    res_y = (y_max - y_min) / float(H)
    dev = boxes_world.device
    boxes_world = boxes_world.to(torch.float32)

    slot = torch.arange(N, device=dev)[None, :]
    in_count = slot < num_boxes.to(dev)[:, None]
    cx, cy, bw, bh = boxes_world.unbind(-1)

    # normalise, then scale: on-boundary points like (0, 0) land on exact
    # integer cells in float32 for symmetric bounds
    rel_x = (cx - x_min) / (x_max - x_min) * float(W)
    rel_y = (cy - y_min) / (y_max - y_min) * float(H)
    in_bev = (rel_x >= 0) & (rel_x < W) & (rel_y >= 0) & (rel_y < H)
    valid = in_count & in_bev

    gx = torch.floor(rel_x)
    gy = torch.floor(rel_y)
    offset = torch.stack([rel_x - gx, rel_y - gy], dim=-1)

    size_w = torch.clamp(bw / res_x, min=1e-3)
    size_h = torch.clamp(bh / res_y, min=1e-3)
    size_log = torch.stack([torch.log(size_w), torch.log(size_h)], dim=-1)
    radii = gaussian_radius(size_w, size_h, min_overlap, min_radius)

    # float -> int32 of a far-away point is undefined: clamp first (the
    # index of an invalid slot is zeroed below)
    gxi = gx.clamp(-1, W).to(torch.int32).clamp(0, W - 1)
    gyi = gy.clamp(-1, H).to(torch.int32).clamp(0, H - 1)
    indices = gyi * W + gxi
    hm = draw_gaussians(torch.stack([gxi, gyi], dim=-1), radii, valid, (H, W))

    maskf = valid.to(torch.float32)
    return {
        "heatmap": hm[..., None],
        "indices": torch.where(valid, indices, torch.zeros_like(indices)),
        "mask": maskf,
        "offset": offset * maskf[..., None],
        "size_log": size_log * maskf[..., None],
    }

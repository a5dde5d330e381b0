"""Static-shape detection decoding on the device.

3x3 max-pool peak suppression (plateau-keeping), a fixed-K top-k, and a
greedy centre-distance NMS over the score-sorted candidates. Returns
padded tensors with validity masks; nothing copies to the host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Bounds = Tuple[float, float, float, float]


def nms2d(heatmap: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep the local maxima of a [B, H, W] heatmap, plateaus included
    (``x * (x == maxpool(x))``; the pool pads with -inf)."""
    pooled = F.max_pool2d(heatmap[:, None], kernel, 1, kernel // 2)[:, 0]
    return heatmap * (heatmap == pooled).to(heatmap.dtype)


def greedy_distance_nms(
    centers: torch.Tensor, valid: torch.Tensor, dist_thresh: float
) -> torch.Tensor:
    """Keep mask [B, K] of a greedy suppression in score order.

    centers [B, K, 2] score-descending; valid [B, K] bool. A candidate is
    kept iff it is valid and no kept earlier one lies strictly closer than
    ``dist_thresh``. A loop over K on the device (K small kernels).
    """
    d2 = ((centers[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
    close = d2 < dist_thresh * dist_thresh
    keep = torch.zeros_like(valid)
    for i in range(centers.shape[1]):
        sup = (keep & close[:, i]).any(dim=-1)
        keep[:, i] = valid[:, i] & ~sup
    return keep


def decode_detections(
    heatmap: torch.Tensor,
    offset: torch.Tensor,
    size_cells: torch.Tensor,
    *,
    bounds: Bounds,
    conf_thresh: float = 0.4,
    nms_dist_m: float = 0.5,
    max_dets: int = 128,
) -> Dict[str, torch.Tensor]:
    """CenterNet outputs -> world-coordinate boxes (padded, masked).

    heatmap [B, H, W, 1] sigmoid scores; offset [B, H, W, 2] sub-cell
    offsets; size_cells [B, H, W, 2]. Returns 'boxes' [B, K, 4]
    (cx, cy, w, h meters), 'scores' [B, K], 'valid' [B, K] bool,
    score-descending with NMS applied and suppressed entries zeroed.
    Equal scores keep the lower flat index first, as ``jax.lax.top_k``.
    """
    B, H, W, _ = heatmap.shape
    x_min, x_max, y_min, y_max = bounds
    res_x = (x_max - x_min) / float(W)
    res_y = (y_max - y_min) / float(H)

    flat = nms2d(heatmap[..., 0]).reshape(B, H * W)
    k = min(max_dets, H * W)
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    if k < max_dets:
        scores = F.pad(scores, (0, max_dets - k))
        idx = F.pad(idx, (0, max_dets - k))
    above = scores > conf_thresh

    xs = (idx % W).float()
    ys = (idx // W).float()
    gather = idx[..., None].expand(B, max_dets, 2)
    off_k = torch.gather(offset.reshape(B, H * W, 2), 1, gather)
    sz_k = torch.gather(size_cells.reshape(B, H * W, 2), 1, gather)
    cx = x_min + (xs + off_k[..., 0]) * res_x
    cy = y_min + (ys + off_k[..., 1]) * res_y
    boxes = torch.stack([cx, cy, sz_k[..., 0] * res_x, sz_k[..., 1] * res_y], dim=-1)

    keep = greedy_distance_nms(boxes[..., :2], above, nms_dist_m)
    keepf = keep.to(boxes.dtype)
    return {"boxes": boxes * keepf[..., None], "scores": scores * keepf, "valid": keep}

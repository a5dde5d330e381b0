"""Plain decode of the head's maps into detections: 3x3 peak suppression
(plateaus kept), the highest ``max_dets`` scores in order (ties to the
lower cell), the confidence threshold, then greedy suppression of any
centre closer than ``nms_dist_m`` to a kept one of higher score."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def decode(heat: torch.Tensor, offset: torch.Tensor, size: torch.Tensor, *, bounds, conf: float,
           nms_dist_m: float, max_dets: int) -> Dict[str, torch.Tensor]:
    """heat [B, H, W], offset and size [B, H, W, 2] -> 'boxes' [B, D, 4]
    (cx, cy, w, h metres), 'scores' [B, D], 'valid' [B, D] bool and
    'cells' [B, D] (flat index of each candidate), on the CPU."""
    heat, offset, size = heat.float().cpu(), offset.float().cpu(), size.float().cpu()
    B, H, W = heat.shape
    x_min, x_max, y_min, y_max = bounds
    rx, ry = (x_max - x_min) / W, (y_max - y_min) / H
    pooled = F.max_pool2d(heat[:, None], 3, 1, 1)[:, 0]
    peaks = torch.where(heat == pooled, heat, torch.zeros_like(heat)).reshape(B, H * W)
    scores, cells = torch.sort(peaks, dim=1, descending=True, stable=True)
    scores, cells = scores[:, :max_dets], cells[:, :max_dets]
    ix, iy = (cells % W).float(), (cells // W).float()
    off = torch.gather(offset.reshape(B, H * W, 2), 1, cells[..., None].expand(-1, -1, 2))
    sz = torch.gather(size.reshape(B, H * W, 2), 1, cells[..., None].expand(-1, -1, 2))
    boxes = torch.stack([x_min + (ix + off[..., 0]) * rx, y_min + (iy + off[..., 1]) * ry,
                         sz[..., 0] * rx, sz[..., 1] * ry], dim=-1)
    valid = np.zeros(scores.shape, dtype=bool)
    centres, above = boxes[..., :2].numpy(), (scores > conf).numpy()
    for b in range(B):
        close = ((centres[b, :, None] - centres[b, None]) ** 2).sum(-1) < nms_dist_m ** 2
        for i in range(scores.shape[1]):
            valid[b, i] = above[b, i] and not (valid[b, :i] & close[i, :i]).any()
    valid = torch.from_numpy(valid)
    keep = valid.float()
    return {"boxes": boxes * keep[..., None], "scores": scores * keep, "valid": valid, "cells": cells}

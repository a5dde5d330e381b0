"""CenterNet detection losses over channels-last maps: the twin of
``vsta_tpu/ops/losses.py``."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def heatmap_focal_loss(
    pred_logits: torch.Tensor, gt: torch.Tensor, alpha: float = 2.0, beta: float = 4.0, reduce: Reduce = None
) -> torch.Tensor:
    """Penalty-reduced pixelwise focal loss over [B, H, W, 1] maps,
    normalised by the number of positives (cells where gt == 1 exactly);
    predictions clamped to [1e-4, 1 - 1e-4]. ``reduce``: sums a count over
    the batch's shards, so that a shard's loss is its part of the global
    batch's (None: the batch is whole)."""
    pred = torch.clamp(torch.sigmoid(pred_logits.to(torch.float32)), 1e-4, 1.0 - 1e-4)
    gt = gt.to(torch.float32)
    pos_mask = (gt == 1.0).to(torch.float32)
    neg_mask = (gt < 1.0).to(torch.float32)
    neg_weights = torch.pow(1.0 - gt, beta)
    pos_loss = torch.log(pred) * torch.pow(1.0 - pred, alpha) * pos_mask
    neg_loss = torch.log(1.0 - pred) * torch.pow(pred, alpha) * neg_weights * neg_mask
    num_pos = pos_mask.sum() if reduce is None else reduce(pos_mask.sum())
    num_pos = torch.clamp(num_pos, min=1.0)
    return -(pos_loss.sum() + neg_loss.sum()) / num_pos


def gather_bev(feat: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """feat [B, H, W, C] at flat cell indices [B, K] -> [B, K, C]."""
    B, H, W, C = feat.shape
    flat = feat.reshape(B, H * W, C)
    return torch.gather(flat, 1, indices.long()[..., None].expand(-1, -1, C))


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, reduce: Reduce = None) -> torch.Tensor:
    """sum(|pred - target| * mask) / (sum(mask) + 1e-4); the denominator
    counts slots, not slot-channels (summed by ``reduce`` as above)."""
    m = mask[..., None].to(torch.float32)
    num = (torch.abs(pred.to(torch.float32) - target.to(torch.float32)) * m).sum()
    den = mask.to(torch.float32).sum()
    return num / ((den if reduce is None else reduce(den)) + 1e-4)


def detection_loss(
    preds: Dict[str, torch.Tensor],
    targets: Dict[str, torch.Tensor],
    *,
    hm_alpha: float = 2.0,
    hm_beta: float = 4.0,
    hm_weight: float = 1.0,
    offset_weight: float = 1.0,
    size_weight: float = 0.1,
    reduce: Reduce = None,
) -> Dict[str, torch.Tensor]:
    """The weighted CenterNet loss. preds: 'heatmap_logits' [B,H,W,1],
    'offset' [B,H,W,2] (after the sigmoid), 'size_raw' [B,H,W,2];
    targets from :func:`vsta_tpu_torch.ops.splat.build_targets`.
    ``reduce``: the sum of a count over the batch's shards (the
    positives, the mask), None for a whole batch; each loss is then this
    shard's part, and the shards' losses add up to the global batch's."""
    hm_loss = heatmap_focal_loss(preds["heatmap_logits"], targets["heatmap"], hm_alpha, hm_beta, reduce)
    mask = targets["mask"]
    offset_loss = masked_l1_loss(gather_bev(preds["offset"], targets["indices"]), targets["offset"], mask, reduce)
    size_loss = masked_l1_loss(gather_bev(preds["size_raw"], targets["indices"]), targets["size_log"], mask, reduce)
    total = hm_weight * hm_loss + offset_weight * offset_loss + size_weight * size_loss
    return {
        "heatmap_loss": hm_loss,
        "offset_loss": offset_loss,
        "size_loss": size_loss,
        "total_loss": total,
    }

"""Plain PyTorch reference of the training step: CenterNet targets from
world boxes, the focal and L1 losses, the gradient, the running mean of
``ACCUM_STEPS`` calls' gradients and Adam with its L2 term, at the
schedule's learning rate. A frozen copy of the configurations' semantics,
in float32 with TF32 off; it imports nothing of the program."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .precision import exact

BUFFER_KINDS = ("bn_mean", "bn_var", "count")


def gaussian_radius(w: torch.Tensor, h: torch.Tensor, overlap: float, min_radius: int) -> torch.Tensor:
    """CenterNet's radius in cells (the least of its three cases), floored."""
    w, h = w.clamp(min=1.0), h.clamp(min=1.0)
    b1, c1 = h + w, w * h * (1 - overlap) / (1 + overlap)
    r1 = (b1 + torch.sqrt((b1 * b1 - 4 * c1).clamp(min=0))) / 2
    b2, c2 = 2 * (h + w), (1 - overlap) * w * h
    r2 = (b2 + torch.sqrt((b2 * b2 - 16 * c2).clamp(min=0))) / 8
    a3, b3, c3 = 4 * overlap, -2 * overlap * (h + w), (overlap - 1) * w * h
    r3 = (b3 + torch.sqrt((b3 * b3 - 4 * a3 * c3).clamp(min=0))) / (2 * a3)
    return torch.floor(torch.minimum(torch.minimum(r1, r2), r3).clamp(min=float(min_radius)))


def targets(boxes: torch.Tensor, num: torch.Tensor, cfg: Dict) -> Dict[str, torch.Tensor]:
    """Heatmap [B, H, W] of truncated Gaussians (each centre exactly 1),
    and per slot the cell, mask, sub-cell offset and log size in cells."""
    m, l = cfg["MODEL"], cfg["LOSS"]
    H, W = m["BEV_SIZE"][-2:]
    x_min, x_max, y_min, y_max = m["BEV_BOUNDS"]
    rx, ry = (x_max - x_min) / W, (y_max - y_min) / H
    B, N, _ = boxes.shape
    cx, cy, bw, bh = boxes.float().unbind(-1)
    gx_f = (cx - x_min) / (x_max - x_min) * W
    gy_f = (cy - y_min) / (y_max - y_min) * H
    valid = (torch.arange(N, device=boxes.device)[None] < num[:, None]) & (gx_f >= 0) & (gx_f < W) & (gy_f >= 0) & (gy_f < H)
    gx, gy = torch.floor(gx_f), torch.floor(gy_f)
    sw, sh = (bw / rx).clamp(min=1e-3), (bh / ry).clamp(min=1e-3)
    r = gaussian_radius(sw, sh, l.get("GAUSSIAN_IOU", 0.7), l.get("GAUSSIAN_MIN_RADIUS", 2))
    xs = torch.arange(W, device=boxes.device, dtype=torch.float32)
    ys = torch.arange(H, device=boxes.device, dtype=torch.float32)
    dx = xs[None, None, None, :] - gx.clamp(0, W - 1)[..., None, None]
    dy = ys[None, None, :, None] - gy.clamp(0, H - 1)[..., None, None]
    sigma = (2 * r + 1) / 6
    g = torch.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma)[..., None, None])
    inside = valid[..., None, None] & (dx.abs() <= r[..., None, None]) & (dy.abs() <= r[..., None, None]) & (r[..., None, None] > 0)
    heat = torch.where(inside, g, torch.zeros_like(g)).amax(dim=1)
    mask = valid.float()
    cell = (gy.clamp(0, H - 1) * W + gx.clamp(0, W - 1)).long() * valid
    return {"heatmap": heat, "mask": mask, "cell": cell,
            "offset": torch.stack([gx_f - gx, gy_f - gy], -1) * mask[..., None],
            "size_log": torch.stack([torch.log(sw), torch.log(sh)], -1) * mask[..., None]}


def loss(out: Dict[str, torch.Tensor], t: Dict[str, torch.Tensor], cfg: Dict) -> torch.Tensor:
    """The weighted CenterNet loss: the penalty-reduced focal loss over the
    heatmap (over its positives), L1 on the offset and the log size at the
    objects' cells (over their number)."""
    l = cfg["LOSS"]
    a, b = l.get("HM_ALPHA", 2.0), l.get("HM_BETA", 4.0)
    pred = torch.sigmoid(out["heatmap_logits"][..., 0]).clamp(1e-4, 1 - 1e-4)
    gt = t["heatmap"]
    pos = (gt == 1).float()
    focal = (torch.log(pred) * (1 - pred) ** a * pos).sum() + (torch.log(1 - pred) * pred ** a * (1 - gt) ** b * (1 - pos)).sum()
    hm = -focal / pos.sum().clamp(min=1.0)
    B, H, W, _ = out["offset"].shape

    def at_cells(x):
        return torch.gather(x.reshape(B, H * W, 2), 1, t["cell"][..., None].expand(-1, -1, 2))

    den = t["mask"].sum() + 1e-4
    off = ((at_cells(out["offset"]) - t["offset"]).abs() * t["mask"][..., None]).sum() / den
    size = ((at_cells(out["size_logits"]) - t["size_log"]).abs() * t["mask"][..., None]).sum() / den
    return l.get("HM_WEIGHT", 1.0) * hm + l.get("OFFSET_WEIGHT", 1.0) * off + l.get("SIZE_WEIGHT", 0.1) * size


def learning_rate(cfg: Dict, updates: int, steps_per_epoch: int) -> float:
    """The schedule's rate at the optimizer's update count."""
    t = cfg["TRAIN"]
    base, epochs = float(t["LR"]), max(1, int(t["EPOCHS"]))
    epoch = updates // max(1, steps_per_epoch)
    if t.get("LR_SCHEDULER", "cosine_warm") != "cosine_warm":
        raise ValueError("the reference follows the cosine_warm schedule only")
    warm = max(1, int(t.get("WARMUP_EPOCHS", 3)))
    total = max(1, epochs - warm)
    return base * min((epoch + 1) / warm, 1.0) * 0.5 * (1 + math.cos(math.pi * min(epoch, total) / total))


def steps(reference, cfg: Dict, weights: Dict[str, torch.Tensor], kinds: Dict[str, str],
          batches: List[Dict[str, torch.Tensor]], steps_per_epoch: int, q=exact) -> Dict[str, object]:
    """The first ``len(batches)`` calls of the training step from
    ``weights``, on the forward of the configuration's ``reference`` module:
    each call's total loss, the first call's gradient as the optimizer holds
    it, and each parameter's change over the calls."""
    reference.tf32_off()
    t = cfg["TRAIN"]
    accum, wd = max(1, int(t.get("ACCUM_STEPS", 1))), float(t.get("WEIGHT_DECAY", 0.0))
    if str(t.get("OPT", "Adam")).lower() != "adam":
        raise ValueError("the reference follows Adam with an L2 term only")
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items() if kinds[k] not in BUFFER_KINDS}
    start = {k: v.detach().clone() for k, v in params.items()}
    w = dict(weights, **params)
    m1 = {k: torch.zeros_like(v) for k, v in params.items()}
    m2 = {k: torch.zeros_like(v) for k, v in params.items()}
    acc = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1, updates = [], None, 0
    for call, b in enumerate(batches):
        ref = reference.Reference(cfg, w, q)
        out = ref.forward(b["images"], b["K"], b["Rt"], train=True)
        total = loss(out, targets(b["boxes_world"], b["num_boxes"], cfg), cfg)
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
        losses.append(float(total.detach()))
        k_mini = call % accum
        with torch.no_grad():
            for k in params:
                acc[k] += (grads[k] - acc[k]) / (k_mini + 1)
            if grad1 is None:
                grad1 = {k: v.clone() for k, v in acc.items()}
            if k_mini == accum - 1:
                lr, updates = learning_rate(cfg, updates, steps_per_epoch), updates + 1
                for k, p in params.items():
                    g = acc[k] + wd * p
                    m1[k].mul_(0.9).add_(g, alpha=0.1)
                    m2[k].mul_(0.999).addcmul_(g, g, value=0.001)
                    mh, vh = m1[k] / (1 - 0.9 ** updates), m2[k] / (1 - 0.999 ** updates)
                    p.sub_(lr * mh / (torch.sqrt(vh) + 1e-8))
                    acc[k].zero_()
    update = {k: (p.detach() - start[k]) for k, p in params.items()}
    return {"losses": losses, "grad": grad1, "update": update}


def kinds_of(reference, cfg: Dict) -> Dict[str, str]:
    m = dict(cfg["MODEL"], VIEWS=cfg["DATA"]["VIEWS"])
    return {n: k for n, _, k in reference.param_specs(m)}


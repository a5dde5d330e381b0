"""Train state, train step and eval step: the twin of
``vsta_tpu/training/state.py``.

``state = create_state(cfg, steps_per_epoch=n)`` then
``metrics = train_step(state, batch)`` with ``train_step =
make_train_step(cfg)``. One call builds the targets, runs the forward in
training mode (bf16 under AMP, BatchNorm on batch statistics), the loss
and the backward, and hands the gradients to the optimizer, which updates
the parameters on every ``ACCUM_STEPS``-th call. BatchNorm statistics and
``state.step`` move on every call. The model, its parameters and
statistics are updated in place.

A batch is a dict of arrays or tensors: 'images' [B, V, H, W, 3] (uint8
or float), 'K' [B, V, 3, 3], 'Rt' [B, V, 4, 4], 'boxes_world' [B, N, 4]
(cx, cy, w, h metres, padded) and 'num_boxes' [B].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import torch

from ..config import Config
from ..convert import init_state_dict
from ..models.bevnet import BEVNet
from ..models.encoders.pretrained import load_pretrained_backbone
from ..ops.decode import decode_detections
from ..ops.losses import detection_loss
from ..ops.splat import build_targets
from ..serving import resolve_device
from .optim import OptState, Optimizer, build_optimizer

Batch = Mapping[str, object]
Metrics = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    model: BEVNet
    tx: Optimizer
    opt_state: OptState
    step: int = 0  # train-step calls so far

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_state(
    cfg: Config,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    *,
    seed: int = 0,
    device: str | torch.device = "cuda",
    steps_per_epoch: int,
) -> TrainState:
    """The model of ``cfg`` on ``device`` with ``state_dict``'s weights
    (random ones from ``seed`` when None) and a fresh optimizer. Runs on
    the CUDA device unless the caller asks for ``device="cpu"``; without a
    CUDA device it raises.

    With random weights, ``MODEL.PRETRAINED`` and ``PRETRAINED_PATH``
    load a torch ResNet ``.pth`` into the backbone. That load is tolerant,
    as the JAX package's: on any failure it prints ``[pretrained] load
    failed (...); training from scratch`` and goes on."""
    dev = resolve_device(device)
    model = BEVNet.from_config(cfg)
    model.load_state_dict(init_state_dict(cfg, seed) if state_dict is None else state_dict)
    m = cfg.model
    if state_dict is None and m.pretrained and m.pretrained_path:
        try:
            load_pretrained_backbone(model.encoder.backbone, m.pretrained_path, m.backbone)
        except Exception as e:  # tolerant, like the reference
            print(f"[pretrained] load failed ({e}); training from scratch")
    model.to(dev)
    tx = build_optimizer(cfg, steps_per_epoch)
    return TrainState(model=model, tx=tx, opt_state=tx.init(model))


def batch_to_device(batch: Batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=dev)
        out[k] = t if t.dtype in (torch.uint8, torch.int32, torch.int64, torch.bool) else t.float()
    return out


def loss_fn(cfg: Config, model: BEVNet, batch: Mapping[str, torch.Tensor]) -> Metrics:
    """Targets, the forward in training mode and the four losses."""
    l, m = cfg.loss, cfg.model
    with torch.no_grad():
        targets = build_targets(
            batch["boxes_world"], batch["num_boxes"], bounds=m.bev_bounds, bev_hw=m.bev_size,
            min_overlap=l.gaussian_iou, min_radius=l.gaussian_min_radius,
        )
    model.train()
    out = model(batch["images"], batch["K"], batch["Rt"])
    return detection_loss(
        out, targets, hm_alpha=l.hm_alpha, hm_beta=l.hm_beta, hm_weight=l.hm_weight,
        offset_weight=l.offset_weight, size_weight=l.size_weight,
    )


def gradients(model: BEVNet, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    """d loss / d parameter for every parameter, zero where the loss does
    not reach it (a frozen backbone, the stages past OUT_INDEX), as JAX's
    gradient tree has them. cuDNN is held to deterministic algorithms for
    the backward, then set back: for float32 convolutions its heuristics
    pick backward algorithms that add with atomics, and two runs of one
    step would differ in the last bits."""
    names, params = zip(*model.named_parameters())
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        torch.backends.cudnn.deterministic = before
    return {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, params, grads)}


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(g.float().pow(2).sum() for g in grads.values()))


def apply_gradients(state: TrainState, grads: Mapping[str, torch.Tensor]) -> bool:
    """Hand one call's gradients to the optimizer; True when it updated."""
    moved = state.tx.update(state.opt_state, state.model, grads)
    state.step += 1
    return moved


def make_train_step(cfg: Config) -> Callable[[TrainState, Batch], Metrics]:
    """Returns ``train_step(state, batch) -> metrics``: the four losses and
    ``grad_norm`` (the global L2 norm of this call's gradients), as 0-dim
    device tensors."""

    def train_step(state: TrainState, batch: Batch) -> Metrics:
        b = batch_to_device(batch, state.device)
        losses = loss_fn(cfg, state.model, b)
        grads = gradients(state.model, losses["total_loss"])
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = global_norm(grads)
        apply_gradients(state, grads)
        return metrics

    return train_step


def make_eval_step(cfg: Config) -> Callable[[TrainState, Batch], Metrics]:
    """Returns ``eval_step(state, batch)``: the forward in eval mode and the
    decode, {'boxes', 'scores', 'valid', 'heatmap'} on the device."""
    e, m = cfg.eval, cfg.model

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch) -> Metrics:
        b = batch_to_device(batch, state.device)
        state.model.eval()
        out = state.model(b["images"], b["K"], b["Rt"])
        det = decode_detections(
            out["heatmap"], out["offset"], out["size"], bounds=m.bev_bounds,
            conf_thresh=e.conf_thresh, nms_dist_m=e.nms_dist_m, max_dets=e.max_dets,
        )
        return {"boxes": det["boxes"], "scores": det["scores"], "valid": det["valid"], "heatmap": out["heatmap"]}

    return eval_step

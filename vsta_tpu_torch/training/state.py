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

On a sharded mesh (``create_state(..., mesh=)``) the batch is this rank's
part (``parallel.shard_batch``). The loss's normalisers are summed over
'data', so a data shard's loss is its part of the global batch's. Every
view rank of a data group computes the same encoder, head and loss, and
backpropagates that loss as it is: the warp's view sum passes the
cotangent through, and the slices of the views it warped gather their
cotangents back over 'view' (``parallel.warp_shard``), so each view rank
holds the whole gradients of its frames, the same on every view rank.
One all-reduce over the mesh, in which only the first view rank of each
data group adds its gradients (the others add zeros), then sums them
over 'data': each rank holds the single-device gradients of the global
batch, with no gradient counted ``n_view`` times and no division by
``n_view`` (exact for any ``n_view``, 3 included), and the parameters
and Adam's state stay equal across ranks. The metrics are the global
batch's.
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
from ..parallel.collectives import gather, sum_no_grad
from ..serving import resolve_device
from ..utils import tracing
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
    mesh=None,
) -> TrainState:
    """The model of ``cfg`` on ``device`` with ``state_dict``'s weights
    (random ones from ``seed`` when None) and a fresh optimizer. Runs on
    the CUDA device unless the caller asks for ``device="cpu"``; without a
    CUDA device it raises.

    With random weights, ``MODEL.PRETRAINED`` and ``PRETRAINED_PATH``
    load a torch ResNet ``.pth`` into the backbone. That load is tolerant,
    as the JAX package's: on any failure it prints ``[pretrained] load
    failed (...); training from scratch`` and goes on. ``mesh``: the mesh
    the model runs under (``BEVNet.from_config``)."""
    dev = resolve_device(device)
    model = BEVNet.from_config(cfg, mesh=mesh)
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


def check_trainable(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for a model the port serves but does
    not train: MVDet's detector (``HEAD: mvdet``), whose loss (a
    Gaussian-smoothed MSE on the map, plus per-view foot and head maps from
    an image classifier the port does not build) is not ported."""
    if cfg.model.head == "mvdet":
        raise NotImplementedError(
            "MODEL.HEAD mvdet serves only: MVDet's loss (the smoothed-MSE occupancy map and the per-view "
            "image classifier's maps) is not ported, so it cannot train"
        )


def loss_fn(cfg: Config, model: BEVNet, batch: Mapping[str, torch.Tensor]) -> Metrics:
    """Targets, the forward in training mode and the four losses."""
    check_trainable(cfg)
    l, m = cfg.loss, cfg.model
    with torch.no_grad():
        targets = build_targets(
            batch["boxes_world"], batch["num_boxes"], bounds=m.bev_bounds, bev_hw=m.bev_size,
            min_overlap=l.gaussian_iou, min_radius=l.gaussian_min_radius,
        )
    model.train()
    out = model(batch["images"], batch["K"], batch["Rt"])
    reduce = (lambda t: sum_no_grad(t, model.mesh, "data")) if model.sharded else None
    return detection_loss(
        out, targets, hm_alpha=l.hm_alpha, hm_beta=l.hm_beta, hm_weight=l.hm_weight,
        offset_weight=l.offset_weight, size_weight=l.size_weight, reduce=reduce,
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


def all_reduce_gradients(grads: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The data shards' gradients summed over 'data', as one flat f32
    buffer in a fixed order, all-reduced over the mesh with the view
    ranks past the first adding zeros (they hold the same gradients):
    each rank gets the same bits."""
    names = list(grads)
    flat = torch.cat([grads[n].float().reshape(-1) for n in names])
    if mesh.view_index != 0:
        flat = torch.zeros_like(flat)
    flat = sum_no_grad(flat, mesh, "mesh")
    out, at = {}, 0
    for n in names:
        g = grads[n]
        out[n] = flat[at : at + g.numel()].view(g.shape).to(g.dtype)
        at += g.numel()
    return out


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
    device tensors. The forward marks its stages on the device and the
    step marks ``end`` after the loss, so the backward lies outside them;
    a call is the host spans ``train.loss`` (targets, forward, loss),
    ``train.backward`` and ``train.optimizer``, each tagged with
    ``state.step`` (:mod:`~vsta_tpu_torch.utils.tracing`). A model the
    port does not train raises ``NotImplementedError`` here (:func:`check_trainable`)."""
    check_trainable(cfg)

    def train_step(state: TrainState, batch: Batch) -> Metrics:
        b = batch_to_device(batch, state.device)
        model = state.model
        with tracing.span("train.loss", state.step):
            losses = loss_fn(cfg, model, b)
            tracing.mark("end", losses["total_loss"])
        metrics = {k: v.detach() for k, v in losses.items()}
        with tracing.span("train.backward", state.step):
            if not model.sharded:
                grads = gradients(model, losses["total_loss"])
            else:
                mesh = model.mesh
                grads = all_reduce_gradients(gradients(model, losses["total_loss"]), mesh)
                metrics = {k: sum_no_grad(v, mesh, "data") for k, v in metrics.items()}
        with tracing.span("train.optimizer", state.step):
            metrics["grad_norm"] = global_norm(grads)
            apply_gradients(state, grads)
        return metrics

    return train_step


def make_eval_step(
    cfg: Config, quant_head: Optional[Dict] = None, quant_encoder: Optional[Dict] = None
) -> Callable[[TrainState, Batch], Metrics]:
    """Returns ``eval_step(state, batch)``: the forward in eval mode and the
    decode, {'boxes', 'scores', 'valid', 'heatmap'} on the device.
    ``quant_head`` / ``quant_encoder``: int8 trees (``export.calibrate_*``)
    on the state's device; the eval then scores the int8 serving path.
    On a sharded mesh the outputs are gathered over 'data': every rank
    gets the global batch's."""
    e, m = cfg.eval, cfg.model

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch) -> Metrics:
        b = batch_to_device(batch, state.device)
        state.model.eval()
        out = state.model(b["images"], b["K"], b["Rt"], quant_head=quant_head, quant_encoder=quant_encoder)
        det = decode_detections(
            out["heatmap"], out["offset"], out["size"], bounds=m.bev_bounds,
            conf_thresh=e.conf_thresh, nms_dist_m=e.nms_dist_m, max_dets=e.max_dets,
        )
        res = {"boxes": det["boxes"], "scores": det["scores"], "valid": det["valid"], "heatmap": out["heatmap"]}
        if state.model.sharded:
            res = {k: gather(v, state.model.mesh, "data", 0) for k, v in res.items()}
        return res

    return eval_step

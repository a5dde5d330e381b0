"""The training loop: the twin of ``vsta_tpu/training/loop.py``.

Dataset and 400/100 (or 80/20) split -> two :class:`Prefetcher` (threaded
decode, pinned non_blocking copies to the card) -> model and optimizer
(``create_state``) -> epochs of ``make_train_step`` calls, the losses kept
on the device and fetched every 10 steps -> eval every ``EVAL.INTERVAL``
(``make_eval_step`` + :class:`DetectionMetrics`) -> ``last`` / ``best``
checkpoints, the memory-triggered one, patience -> learning curves.

It runs on ``device`` when given, else on ``RUNTIME.DEVICE`` (``cpu``,
or the CUDA device for any other value), over the ('data', 'view') mesh
of ``RUNTIME.MESH_DATA`` x ``MESH_VIEW`` (``parallel.make_mesh``, clamped
to the batch and the views; one process is the 1x1 mesh). Under torchrun
(``torchrun --nproc_per_node N -m vsta_tpu_torch.train ...``) each rank
reads the same batches, keeps its slice and runs the sharded step; the
eval's detections and ground truth are gathered over 'data', so every
rank scores the same frames and takes the same decisions; rank 0 alone
writes the checkpoints, ``scalars.jsonl``, ``metrics.jsonl``, the
figures and the trace. A rank the mesh leaves out returns at once. On
``resume`` the Prefetchers are new, so
the resumed epoch shuffles and jitters as epoch 0 did: the reference's
behaviour, kept.

Per epoch, ``scalars.jsonl`` gets ``time/epoch_s`` (train and eval),
``time/train_s`` (the train steps, losses fetched), ``time/steps`` and
``time/input_wait_s`` (the loop's wait on the train Prefetcher's queue).
"""

from __future__ import annotations

import time
from datetime import datetime
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import Prefetcher, split_train_val
from ..data.wildtrack import WildtrackDataset
from ..parallel.collectives import gather
from ..parallel.mesh import init_distributed, make_mesh
from ..utils.logging import MetricWriter, ScalarLogger
from ..utils.platform import runtime_device
from ..utils.telemetry import host_stats, max_device_memory_percent
from ..utils.visualization import save_bev_heatmap, save_learning_curves
from .checkpoint import CheckpointManager
from .metrics import DetectionMetrics
from .state import create_state, make_eval_step, make_train_step


def config_mesh(cfg: Config, batch_size: Optional[int] = None):
    """The mesh ``RUNTIME.MESH_DATA`` x ``MESH_VIEW`` asks for, clamped to
    the batch and the views, as the JAX entry points build it."""
    return make_mesh(
        cfg.runtime.mesh_data, cfg.runtime.mesh_view,
        batch_size=cfg.data.batch_size if batch_size is None else batch_size, views=cfg.data.views,
    )


def global_batch(mesh, batch: Mapping[str, torch.Tensor], keys) -> Dict[str, np.ndarray]:
    """``keys`` of this rank's batch gathered over 'data', as numpy: the
    global batch's, on every rank."""
    return {k: gather(batch[k], mesh, "data", 0).cpu().numpy() for k in keys}


class _Quiet:
    """Stands for the writers on a rank other than 0: every call does nothing."""

    def __getattr__(self, name):
        return lambda *a, **k: None


def _first_batch(cfg: Config, batch: Mapping[str, torch.Tensor]) -> None:
    """GT counts and camera heights before burning compute; warn where
    static cameras meet calibrations that vary across the batch."""
    nb = batch["num_boxes"].cpu().numpy()
    Rt0 = batch["Rt"][0].cpu().numpy()
    cam_pos = np.stack([-Rt0[v, :3, :3].T @ Rt0[v, :3, 3] for v in range(Rt0.shape[0])])
    print(
        f"[first-batch] gt/frame min={nb.min()} mean={nb.mean():.1f} "
        f"max={nb.max()} | cam heights {np.round(cam_pos[:, 2], 2).tolist()} m"
    )
    if cfg.model.static_cameras and nb.shape[0] > 1:
        K_all = batch["K"].cpu().numpy()
        Rt_all = batch["Rt"].cpu().numpy()
        if np.ptp(K_all, axis=0).max() > 1e-4 or np.ptp(Rt_all, axis=0).max() > 1e-4:
            print(
                "[warn] MODEL.STATIC_CAMERAS=true but K/Rt vary "
                "across the batch - the model will use frame 0's "
                "cameras for every frame. Set MODEL.STATIC_CAMERAS: "
                "false for per-frame calibrations."
            )


def run_training(
    cfg: Config,
    *,
    work_dir: str = ".",
    save_vis: bool = False,
    resume: bool = False,
    dataset: Optional[WildtrackDataset] = None,
    val_dataset: Optional[WildtrackDataset] = None,
    max_epochs: Optional[int] = None,
    profile_steps: int = 0,
    train_indices: Optional[list] = None,
    val_indices: Optional[list] = None,
    device: Optional[str | torch.device] = None,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, float]:
    """Train BEVNet on Wildtrack(-format) data; returns the final metrics.
    ``state_dict``: the initial weights (``init_state_dict(cfg,
    TRAIN.SEED)`` when None)."""
    dev = init_distributed(runtime_device(cfg.runtime.device) if device is None else device)
    mesh = config_mesh(cfg)
    if not mesh.member:
        return {}
    print(f"[mesh] data {mesh.n_data} x view {mesh.n_view} on {mesh.size} device(s)")
    main = mesh.is_main
    work_dir = Path(work_dir)
    save_dir = work_dir / cfg.runtime.save_dir
    out_dir = work_dir / cfg.runtime.output_dir
    save_dir.mkdir(parents=True, exist_ok=True)
    out_dir.mkdir(parents=True, exist_ok=True)

    train_ds = dataset if dataset is not None else WildtrackDataset(cfg, train=True)
    eval_ds = (
        val_dataset
        if val_dataset is not None
        else WildtrackDataset(
            cfg, train=False, cache_from=train_ds if isinstance(train_ds, WildtrackDataset) else None
        )
    )
    idx_train, idx_val = split_train_val(len(train_ds), cfg.train.seed)
    if train_indices is not None:
        idx_train = list(train_indices)
    if val_indices is not None:
        idx_val = list(val_indices)
    print(f"[data] {len(train_ds)} frames -> {len(idx_train)} train / {len(idx_val)} val")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[device] {dev} ({name})")

    B, workers = cfg.data.batch_size, cfg.runtime.num_workers
    shard = mesh.slice_batch if mesh.size > 1 else None
    dl_train = Prefetcher(
        train_ds, idx_train, B, shuffle=True, num_workers=workers, seed=cfg.train.seed, drop_last=True, device=dev,
        shard=shard,
    )
    dl_val = Prefetcher(eval_ds, idx_val, B, shuffle=False, num_workers=workers, device=dev, shard=shard)

    steps_per_epoch = max(1, len(dl_train))
    state = create_state(
        cfg, state_dict, seed=cfg.train.seed, device=dev, steps_per_epoch=steps_per_epoch, mesh=mesh
    )
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[model] {cfg.model.backbone} | {n_params/1e6:.2f} M params")

    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)

    ckpt = CheckpointManager(str(save_dir))
    save = ckpt.save if main else _Quiet().save
    logger = ScalarLogger(str(save_dir)) if main else _Quiet()
    metric_writer = MetricWriter(str(save_dir)) if main else _Quiet()

    start_epoch, best_f1 = 0, -1.0
    if resume and ckpt.exists("last"):
        state, start_epoch, best_f1 = ckpt.restore("last", state)
        start_epoch += 1
        print(f"[resume] from epoch {start_epoch}, best_f1={best_f1:.3f}")

    debug_max = cfg.runtime.debug_max_steps
    interval = max(1, cfg.eval.interval)
    patience = cfg.train.patience
    mem_limit = cfg.runtime.memory_limit_percent

    no_improve = 0
    global_step = int(state.step)
    prof = None
    prof_dir = save_dir / "profile"
    if profile_steps > 0 and main:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        print(f"[profile] tracing first {profile_steps} steps -> {prof_dir}")

    def _stop_profile(note: str) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        prof_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(prof_dir / "trace.json"))
        print(f"[profile] trace complete{note}")

    train_loss_curve, val_f1_curve = [], []
    epochs = max_epochs if max_epochs is not None else cfg.train.epochs
    final_metrics: Dict[str, float] = {}

    first_batch_seen = False
    if cfg.runtime.debug_nans:
        print("[debug] torch.autograd anomaly detection enabled")
    with torch.autograd.set_detect_anomaly(cfg.runtime.debug_nans):
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            running = 0.0
            step_count = 0
            # Device loss scalars are buffered and fetched in bunches every
            # 10 steps: a per-step float() would sync the host to the device
            # every iteration and serialise dispatch.
            loss_buf: list = []  # (global_step, device scalar)

            def _drain_losses():
                nonlocal running
                for gs, dl in loss_buf:
                    v = float(dl)
                    running += v
                    logger.log("train/loss_iter", v, gs)
                loss_buf.clear()

            for batch in dl_train:
                if not first_batch_seen:
                    first_batch_seen = True
                    _first_batch(cfg, batch)
                metrics = train_step(state, batch)
                step_count += 1
                global_step += 1
                loss_buf.append((global_step, metrics["total_loss"]))
                if step_count % 10 == 0:
                    _drain_losses()
                    dt = time.perf_counter() - t0
                    print(
                        f"[train][epoch {epoch}] steps={step_count} "
                        f"avg_steps/s={step_count / max(1e-6, dt):.2f}"
                    )
                if prof is not None and global_step >= profile_steps:
                    _stop_profile("")
                    prof = None
                if debug_max > 0 and step_count >= debug_max:
                    break
            _drain_losses()
            train_s = time.perf_counter() - t0
            input_wait_s = dl_train.wait_s
            train_loss_epoch = running / max(1, step_count)
            train_loss_curve.append(train_loss_epoch)

            do_eval = (epoch + 1) % interval == 0
            summary: Dict[str, float] = {}
            if do_eval:
                acc = DetectionMetrics(match_dist=cfg.eval.nms_dist_m)
                val_steps = 0
                for batch in dl_val:
                    out = eval_step(state, batch)
                    gt = global_batch(mesh, batch, ("boxes_world", "num_boxes", "batch_mask"))
                    acc.update_batch(
                        out["boxes"].cpu().numpy(),
                        out["scores"].cpu().numpy(),
                        out["valid"].cpu().numpy(),
                        gt["boxes_world"],
                        gt["num_boxes"],
                        gt["batch_mask"],
                    )
                    if save_vis and main and val_steps == 0:
                        save_bev_heatmap(out["heatmap"].float().cpu().numpy(), str(out_dir / f"epoch{epoch}_hm.png"))
                    val_steps += 1
                    if debug_max > 0 and val_steps >= debug_max:
                        break
                summary = acc.summary()
                if summary.get("n_frames", 0) == 0:
                    # no frame was scored: no metric to report and no
                    # "best" checkpoint to save
                    print(
                        "[warn] eval scored 0 frames (empty val split?); "
                        "skipping metrics and best-checkpoint selection"
                    )
                    summary = {}
                else:
                    val_f1_curve.append(summary["f1"])
                    final_metrics = summary

            stamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
            phase = "eval" if do_eval else "train"
            msg = f"[{stamp}] phase={phase} epoch={epoch} loss={train_loss_epoch:.4f}"
            if summary:
                msg += (
                    f" P={summary['precision']:.3f} R={summary['recall']:.3f}"
                    f" F1={summary['f1']:.3f} MLE={summary['mle']:.3f}"
                    f" MODA={summary['moda']:.3f} MODP={summary['modp']:.3f}"
                    f" TP={summary['tp']:.0f} FP={summary['fp']:.0f} FN={summary['fn']:.0f}"
                )
            print(msg)
            epoch_s = time.perf_counter() - t0
            print(
                f"[time] epoch={epoch} total={epoch_s:.3f}s train={train_s:.3f}s steps={step_count} "
                f"input_wait={input_wait_s:.3f}s"
            )
            logger.log_dict(
                {"epoch_s": epoch_s, "train_s": train_s, "steps": step_count, "input_wait_s": input_wait_s},
                epoch, prefix="time/",
            )

            mem_pct = max_device_memory_percent(dev)
            if mem_pct is not None:
                print(f"[gpu] mem%={mem_pct:.0f}")
                if mem_pct >= mem_limit:
                    save("mem_triggered", state, epoch=epoch, best_f1=best_f1)
                    print("[gpu] saved memory-triggered checkpoint")
            hs = host_stats()
            if hs:
                print(f"[sys] cpu={hs.get('cpu_percent', 0):.0f}% ram={hs.get('ram_percent', 0):.0f}%")

            if summary:
                logger.log_dict(
                    {k: summary[k] for k in ("precision", "recall", "f1", "mle", "moda", "modp")},
                    epoch,
                    prefix="val/",
                )
            metric_writer.write({"epoch": epoch, "train_loss": train_loss_epoch, **summary})

            save("last", state, epoch=epoch, best_f1=best_f1)
            if summary and summary["f1"] > best_f1:
                best_f1 = summary["f1"]
                save("best", state, epoch=epoch, best_f1=best_f1)
                print(f"[ckpt] new best (F1={best_f1:.3f})")
                no_improve = 0
            elif do_eval:
                no_improve += 1
            if patience > 0 and no_improve >= patience and do_eval:
                print(f"[early-stop] epoch {epoch}: no F1 improvement for {no_improve} evals")
                break

    if prof is not None:
        _stop_profile(" (run ended before N steps)")
    if main:
        save_learning_curves(train_loss_curve, val_f1_curve, str(save_dir / "learning_curves.png"))
    logger.close()
    final_metrics["train_loss"] = train_loss_curve[-1] if train_loss_curve else float("nan")
    final_metrics["best_f1"] = best_f1
    return final_metrics

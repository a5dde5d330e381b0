"""Multi-epoch train -> evaluate on a larger synthetic Wildtrack, with
recorded MODA/MODP: the twin of ``scripts/train_synthetic_e2e.py``.

    python -m vsta_tpu_torch.train_synthetic_e2e [--fusion concat] [--epochs 30] [--track]
    python -m vsta_tpu_torch.train_synthetic_e2e --config configs/wildtrack_v1_resnet50.yaml --epochs 20

Generates a 120-frame, 7-view synthetic Wildtrack (the port's generator,
seed 11: the JAX script's tree byte for byte) under the temporary
directory, unless ``--data_root`` names one, trains the requested fusion
variant with the config's schedule (patience off, no step cap) and prints
the final val metrics as ``[e2e-result] {json}``. ``--track`` trains on
the first 80 % of the frames, runs SORT over the trained model's
detections on the last 20 % in frame order, scores CLEAR-MOT/IDF1 against
the generator's person identities (``[track-result] {json}``) and appends
``{"tracking": ...}`` to ``<work_dir>/<SAVE_DIR>/metrics.jsonl``.

Runs where ``RUNTIME.DEVICE`` says: the CUDA device (raising without
one), unless the config says ``cpu``; over the mesh of
``RUNTIME.MESH_DATA`` x ``MESH_VIEW`` (under torchrun rank 0 prints and
writes).
"""

import argparse
import dataclasses
import json
import tempfile
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/wildtrack.yaml",
                    help="base config (e.g. configs/wildtrack_v1_resnet50.yaml "
                         "to drive the BASELINE.json-named Phase-1 family)")
    ap.add_argument("--fusion", default="concat",
                    choices=["concat", "mean", "max", "sum", "attn", "deform_attn"])
    ap.add_argument("--warp_impl", default=None,
                    help="override MODEL.WARP_IMPL (default: config value)")
    ap.add_argument("--norm", default=None, choices=["batch", "group"],
                    help="override MODEL.NORM (GroupNorm-32 backbone "
                         "variant, resnets only)")
    ap.add_argument("--feat_dim", type=int, default=None,
                    help="override MODEL.FEAT_DIM (per-view fusions like "
                         "attn warp FEAT_DIM channels to BEV - use ~64, "
                         "not the flagship 1280)")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--people", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--work_dir", default=None)
    ap.add_argument("--data_root", default=None,
                    help="reuse an existing synthetic tree instead of generating")
    ap.add_argument("--img_hw", default="540x960",
                    help="source image size HxW (decoded+resized to the config size)")
    ap.add_argument("--track", action="store_true",
                    help="hold out the LAST 20%% of frames as a contiguous "
                         "sequence, run SORT over the trained model's "
                         "detections on it in frame order, and score "
                         "MOTA/MOTP/IDF1 against the generator's personID "
                         "ground truth (reference Phase-3 criterion)")
    args = ap.parse_args(argv)

    from .config import load_config
    from .data.synthetic import generate_synthetic_wildtrack
    from .parallel.mesh import init_distributed, quiet_unless_main, world
    from .training.loop import run_training
    from .utils.platform import runtime_device

    src_h, src_w = (int(x) for x in args.img_hw.split("x"))
    cfg = load_config(args.config)
    init_distributed(runtime_device(cfg.runtime.device))
    quiet_unless_main()
    main_rank = world()[0] == 0
    if args.data_root:
        root = Path(args.data_root)
    else:
        root = Path(tempfile.gettempdir()) / f"vsta_e2e_{args.frames}f_{src_h}x{src_w}"
        marker = root / ".complete"
        if main_rank and not marker.exists():
            print(f"[e2e] generating {args.frames}-frame synthetic Wildtrack at {root}")
            generate_synthetic_wildtrack(
                root, n_frames=args.frames, n_views=7, n_people=args.people,
                img_hw=(src_h, src_w), seed=11,
            )
            marker.touch()
        _barrier()

    model_kw = {"fusion": args.fusion}
    if args.warp_impl:
        model_kw["warp_impl"] = args.warp_impl
    if args.norm:
        model_kw["norm"] = args.norm
    if args.feat_dim:
        model_kw["feat_dim"] = args.feat_dim
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, data_root=str(root), batch_size=args.batch),
        model=dataclasses.replace(cfg.model, **model_kw),
        train=dataclasses.replace(cfg.train, epochs=args.epochs, patience=0),
        runtime=dataclasses.replace(cfg.runtime, debug_max_steps=0),
    )

    work = Path(args.work_dir or (root.parent / f"vsta_e2e_run_{args.fusion}"))
    work.mkdir(parents=True, exist_ok=True)
    print(f"[e2e] training fusion={args.fusion} epochs={args.epochs} -> {work}")

    train_idx = val_idx = None
    if args.track:
        # tracking needs a temporally CONTIGUOUS held-out sequence, not
        # the random 80/20 scatter: train on the first 80% of frames,
        # track + score the last 20%
        n_val = max(2, int(args.frames * 0.2))
        train_idx = list(range(0, args.frames - n_val))
        val_idx = list(range(args.frames - n_val, args.frames))

    metrics = run_training(cfg, work_dir=str(work), train_indices=train_idx, val_indices=val_idx)
    summary = {
        "config": args.config,
        "backbone": cfg.model.backbone,
        "norm": cfg.model.norm,
        "fusion": args.fusion,
        "warp_impl": cfg.model.warp_impl,
        "epochs": args.epochs,
        "frames": args.frames,
        **{k: round(float(v), 4) for k, v in metrics.items()},
    }
    if args.track:
        mot = run_tracking_eval(cfg, work, val_idx)
        summary.update({f"track_{k}": round(float(v), 4) for k, v in mot.items()})
        if main_rank:
            with open(work / cfg.runtime.save_dir / "metrics.jsonl", "a") as f:
                f.write(json.dumps({"tracking": mot, "val_frames": len(val_idx)}) + "\n")
    print("[e2e-result] " + json.dumps(summary))
    return summary


def _barrier() -> None:
    """Wait for rank 0 (which writes the tree) under torchrun."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def run_tracking_eval(cfg, work: Path, val_idx):
    """SORT over the trained model's detections on the held-out sequence,
    scored with CLEAR-MOT/IDF1 against the dataset's person identities."""
    from .data.pipeline import Prefetcher
    from .data.wildtrack import WildtrackDataset
    from .parallel.mesh import init_distributed
    from .tracking import SortTracker
    from .tracking.metrics import MotAccumulator
    from .training.checkpoint import CheckpointManager
    from .training.loop import config_mesh, global_batch
    from .training.state import create_state, make_eval_step
    from .utils.platform import runtime_device

    dev = init_distributed(runtime_device(cfg.runtime.device))
    ds = WildtrackDataset(cfg, train=False)
    mesh = config_mesh(cfg)
    state = create_state(cfg, device=dev, steps_per_epoch=1, mesh=mesh)
    ckpt = CheckpointManager(str(work / cfg.runtime.save_dir))
    name = "best" if ckpt.exists("best") else "last"
    state, epoch, f1 = ckpt.restore(name, state)
    print(f"[track] evaluating checkpoint '{name}' (epoch {epoch}) on "
          f"{len(val_idx)} held-out frames")

    eval_step = make_eval_step(cfg)
    tracker = SortTracker(
        max_age=cfg.track.max_age,
        min_hits=cfg.track.min_hits,
        match_dist_m=cfg.track.match_dist_m,
    )
    acc = MotAccumulator(match_dist=cfg.track.match_dist_m)
    dl = Prefetcher(
        ds, val_idx, cfg.data.batch_size, shuffle=False,
        num_workers=cfg.runtime.num_workers, device=dev,
        shard=mesh.slice_batch if mesh.size > 1 else None,
    )
    for batch in dl:
        out = eval_step(state, batch)  # gathered over 'data' on a mesh
        boxes, scores, valid = (out[k].cpu().numpy() for k in ("boxes", "scores", "valid"))
        g = global_batch(mesh, batch, ("frame_idx", "batch_mask"))
        fidx, mask = g["frame_idx"], g["batch_mask"]
        for b in range(boxes.shape[0]):
            if not mask[b]:
                continue
            keep = valid[b]
            trks = tracker.update(boxes[b][keep, :2], scores[b][keep])
            h_ids = [int(t["id"]) for t in trks]
            h_xy = np.array([t["xy"] for t in trks], np.float64).reshape(-1, 2)
            i = int(fidx[b])
            acc.update(ds.ids_per_frame[i], ds.centers_per_frame[i], h_ids, h_xy)
    mot = acc.summary()
    print("[track-result] " + json.dumps({k: round(float(v), 4) for k, v in mot.items()}))
    return mot


if __name__ == "__main__":
    main()

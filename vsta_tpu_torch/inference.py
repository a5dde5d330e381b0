"""Batch inference CLI of the port: the twin of ``inference.py``.

    python -m vsta_tpu_torch.inference --config configs/wildtrack.yaml \\
        --checkpoint checkpoints/best [--track] [--clips N] [--save_vis]

Loads a checkpoint of this package (``training/checkpoint.py``), runs the
whole dataset in order and writes one JSON per frame ({"frame_idx",
"boxes", "scores"}) to ``RUNTIME.OUTPUT_DIR``. ``--track`` runs the SORT
tracker (``tracking/``) over the decoded frames and adds "tracks";
``--clips N`` (with ``--track``) runs N temporal windows as the N rows of
each batch, one online tracker a clip, and records each frame's "clip".
``--save_vis`` writes the first batch's BEV heatmap. Runs on the CUDA
device unless ``RUNTIME.DEVICE`` is ``cpu``. The int8 paths
(``--quantize-head``, ``--quantize-encoder``) are not ported: they raise.
"""

import argparse
from pathlib import Path

from .config import load_config
from .data.pipeline import Prefetcher, multi_clip_plan
from .data.wildtrack import WildtrackDataset
from .tracking import SortTracker
from .training.checkpoint import CheckpointManager
from .training.loop import one_device
from .training.state import create_state, make_eval_step
from .utils.platform import runtime_device
from .utils.visualization import save_bev_heatmap, save_predictions_json


def track_rows(trackers, boxes, scores, valid, batch_mask, per_clip: bool):
    """Advance the trackers by one batch of decoded frames (numpy); the
    tracks of each row as the per-frame JSON holds them. Rows arrive in
    temporal order per stream: with ``per_clip`` row b is clip b, else one
    tracker takes every row in order."""
    out = []
    for b in range(boxes.shape[0]):
        if not batch_mask[b]:
            out.append([])
            continue
        keep = valid[b]
        trk = trackers[b if per_clip else 0]
        out.append([
            {
                "id": int(t["id"]),
                "xy": [float(t["xy"][0]), float(t["xy"][1])],
                "velocity": [float(t["velocity"][0]), float(t["velocity"][1])],
                "score": float(t["score"]),
            }
            for t in trk.update(boxes[b][keep, :2], scores[b][keep])
        ])
    return out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default="checkpoints/best")
    parser.add_argument("--track", action="store_true", default=False)
    parser.add_argument("--clips", type=int, default=1,
                        help="with --track: run N temporal windows (clips) as N batch rows, "
                             "one online tracker per clip")
    parser.add_argument("--save_vis", action="store_true", default=False)
    parser.add_argument("--quantize-head", action="store_true", default=False,
                        help="int8 detector stem: not ported (ROADMAP Queue 1 item 6)")
    parser.add_argument("--quantize-encoder", action="store_true", default=False,
                        help="int8 ResNet encoder: not ported (ROADMAP Queue 1 item 6)")
    args = parser.parse_args()
    if args.clips > 1 and not args.track:
        parser.error("--clips requires --track")
    if args.quantize_head or args.quantize_encoder:
        raise NotImplementedError("the int8 serving paths are ROADMAP Queue 1 item 6, 'int8'")

    cfg = load_config(args.config)
    dev = runtime_device(cfg.runtime.device)
    one_device(cfg)
    ds = WildtrackDataset(cfg, train=False)
    # multi-clip mode: row c of every batch is clip c's next frame
    batch_size = args.clips if args.clips > 1 else cfg.data.batch_size
    plan = multi_clip_plan(range(len(ds)), args.clips) if args.clips > 1 else None
    dl = Prefetcher(ds, range(len(ds)), batch_size, shuffle=False, num_workers=cfg.runtime.num_workers,
                    device=dev, plan=plan)

    state = create_state(cfg, device=dev, steps_per_epoch=1)
    ckpt_path = Path(args.checkpoint)
    state, epoch, f1 = CheckpointManager(str(ckpt_path.parent)).restore(ckpt_path.name, state)
    print(f"[ckpt] loaded {args.checkpoint} (epoch {epoch}, f1={f1:.3f})")

    t = cfg.track
    trackers = None
    if args.track:
        trackers = [SortTracker(max_age=t.max_age, min_hits=t.min_hits, match_dist_m=t.match_dist_m)
                    for _ in range(max(1, args.clips))]

    eval_step = make_eval_step(cfg)
    out_dir = cfg.runtime.output_dir
    n_frames = 0
    for batch in dl:
        out = eval_step(state, batch)
        boxes, scores, valid = (out[k].cpu().numpy() for k in ("boxes", "scores", "valid"))
        frame_idx = batch["frame_idx"].cpu().numpy().tolist()
        batch_mask = batch["batch_mask"].cpu().numpy()
        tracks = None
        if trackers is not None:
            tracks = track_rows(trackers, boxes, scores, valid, batch_mask, per_clip=args.clips > 1)
        save_predictions_json(
            boxes, scores, valid, out_dir, frame_idx, batch_mask, tracks=tracks,
            clips=list(range(args.clips)) if args.clips > 1 else None,
        )
        if args.save_vis and n_frames == 0:
            save_bev_heatmap(out["heatmap"].cpu().numpy(), str(Path(out_dir) / "heatmap_first.png"))
        n_frames += int(batch_mask.sum())
    print(f"Saved predictions JSON for {n_frames} frames to {out_dir}")


if __name__ == "__main__":
    main()

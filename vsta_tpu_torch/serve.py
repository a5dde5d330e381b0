"""Streaming serving CLI of the port: the twin of ``serve.py``.

    python -m vsta_tpu_torch.export --config configs/wildtrack.yaml \\
        --checkpoint checkpoints/best --out model.pt --batch 1
    python -m vsta_tpu_torch.serve --artifact model.pt --source data/Wildtrack \\
        [--track] [--clips N] [--overlap] [--out outputs/]

Loads an artifact of :mod:`vsta_tpu_torch.export` (weights and manifest;
the manifest embeds the config), which on the card replays one CUDA graph
a request, and streams the frame tree in dataset order at the artifact's
frozen batch size through the pinned ``Prefetcher`` (4 batches ahead). It
writes one JSON a frame, adds SORT "tracks" with ``--track`` (one tracker
a clip with ``--clips N``, N the batch size) and prints the ``[serve]``
line: latency a batch (mean, p50, p95) and a frame, host clock around the
request and the fetch of its detections. ``--overlap`` replays batch i+1
before it fetches batch i (each request's outputs are copies, so the next
replay leaves them alone); the latency is then pipelined throughput.
Runs on the CUDA device unless ``RUNTIME.DEVICE`` is ``cpu``.
"""

import argparse
import dataclasses
import json
import re
import time

import numpy as np
import torch


def _batch_from_manifest(manifest: dict, default: int) -> int:
    """The artifact's frozen batch size, from its first input aval
    (e.g. "uint8[1,7,270,480,3]")."""
    avals = manifest.get("in_avals") or []
    m = re.search(r"\[(\d+)", avals[0]) if avals else None
    return int(m.group(1)) if m else default


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", type=str, required=True,
                    help="artifact from python -m vsta_tpu_torch.export (its .json manifest beside it)")
    ap.add_argument("--config", type=str, default=None,
                    help="config override; default: the manifest's embedded config")
    ap.add_argument("--source", type=str, default=None, help="override DATA.DATA_ROOT (the frame tree to stream)")
    ap.add_argument("--out", type=str, default=None, help="override RUNTIME.OUTPUT_DIR for prediction JSON")
    ap.add_argument("--track", action="store_true", default=False)
    ap.add_argument("--clips", type=int, default=0,
                    help="with --track: split the source into N temporal windows, one a batch row with its "
                         "own tracker; N must equal the artifact's frozen batch size (0 = single stream)")
    ap.add_argument("--limit", type=int, default=0, help="serve only the first N frames (0 = all)")
    ap.add_argument("--warmup", type=int, default=1, help="untimed warmup batches")
    ap.add_argument("--overlap", action="store_true", default=False,
                    help="one-deep pipelining: replay batch i+1 before fetching and post-processing batch i; "
                         "latency is then pipelined throughput, not request latency")
    args = ap.parse_args()
    if args.clips > 1 and not args.track:
        ap.error("--clips requires --track")

    from .export import load_serving, manifest_path

    mpath = manifest_path(args.artifact)
    if not mpath.exists():
        raise FileNotFoundError(
            f"manifest {mpath} not found - export with python -m vsta_tpu_torch.export (it writes the manifest "
            "next to the artifact)")
    manifest = json.loads(mpath.read_text())

    from .config import from_dict, load_config

    if args.config:
        cfg = load_config(args.config)
    elif "config" in manifest:
        cfg = from_dict(manifest["config"])
    else:
        raise SystemExit("manifest has no embedded config; pass --config")
    if args.source:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data_root=args.source))
    if args.out:
        cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, output_dir=args.out))

    from .data.pipeline import Prefetcher, multi_clip_plan
    from .data.wildtrack import WildtrackDataset
    from .inference import track_rows
    from .tracking import SortTracker
    from .utils.platform import runtime_device
    from .utils.visualization import save_predictions_json

    dev = runtime_device(cfg.runtime.device)
    B = _batch_from_manifest(manifest, cfg.data.batch_size)
    ds = WildtrackDataset(cfg, train=False)
    indices = range(min(args.limit, len(ds)) if args.limit else len(ds))
    plan = None
    if args.clips > 1:
        if args.clips != B:
            raise SystemExit(
                f"--clips {args.clips} must equal the artifact's frozen batch size {B} (each clip rides one "
                "batch row)")
        plan = multi_clip_plan(indices, args.clips)
    # the graph is captured before the Prefetcher's threads start copying
    serve = load_serving(args.artifact, device=dev)
    dl = Prefetcher(ds, indices, B, shuffle=False, prefetch=4, num_workers=cfg.runtime.num_workers,
                    device=dev, plan=plan)

    trackers = None
    if args.track:
        t = cfg.track
        trackers = [SortTracker(max_age=t.max_age, min_hits=t.min_hits, match_dist_m=t.match_dist_m)
                    for _ in range(max(1, args.clips))]

    out_dir = cfg.runtime.output_dir
    lat, n_frames, n_warm, n_timed = [], 0, 0, 0

    def start_fetch(out, batch):
        """Queue the copies of a request's detections and its frame indices
        and mask to pinned host memory; returns (host tensors, the event they
        end at). The event lies before any later request on the stream, so
        waiting on it does not wait for the next replay."""
        leaves = {**out, "frame_idx": batch["frame_idx"], "batch_mask": batch["batch_mask"]}
        if dev.type != "cuda":
            return leaves, None
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
                for k, v in leaves.items()}
        return host, torch.cuda.current_stream(dev).record_event()

    def finish_fetch(fetched):
        host, event = fetched
        if event is not None:
            event.synchronize()
        return {k: v.numpy() for k, v in host.items()}

    def postprocess(out):
        """Online tracking and a JSON a frame, from fetched arrays."""
        nonlocal n_frames
        boxes, scores, valid, batch_mask = out["boxes"], out["scores"], out["valid"], out["batch_mask"]
        tracks = None
        if trackers is not None:
            tracks = track_rows(trackers, boxes, scores, valid, batch_mask, per_clip=args.clips > 1)
        save_predictions_json(boxes, scores, valid, out_dir, out["frame_idx"].tolist(), batch_mask, tracks=tracks,
                              clips=list(range(args.clips)) if args.clips > 1 else None)
        n_frames += int(batch_mask.sum())

    def record(dt, mask):
        nonlocal n_warm, n_timed
        if n_warm < args.warmup:
            n_warm += 1
        else:
            lat.append(dt)
            n_timed += int(mask.sum())  # real frames only, not a last batch's padding

    if not args.overlap:
        for batch in dl:
            t0 = time.perf_counter()
            out = finish_fetch(start_fetch(serve(batch["images"], batch["K"], batch["Rt"]), batch))
            record(time.perf_counter() - t0, out["batch_mask"])
            postprocess(out)
    else:
        pending = None  # the batch before: its fetch, queued behind its replay
        for batch in dl:
            t0 = time.perf_counter()
            fetched = start_fetch(serve(batch["images"], batch["K"], batch["Rt"]), batch)
            if pending is not None:
                out = finish_fetch(pending)
                record(time.perf_counter() - t0, out["batch_mask"])  # replay i+1 + drain i
                postprocess(out)
            pending = fetched
        if pending is not None:
            postprocess(finish_fetch(pending))

    stats = {"frames": n_frames, "batch": B, "overlap": bool(args.overlap)}
    if lat and n_timed:
        arr = np.array(lat)
        stats.update({
            "batches_timed": len(lat),
            "frames_timed": n_timed,
            "latency_ms_mean": round(float(arr.mean() * 1e3), 2),
            "latency_ms_p50": round(float(np.percentile(arr, 50) * 1e3), 2),
            "latency_ms_p95": round(float(np.percentile(arr, 95) * 1e3), 2),
            "latency_ms_per_frame": round(float(arr.sum() * 1e3 / n_timed), 2),
            "frames_per_sec": round(n_timed / float(arr.sum()), 1),
        })
    print("[serve] " + json.dumps(stats))
    print(f"Saved predictions JSON for {n_frames} frames to {out_dir}")


if __name__ == "__main__":
    main()

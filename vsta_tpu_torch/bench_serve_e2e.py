"""One recorded full-system serving run: the twin of
``scripts/bench_serve_e2e.py``.

    python -m vsta_tpu_torch.bench_serve_e2e \\
        --checkpoint /tmp/vsta_e2e_run_concat/checkpoints/best \\
        --data /tmp/vsta_e2e_120f_540x960 --clips 1,4 [--overlap] [--device cpu]

Drives the deployment pipeline of the port end to end over a synthetic
tree (from ``python -m vsta_tpu_torch.train_synthetic_e2e``), per clip
count: trained checkpoint -> ``python -m vsta_tpu_torch.export`` (an
artifact frozen at batch = n_clips; on the card one CUDA graph a
request) -> ``python -m vsta_tpu_torch.serve --track [--clips N]``
(batched multi-clip streaming, one online SORT tracker a batch row) ->
per-clip CLEAR-MOT/IDF1 against the generator's person identities, with
the latency stats the serve CLI prints. Everything runs through the CLIs
as subprocesses; this module only orchestrates and scores. A CLI that
exits non-zero, or a serve run without its ``[serve] {...}`` line, raises.

Prints one ``[serve-e2e] {json}`` line per clip count (and the per-clip
scores when N > 1), then a markdown table. Runs on the CUDA device
unless ``--device`` or the config's ``RUNTIME.DEVICE`` says ``cpu``.
"""

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def run_cli(cmd, label):
    """``python -m <cmd>`` from the repository's root; its standard output."""
    print(f"[serve-e2e] $ {' '.join(cmd)}", flush=True)
    proc = subprocess.run([sys.executable, "-m"] + cmd, capture_output=True, text=True, cwd=str(REPO))
    if proc.returncode != 0:
        print(proc.stdout[-2000:])
        print(proc.stderr[-2000:], file=sys.stderr)
        raise SystemExit(f"{label} failed with rc={proc.returncode}")
    return proc.stdout


def score_mot(out_dir: Path, cfg, n_clips: int):
    """Score the tracks the serve CLI wrote against the dataset's
    identities, one MotAccumulator per clip (track ids are per-clip)."""
    from .data.wildtrack import WildtrackDataset
    from .tracking.metrics import MotAccumulator

    ds = WildtrackDataset(cfg, train=False)
    frames = sorted(out_dir.glob("frame_*.json"))
    assert frames, f"the serve CLI wrote no frame JSONs to {out_dir}"
    per_clip = defaultdict(list)
    for p in frames:
        d = json.loads(p.read_text())
        per_clip[d.get("clip", 0)].append(d)

    accs = {}
    for clip, items in sorted(per_clip.items()):
        acc = MotAccumulator(match_dist=cfg.track.match_dist_m)
        # clips are contiguous temporal windows: frame_idx order IS the
        # order each row's tracker saw them (pipeline.multi_clip_plan)
        for d in sorted(items, key=lambda d: d["frame_idx"]):
            i = int(d["frame_idx"])
            hyp = d.get("tracks") or []
            acc.update(
                ds.ids_per_frame[i],
                ds.centers_per_frame[i],
                [int(t["id"]) for t in hyp],
                np.array([t["xy"] for t in hyp], np.float64).reshape(-1, 2),
            )
        accs[clip] = acc.summary()

    n = sum(a["n_gt"] for a in accs.values())
    agg = {
        # GT-weighted aggregate over clips (equals the single-stream
        # definition when n_clips == 1)
        "mota": sum(a["mota"] * a["n_gt"] for a in accs.values()) / max(1, n),
        "idf1": sum(a["idf1"] * a["n_gt"] for a in accs.values()) / max(1, n),
        "motp_m": sum(a["motp"] * a["n_gt"] for a in accs.values()) / max(1, n),
        "id_switches": sum(a["id_switches"] for a in accs.values()),
        "n_gt": n,
        "frames_scored": len(frames),
    }
    return agg, {c: {k: round(float(v), 4) for k, v in a.items()} for c, a in accs.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True,
                    help="trained checkpoint of the port, e.g. "
                         "/tmp/vsta_e2e_run_concat/checkpoints/best")
    ap.add_argument("--config", default="configs/wildtrack.yaml")
    ap.add_argument("--data", required=True, help="synthetic Wildtrack root")
    ap.add_argument("--clips", default="1,4",
                    help="comma-separated clip counts to record")
    ap.add_argument("--limit", type=int, default=0,
                    help="serve only the first N frames (0 = all)")
    ap.add_argument("--device", default=None,
                    help="override RUNTIME.DEVICE (cpu; default: config value, "
                         "the CUDA device for any value but cpu)")
    ap.add_argument("--quantize-head", action="store_true", default=False)
    ap.add_argument("--overlap", action="store_true", default=False,
                    help="serve with one-deep pipelining (throughput mode)")
    args = ap.parse_args(argv)

    import yaml

    from .config import load_config, to_dict
    from .utils.platform import runtime_device

    cfg = load_config(args.config)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_root=args.data)
    )
    if args.device:
        cfg = dataclasses.replace(
            cfg, runtime=dataclasses.replace(cfg.runtime, device=args.device)
        )
    platform = runtime_device(cfg.runtime.device).type  # raises without a card unless cpu

    tmp = Path(tempfile.mkdtemp(prefix="vsta_serve_e2e_"))
    cfg_path = tmp / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(to_dict(cfg)))

    rows = []
    for n_clips in (int(c) for c in args.clips.split(",")):
        artifact = tmp / f"model_b{n_clips}.pt"
        export_cmd = [
            "vsta_tpu_torch.export", "--config", str(cfg_path),
            "--checkpoint", args.checkpoint,
            "--out", str(artifact), "--batch", str(max(1, n_clips)),
            "--platform", platform,
        ]
        if args.quantize_head:
            export_cmd.append("--quantize-head")
        run_cli(export_cmd, f"export b{n_clips}")

        out_dir = tmp / f"serve_clips{n_clips}"
        serve_cmd = [
            "vsta_tpu_torch.serve", "--artifact", str(artifact), "--track",
            "--out", str(out_dir),
        ]
        if n_clips > 1:
            serve_cmd += ["--clips", str(n_clips)]
        if args.overlap:
            serve_cmd.append("--overlap")
        if args.limit:
            serve_cmd += ["--limit", str(args.limit)]
        out = run_cli(serve_cmd, f"serve clips={n_clips}")
        m = re.search(r"^\[serve\] (\{.*\})$", out, re.MULTILINE)
        if not m:
            raise SystemExit(f"no [serve] stats line in the serve CLI's output:\n{out[-1500:]}")
        latency = json.loads(m.group(1))

        mot, per_clip = score_mot(out_dir, cfg, n_clips)
        row = {
            "clips": n_clips,
            "overlap": bool(args.overlap),
            "device": platform,  # the device it ran on: cuda or cpu
            "quantize_head": bool(args.quantize_head),
            "mota": round(mot["mota"], 4),
            "idf1": round(mot["idf1"], 4),
            "motp_m": round(mot["motp_m"], 4),
            "id_switches": int(mot["id_switches"]),
            "frames": int(latency.get("frames", mot["frames_scored"])),
            "latency_ms_p50": latency.get("latency_ms_p50"),
            "latency_ms_p95": latency.get("latency_ms_p95"),
            "latency_ms_per_frame": latency.get("latency_ms_per_frame"),
            "frames_per_sec": latency.get("frames_per_sec"),
        }
        rows.append(row)
        print("[serve-e2e] " + json.dumps(row), flush=True)
        if n_clips > 1:
            print("[serve-e2e] per-clip: " + json.dumps(per_clip), flush=True)

    print("\n| clips | MOTA | IDF1 | MOTP (m) | IDsw | p50 (ms) | p95 (ms) | f/s |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['clips']} | {r['mota']:.3f} | {r['idf1']:.3f} | "
            f"{r['motp_m']:.3f} | {r['id_switches']} | {r['latency_ms_p50']} | "
            f"{r['latency_ms_p95']} | {r['frames_per_sec']} |"
        )
    return rows


if __name__ == "__main__":
    main()

"""SORT tracking and the inference CLI of vsta_tpu_torch, on the CPU.

The port keeps its own copy of the JAX package's tracking (numpy and
scipy on the host), so the same detection sequences must give the same
tracks, IDs and metrics: Kalman states to 1e-12 (the same float64
arithmetic), track IDs, hits and MOT counts exactly. Then
``python -m vsta_tpu_torch.inference --track --clips 2`` runs as a
subprocess on a tiny synthetic tree with the ``simple`` backbone and a
checkpoint of random weights, and writes one JSON per frame with its
tracks and clip; the tracks it writes are those the port's tracker gives
on the same decoded frames in process.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from vsta_tpu import tracking as jtracking
from vsta_tpu_torch import tracking
from vsta_tpu_torch.config import from_dict
from vsta_tpu_torch.data.pipeline import multi_clip_plan
from vsta_tpu_torch.data.synthetic import generate_synthetic_wildtrack
from vsta_tpu_torch.training.checkpoint import CheckpointManager
from vsta_tpu_torch.training.state import create_state

ROOT = Path(__file__).resolve().parents[1]


def detection_sequence(rng, n_frames=40, n_people=6, noise=0.08, p_miss=0.15, n_clutter=1):
    """People walking at constant velocity with measurement noise, missed
    detections, clutter, and one person entering and one leaving midway.
    Returns per-frame (gt ids, gt xy, detections xy, scores)."""
    start = rng.uniform(-8.0, 8.0, (n_people, 2))
    vel = rng.uniform(-0.15, 0.15, (n_people, 2))
    frames = []
    for t in range(n_frames):
        alive = [p for p in range(n_people) if not (p == 0 and t >= n_frames // 2) and not (p == 1 and t < 10)]
        xy = np.array([start[p] + t * vel[p] for p in alive])
        seen = [i for i in range(len(alive)) if rng.uniform() > p_miss]
        det = xy[seen] + noise * rng.standard_normal((len(seen), 2))
        det = np.concatenate([det, rng.uniform(-10.0, 10.0, (rng.integers(0, n_clutter + 1), 2))])
        frames.append((alive, xy, det, rng.uniform(0.3, 1.0, len(det))))
    return frames


def test_kalman_filter_matches_jax(rng):
    a, b = tracking.KalmanFilter2D(np.array([1.0, -2.0])), jtracking.KalmanFilter2D(np.array([1.0, -2.0]))
    for _ in range(25):
        np.testing.assert_allclose(a.predict(), b.predict(), rtol=0, atol=1e-12)
        z = rng.standard_normal(2)
        a.update(z)
        b.update(z)
        np.testing.assert_allclose(a.x, b.x, rtol=0, atol=1e-12)
        np.testing.assert_allclose(a.P, b.P, rtol=0, atol=1e-12)
    np.testing.assert_allclose(a.velocity, b.velocity, rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed,max_age,min_hits", [(0, 5, 2), (1, 2, 3), (2, 0, 1)])
def test_sort_tracker_matches_jax(seed, max_age, min_hits):
    """The same confirmed tracks frame by frame: IDs, hits, positions,
    velocities and scores, and the same live tracks after each frame."""
    frames = detection_sequence(np.random.default_rng(seed))
    kw = dict(max_age=max_age, min_hits=min_hits, match_dist_m=1.0)
    a, b = tracking.SortTracker(**kw), jtracking.SortTracker(**kw)
    n_out = 0
    for _, _, det, scores in frames:
        got, want = a.update(det, scores), b.update(det, scores)
        assert [(t["id"], t["hits"]) for t in got] == [(t["id"], t["hits"]) for t in want]
        for g, w in zip(got, want):
            for k in ("xy", "velocity"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12)
            assert g["score"] == w["score"]
        assert [(t.track_id, t.age, t.frames) for t in a.tracks] == [(t.track_id, t.age, t.frames) for t in b.tracks]
        n_out += len(got)
    assert n_out > 0 and a._next_id == b._next_id > 6
    boxes = [np.concatenate([d, np.full((len(d), 2), 0.6)], axis=1) for _, _, d, _ in frames]
    got = tracking.track_sequence(boxes, [s for *_, s in frames], **kw)
    want = jtracking.track_sequence(boxes, [s for *_, s in frames], **kw)
    assert [[t["id"] for t in f] for f in got] == [[t["id"] for t in f] for f in want]


def test_mot_metrics_match_jax():
    """CLEAR-MOT and IDF1 of the tracker's output against the ground truth,
    and an accumulator fed frame by frame."""
    frames = detection_sequence(np.random.default_rng(3))
    trk = tracking.SortTracker(max_age=3, min_hits=2, match_dist_m=1.0)
    gt, hyp = [], []
    for ids, xy, det, scores in frames:
        out = trk.update(det, scores)
        gt.append((ids, xy))
        hyp.append(([t["id"] for t in out], np.array([t["xy"] for t in out]).reshape(-1, 2)))
    got = tracking.evaluate_tracking(gt, hyp, match_dist=0.5)
    want = jtracking.evaluate_tracking(gt, hyp, match_dist=0.5)
    assert got == want
    assert got["matches"] > 0 and got["id_switches"] >= 0 and 0.0 < got["idf1"] <= 1.0
    a, b = tracking.MotAccumulator(match_dist=1.0), jtracking.MotAccumulator(match_dist=1.0)
    for (g_ids, g_xy), (h_ids, h_xy) in zip(gt, hyp):
        a.update(g_ids, g_xy, h_ids, h_xy)
        b.update(g_ids, g_xy, h_ids, h_xy)
    assert a.summary() == b.summary()


def test_inference_cli_tracks_two_clips(tmp_path):
    """python -m vsta_tpu_torch.inference --track --clips 2 with
    RUNTIME.DEVICE cpu: a JSON per frame with boxes, scores, tracks and
    the frame's clip; then the same frames through make_eval_step and the
    port's tracker in process, one tracker a clip, give the same tracks."""
    from vsta_tpu_torch.data.wildtrack import WildtrackDataset, collate
    from vsta_tpu_torch.inference import track_rows
    from vsta_tpu_torch.training.state import make_eval_step

    n_frames = 7
    root = generate_synthetic_wildtrack(tmp_path / "wt", n_frames=n_frames, n_views=2, n_people=3, img_hw=(108, 192))
    raw = {
        "DATA": {"BATCH_SIZE": 2, "IMG_SIZE": [3, 54, 96], "VIEWS": 2, "DATA_ROOT": str(root)},
        "MODEL": {"BACKBONE": "simple", "FEAT_DIM": 8, "OUT_INDEX": 1, "BEV_SIZE": [32, 12, 24],
                  "BEV_BOUNDS": [-12.0, 12.0, -6.0, 6.0], "BEV_PROJ_CH": 8},
        "RUNTIME": {"DEVICE": "cpu", "NUM_WORKERS": 1, "OUTPUT_DIR": "out/", "USE_AMP": False},
        "EVAL": {"CONF_THRESH": 0.05, "NMS_DIST_M": 0.5, "MAX_DETS": 16},
        "TRACK": {"MAX_AGE": 2, "MIN_HITS": 1, "MATCH_DIST_M": 2.0},
    }
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    cfg = from_dict(raw)
    state = create_state(cfg, seed=3, device="cpu", steps_per_epoch=1)
    CheckpointManager(str(tmp_path / "ckpt")).save("best", state, epoch=0, best_f1=0.0)

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "vsta_tpu_torch.inference", "--config", str(cfg_path), "--checkpoint",
         str(tmp_path / "ckpt" / "best"), "--track", "--clips", "2"],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(tmp_path),
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert f"Saved predictions JSON for {n_frames} frames" in r.stdout
    files = sorted((tmp_path / "out").glob("frame_*.json"))
    assert len(files) == n_frames
    written = {json.loads(f.read_text())["frame_idx"]: json.loads(f.read_text()) for f in files}
    assert all(set(d) == {"frame_idx", "boxes", "scores", "tracks", "clip"} for d in written.values())

    plan = multi_clip_plan(range(n_frames), 2)
    clip_of = {f: c for chunk, n_real in plan for c, f in enumerate(chunk[:n_real])}
    assert {f: d["clip"] for f, d in written.items()} == clip_of
    ds = WildtrackDataset(cfg, train=False)
    eval_step = make_eval_step(cfg)
    trackers = [tracking.SortTracker(max_age=2, min_hits=1, match_dist_m=2.0) for _ in range(2)]
    n_tracks = 0
    for chunk, n_real in plan:
        batch = collate([ds[i] for i in chunk])
        out = eval_step(state, batch)
        mask = np.arange(len(chunk)) < n_real
        rows = track_rows(trackers, *(out[k].numpy() for k in ("boxes", "scores", "valid")), mask, per_clip=True)
        for c, f in enumerate(chunk[:n_real]):
            assert written[f]["tracks"] == rows[c], f
            n_tracks += len(rows[c])
    assert n_tracks > 0


@pytest.mark.parametrize("flag", ["--quantize-head", "--quantize-encoder"])
def test_inference_cli_int8_flags_raise(flag, tmp_path):
    """The int8 serving paths are not ported: the flags raise and name
    their ROADMAP item, before any config is read."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-m", "vsta_tpu_torch.inference", "--config", str(tmp_path / "none.yaml"), flag],
                       capture_output=True, text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert r.returncode != 0 and "NotImplementedError" in r.stderr and "Queue 1 item 6" in r.stderr, r.stderr[-2000:]

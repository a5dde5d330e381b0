"""The port's export and serving CLIs on the CPU (``RUNTIME.DEVICE cpu``):
``python -m vsta_tpu_torch.export`` writes an artifact from a checkpoint,
``python -m vsta_tpu_torch.serve`` streams a synthetic tree through it, as
tests/test_serve.py drives the JAX package's ``serve.py``: per-frame JSON
with tracks, ``--clips``, ``--overlap`` identical to the synchronous
run, the stats line, and ``_batch_from_manifest``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from vsta_tpu_torch.config import from_dict
from vsta_tpu_torch.data.synthetic import generate_synthetic_wildtrack
from vsta_tpu_torch.serve import _batch_from_manifest
from vsta_tpu_torch.training.checkpoint import CheckpointManager
from vsta_tpu_torch.training.state import create_state

ROOT = Path(__file__).resolve().parents[1]
N_FRAMES = 6


def _cli(args, cwd, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, timeout=timeout, env=env,
                          cwd=str(cwd))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A 6-frame tree, a checkpoint of the tiny config and its artifact at
    batch 2, written by the export CLI."""
    tmp = tmp_path_factory.mktemp("serve")
    root = generate_synthetic_wildtrack(tmp / "wt", n_frames=N_FRAMES, n_views=2, n_people=3, img_hw=(108, 192))
    raw = {
        "DATA": {"BATCH_SIZE": 2, "IMG_SIZE": [3, 54, 96], "VIEWS": 2, "DATA_ROOT": str(root)},
        "MODEL": {"BACKBONE": "simple", "FEAT_DIM": 8, "OUT_INDEX": 1, "BEV_SIZE": [32, 12, 24],
                  "BEV_BOUNDS": [-12.0, 12.0, -6.0, 6.0], "BEV_PROJ_CH": 8, "WARP_IMPL": "fused"},
        "RUNTIME": {"DEVICE": "cpu", "NUM_WORKERS": 1, "OUTPUT_DIR": "out/", "USE_AMP": False},
        "EVAL": {"CONF_THRESH": 0.05, "NMS_DIST_M": 0.5, "MAX_DETS": 16},
        "TRACK": {"MAX_AGE": 2, "MIN_HITS": 1, "MATCH_DIST_M": 2.0},
    }
    cfg_path = tmp / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    state = create_state(from_dict(raw), seed=3, device="cpu", steps_per_epoch=1)
    CheckpointManager(str(tmp / "ckpt")).save("best", state, epoch=0, best_f1=0.0)
    artifact = tmp / "model.pt"
    r = _cli(["vsta_tpu_torch.export", "--config", str(cfg_path), "--checkpoint", str(tmp / "ckpt" / "best"),
              "--out", str(artifact), "--batch", "2", "--platform", "cpu"], tmp)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "[export]" in r.stdout and (tmp / "model.pt.json").exists()
    return tmp, cfg_path, artifact


def _stats(stdout):
    return json.loads([ln for ln in stdout.splitlines() if ln.startswith("[serve] ")][0][len("[serve] "):])


def _frames(out_dir):
    return {p.name: json.loads(p.read_text()) for p in sorted(Path(out_dir).glob("frame_*.json"))}


def test_serve_cli_streams_artifact(setup, tmp_path):
    """--limit 3 at batch 2: the second (timed) batch holds one real frame,
    and the per-frame stats count it alone."""
    _, _, artifact = setup
    out = tmp_path / "served"
    r = _cli(["vsta_tpu_torch.serve", "--artifact", str(artifact), "--track", "--out", str(out), "--warmup", "1",
              "--limit", "3"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    frames = _frames(out)
    assert len(frames) == 3
    assert all(set(d) == {"frame_idx", "boxes", "scores", "tracks"} for d in frames.values())
    stats = _stats(r.stdout)
    assert stats["frames"] == 3 and stats["batch"] == 2 and stats["overlap"] is False
    assert stats["batches_timed"] == 1 and stats["frames_timed"] == 1
    assert stats["latency_ms_mean"] > 0
    assert abs(stats["latency_ms_per_frame"] - stats["latency_ms_mean"]) < 0.02


def test_serve_cli_multi_clip(setup, tmp_path):
    """--clips 2: every JSON carries its clip, the two clips cover their
    contiguous windows; --clips 3 against a batch-2 artifact fails."""
    _, _, artifact = setup
    out = tmp_path / "served"
    r = _cli(["vsta_tpu_torch.serve", "--artifact", str(artifact), "--track", "--clips", "2", "--out", str(out)],
             tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    by_clip = {}
    for d in _frames(out).values():
        assert "clip" in d and "tracks" in d
        by_clip.setdefault(d["clip"], []).append(d["frame_idx"])
    assert sorted(by_clip) == [0, 1]
    assert sorted(by_clip[0]) == [0, 1, 2] and sorted(by_clip[1]) == [3, 4, 5]
    r = _cli(["vsta_tpu_torch.serve", "--artifact", str(artifact), "--track", "--clips", "3", "--out", str(out)],
             tmp_path)
    assert r.returncode != 0
    assert "must equal the artifact's frozen batch size" in r.stderr + r.stdout


def test_serve_cli_overlap_matches_sync(setup, tmp_path):
    """--overlap gives the same predictions and tracks as the synchronous
    run; only the timing's meaning changes."""
    _, _, artifact = setup
    outs = {}
    for mode, extra in (("sync", []), ("overlap", ["--overlap"])):
        out = tmp_path / mode
        r = _cli(["vsta_tpu_torch.serve", "--artifact", str(artifact), "--track", "--out", str(out)] + extra, tmp_path)
        assert r.returncode == 0, r.stderr[-2000:]
        stats = _stats(r.stdout)
        assert stats["frames"] == N_FRAMES and stats["overlap"] == (mode == "overlap")
        outs[mode] = _frames(out)
    assert len(outs["sync"]) == N_FRAMES
    assert outs["sync"] == outs["overlap"]


def test_export_cli_int8_flags(setup, tmp_path):
    """--quantize-head exports an int8 artifact that serves; --quantize-encoder
    on the simple backbone raises the JAX package's ValueError."""
    tmp, cfg_path, _ = setup
    ckpt = str(tmp / "ckpt" / "best")
    q = tmp_path / "q.pt"
    r = _cli(["vsta_tpu_torch.export", "--config", str(cfg_path), "--checkpoint", ckpt, "--out", str(q), "--batch",
              "2", "--platform", "cpu", "--quantize-head", "--calib-batches", "1"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[quant] int8 head calibrated on 1 batches" in r.stdout
    r = _cli(["vsta_tpu_torch.serve", "--artifact", str(q), "--out", str(tmp_path / "q_out"), "--limit", "2"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert _stats(r.stdout)["frames"] == 2
    r = _cli(["vsta_tpu_torch.export", "--config", str(cfg_path), "--checkpoint", ckpt, "--out",
              str(tmp_path / "e.pt"), "--platform", "cpu", "--quantize-encoder"], tmp_path)
    assert r.returncode != 0 and "ValueError" in r.stderr and "resnet family" in r.stderr, r.stderr[-2000:]


def test_serve_batch_from_manifest():
    assert _batch_from_manifest({"in_avals": ["uint8[3,7,270,480,3]"]}, 1) == 3
    assert _batch_from_manifest({}, 5) == 5

"""The recorded-accuracy harnesses of the port on the CPU:
``python -m vsta_tpu_torch.train_synthetic_e2e`` and ``python -m
vsta_tpu_torch.bench_serve_e2e``, against their JAX twins
``scripts/train_synthetic_e2e.py`` and ``scripts/bench_serve_e2e.py``
(loaded by file path).

- ``score_mot`` of both on the same frame JSONs: equal dicts (the port
  keeps its own copy of the dataset reader and the MOT accumulator, the
  same float64 arithmetic).
- ``run_tracking_eval`` of both on one tiny synthetic tree (the ``simple``
  backbone, the shapes of tests/test_scripts.py), from the same random
  weights (JAX's initial state, moved through convert.py), each restored
  from a checkpoint of its own package: the held-out frames' detections
  through SORT and MotAccumulator give the same MOT summary, counts
  exactly and the ratios within 1e-9 (the detections differ by float32
  rounding; no score lies within 1e-3 of ``EVAL.CONF_THRESH``, so
  rounding decides no detection).
- The slice end to end: ``train_synthetic_e2e --track`` on a tiny config
  (``RUNTIME.DEVICE: cpu``, 8 frames, 1 epoch) in this process, then
  ``bench_serve_e2e --clips 1,2 --limit 4 --device cpu`` on its
  checkpoint as two subprocesses at once, ``--overlap`` off and on: the
  result lines carry exactly the JAX scripts' keys, the MOT numbers of
  both runs are equal, and every served frame is scored. Each export and
  serve CLI appends its kernel launches to ``VSTA_TORCH_LAUNCH_LOG`` at
  exit: none on the CPU.
- No fallback: without a card both harnesses raise on a config that names
  the accelerator; a failed CLI or a missing ``[serve]`` line raises.
"""

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import yaml

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)
from vsta_tpu_torch import bench_serve_e2e, kernels, train_synthetic_e2e
from vsta_tpu_torch.config import from_dict
from vsta_tpu_torch.data.synthetic import generate_synthetic_wildtrack

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 8
IMG_HW = (108, 192)
# no heatmap score of JAX's initial weights over the tree (0.023 to 0.259)
# lies within 1e-3 of it (the nearest, 2.4e-3 away)
CONF = 0.229


def tiny_raw(root, views=7, conf=CONF):
    """The JAX CLI test's tiny config (tests/test_scripts.py) on ``root``."""
    return {
        "DATA": {"BATCH_SIZE": 2, "IMG_SIZE": [3, 54, 96], "VIEWS": views, "DATA_ROOT": str(root)},
        "MODEL": {"BACKBONE": "simple", "FEAT_DIM": 8, "OUT_INDEX": 1, "BEV_SIZE": [32, 12, 24],
                  "BEV_BOUNDS": [-12.0, 12.0, -6.0, 6.0], "BEV_PROJ_CH": 8},
        "TRAIN": {"EPOCHS": 1, "LR": 0.001},
        "LOSS": {"MAX_OBJECTS": 8},
        "RUNTIME": {"DEVICE": "cpu", "NUM_WORKERS": 1, "SAVE_DIR": "ckpt/", "OUTPUT_DIR": "out/", "USE_AMP": False},
        "EVAL": {"CONF_THRESH": conf, "NMS_DIST_M": 0.5, "INTERVAL": 1, "MAX_DETS": 16},
    }


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def literal_keys(name, target):
    """The constant keys of the dict literal assigned to ``target`` in the
    JAX script ``scripts/<name>.py``."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == target for t in node.targets)):
            return {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
    raise AssertionError(f"no dict literal {target} in scripts/{name}.py")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return generate_synthetic_wildtrack(tmp_path_factory.mktemp("e2e") / "wt", n_frames=FRAMES, n_views=7,
                                        n_people=12, img_hw=IMG_HW, seed=11)


def test_score_mot_matches_jax(tree, tmp_path):
    """Two clips of frame JSONs as the serve CLI writes them: the ground
    truth moved by noise, one person missed a frame, a false positive and
    an identity swap in clip 1."""
    from vsta_tpu import config as jcfg
    from vsta_tpu_torch.data.wildtrack import WildtrackDataset

    raw = tiny_raw(tree)
    ds = WildtrackDataset(from_dict(raw), train=False)
    rng = np.random.default_rng(3)
    for i in range(FRAMES):
        ids, xy = ds.ids_per_frame[i], ds.centers_per_frame[i]
        keep = np.arange(len(ids)) != (i % len(ids))
        hyp_xy = xy[keep] + rng.normal(0.0, 0.1, (int(keep.sum()), 2))
        hyp_ids = [int(k) + 100 for k in ids[keep]]
        if i >= FRAMES // 2 + 2 and len(hyp_ids) > 1:
            hyp_ids[0], hyp_ids[1] = hyp_ids[1], hyp_ids[0]
        tracks = [{"id": k, "xy": [float(a), float(b)]} for k, (a, b) in zip(hyp_ids, hyp_xy)]
        if i % 3 == 0:
            tracks.append({"id": 999, "xy": [float(rng.uniform(-10, 10)), 0.0]})
        frame = {"frame_idx": i, "boxes": [], "scores": [], "tracks": tracks, "clip": int(i >= FRAMES // 2)}
        (tmp_path / f"frame_{i:05d}.json").write_text(json.dumps(frame))
    got = bench_serve_e2e.score_mot(tmp_path, from_dict(raw), 2)
    want = jax_script("bench_serve_e2e").score_mot(tmp_path, jcfg.from_dict(raw), 2)
    assert got == want
    assert got[0]["n_gt"] > 0 and got[0]["frames_scored"] == FRAMES and got[0]["id_switches"] > 0


def test_track_scoring_matches_jax(tree, tmp_path):
    """``run_tracking_eval`` of both harnesses on the tree's frames in
    order, from JAX's initial weights (each package's own checkpoint)."""
    import jax

    from vsta_tpu import config as jcfg
    from vsta_tpu.parallel.mesh import make_mesh
    from vsta_tpu.training.checkpoint import CheckpointManager as JCheckpointManager
    from vsta_tpu.training.optim import build_optimizer
    from vsta_tpu.training.state import create_state as jcreate_state
    from vsta_tpu_torch.convert import state_dict_from_flax
    from vsta_tpu_torch.training.checkpoint import CheckpointManager
    from vsta_tpu_torch.training.state import create_state

    raw = tiny_raw(tree)
    jc, tc = jcfg.from_dict(raw), from_dict(raw)
    mesh = make_mesh(jc.runtime.mesh_data, jc.runtime.mesh_view, batch_size=jc.data.batch_size, views=jc.data.views)
    jstate = jcreate_state(jc, build_optimizer(jc, 1), jax.random.PRNGKey(0), mesh=mesh)
    JCheckpointManager(str(tmp_path / "jax" / "ckpt")).save("best", jstate, epoch=0, best_f1=0.0)
    sd = state_dict_from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    state = create_state(tc, sd, device="cpu", steps_per_epoch=1)
    CheckpointManager(str(tmp_path / "port" / "ckpt")).save("best", state, epoch=0, best_f1=0.0)

    val_idx = list(range(FRAMES))
    want = jax_script("train_synthetic_e2e").run_tracking_eval(jc, tmp_path / "jax", val_idx)
    got = train_synthetic_e2e.run_tracking_eval(tc, tmp_path / "port", val_idx)
    assert got.keys() == want.keys()
    for k in ("id_switches", "misses", "false_positives", "matches", "n_gt"):
        assert got[k] == want[k], k
    for k in ("mota", "motp", "idf1"):
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    assert want["matches"] > 0 and want["false_positives"] > 0

    # the margin the tolerance rests on: every score the port's eval step
    # gives these frames lies 1e-3 or more from the threshold
    from vsta_tpu_torch.data.wildtrack import WildtrackDataset, collate
    from vsta_tpu_torch.training.state import batch_to_device, make_eval_step

    ds = WildtrackDataset(tc, train=False)
    step = make_eval_step(tc)
    for i in range(0, FRAMES, 4):
        hm = step(state, batch_to_device(collate([ds[j] for j in range(i, i + 4)]), "cpu"))["heatmap"].numpy()
        assert np.abs(hm - CONF).min() >= 1e-3


def _serve_rows(stdout):
    rows = [json.loads(m) for m in re.findall(r"^\[serve-e2e\] (\{.*\})$", stdout, re.MULTILINE)]
    per_clip = re.findall(r"^\[serve-e2e\] per-clip: (\{.*\})$", stdout, re.MULTILINE)
    return rows, per_clip


def test_slice_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    """train_synthetic_e2e --track, then bench_serve_e2e on its
    checkpoint, synchronous and --overlap."""
    from vsta_tpu.tracking.metrics import MotAccumulator as JMotAccumulator

    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(tiny_raw("unused", conf=0.05)))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # ScalarLogger writes scalars.jsonl alone
    summary = train_synthetic_e2e.main([
        "--config", str(cfg_path), "--frames", str(FRAMES), "--epochs", "1", "--batch", "2",
        "--img_hw", "x".join(map(str, IMG_HW)), "--track", "--work_dir", str(tmp_path / "run"),
    ])
    text = capsys.readouterr().out
    root = tmp_path / f"vsta_e2e_{FRAMES}f_{IMG_HW[0]}x{IMG_HW[1]}"
    assert (root / ".complete").exists()
    lines = {tag: json.loads(m) for tag, m in re.findall(r"^\[(e2e-result|track-result)\] (\{.*\})$", text, re.MULTILINE)}
    assert lines["e2e-result"] == summary
    mot_keys = set(JMotAccumulator(match_dist=1.0).summary())
    assert set(lines["track-result"]) == mot_keys
    metric_keys = set(summary) - literal_keys("train_synthetic_e2e", "summary") - {f"track_{k}" for k in mot_keys}
    assert {"moda", "modp", "f1", "mle", "best_f1"} <= metric_keys
    assert set(summary) == literal_keys("train_synthetic_e2e", "summary") | metric_keys | {f"track_{k}" for k in mot_keys}
    assert summary["track_n_gt"] > 0 and all(np.isfinite(float(v)) for k, v in summary.items() if k not in
                                             ("config", "backbone", "norm", "fusion", "warp_impl"))
    records = [json.loads(x) for x in (tmp_path / "run" / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    assert records[-1] == {"tracking": {k: records[-1]["tracking"][k] for k in mot_keys}, "val_frames": 2}

    cmd = [sys.executable, "-m", "vsta_tpu_torch.bench_serve_e2e", "--checkpoint", str(tmp_path / "run" / "ckpt" / "best"),
           "--config", str(cfg_path), "--data", str(root), "--clips", "1,2", "--limit", "4", "--device", "cpu"]
    env = {**os.environ, "TMPDIR": str(tmp_path), kernels.LAUNCH_LOG_ENV: str(tmp_path / "launches.jsonl")}
    procs = [subprocess.Popen(cmd + extra, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env)
             for extra in ([], ["--overlap"])]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    (sync, sync_clips), (over, over_clips) = (_serve_rows(out) for out, _ in outs)
    keys = literal_keys("bench_serve_e2e", "row")
    assert [r["clips"] for r in sync] == [r["clips"] for r in over] == [1, 2]
    for a, b in zip(sync, over):
        assert set(a) == set(b) == keys
        assert (a["overlap"], b["overlap"]) == (False, True) and a["device"] == "cpu"
        assert a["frames"] == b["frames"] == 4
        for k in ("mota", "idf1", "motp_m", "id_switches"):
            assert a[k] == b[k], k
            assert np.isfinite(a[k])
    assert len(sync_clips) == len(over_clips) == 1 and json.loads(sync_clips[0]) == json.loads(over_clips[0])
    assert sum(c["n_gt"] for c in json.loads(sync_clips[0]).values()) > 0
    assert "| clips | MOTA | IDF1 |" in outs[0][0]
    # every export and serve CLI logged its launches at exit: none on the
    # CPU, where each wrapper takes its plain version
    logged = [json.loads(x) for x in (tmp_path / "launches.jsonl").read_text().splitlines()]
    clis = [rec for rec in logged if rec["argv"][0].endswith(("export.py", "serve.py"))]
    assert len(clis) == 8 and set(logged[0]["launches"]) == set(kernels.launch_counts())
    assert all(n == 0 for rec in logged for n in rec["launches"].values())


def test_no_fallback_and_failed_cli_raise(tmp_path, monkeypatch):
    """Without a card a config that names the accelerator raises in both
    harnesses before any work; a CLI that exits non-zero, or a serve run
    without its ``[serve]`` line, raises."""
    import torch

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the harnesses' temporary directories
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_synthetic_e2e.main(["--config", str(ROOT / "configs" / "wildtrack.yaml"), "--data_root", str(tmp_path)])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_serve_e2e.main(["--checkpoint", str(tmp_path / "best"), "--data", str(tmp_path)])
    with pytest.raises(SystemExit, match="rc=2"):
        bench_serve_e2e.run_cli(["vsta_tpu_torch.serve", "--no-such-flag"], "serve")
    monkeypatch.setattr(bench_serve_e2e, "run_cli", lambda cmd, label: "[export] done\n")
    with pytest.raises(SystemExit, match=r"no \[serve\] stats line"):
        bench_serve_e2e.main(["--checkpoint", str(tmp_path / "best"), "--data", str(tmp_path), "--device", "cpu",
                              "--clips", "1"])

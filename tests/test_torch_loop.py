"""The port's training loop against the JAX package's, on the CPU: the
``simple`` backbone, the detection metrics, checkpoints with resume,
``run_training`` and the train/evaluate CLIs.

Model: the JAX CLI test's tiny config (tests/test_scripts.py: ``simple``
backbone, FEAT_DIM 8, 2 views at 54x96, BEV 12x24, f32) on a synthetic
tree of 10 frames at 108x192 (8 train / 2 val).

Tolerances: the backbone's features to 1e-5 (f32 convolutions summed in
another order); per-step losses of the two loops to rtol 1e-4, the
tolerance tests/test_torch_train.py holds the train step to; the loops'
returned metrics: counts exactly, the distance-based ones (MLE, MODP) and
the train loss to rtol 1e-4; checkpoints bit for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vsta_tpu import config as jcfg
from vsta_tpu.data.synthetic import generate_synthetic_wildtrack, make_ring_camera
from vsta_tpu.models.encoders.encoder import ViewEncoder as JViewEncoder
from vsta_tpu.models.encoders.simple import SimpleConvFeatures as JSimple
from vsta_tpu.parallel.mesh import make_mesh
from vsta_tpu.training import loop as jloop
from vsta_tpu.training import metrics as jmetrics
from vsta_tpu.training import optim as joptim
from vsta_tpu.training import state as jstate
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.convert import state_dict_from_flax
from vsta_tpu_torch.models.bevnet import BEVNet
from vsta_tpu_torch.models.encoders.encoder import ViewEncoder
from vsta_tpu_torch.training import loop as tloop
from vsta_tpu_torch.training import metrics as tmetrics
from vsta_tpu_torch.training.checkpoint import CheckpointManager
from vsta_tpu_torch.training.state import create_state, make_train_step

ROOT = Path(__file__).resolve().parent.parent
N_FRAMES = 10
# no score of the two trained models' val heatmaps lies within 1e-4 of it
# (test_run_training_matches_jax prints the margin)
CONF_THRESH = 0.177


def tiny_raw(root, **over):
    raw = {
        "DATA": {"BATCH_SIZE": 2, "IMG_SIZE": [3, 54, 96], "VIEWS": 2, "DATA_ROOT": str(root)},
        "MODEL": {"BACKBONE": "simple", "FEAT_DIM": 8, "OUT_INDEX": 1, "BEV_SIZE": [32, 12, 24],
                  "BEV_BOUNDS": [-12.0, 12.0, -6.0, 6.0], "BEV_PROJ_CH": 8},
        "TRAIN": {"EPOCHS": 1, "LR": 0.001},
        "LOSS": {"MAX_OBJECTS": 8},
        "RUNTIME": {"DEVICE": "cpu", "NUM_WORKERS": 1, "SAVE_DIR": "ckpt/", "OUTPUT_DIR": "out/",
                    "USE_AMP": False, "DEBUG_MAX_STEPS": 2},
        "EVAL": {"CONF_THRESH": CONF_THRESH, "NMS_DIST_M": 0.5, "INTERVAL": 1, "MAX_DETS": 16},
    }
    for k, v in over.items():
        raw[k] = {**raw[k], **v}
    return raw


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return generate_synthetic_wildtrack(
        tmp_path_factory.mktemp("wt") / "wt", n_frames=N_FRAMES, n_views=2, n_people=3, img_hw=(108, 192)
    )


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), jax.tree.map(np.asarray, dict(tree)))


# -- the simple backbone ---------------------------------------------------


def test_simple_backbone_features_match_jax(rng):
    """Every pyramid level (one map, five times) and the encoder's
    projected output, from the Flax parameters converted by convert.py."""
    x = rng.standard_normal((3, 54, 96, 3)).astype(np.float32)
    raw = tiny_raw("unused")
    jm = JViewEncoder(backbone="simple", feat_dim=8, out_index=1)
    images = x.reshape(1, 3, 54, 96, 3)
    v = jm.init(jax.random.PRNGKey(4), images)
    v = {"params": {k: dict(p) for k, p in _np(v["params"]).items()}}
    for p in v["params"].values():  # non-zero biases
        if "bias" in p:
            p["bias"] = rng.standard_normal(p["bias"].shape).astype(np.float32)
    for p in v["params"]["backbone"].values():
        p["bias"] = rng.standard_normal(p["bias"].shape).astype(np.float32)
    want_levels = JSimple(out_channels=8).apply({"params": v["params"]["backbone"]}, x)
    want = jm.apply(v, images)

    model = BEVNet.from_config(tcfg.from_dict(raw))
    sd = state_dict_from_flax({"params": {**_np(model_params_stub(raw)), "encoder": v["params"]}})
    enc = ViewEncoder("simple", feat_dim=8, out_index=1)
    enc.load_state_dict({k[len("encoder."):]: t for k, t in sd.items() if k.startswith("encoder.")})
    with torch.no_grad():
        levels = enc.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = enc(torch.from_numpy(images))
    assert len(levels) == len(want_levels) == 5
    for lvl, w in zip(levels, want_levels):
        np.testing.assert_allclose(lvl.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert got.shape == want.shape == (1, 3, 14, 24, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert model.encoder.backbone.conv1.out_channels == 8 and "encoder.backbone.conv0.weight" in sd


def model_params_stub(raw):
    """A whole tiny Flax BEVNet's parameters (the converter maps the tree
    as a whole)."""
    from vsta_tpu.models import BEVNet as JBEVNet

    m = JBEVNet.from_config(jcfg.from_dict(raw))
    z = np.zeros((2, 2, 54, 96, 3), np.float32)
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 2, 4, 4))
    v = jax.jit(m.init)(jax.random.PRNGKey(0), z, eye[..., :3, :3], eye)
    assert "batch_stats" not in v  # no BatchNorm in the simple model
    return v["params"]


@pytest.mark.parametrize("over", [{"NORM": "group", "BACKBONE": "efficientnet_b0"}, {"BACKBONE": "resnet18"}])
def test_resnets_build_and_group_norm_needs_one(over):
    """MODEL.NORM group on EfficientNet-B0 raises ValueError, as in the JAX
    package; a ResNet builds (once it raised NotImplementedError)."""
    cfg = tcfg.from_dict(tiny_raw("unused", MODEL=over))
    if "NORM" in over:
        with pytest.raises(ValueError, match="only supported for resnet"):
            BEVNet.from_config(cfg)
        return
    assert type(BEVNet.from_config(cfg).encoder.backbone).__name__ == "ResNetFeatures"


# -- metrics ----------------------------------------------------------------


def test_greedy_match_and_summary_match_jax(rng):
    frames = []
    for f in range(6):
        n_gt, n_pred = int(rng.integers(0, 6)), int(rng.integers(0, 7))
        gt = rng.uniform(-5, 5, (n_gt, 2)).astype(np.float32)
        pred = np.concatenate([gt[: n_pred // 2] + rng.normal(0, 0.3, (min(n_gt, n_pred // 2), 2)),
                               rng.uniform(-5, 5, (n_pred - min(n_gt, n_pred // 2), 2))]).astype(np.float32)
        frames.append((pred, gt))
    frames.append((np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32)))
    for pred, gt in frames:
        assert tmetrics.greedy_match(pred, gt, 0.5) == jmetrics.greedy_match(pred, gt, 0.5)
    a, b = tmetrics.DetectionMetrics(match_dist=0.5), jmetrics.DetectionMetrics(match_dist=0.5)
    for pred, gt in frames:
        a.update(pred, gt)
        b.update(pred, gt)
    # a padded batch: the masked row is not scored
    boxes = rng.uniform(-5, 5, (3, 4, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    valid = rng.uniform(0, 1, (3, 4)) > 0.4
    gt = boxes + rng.normal(0, 0.2, boxes.shape).astype(np.float32)
    mask = np.array([True, True, False])
    a.update_batch(boxes, scores, valid, gt, np.array([4, 2, 3]), mask)
    b.update_batch(boxes, scores, valid, gt, np.array([4, 2, 3]), mask)
    got, want = a.summary(), b.summary()
    assert got == want and got["n_frames"] == 9.0 and 0 < got["tp"] < got["tp"] + got["fp"]
    empty = tmetrics.DetectionMetrics().summary()
    assert empty.keys() == jmetrics.DetectionMetrics().summary().keys() and np.isnan(empty["f1"])


# -- checkpoints ------------------------------------------------------------


def _batch(seed, B=2, V=2, H=54, W=96):
    r = np.random.default_rng(seed)
    Ks, Rts = zip(*(make_ring_camera(v, V, radius=10.0, height=4.0, img_hw=(H, W)) for v in range(V)))
    boxes = np.zeros((B, 8, 4), np.float32)
    boxes[:, :4, :2] = r.uniform(-5, 5, (B, 4, 2))
    boxes[:, :4, 2:] = 0.6
    return {"images": r.integers(0, 256, (B, V, H, W, 3), dtype=np.uint8),
            "K": np.broadcast_to(np.stack(Ks), (B, V, 3, 3)).astype(np.float32),
            "Rt": np.broadcast_to(np.stack(Rts), (B, V, 4, 4)).astype(np.float32),
            "boxes_world": boxes, "num_boxes": np.array([4, 3], np.int32)}


def _full_state(state):
    opt = state.opt_state
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"acc.{k}": v for k, v in opt.acc.items()})
    inner = opt.inner.state_dict()
    for i, s in inner["state"].items():
        out.update({f"adam.{i}.{k}": torch.as_tensor(v) for k, v in s.items()})
    return out, (opt.mini_step, opt.count, state.step, inner["param_groups"][0]["lr"])


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """Three calls, save, a fresh state restored, one call: bit for bit the
    state of four uninterrupted calls (ACCUM_STEPS 2: the third call's
    gradients wait in the accumulator at the save, Adam has moved once),
    model, Adam moments and step, accumulator, counts."""
    cfg = tcfg.from_dict(tiny_raw("unused", TRAIN={"ACCUM_STEPS": 2}))
    batches = [_batch(s) for s in range(4)]
    step = make_train_step(cfg)
    a = create_state(cfg, seed=3, device="cpu", steps_per_epoch=2)
    for b in batches[:3]:
        step(a, b)
    assert a.opt_state.mini_step == 1 and a.opt_state.count == 1
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save("last", a, epoch=4, best_f1=0.25)
    assert ckpt.exists("last") and sorted(os.listdir(tmp_path / "ckpt")) == ["last"]
    step(a, batches[3])

    b_state = create_state(cfg, seed=9, device="cpu", steps_per_epoch=2)
    b_state, epoch, best = CheckpointManager(str(tmp_path / "ckpt")).restore("last", b_state)
    assert (epoch, best, b_state.step) == (4, 0.25, 3)
    step(b_state, batches[3])
    want, want_counts = _full_state(a)
    got, got_counts = _full_state(b_state)
    assert got.keys() == want.keys() and got_counts == want_counts
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert any(k.startswith("adam.") and k.endswith("exp_avg") for k in got)


def test_checkpoint_refuses_another_config(tmp_path):
    cfg = tcfg.from_dict(tiny_raw("unused"))
    state = create_state(cfg, seed=0, device="cpu", steps_per_epoch=1)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("best", state, epoch=0, best_f1=0.5)
    accum = create_state(tcfg.from_dict(tiny_raw("unused", TRAIN={"ACCUM_STEPS": 2})), device="cpu", steps_per_epoch=1)
    with pytest.raises(ValueError, match="accumulator"):
        ckpt.restore("best", accum)


# -- the loop ---------------------------------------------------------------


def _losses(save_dir):
    recs = [json.loads(s) for s in (save_dir / "scalars.jsonl").read_text().splitlines()]
    return [r["value"] for r in recs if r["tag"] == "train/loss_iter"]


def _val_scores(cfg, save_dir, tree):
    """Every val heatmap score of the port's trained model (the 'last'
    checkpoint), for the margin to CONF_THRESH."""
    from vsta_tpu_torch.data.pipeline import Prefetcher, split_train_val
    from vsta_tpu_torch.data.wildtrack import WildtrackDataset

    state = create_state(cfg, device="cpu", steps_per_epoch=1)
    CheckpointManager(str(save_dir)).restore("last", state)
    ds = WildtrackDataset(cfg)
    scores = []
    state.model.eval()
    for batch in Prefetcher(ds, split_train_val(len(ds), cfg.train.seed)[1], 2, device="cpu"):
        with torch.no_grad():
            out = state.model(batch["images"], batch["K"], batch["Rt"])
        scores.append(out["heatmap"].numpy()[batch["batch_mask"].numpy()])
    return np.concatenate([s.ravel() for s in scores])


def test_run_training_matches_jax(tree, tmp_path, capsys):
    """Both loops, two DEBUG_MAX_STEPS steps and one eval on the same tree
    from the same initial weights (JAX's create_state, converted)."""
    raw = tiny_raw(tree)
    jc, tc = jcfg.from_dict(raw), tcfg.from_dict(raw)
    want = jloop.run_training(jc, work_dir=str(tmp_path / "jax"))
    mesh = make_mesh(jc.runtime.mesh_data, jc.runtime.mesh_view, batch_size=2, views=2)
    jst = jstate.create_state(jc, joptim.build_optimizer(jc, 1), jax.random.PRNGKey(jc.train.seed), mesh=mesh)
    sd = state_dict_from_flax({"params": _np(jst.params)})
    got = tloop.run_training(tc, work_dir=str(tmp_path / "port"), state_dict=sd)
    out = capsys.readouterr().out
    assert "[first-batch]" in out and out.count("phase=eval") == 2

    l_got, l_want = _losses(tmp_path / "port" / "ckpt"), _losses(tmp_path / "jax" / "ckpt")
    assert len(l_got) == len(l_want) == 2
    np.testing.assert_allclose(l_got, l_want, rtol=1e-4)
    assert l_got[0] != l_got[1]

    scores = _val_scores(tc, tmp_path / "port" / "ckpt", tree)
    margin = float(np.abs(scores - CONF_THRESH).min())
    with capsys.disabled():
        print(f"\n[loop parity] losses port {l_got} jax {l_want}; CONF_THRESH {CONF_THRESH} margin {margin:.3e} "
              f"over {scores.size} val scores (max {scores.max():.4f}); metrics {got}")
    assert margin > 1e-4
    assert got.keys() == want.keys()
    for k in want:
        if k in ("mle", "modp", "frame_mle", "train_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
        else:
            assert got[k] == want[k], k
    assert got["n_frames"] == 2.0 and got["tp"] > 0
    for name in ("last", "best", "metrics.jsonl", "learning_curves.json"):
        assert (tmp_path / "port" / "ckpt" / name).exists(), name


def _cli(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, timeout=600, env=env,
                          cwd=str(cwd))


def test_train_resume_and_evaluate_clis(tree, tmp_path):
    """python -m vsta_tpu_torch.train, then --resume for one more epoch,
    then .evaluate on the best checkpoint, all with RUNTIME.DEVICE cpu."""
    import yaml

    cfg1, cfg2 = tmp_path / "one.yaml", tmp_path / "two.yaml"
    cfg1.write_text(yaml.safe_dump(tiny_raw(tree)))
    cfg2.write_text(yaml.safe_dump(tiny_raw(tree, TRAIN={"EPOCHS": 2})))
    r = _cli(["vsta_tpu_torch.train", "--config", str(cfg1), "--work_dir", str(tmp_path)], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[first-batch]" in r.stdout and "[done]" in r.stdout and "[resume]" not in r.stdout
    r = _cli(["vsta_tpu_torch.train", "--config", str(cfg2), "--work_dir", str(tmp_path), "--resume"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[resume] from epoch 1" in r.stdout and "epoch=1" in r.stdout and "[done]" in r.stdout
    r = _cli(["vsta_tpu_torch.evaluate", "--config", str(cfg2), "--checkpoint", str(tmp_path / "ckpt" / "best"),
              "--split", "all"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    metrics = json.loads(r.stdout[r.stdout.index("{"):])
    assert metrics["n_frames"] == float(N_FRAMES) and set(metrics) >= {"precision", "recall", "f1", "moda", "modp"}
    r = _cli(["vsta_tpu_torch.evaluate", "--config", str(cfg2), "--quantize-head"], tmp_path)
    assert r.returncode != 0 and "item 6" in r.stderr


# -- utils --------------------------------------------------------------------


def test_without_matplotlib_and_tensorboard_the_loop_still_records(tmp_path, monkeypatch, capsys):
    """The card's host has no matplotlib: each plot prints one line, and
    the curves still reach learning_curves.json; without TensorBoard the
    scalars still reach scalars.jsonl."""
    from vsta_tpu_torch.utils.logging import ScalarLogger
    from vsta_tpu_torch.utils.visualization import save_bev_heatmap, save_learning_curves

    for name in ("matplotlib", "matplotlib.pyplot", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, name, None)
    save_learning_curves([3.0, 2.5], [0.1], str(tmp_path / "c" / "learning_curves.png"))
    save_bev_heatmap(np.zeros((1, 4, 6, 1)), str(tmp_path / "hm.png"))
    logger = ScalarLogger(str(tmp_path / "log"))
    logger.log("train/loss_iter", 1.5, 3)
    logger.close()
    out = capsys.readouterr().out
    assert out.count("matplotlib unavailable") == 2 and "TensorBoard unavailable" in out
    assert json.loads((tmp_path / "c" / "learning_curves.json").read_text()) == {"train_loss": [3.0, 2.5], "val_f1": [0.1]}
    assert not (tmp_path / "c" / "learning_curves.png").exists() and not (tmp_path / "hm.png").exists()
    rec = json.loads((tmp_path / "log" / "scalars.jsonl").read_text())
    assert (rec["tag"], rec["value"], rec["step"]) == ("train/loss_iter", 1.5, 3)


def test_telemetry_reads_no_device_on_the_cpu():
    from vsta_tpu_torch.utils import telemetry

    assert telemetry.max_device_memory_percent(torch.device("cpu")) is None
    assert telemetry.device_memory_stats(torch.device("cpu")) == {}
    assert set(telemetry.host_stats()) == {"cpu_percent", "ram_percent"}


def test_more_than_one_device_raises():
    cfg = tcfg.from_dict(tiny_raw("unused", RUNTIME={"MESH_DATA": 2}))
    with pytest.raises(NotImplementedError, match="Multi-device"):
        tloop.run_training(cfg, device="cpu")


def test_prediction_json_matches_jax(tmp_path, rng):
    from vsta_tpu.utils.visualization import save_predictions_json as jsave
    from vsta_tpu_torch.utils.visualization import save_predictions_json as tsave

    boxes = rng.uniform(-5, 5, (3, 4, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    valid = scores > 0.3
    kw = dict(frame_indices=[7, 8, 8], batch_mask=np.array([True, True, False]),
              tracks=[[{"id": 1}], [], []], clips=[0, 1, 1])
    jsave(boxes, scores, valid, str(tmp_path / "jax"), **kw)
    tsave(boxes, scores, valid, str(tmp_path / "port"), **kw)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) == ["frame_000007.json", "frame_000008.json"]
    for n in names:
        assert (tmp_path / "port" / n).read_text() == (tmp_path / "jax" / n).read_text()

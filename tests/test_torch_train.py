"""The training slice: vsta_tpu_torch's targets, losses, optimizer,
schedules and train step against the JAX package, f32 on the CPU.

The train step runs EfficientNet-B0 at 64x96 with 3 views on both sides
from the same weights (through convert.py), the JAX one as
vsta_tpu.training.state.make_train_step with the Pallas warp and the
grouped sampler's Pallas kernels in interpret mode. Compared after each
call: the four losses, grad_norm, every gradient, the parameters (the
stages past OUT_INDEX included: the L2 term moves them) and the BatchNorm
statistics.

Tolerance: 1e-4 of each tensor's largest magnitude plus 1e-5 (rtol 1e-4
for scalars), because convolutions sum in other orders on XLA and torch;
the 1e-5 covers gradients that are 0 up to rounding on both sides (a
BatchNorm bias ahead of a 1x1 conv and another BatchNorm). An updated
parameter is compared to 1e-4 of the learning rate plus 1e-4 of the
parameter: Adam's first steps are close to lr * sign(gradient). The
forwards agree to about 2e-6, and a ReLU input that close to 0 can land on
either side of the kink and move a gradient by far more: weights seeded 1
with batch 10 do that (2.6e-3 at the head's stem). The seeds below put no
ReLU input that close, and the gradients agree to 3e-5 or better.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vsta_tpu import config as jcfg
from vsta_tpu.data.synthetic import make_ring_camera
from vsta_tpu.models import BEVNet as JBEVNet
from vsta_tpu.models import bevnet as jbevnet
from vsta_tpu.ops import losses as jlosses
from vsta_tpu.ops import splat as jsplat
from vsta_tpu.ops import warp as jwarp
from vsta_tpu.training import optim as joptim
from vsta_tpu.training import state as jstate
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.convert import batch_stats_from_flax, params_from_flax, state_dict_from_flax
from vsta_tpu_torch.ops import losses as tlosses
from vsta_tpu_torch.ops import splat as tsplat
from vsta_tpu_torch.training import optim as toptim
from vsta_tpu_torch.training.state import create_state, make_eval_step, make_train_step

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


B, V, H, W = 2, 3, 64, 96
BOUNDS = (-12.0, 12.0, -4.0, 4.0)
BEV = (16, 48)
SPE = 2  # steps per epoch
WEIGHT_SEED, BATCH_SEED = 3, 20
RAW = {
    "DATA": {"BATCH_SIZE": B, "IMG_SIZE": [3, H, W], "VIEWS": V},
    "MODEL": {
        "BACKBONE": "efficientnet_b0", "FEAT_DIM": 48, "OUT_INDEX": 2,
        "BEV_SIZE": [32, *BEV], "BEV_BOUNDS": list(BOUNDS),
        "BEV_PROJ_CH": 48, "HEAD_MID1": 64, "HEAD_MID2": 32,
        "WARP_IMPL": "pallas", "FUSION": "concat",
    },
    "TRAIN": {
        "EPOCHS": 10, "LR": 1e-3, "OPT": "Adam", "WEIGHT_DECAY": 1e-4,
        "LR_SCHEDULER": "cosine_warm", "WARMUP_EPOCHS": 3, "ACCUM_STEPS": 1,
    },
    "LOSS": {"MAX_OBJECTS": 8},
    "RUNTIME": {"USE_AMP": False},
    "EVAL": {"CONF_THRESH": 0.3, "NMS_DIST_M": 1.0, "MAX_DETS": 16},
}
# BEV_PROJ_CH 48 > 40 + 1 raw channels: the warp-first branch, as the
# flagship (128 > 41); 32 takes the project-first branch
CASES = {
    "warp-first": ({}, 1),
    "warp-first-accum2": ({"TRAIN": {"ACCUM_STEPS": 2}}, 2),
    "project-first": ({"MODEL": {"BEV_PROJ_CH": 32}}, 1),
    "frozen-backbone": ({"TRAIN": {"FREEZE_BACKBONE": True}}, 1),
}


def _raw(over):
    raw = {k: dict(v) for k, v in RAW.items()}
    for k, v in over.items():
        raw[k].update(v)
    return raw


def _batch(seed):
    rng = np.random.default_rng(seed)
    Ks, Rts = zip(*(make_ring_camera(v, V, radius=10.0, height=4.0, img_hw=(H, W)) for v in range(V)))
    boxes = np.zeros((B, 8, 4), np.float32)
    n = 6
    boxes[:, :n, 0] = rng.uniform(-11.0, 11.0, (B, n))
    boxes[:, :n, 1] = rng.uniform(-3.5, 3.5, (B, n))
    boxes[:, :n, 2:] = rng.uniform(0.4, 1.2, (B, n, 2))
    boxes[:, 0, :2] = [0.0, 0.0]  # on a cell corner
    boxes[:, 1, :2] = [13.0, 1.0]  # outside the bounds
    boxes[0, 2, :2] = [-12.0, -4.0]  # on the lower bounds
    return {
        "images": rng.integers(0, 256, (B, V, H, W, 3)).astype(np.uint8),
        "K": np.broadcast_to(np.stack(Ks), (B, V, 3, 3)).astype(np.float32),
        "Rt": np.broadcast_to(np.stack(Rts), (B, V, 4, 4)).astype(np.float32),
        "boxes_world": boxes,
        "num_boxes": np.array([n, n - 1], np.int32),
    }


def _numpy_tree(tree, rng):
    """Numpy copy with random norm scales, 1-D biases and BatchNorm
    statistics, so that no parameter sits at 0 with a gradient that is 0
    only up to rounding (Adam's first step would amplify its sign)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _numpy_tree(v, rng)
            continue
        a = np.array(v, dtype=np.float32)
        if k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k == "mean" or (k == "bias" and a.ndim == 1):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[k] = a
    return out


def _tree_np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), jax.tree.map(np.asarray, dict(tree)))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Run the case's calls through both train steps. ``want``/``got`` hold,
    per call, (metrics, gradients, parameters, statistics) of JAX and of
    the port; ``initial`` the port's state dict before the first call."""
    over, calls = CASES[request.param]
    raw = _raw(over)
    cfg = jcfg.from_dict(raw)
    batches = [_batch(BATCH_SEED + i) for i in range(calls)]

    model = JBEVNet.from_config(cfg)
    b0 = batches[0]
    v = jax.jit(model.init)(jax.random.PRNGKey(0), b0["images"].astype(np.float32), b0["K"], b0["Rt"])
    v = _numpy_tree(_tree_np(v), np.random.default_rng(WEIGHT_SEED))
    tx = joptim.build_optimizer(cfg, steps_per_epoch=SPE)
    jst = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
        opt_state=tx.init(v["params"]), apply_fn=model.apply, tx=tx,
    )
    step = jstate.make_train_step(cfg)
    l, m = cfg.loss, cfg.model

    def grads_of(state, batch):  # the gradients make_train_step takes (its loss_fn)
        targets = jsplat.build_targets(
            batch["boxes_world"], batch["num_boxes"], bounds=m.bev_bounds, bev_hw=m.bev_size,
            min_overlap=l.gaussian_iou, min_radius=l.gaussian_min_radius,
        )

        def loss(params):
            out, _ = state.apply_fn(
                {"params": params, "batch_stats": state.batch_stats},
                batch["images"], batch["K"], batch["Rt"], train=True, mutable=["batch_stats"],
            )
            return jlosses.detection_loss(out, targets)["total_loss"]

        return jax.grad(loss)(state.params)

    fn = jax.jit(lambda s, b: (*step(s, b), grads_of(s, b)))
    jbevnet.FORCE_PALLAS_INTERPRET = True
    jwarp.FORCE_GROUPED_INTERPRET = True
    want = []
    try:
        for b in batches:
            jst, metrics, grads = fn(jst, b)
            want.append((
                {k: float(x) for k, x in metrics.items()},
                params_from_flax(_tree_np(grads)),
                params_from_flax(_tree_np(jst.params)),
                {k: t for k, t in batch_stats_from_flax(_tree_np(jst.batch_stats)).items()
                 if k.endswith(("running_mean", "running_var"))},
            ))
    finally:
        jbevnet.FORCE_PALLAS_INTERPRET = False
        jwarp.FORCE_GROUPED_INTERPRET = False

    tc = tcfg.from_dict(raw)
    state = create_state(tc, state_dict_from_flax(v), device="cpu", steps_per_epoch=SPE)
    initial = {k: t.clone() for k, t in state.model.state_dict().items()}
    train_step = make_train_step(tc)
    got = []
    captured = {}
    apply = state.tx.update

    def spy(opt_state, model, grads):  # keep each call's gradients
        captured["grads"] = {k: g.clone() for k, g in grads.items()}
        return apply(opt_state, model, grads)

    state.tx.update = spy
    for b in batches:
        metrics = train_step(state, b)
        sd = state.model.state_dict()
        got.append((
            {k: float(x) for k, x in metrics.items()},
            captured["grads"],
            {k: t.clone() for k, t in sd.items() if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))},
            {k: t.clone() for k, t in sd.items() if k.endswith(("running_mean", "running_var"))},
        ))
    eval_pair = None
    if request.param == "warp-first":  # the eval step once, on the trained state
        eval_batch = _batch(20)
        jbevnet.FORCE_PALLAS_INTERPRET = True
        try:
            want_eval = jax.jit(jstate.make_eval_step(cfg))(jst, eval_batch)
        finally:
            jbevnet.FORCE_PALLAS_INTERPRET = False
        eval_pair = (want_eval, make_eval_step(tc)(state, eval_batch))
    return SimpleNamespace(
        name=request.param, cfg=cfg, want=want, got=got, initial=initial, state=state, eval_pair=eval_pair
    )


def _close(got, want, what, atol_rel=1e-4):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    tol = atol_rel * float(np.abs(want).max()) + 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=tol, err_msg=what)


def test_train_step_losses_match_jax(case):
    want, got = case.want, case.got
    for i, (w, g) in enumerate(zip(want, got)):
        for k in ("heatmap_loss", "offset_loss", "size_loss", "total_loss"):
            np.testing.assert_allclose(g[0][k], w[0][k], rtol=1e-4, err_msg=f"call {i}: {k}")
        assert all(np.isfinite(x) for x in g[0].values())


def test_train_step_grad_norm_matches_jax(case):
    want, got = case.want, case.got
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g[0]["grad_norm"], w[0]["grad_norm"], rtol=1e-4, err_msg=f"call {i}")
        assert g[0]["grad_norm"] > 0


def test_train_step_gradients_match_jax(case):
    want, got = case.want, case.got
    for i, (w, g) in enumerate(zip(want, got)):
        assert g[1].keys() == w[1].keys()
        for k in w[1]:
            _close(g[1][k], w[1][k], f"call {i}: d/d {k}")


def test_train_step_updated_params_match_jax(case):
    """Parameters after each call. Adam's first step is lr * g / (|g| +
    eps) with g = gradient + weight_decay * parameter: where g is within
    the gradient rule's tolerance of 0, its sign is rounding noise, and
    those elements are held to one step of either sign, 2 * lr."""
    name, cfg, want, got, initial = case.name, case.cfg, case.want, case.got, case.initial
    lr, wd, accum = cfg.train.lr, cfg.train.weight_decay, cfg.train.accum_steps
    for i, (w, g) in enumerate(zip(want, got)):
        assert g[2].keys() == w[2].keys()
        window = want[i - i % accum : i + 1]  # the calls this update averages
        for k in w[2]:
            grad = np.mean([np.asarray(c[1][k]) for c in window], axis=0)
            noise = np.abs(grad + wd * initial[k].numpy()) <= 1e-4 * np.abs(grad).max() + 1e-5
            want_p, got_p = np.asarray(w[2][k]), g[2][k].numpy()
            np.testing.assert_allclose(
                got_p[~noise], want_p[~noise], rtol=1e-4, atol=1e-4 * lr, err_msg=f"call {i}: {k}"
            )
            assert np.all(np.abs(got_p - want_p)[noise] <= 2 * lr), f"call {i}: {k}"
    # with ACCUM_STEPS 2 the first call moves no parameter, the second does
    moved = [any(not torch.equal(g[2][k], initial[k]) for k in g[2]) for g in got]
    assert moved == ([False, True] if name.endswith("accum2") else [True])


def test_train_step_batch_stats_match_jax(case):
    name, want, got, initial = case.name, case.want, case.got, case.initial
    for i, (w, g) in enumerate(zip(want, got)):
        assert g[3].keys() == w[3].keys()
        for k in w[3]:
            _close(g[3][k], w[3][k], f"call {i}: {k}")
    stage6 = "encoder.backbone.stages.6.0.project_bn.running_mean"
    moved = not torch.equal(got[-1][3][stage6], initial[stage6])
    assert moved == (name != "frozen-backbone")


def test_train_step_moves_the_unused_stages(case):
    """Stages 3-6 get zero gradient, yet the L2 term moves them by about
    lr * warmup factor (Adam's first step), in JAX and in the port; a
    frozen backbone does not move at all."""
    name, want, got, initial, state = case.name, case.want, case.got, case.initial, case.state
    k = "encoder.backbone.stages.6.0.expand_conv.weight"
    assert not got[-1][1][k].any() and not want[-1][1][k].any()
    step = float((got[-1][2][k] - initial[k]).abs().max())
    if name == "frozen-backbone":
        assert step == 0.0
    else:
        lr0 = toptim.lr_schedule(tcfg.from_dict(RAW), SPE)(0)
        assert lr0 * 0.9 < step <= lr0 * 1.0001
    assert state.step == len(got)


@pytest.mark.parametrize("sched", ["step", "cosine_warm", "cosine"])
def test_lr_schedule_matches_optax(sched):
    raw = _raw({"TRAIN": {"LR_SCHEDULER": sched, "EPOCHS": 4, "WARMUP_EPOCHS": 2}})
    want = joptim.lr_schedule(jcfg.from_dict(raw), steps_per_epoch=3)
    got = toptim.lr_schedule(tcfg.from_dict(raw), steps_per_epoch=3)
    counts = list(range(0, 2 * 3 + 1)) + [30, 31, 400]  # two epochs, then past the step and the decay
    np.testing.assert_allclose([got(c) for c in counts], [float(want(c)) for c in counts], rtol=1e-6)


class _Two(torch.nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(a.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("opt,accum", [("Adam", 1), ("Adam", 2), ("adamw", 1)])
def test_optimizer_matches_optax_chain(rng, opt, accum):
    """Three updates of build_optimizer's chain (Adam + L2 term, AdamW;
    MultiSteps accumulation of 2) on two parameters, one with a zero
    gradient throughout, against the optax chain."""
    raw = _raw({"TRAIN": {"OPT": opt, "ACCUM_STEPS": accum, "WEIGHT_DECAY": 1e-2}})
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    tx = joptim.build_optimizer(jcfg.from_dict(raw), steps_per_epoch=1)
    params = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    ostate = tx.init(params)
    model = _Two(a, b)
    ttx = toptim.build_optimizer(tcfg.from_dict(raw), steps_per_epoch=1)
    tstate = ttx.init(model)
    for i in range(3 * accum):
        ga = rng.standard_normal((3, 4)).astype(np.float32)
        upd, ostate = tx.update({"a": jnp.asarray(ga), "b": jnp.zeros(5)}, ostate, params)
        params = optax.apply_updates(params, upd)
        moved = ttx.update(tstate, model, {"a": torch.from_numpy(ga), "b": torch.zeros(5)})
        assert moved == ((i + 1) % accum == 0)
        np.testing.assert_allclose(model.a.detach().numpy(), np.asarray(params["a"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(model.b.detach().numpy(), np.asarray(params["b"]), rtol=1e-5, atol=1e-7)
    assert not np.array_equal(model.b.detach().numpy(), b)  # the decay moved it


def test_build_targets_matches_jax():
    batch = _batch(3)
    boxes, num = batch["boxes_world"], batch["num_boxes"]
    boxes[1, 3] = [12.0, 4.0, 0.5, 0.5]  # on the upper bounds: outside
    kw = dict(bounds=BOUNDS, bev_hw=BEV, min_overlap=0.7, min_radius=2)
    want = jsplat.build_targets(jnp.asarray(boxes), jnp.asarray(num), **kw)
    got = tsplat.build_targets(torch.from_numpy(boxes), torch.from_numpy(num), **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == (torch.int32 if k == "indices" else torch.float32), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    hm = got["heatmap"].numpy()
    assert (hm == 1.0).sum() == int(got["mask"].sum())  # every valid centre exactly 1
    assert got["mask"].numpy().tolist() == np.asarray(want["mask"]).tolist()


def test_gaussian_radius_matches_jax(rng):
    w = rng.uniform(0.2, 30.0, 64).astype(np.float32)
    h = rng.uniform(0.2, 30.0, 64).astype(np.float32)
    for ov in (0.7, 0.0):
        want = jsplat.gaussian_radius(jnp.asarray(w), jnp.asarray(h), ov, 2)
        got = tsplat.gaussian_radius(torch.from_numpy(w), torch.from_numpy(h), ov, 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_detection_loss_matches_jax(rng):
    batch = _batch(4)
    kw = dict(bounds=BOUNDS, bev_hw=BEV, min_overlap=0.7, min_radius=2)
    targets = jsplat.build_targets(jnp.asarray(batch["boxes_world"]), jnp.asarray(batch["num_boxes"]), **kw)
    preds = {
        "heatmap_logits": rng.standard_normal((B, *BEV, 1)).astype(np.float32) * 3,
        "offset": rng.uniform(0, 1, (B, *BEV, 2)).astype(np.float32),
        "size_raw": rng.standard_normal((B, *BEV, 2)).astype(np.float32),
    }
    weights = dict(hm_alpha=2.0, hm_beta=4.0, hm_weight=1.0, offset_weight=1.0, size_weight=0.1)
    want = jlosses.detection_loss({k: jnp.asarray(v) for k, v in preds.items()}, targets, **weights)
    got = tlosses.detection_loss(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        {k: torch.from_numpy(np.array(v)) for k, v in targets.items()}, **weights,
    )
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["warp-first"], indirect=True)
def test_eval_step_matches_jax(case):
    """The eval step on the trained state (forward in eval mode, on the
    running statistics, and decode) against the JAX eval step."""
    want, got = case.eval_pair
    assert set(got) == set(want) == {"boxes", "scores", "valid", "heatmap"}
    assert not case.state.model.training
    np.testing.assert_allclose(got["heatmap"].numpy(), np.asarray(want["heatmap"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=1e-4, atol=1e-4)


def test_create_state_is_seeded_and_stays_on_the_cpu_when_asked():
    cfg = tcfg.from_dict(RAW)
    a = create_state(cfg, seed=3, device="cpu", steps_per_epoch=1)
    b = create_state(cfg, seed=3, device="cpu", steps_per_epoch=1)
    assert a.device.type == "cpu" and a.step == 0
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, bev_proj_ch=32))
    assert create_state(cfg32, device="cpu", steps_per_epoch=1).model.view_proj.shape[-1] == 32


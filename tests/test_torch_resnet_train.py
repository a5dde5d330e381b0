"""The train step of the three shipped ResNet configs (and the sanity
config with MODEL.NORM group), vsta_tpu_torch against the JAX package on
the CPU, float32, at the sizes of tests/test_torch_resnet_configs.py: one
call, two for ResNet-50's ACCUM_STEPS 2. Compared after each call: the
four losses, grad_norm, every gradient, the updated parameters and the
BatchNorm statistics of every stage (those past OUT_INDEX move too).

The gradients are held to JAX's own float64 result (the same model
cloned with ``dtype=float64`` under ``jax.enable_x64``, from the same
weights and batch), by each tensor's relative distance ||a - b|| / ||b||.
Element by element two float32 runs cannot agree here: a ReLU or max-pool
input within float32 rounding of its kink goes either way, and one such
decision in the head moves every upstream gradient (by about 2e-3 in the
sanity model with GroupNorm, where the port flips one and JAX none).
So each tensor is held to its own bound: the larger of 5e-3 and twice
the distance of JAX's float32 gradient of that tensor from float64 (and
grad_norm's relative error to the larger of 5e-3 and twice JAX's). JAX's
float32 tensors lie up to 1.25e-2 from float64 in ResNet-50 and up to
3.6e-3 in the sanity model. The port's largest distances, each beside its
tensor's bound: sanity 5.9e-6 (5e-3), ResNet-50 3.1e-3 (1.3e-2, the stem
norm's bias), ms_max 4.9e-4 (5e-3), sanity with GroupNorm 2.3e-3 (5e-3,
the one flipped kink above).

Other tolerances: losses rtol 1e-4 and statistics 1e-4 of the largest
magnitude plus 1e-5, against JAX's float32 step; an updated parameter
1e-4 of the learning rate, or one Adam step of either sign where its
gradient is within either package's float32 error of 0.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_resnet_configs import CONFIGS, _batch, _close, _init, _randomize, _raw, _tree_np
from vsta_tpu import config as jcfg
from vsta_tpu.ops import losses as jlosses
from vsta_tpu.ops import splat as jsplat
from vsta_tpu.training import optim as joptim
from vsta_tpu.training import state as jstate
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.convert import batch_stats_from_flax, params_from_flax, state_dict_from_flax
from vsta_tpu_torch.training.state import create_state, make_train_step

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


SPE = 2


def _loss_grads(cfg):
    """grads(model, params, batch_stats, batch): d total_loss / d params in
    training mode, as make_train_step's loss_fn takes them."""
    l, m = cfg.loss, cfg.model

    def grads(model, params, stats, batch):
        targets = jsplat.build_targets(batch["boxes_world"], batch["num_boxes"], bounds=m.bev_bounds,
                                       bev_hw=m.bev_size, min_overlap=l.gaussian_iou, min_radius=l.gaussian_min_radius)

        def loss(p):
            args = (batch["images"], batch["K"], batch["Rt"])
            if stats:
                out, _ = model.apply({"params": p, "batch_stats": stats}, *args, train=True, mutable=["batch_stats"])
            else:
                out = model.apply({"params": p}, *args, train=True)
            return jlosses.detection_loss(out, targets)["total_loss"]

        return jax.grad(loss)(params)

    return grads


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    """Per call: JAX's float32 (metrics, gradients, parameters, statistics),
    its float64 gradients, and the port's (metrics, gradients, parameters,
    statistics)."""
    raw = _raw(request.param, amp=False)
    cfg = jcfg.from_dict(raw)
    calls = cfg.train.accum_steps
    batches = [_batch(cfg, 20 + i) for i in range(calls)]
    model, v = _init(cfg)
    v = _randomize(v, np.random.default_rng(3))
    tx = joptim.build_optimizer(cfg, steps_per_epoch=SPE)
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v.get("batch_stats", {}),
                            opt_state=tx.init(v["params"]), apply_fn=model.apply, tx=tx)
    step = jstate.make_train_step(cfg)
    grads = _loss_grads(cfg)
    fn = jax.jit(lambda s, b: (*step(s, b), grads(model, s.params, s.batch_stats, b)))
    model64 = model.clone(dtype=jnp.float64)
    fn64 = jax.jit(lambda p, s, b: grads(model64, p, s, b))
    want, want64 = [], []
    for b in batches:
        with jax.enable_x64(True):
            f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
            g64 = fn64(f64(jst.params), f64(jst.batch_stats) if jst.batch_stats else None, b)
            want64.append(params_from_flax(jax.tree.map(np.asarray, g64)))
        jst, metrics, g = fn(jst, b)
        want.append((
            {k: float(x) for k, x in metrics.items()},
            params_from_flax(_tree_np(g)),
            params_from_flax(_tree_np(jst.params)),
            {k: t for k, t in batch_stats_from_flax(_tree_np(jst.batch_stats)).items()
             if k.endswith(("running_mean", "running_var"))} if jst.batch_stats else {},
        ))

    tc = tcfg.from_dict(raw)
    state = create_state(tc, state_dict_from_flax(v), device="cpu", steps_per_epoch=SPE)
    initial = {k: t.clone() for k, t in state.model.state_dict().items()}
    train_step = make_train_step(tc)
    captured = {}
    apply = state.tx.update

    def spy(opt_state, model, grads):
        captured["grads"] = {k: g.clone() for k, g in grads.items()}
        return apply(opt_state, model, grads)

    state.tx.update = spy
    got = []
    for b in batches:
        metrics = train_step(state, b)
        sd = state.model.state_dict()
        got.append((
            {k: float(x) for k, x in metrics.items()},
            captured["grads"],
            {k: t.clone() for k, t in sd.items() if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))},
            {k: t.clone() for k, t in sd.items() if k.endswith(("running_mean", "running_var"))},
        ))
    # per call and tensor: the bound on its distance from float64 (twice
    # JAX's own float32 distance, at least 5e-3) and the largest float32
    # error of either package against float64; per call the bound on
    # grad_norm's relative error, chosen the same way
    dist = lambda a, b: float((a.double() - b).norm() / max(float(b.norm()), 1e-30))  # noqa: E731
    bounds = [{k: max(5e-3, 2 * dist(c[1][k], w[k])) for k in w} for c, w in zip(want, want64)]
    norms64 = [float(torch.sqrt(sum(t.double().pow(2).sum() for t in w.values()))) for w in want64]
    norm_bounds = [max(5e-3, 2 * abs(c[0]["grad_norm"] - n) / n) for c, n in zip(want, norms64)]
    errs = [{k: max(float((c[1][k].double() - w[k]).abs().max()), float((o[1][k].double() - w[k]).abs().max()),
                    1e-4 * float(w[k].abs().max()) + 1e-5) for k in w}
            for c, o, w in zip(want, got, want64)]
    return SimpleNamespace(name=request.param, cfg=cfg, want=want, want64=want64, got=got, initial=initial,
                           bounds=bounds, norms64=norms64, norm_bounds=norm_bounds, errs=errs, dist=dist)


def test_train_step_losses_match_jax(case):
    for i, (w, g) in enumerate(zip(case.want, case.got)):
        for k in ("heatmap_loss", "offset_loss", "size_loss", "total_loss"):
            np.testing.assert_allclose(g[0][k], w[0][k], rtol=1e-4, err_msg=f"call {i}: {k}")
        assert all(np.isfinite(x) for x in g[0].values()) and g[0]["grad_norm"] > 0


def test_train_step_gradients_match_jax_float64(case):
    for i, (w, g) in enumerate(zip(case.want64, case.got)):
        assert g[1].keys() == w.keys() == case.want[i][1].keys()
        for k in w:
            d = case.dist(g[1][k], w[k])
            assert d <= case.bounds[i][k], (i, k, d, case.bounds[i][k])
        norm64 = case.norms64[i]
        assert abs(g[0]["grad_norm"] - norm64) <= case.norm_bounds[i] * norm64, (i, g[0]["grad_norm"], norm64)
    # the gradient reaches the first block's closing norm, whose scale Flax starts at 0
    assert case.want64[0]["encoder.backbone.stages.0.0.norms.1.weight"].abs().max() > 1e-6


def test_train_step_updated_params_and_stats_match_jax(case):
    cfg, lr, wd, accum = case.cfg, case.cfg.train.lr, case.cfg.train.weight_decay, case.cfg.train.accum_steps
    for i, (w, g) in enumerate(zip(case.want, case.got)):
        assert g[2].keys() == w[2].keys()
        calls = range(i - i % accum, i + 1)  # the calls this update averages
        for k in w[2]:
            grad = np.mean([case.want64[j][k].numpy() for j in calls], axis=0)
            near = max(case.errs[j][k] for j in calls)
            noise = np.abs(grad + wd * case.initial[k].double().numpy()) <= near
            want_p, got_p = np.asarray(w[2][k]), g[2][k].numpy()
            np.testing.assert_allclose(got_p[~noise], want_p[~noise], rtol=1e-4, atol=1e-4 * lr,
                                       err_msg=f"call {i}: {k}")
            assert np.all(np.abs(got_p - want_p)[noise] <= 2 * lr), f"call {i}: {k}"
        assert g[3].keys() == w[3].keys()
        for k in w[3]:
            _close(g[3][k], w[3][k], f"call {i}: {k}")
    moved = [any(not torch.equal(g[2][k], case.initial[k]) for k in g[2]) for g in case.got]
    assert moved == ([False, True] if accum == 2 else [True])
    last = "encoder.backbone.stages.3.1.norms.0.running_mean"
    if cfg.model.norm == "batch":
        assert not torch.equal(case.got[-1][3][last], case.initial[last])
    else:
        assert not case.got[-1][3]

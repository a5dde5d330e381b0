"""The deformable-attention family (FUSION: deform_attn): vsta_tpu_torch's
scaled sampler, DeformableFusion, the BEVNet branch and the train step
against the JAX package, on the CPU, weights through convert.py.

Sizes: EfficientNet-B0 at 64x96 with 3 views, BEV 25x41 (odd, so the
strided query grid has ceil(n / s) cells), 2 heads x 2 points,
ATTN_STRIDE 1 and 2. The JAX side runs the grouped sampler's Pallas
kernels in interpret mode (FORCE_GROUPED_INTERPRET), as its own tests do.

The Flax initialisation zeroes the kernels of the offsets and attention
heads, which would hide a broken dependence of the sampling on the query,
so every comparison loads random non-zero kernels there (offsets of about
a pixel: samples cross cell borders and leave the map); one test keeps the
initialisation to hold init_state_dict to it.

Tolerances: float32 forwards 1e-4 (convolutions sum in other orders on
XLA and torch); the sampler alone 1e-5; bfloat16 forwards are held to
3e-2 of the output's largest magnitude (both sides round at every layer
and the softmax is taken in other precisions). The train step uses the
rules of test_torch_train.py: 1e-4 of each tensor's largest magnitude
plus 1e-5 for gradients and statistics, rtol 1e-4 for scalars.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vsta_tpu import config as jcfg
from vsta_tpu.data.synthetic import make_ring_camera
from vsta_tpu.models import BEVNet as JBEVNet
from vsta_tpu.models import fusion as jfusion
from vsta_tpu.ops import losses as jlosses
from vsta_tpu.ops import splat as jsplat
from vsta_tpu.ops import warp as jwarp
from vsta_tpu.training import optim as joptim
from vsta_tpu.training import state as jstate
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.convert import (
    batch_stats_from_flax, init_state_dict, params_from_flax, state_dict_from_flax,
)
from vsta_tpu_torch.models import BEVNet
from vsta_tpu_torch.ops.resize import interp_matrix, resize_bilinear
from vsta_tpu_torch.models.fusion import DeformableFusion, ring_offsets
from vsta_tpu_torch.ops import grouped_cuda as gc
from vsta_tpu_torch.training.state import create_state, make_train_step

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


B, V, H, W = 2, 3, 64, 96
BOUNDS = (-12.0, 12.0, -4.0, 4.0)
BEV = (25, 41)
HEADS, POINTS = 2, 2
SPE = 2
RAW = {
    "DATA": {"BATCH_SIZE": B, "IMG_SIZE": [3, H, W], "VIEWS": V},
    "MODEL": {
        "BACKBONE": "efficientnet_b0", "FEAT_DIM": 16, "OUT_INDEX": 2,
        "BEV_SIZE": [32, *BEV], "BEV_BOUNDS": list(BOUNDS),
        "BEV_PROJ_CH": 32, "HEAD_MID1": 64, "HEAD_MID2": 32,
        "WARP_IMPL": "fused", "FUSION": "deform_attn",
        "ATTN_HEADS": HEADS, "ATTN_POINTS": POINTS, "ATTN_STRIDE": 2,
    },
    "TRAIN": {
        "EPOCHS": 10, "LR": 1e-3, "OPT": "Adam", "WEIGHT_DECAY": 1e-4,
        "LR_SCHEDULER": "cosine_warm", "WARMUP_EPOCHS": 3, "ACCUM_STEPS": 1,
    },
    "LOSS": {"MAX_OBJECTS": 8},
    "RUNTIME": {"USE_AMP": False},
    "EVAL": {"CONF_THRESH": 0.3, "NMS_DIST_M": 1.0, "MAX_DETS": 16},
}


def _raw(over):
    raw = {k: dict(v) for k, v in RAW.items()}
    for k, v in over.items():
        raw[k].update(v)
    return raw


@pytest.fixture
def grouped_interpret():
    jwarp.FORCE_GROUPED_INTERPRET = True
    try:
        yield
    finally:
        jwarp.FORCE_GROUPED_INTERPRET = False


def _batch(seed):
    rng = np.random.default_rng(seed)
    Ks, Rts = zip(*(make_ring_camera(v, V, radius=10.0, height=4.0, img_hw=(H, W)) for v in range(V)))
    boxes = np.zeros((B, 8, 4), np.float32)
    n = 6
    boxes[:, :n, 0] = rng.uniform(-11.0, 11.0, (B, n))
    boxes[:, :n, 1] = rng.uniform(-3.5, 3.5, (B, n))
    boxes[:, :n, 2:] = rng.uniform(0.4, 1.2, (B, n, 2))
    return {
        "images": rng.integers(0, 256, (B, V, H, W, 3)).astype(np.uint8),
        "K": np.broadcast_to(np.stack(Ks), (B, V, 3, 3)).astype(np.float32),
        "Rt": np.broadcast_to(np.stack(Rts), (B, V, 4, 4)).astype(np.float32),
        "boxes_world": boxes,
        "num_boxes": np.array([n, n - 1], np.int32),
    }


def _tree_np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), jax.tree.map(np.asarray, dict(tree)))


def _randomize(tree, rng):
    """Numpy copy with random norm scales, 1-D biases and BatchNorm
    statistics, as test_torch_train.py's."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(v, rng)
            continue
        a = np.array(v, dtype=np.float32)
        if k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k == "mean" or (k == "bias" and a.ndim == 1):
            a = a + (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[k] = a
    return out


def _wake_sampling_heads(params, rng):
    """Random non-zero kernels for the offsets and attention heads."""
    for name, scale in (("offsets", 0.3), ("attn", 0.5)):
        k = params[name]["kernel"]
        params[name]["kernel"] = (scale * rng.standard_normal(k.shape)).astype(np.float32)


def _variables(cfg, seed):
    """Flax variables of BEVNet.from_config(cfg) as numpy, norms and the
    sampling heads randomised."""
    model = JBEVNet.from_config(cfg)
    b = _batch(0)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), b["images"].astype(np.float32), b["K"], b["Rt"])
    rng = np.random.default_rng(seed)
    v = _randomize(_tree_np(v), rng)
    _wake_sampling_heads(v["params"]["deform_fusion"], rng)
    return model, v


# -- pieces ---------------------------------------------------------------


def _residual_upsample(res, size):
    """BEVNet's upsample of the f32 NHWC residual, as its forward calls it."""
    return resize_bilinear(res.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)


@pytest.mark.parametrize("src,dst", [((7, 11), (28, 44)), ((13, 21), (25, 41)), ((30, 90), (120, 360))])
def test_residual_upsample_matches_jax_image_resize(rng, src, dst):
    """The port's residual upsample (resize_bilinear, two products with
    fixed matrices, on the NHWC residual seen as NCHW) against
    jax.image.resize(bilinear), at an integer factor, at the
    factor 25/13 of an odd grid strided by 2, and at the flagship's; its
    matrices are JAX's weights bit for bit, and F.interpolate's (the op it
    replaced) within float32 rounding."""
    x = rng.standard_normal((2, *src, 5)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *dst, 5), method="bilinear")
    got = _residual_upsample(torch.from_numpy(x), dst)
    assert got.dtype == torch.float32 and got.shape == (2, *dst, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for n, m in zip(src, dst):
        jw = np.asarray(jax.image.resize(jnp.eye(n, dtype=jnp.float32), (n, m), method="bilinear")).T
        np.testing.assert_array_equal(interp_matrix(n, m).numpy(), jw)
        fw = F.interpolate(torch.eye(n)[None], size=m, mode="linear", align_corners=False)[0].t()
        np.testing.assert_allclose(interp_matrix(n, m).numpy(), fw.numpy(), atol=1e-5)


@pytest.mark.parametrize("src,dst", [((7, 11), (28, 44)), ((13, 21), (25, 41)), ((30, 90), (120, 360))])
def test_residual_upsample_vjp_matches_jax(rng, src, dst):
    """The upsample's backward (two products with the transposed matrices)
    against jax.vjp of jax.image.resize, at the same three sizes."""
    x = rng.standard_normal((2, *src, 5)).astype(np.float32)
    g = rng.standard_normal((2, *dst, 5)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax.image.resize(a, (2, *dst, 5), method="bilinear"), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(x).requires_grad_(True)
    _residual_upsample(leaf, dst).backward(torch.from_numpy(g))
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads,points", [(4, 4), (2, 2), (3, 1)])
def test_ring_offsets_match_jax(heads, points):
    np.testing.assert_array_equal(
        ring_offsets(heads, points).numpy(), np.asarray(jfusion._ring_offset_init(heads, points))
    )


def _sampler_inputs(rng, exact):
    G, Hf, Wf, C, S = 4, 6, 9, 8, 200
    coords = np.stack([rng.uniform(-1.5, Wf + 0.5, (G, S)), rng.uniform(-1.5, Hf + 0.5, (G, S))], -1).astype(np.float32)
    coords.reshape(-1, 2)[::37, 0] = np.nan
    coords.reshape(-1, 2)[5::41, 1] = np.inf
    if exact:  # bf16: products and sums exact in f32 (see test_torch_grouped.py)
        frac = rng.integers(1, 8, (G, S, 2)).astype(np.float32) / 8.0
        coords = np.where(np.isfinite(coords), np.floor(coords) + frac, coords).astype(np.float32)
        feats = rng.integers(-4, 5, (G, Hf, Wf, C)).astype(np.float32)
        scale = (rng.integers(1, 9, (G, S)) / 8.0).astype(np.float32)
        gout = rng.integers(-4, 5, (G, S, C)).astype(np.float32)
    else:
        feats = rng.standard_normal((G, Hf, Wf, C)).astype(np.float32)
        scale = rng.uniform(0.0, 1.0, (G, S)).astype(np.float32)
        gout = rng.standard_normal((G, S, C)).astype(np.float32)
    scale[:, ::11] = 0.0  # masked views weigh exactly 0
    return feats, coords, scale, gout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_bilinear_many_scaled_and_gradients_match_jax(rng, grouped_interpret, dtype):
    """The output and the gradients of feats, coords and scale. bf16 is
    exact on inputs whose products and sums are exact in f32 (weights are
    multiples of 2**-9); f32 to 1e-5."""
    exact = dtype == "bfloat16"
    feats, coords, scale, gout = _sampler_inputs(rng, exact)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(
        jwarp.sample_bilinear_many_scaled,
        jnp.asarray(feats).astype(jdt), jnp.asarray(coords), jnp.asarray(scale),
    )
    want = vjp(jnp.asarray(gout).astype(jdt))
    leaves = [
        torch.from_numpy(feats).to(tdt).requires_grad_(True),
        torch.from_numpy(coords).requires_grad_(True),
        torch.from_numpy(scale).requires_grad_(True),
    ]
    got = gc.sample_bilinear_many_scaled(*leaves)
    got.backward(torch.from_numpy(gout).to(tdt))
    assert got.dtype == tdt and leaves[0].grad.dtype == tdt

    def close(g, w, what):
        g, w = g.detach().float().numpy(), np.asarray(jnp.asarray(w).astype(jnp.float32))
        finite = np.isfinite(w)  # the coordinates' gradient at a non-finite coordinate is NaN on both sides
        assert np.array_equal(np.isfinite(g), finite), what
        if exact:
            np.testing.assert_array_equal(g[finite], w[finite], err_msg=what)
        else:
            np.testing.assert_allclose(g[finite], w[finite], atol=1e-5, rtol=1e-5, err_msg=what)

    close(got, out, "output")
    for leaf, w, what in zip(leaves, want, ("d feats", "d coords", "d scale")):
        close(leaf.grad, w, what)
    unscaled = gc.sample_bilinear_many(leaves[0].detach(), leaves[1].detach())
    want_unscaled = jwarp.sample_bilinear_many(jnp.asarray(feats).astype(jdt), jnp.asarray(coords))
    close(unscaled, want_unscaled, "sample_bilinear_many")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_deformable_fusion_forward_matches_flax(rng, grouped_interpret, dtype, tol):
    """The module alone, with non-finite reference points, points outside
    the map and behind the camera, and cells no view sees."""
    Hf, Wf, C, Cq, out_ch, Hq, Wq = 8, 12, 16, 10, 8, 5, 7
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    feats = rng.standard_normal((B, V, Hf, Wf, C)).astype(np.float32)
    coords = np.stack([rng.uniform(-3, Wf + 2, (B, V, Hq, Wq)), rng.uniform(-3, Hf + 2, (B, V, Hq, Wq))], -1).astype(np.float32)
    coords[0, 1, 2, 3, 0] = np.nan
    coords[:, :, 0, 0] = -5.0  # a cell no view sees
    depth = rng.uniform(-0.5, 2.0, (B, V, Hq, Wq)).astype(np.float32)
    query = rng.standard_normal((B, Hq, Wq, Cq)).astype(np.float32)
    jmod = jfusion.DeformableFusion(heads=HEADS, points=POINTS, out_ch=out_ch, dtype=jdt)
    args = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(query), jnp.asarray(depth))
    params = _tree_np(jmod.init(jax.random.PRNGKey(1), *args))["params"]
    for layer in params.values():
        layer["bias"] = layer["bias"] + (0.1 * rng.standard_normal(layer["bias"].shape)).astype(np.float32)
    _wake_sampling_heads(params, rng)
    want = np.asarray(jmod.apply({"params": params}, *args).astype(jnp.float32))

    tmod = DeformableFusion(V, C, Cq, HEADS, POINTS, out_ch, tdt)
    tmod.load_state_dict({
        f"{n}.{k}": torch.from_numpy(np.ascontiguousarray(a.T if k == "weight" else a))
        for n, layer in params.items() for k, a in (("weight", layer["kernel"]), ("bias", layer["bias"]))
    })
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (feats, coords, query, depth)))
    assert got.dtype == tdt and got.shape == (B, Hq, Wq, out_ch)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * np.abs(want).max(), rtol=tol)
    # without depth_w the views behind the camera count as valid
    want_nd = np.asarray(jmod.apply({"params": params}, *args[:3]).astype(jnp.float32))
    with torch.no_grad():
        got_nd = tmod(*(torch.from_numpy(a) for a in (feats, coords, query)))
    np.testing.assert_allclose(got_nd.float().numpy(), want_nd, atol=tol * np.abs(want_nd).max(), rtol=tol)
    assert np.abs(want_nd - want).max() > 10 * tol * np.abs(want).max()


@pytest.mark.parametrize(
    "stride,amp,tol", [(2, False, 1e-4), (1, False, 1e-4), (2, True, 3e-2)],
    ids=["stride2-f32", "stride1-f32", "stride2-bf16"],
)
def test_bevnet_deform_forward_matches_flax(grouped_interpret, stride, amp, tol):
    raw = _raw({"MODEL": {"ATTN_STRIDE": stride}, "RUNTIME": {"USE_AMP": amp}})
    model, v = _variables(jcfg.from_dict(raw), seed=5)
    b = _batch(7)
    want = jax.jit(lambda v, i, k, r: model.apply(v, i, k, r, train=False))(v, b["images"], b["K"], b["Rt"])
    net = BEVNet.from_config(tcfg.from_dict(raw))
    net.load_state_dict(state_dict_from_flax(v))
    net.eval()
    with torch.no_grad():
        got = net(*(torch.from_numpy(b[k]) for k in ("images", "K", "Rt")))
    assert set(got) == set(want)
    for k in ("heatmap_logits", "offset", "size_raw", "bev_feat"):
        w = np.asarray(want[k], dtype=np.float32)
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, atol=tol * max(1.0, np.abs(w).max()), rtol=tol, err_msg=k)


def test_init_state_dict_reproduces_the_sampling_heads_start():
    """Zero kernels, the ring bias tiled over the views and zero attention
    logits, as Flax initialises them; every other new parameter has the
    Flax shape and a LeCun-normal spread."""
    raw = _raw({})
    cfg = jcfg.from_dict(raw)
    model = JBEVNet.from_config(cfg)
    b = _batch(0)
    v = _tree_np(jax.jit(model.init)(jax.random.PRNGKey(0), b["images"].astype(np.float32), b["K"], b["Rt"]))
    want = state_dict_from_flax(v)
    got = init_state_dict(tcfg.from_dict(raw), seed=0)
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want)
    for k in ("deform_fusion.offsets.weight", "deform_fusion.offsets.bias", "deform_fusion.attn.weight",
              "deform_fusion.attn.bias", "query_proj_bias", "deform_fusion.value.bias"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert got["deform_fusion.offsets.bias"].abs().max() == POINTS
    for k in ("query_proj", "deform_fusion.value.weight", "deform_fusion.out.weight", "encoder.proj.weight"):
        np.testing.assert_allclose(float(got[k].std()), float(want[k].std()), rtol=0.25, err_msg=k)
    assert "view_proj" not in got


def test_from_config_accepts_deform_with_every_backbone_option():
    """The family builds, with static and with per-frame cameras, beside
    the unfused fusions, and over the options once left to port: a ResNet
    backbone (with GroupNorm too) and a multi-scale OUT_INDEX."""
    assert BEVNet.from_config(tcfg.from_dict(_raw({}))).fusion == "deform_attn"
    for fusion in ("mean", "attn"):
        assert BEVNet.from_config(tcfg.from_dict(_raw({"MODEL": {"FUSION": fusion}}))).fusion == fusion
    assert not BEVNet.from_config(tcfg.from_dict(_raw({"MODEL": {"STATIC_CAMERAS": False}}))).static_cameras
    net = BEVNet.from_config(tcfg.from_dict(_raw({"MODEL": {"BACKBONE": "resnet18", "NORM": "group"}})))
    assert net.fusion == "deform_attn" and net.encoder.backbone.norm == "group"
    net = BEVNet.from_config(tcfg.from_dict(_raw({"MODEL": {"OUT_INDEX": [1, 2]}})))
    assert net.encoder.levels == (1, 2) and net.encoder.proj.in_channels == 24 + 40


# -- the train step -------------------------------------------------------

CASES = {
    "stride2": ({}, 1, 11, 30),
    "stride1-accum2": ({"MODEL": {"ATTN_STRIDE": 1}, "TRAIN": {"ACCUM_STEPS": 2}}, 2, 13, 41),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Run the case's calls through both train steps; per call, (metrics,
    gradients, parameters, statistics) of JAX (``want``) and of the port
    (``got``)."""
    over, calls, weight_seed, batch_seed = CASES[request.param]
    raw = _raw(over)
    cfg = jcfg.from_dict(raw)
    batches = [_batch(batch_seed + i) for i in range(calls)]
    model, v = _variables(cfg, weight_seed)
    tx = joptim.build_optimizer(cfg, steps_per_epoch=SPE)
    jst = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
        opt_state=tx.init(v["params"]), apply_fn=model.apply, tx=tx,
    )
    step = jstate.make_train_step(cfg)
    l, m = cfg.loss, cfg.model

    def grads_of(state, batch):
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
        jwarp.FORCE_GROUPED_INTERPRET = False

    tc = tcfg.from_dict(raw)
    state = create_state(tc, state_dict_from_flax(v), device="cpu", steps_per_epoch=SPE)
    initial = {k: t.clone() for k, t in state.model.state_dict().items()}
    train_step = make_train_step(tc)
    got, captured = [], {}
    apply = state.tx.update

    def spy(opt_state, mod, grads):
        captured["grads"] = {k: g.clone() for k, g in grads.items()}
        return apply(opt_state, mod, grads)

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
    return SimpleNamespace(name=request.param, cfg=cfg, want=want, got=got, initial=initial)


def _close(got, want, what):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()) + 1e-5, err_msg=what)


def test_deform_train_step_losses_and_grad_norm_match_jax(case):
    for i, (w, g) in enumerate(zip(case.want, case.got)):
        assert g[0].keys() == w[0].keys()
        for k in w[0]:
            np.testing.assert_allclose(g[0][k], w[0][k], rtol=1e-4, err_msg=f"call {i}: {k}")


def test_deform_train_step_gradients_match_jax(case):
    for i, (w, g) in enumerate(zip(case.want, case.got)):
        assert g[1].keys() == w[1].keys()
        for k in w[1]:
            _close(g[1][k], w[1][k], f"call {i}: d/d {k}")


def test_deform_train_step_sampling_heads_get_gradients(case):
    """The offsets and attention heads learn only through the sampler's
    d_wts: their gradients are non-zero and match."""
    for w, g in zip(case.want, case.got):
        for k in ("deform_fusion.offsets.weight", "deform_fusion.offsets.bias",
                  "deform_fusion.attn.weight", "deform_fusion.attn.bias", "query_proj", "encoder.proj.weight"):
            assert float(g[1][k].abs().max()) > 1e-6, k
            assert float(np.abs(w[1][k]).max()) > 1e-6, k


def test_deform_train_step_updated_params_match_jax(case):
    """As test_torch_train.py: where gradient + decay is within the
    gradient rule's tolerance of 0, Adam's first step has a sign of
    rounding noise, and those elements are held to 2 * lr."""
    cfg, want, got, initial = case.cfg, case.want, case.got, case.initial
    lr, wd, accum = cfg.train.lr, cfg.train.weight_decay, cfg.train.accum_steps
    for i, (w, g) in enumerate(zip(want, got)):
        assert g[2].keys() == w[2].keys()
        window = want[i - i % accum : i + 1]
        for k in w[2]:
            grad = np.mean([np.asarray(c[1][k]) for c in window], axis=0)
            noise = np.abs(grad + wd * initial[k].numpy()) <= 1e-4 * np.abs(grad).max() + 1e-5
            want_p, got_p = np.asarray(w[2][k]), g[2][k].numpy()
            np.testing.assert_allclose(
                got_p[~noise], want_p[~noise], rtol=1e-4, atol=1e-4 * lr, err_msg=f"call {i}: {k}"
            )
            assert np.all(np.abs(got_p - want_p)[noise] <= 2 * lr), f"call {i}: {k}"
    moved = [any(not torch.equal(g[2][k], initial[k]) for k in g[2]) for g in got]
    assert moved == ([False, True] if accum == 2 else [True])


def test_deform_train_step_batch_stats_match_jax(case):
    for i, (w, g) in enumerate(zip(case.want, case.got)):
        assert g[3].keys() == w[3].keys()
        for k in w[3]:
            _close(g[3][k], w[3][k], f"call {i}: {k}")

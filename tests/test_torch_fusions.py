"""The unfused fusions: vsta_tpu_torch's simple_fusion (sum, mean, max),
AttentionFusion, bev_proj and concat under WARP_IMPL gather and fused,
against the JAX package on the CPU, weights through convert.py.

Sizes: EfficientNet-B0 at 64x96 with 3 views, FEAT_DIM 16, BEV 16x48,
BEV_PROJ_CH 32. The per-view BEV maps come from warp_views (the grouped
sampler, held to the JAX one in tests/test_torch_perframe.py).

Tolerances: the fusion modules alone 1e-5 in float32 and one bfloat16 ulp
(2**-7 of the largest value) in bfloat16, where the softmax and the
weighted sum round in other places; model forwards 1e-4 in float32
(convolutions sum in other orders) and, in bfloat16, 5e-2 of the largest
magnitude for one element and 1e-2 for the mean, as
tests/test_torch_perframe.py; gradients 1e-4 of each tensor's largest
magnitude plus 1e-5, as tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsta_tpu import config as jcfg
from vsta_tpu.data.synthetic import make_ring_camera
from vsta_tpu.models import BEVNet as JBEVNet
from vsta_tpu.models import fusion as jfusion
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.convert import init_state_dict, params_from_flax, state_dict_from_flax
from vsta_tpu_torch.models import BEVNet
from vsta_tpu_torch.models.fusion import AttentionFusion, simple_fusion
from vsta_tpu_torch.ops import grouped_cuda as gc
from vsta_tpu_torch.ops.warp_cuda import warp_tiles
from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


B, V, H, W = 2, 3, 64, 96
BOUNDS = (-12.0, 12.0, -4.0, 4.0)
BEV = (16, 48)
RAW = {
    "DATA": {"BATCH_SIZE": B, "IMG_SIZE": [3, H, W], "VIEWS": V},
    "MODEL": {
        "BACKBONE": "efficientnet_b0", "FEAT_DIM": 16, "OUT_INDEX": 2,
        "BEV_SIZE": [32, *BEV], "BEV_BOUNDS": list(BOUNDS),
        "BEV_PROJ_CH": 32, "HEAD_MID1": 64, "HEAD_MID2": 32,
        "WARP_IMPL": "gather", "FUSION": "concat",
    },
    "RUNTIME": {"USE_AMP": False},
}
# (FUSION, WARP_IMPL) of the six options
OPTIONS = {
    "sum": ("sum", "gather"), "mean": ("mean", "gather"), "max": ("max", "gather"), "attn": ("attn", "gather"),
    "concat-gather": ("concat", "gather"), "concat-fused": ("concat", "fused"),
}


def _raw(option, static=True, amp=False):
    fusion, warp_impl = OPTIONS[option]
    raw = {k: dict(v) for k, v in RAW.items()}
    raw["MODEL"].update(FUSION=fusion, WARP_IMPL=warp_impl, STATIC_CAMERAS=static)
    raw["RUNTIME"]["USE_AMP"] = amp
    return raw


def _inputs(seed, per_frame=False):
    """Frames and ring cameras; with ``per_frame`` the ring's radius and
    height are drawn for every frame."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, V, H, W, 3)).astype(np.uint8)
    Ks, Rts = [], []
    for _ in range(B):
        radius, height = (rng.uniform(8.0, 12.0), rng.uniform(3.0, 5.0)) if per_frame else (10.0, 4.0)
        k, rt = zip(*(make_ring_camera(v, V, radius=radius, height=height, img_hw=(H, W)) for v in range(V)))
        Ks.append(np.stack(k))
        Rts.append(np.stack(rt))
    return images, np.stack(Ks).astype(np.float32), np.stack(Rts).astype(np.float32)


def _tree_np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), jax.tree.map(np.asarray, dict(tree)))


def _randomize(tree, rng):
    """Numpy copy with random norm scales, 1-D biases and BatchNorm
    statistics, as tests/test_torch_train.py's."""
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


def _variables(cfg, seed, randomize=True):
    model = JBEVNet.from_config(cfg)
    images, K, Rt = _inputs(0)
    v = _tree_np(jax.jit(model.init)(jax.random.PRNGKey(0), images.astype(np.float32), K, Rt))
    return model, (_randomize(v, np.random.default_rng(seed)) if randomize else v)


# -- the fusion modules alone ------------------------------------------------


def _views_with_ties(rng):
    """[B, V, H, W, C] per-view maps as the warp leaves them: cells a view
    does not see are exact zeros (so the max over views ties at 0 wherever
    the seeing views are negative), a few cells tie at a positive value,
    and one cell is seen by no view."""
    x = rng.standard_normal((B, V, 5, 7, 6)).astype(np.float32)
    x[:, 1, :, :3] = 0.0
    x[:, 2, :2] = 0.0
    x[0, 0, 3, 4] = x[0, 1, 3, 4] = np.abs(x[0, 0, 3, 4]) + 3.0  # a positive tie of two views
    x[:, :, 0, 0] = 0.0
    return x


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_simple_fusion_and_gradient_match_flax(rng, mode, dtype):
    """Values and the gradient of the per-view maps, ties of the max
    included: jnp.max splits a tie's gradient evenly, and so must the port."""
    x = _views_with_ties(rng)
    g = rng.standard_normal((B, 5, 7, 6)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmod = jfusion.SimpleFusion(mode=mode)
    out, vjp = jax.vjp(lambda a: jmod.apply({}, a), jnp.asarray(x).astype(jdt))
    (want_g,) = vjp(jnp.asarray(g).astype(jdt))
    leaf = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = simple_fusion(leaf, mode)
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(atol=2.0**-7 * 4, rtol=2.0**-7)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(out.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(leaf.grad.float().numpy(), np.asarray(want_g.astype(jnp.float32)), **tol)
    if mode == "max":  # the positive tie halves the gradient, the blind cell splits it three ways
        tie = leaf.grad[0, :, 3, 4].float()
        assert torch.equal(tie[0], tie[1]) and not tie[2].any()
        np.testing.assert_allclose(tie[0].numpy() * 2, g[0, 3, 4], rtol=2.0**-6)
        blind = leaf.grad[:, :, 0, 0].float()
        np.testing.assert_allclose(blind.numpy() * 3, np.broadcast_to(g[:, None, 0, 0], blind.shape), rtol=2.0**-6)


def test_simple_fusion_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown simple fusion mode"):
        simple_fusion(torch.zeros(1, 2, 3, 3, 4), "median")


def _attention_pair(rng, dtype):
    """The Flax module's parameters under its automatic names, loaded into
    the port's module."""
    C = 6
    x = _views_with_ties(rng)
    jmod = jfusion.AttentionFusion(dtype=getattr(jnp, dtype))
    params = _tree_np(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))["params"]
    assert set(params) == {"Dense_0", "Dense_1"}
    assert params["Dense_0"]["kernel"].shape == (C, 32) and params["Dense_1"]["kernel"].shape == (32, 1)
    for layer in params.values():
        layer["bias"] = layer["bias"] + (0.1 * rng.standard_normal(layer["bias"].shape)).astype(np.float32)
    tmod = AttentionFusion(C, dtype=getattr(torch, dtype))
    tmod.load_state_dict({
        f"{n}.{k}": torch.from_numpy(np.ascontiguousarray(a.T if k == "weight" else a))
        for n, layer in (("hidden", params["Dense_0"]), ("logit", params["Dense_1"]))
        for k, a in (("weight", layer["kernel"]), ("bias", layer["bias"]))
    })
    return x, jmod, params, tmod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_fusion_matches_flax(rng, dtype):
    """Hidden 32, tanh, one logit a view, views with coverage <= 1e-6
    masked with -1e9, softmax over the view axis in the compute dtype."""
    x, jmod, params, tmod = _attention_pair(rng, dtype)
    coverage = np.abs(x).max(-1)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(coverage)).astype(jnp.float32))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(coverage))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape == (B, 5, 7, 6)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2.0**-7 * np.abs(want).max(), rtol=2.0**-7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # without coverage the blind views vote too
    want_nc = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got_nc = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got_nc.float().numpy(), want_nc, **tol)
    assert np.abs(want_nc - want).max() > 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_fusion_cell_no_view_covers(rng, dtype):
    """Every logit of such a cell is masked: the softmax gives 1 / V to
    each view, not NaN; with non-zero features there (and a coverage that
    says blind) the output is their plain mean, in JAX and in the port."""
    x, jmod, params, tmod = _attention_pair(rng, dtype)
    x[:, :, 0, 0] = rng.standard_normal((B, V, 6)).astype(np.float32)
    coverage = np.abs(x).max(-1)
    coverage[:, :, 0, 0] = 0.0
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(coverage)).astype(jnp.float32))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(coverage)).float().numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2.0**-7 * np.abs(want).max(), rtol=2.0**-7)
    np.testing.assert_allclose(got, want, **tol)
    cast = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    np.testing.assert_allclose(got[:, 0, 0], cast[:, :, 0, 0].mean(1), atol=2.0**-6 if dtype == "bfloat16" else 1e-6)


def test_attention_fusion_gradients_match_flax(rng):
    """The gradients of both Dense layers and of the per-view maps, the
    masked views and the uncovered cell included."""
    x, jmod, params, tmod = _attention_pair(rng, "float32")
    coverage = np.abs(x).max(-1)
    g = rng.standard_normal((B, 5, 7, 6)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, a: jmod.apply({"params": p}, a, jnp.asarray(coverage)), params, jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(x).requires_grad_(True)
    tmod(leaf, torch.from_numpy(coverage)).backward(torch.from_numpy(g))
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_x), atol=1e-5, rtol=1e-5)
    for name, layer in (("hidden", "Dense_0"), ("logit", "Dense_1")):
        mod = getattr(tmod, name)
        np.testing.assert_allclose(mod.weight.grad.numpy(), np.asarray(want_p[layer]["kernel"]).T, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(mod.bias.grad.numpy(), np.asarray(want_p[layer]["bias"]), atol=1e-5, rtol=1e-5)
        assert float(mod.weight.grad.abs().max()) > 1e-4


# -- BEVNet ------------------------------------------------------------------

FORWARD_CASES = [(o, True, False) for o in OPTIONS] + [
    ("attn", False, False), ("concat-gather", False, False), ("max", False, False), ("concat-fused", False, False),
    ("attn", True, True), ("mean", True, True),
]


@pytest.mark.parametrize(
    "option,static,amp", FORWARD_CASES,
    ids=[f"{o}-{'static' if s else 'perframe'}-{'bf16' if a else 'f32'}" for o, s, a in FORWARD_CASES],
)
def test_bevnet_fusion_forward_matches_flax(option, static, amp):
    """Every head output and bev_feat from the same weights. None of
    these options launches a warp kernel (concat under WARP_IMPL fused runs
    the grouped sampler, as the JAX package does off the TPU kernel path)."""
    raw = _raw(option, static, amp)
    model, v = _variables(jcfg.from_dict(raw), seed=5)
    images, K, Rt = _inputs(7, per_frame=not static)
    want = jax.jit(lambda v, i, k, r: model.apply(v, i, k, r, train=False))(v, images, K, Rt)
    net = BEVNet.from_config(tcfg.from_dict(raw))
    sd = state_dict_from_flax(v)
    assert sd.keys() == net.state_dict().keys()
    net.load_state_dict(sd)
    net.eval()
    before = (warp_tiles.launches, warp_views_sum.launches, gc.sample_tiles_grouped.launches)
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in (images, K, Rt)))
    assert (warp_tiles.launches, warp_views_sum.launches, gc.sample_tiles_grouped.launches) == before
    assert set(got) == set(want)
    tol = 5e-2 if amp else 1e-4
    for k in ("heatmap_logits", "heatmap", "offset", "size_raw", "bev_feat") + (() if amp else ("size",)):
        w = np.asarray(want[k], dtype=np.float32)
        assert got[k].shape == w.shape, k
        scale = max(1.0, np.abs(w).max())
        np.testing.assert_allclose(got[k].numpy(), w, atol=tol * scale, rtol=tol, err_msg=k)
        assert np.abs(got[k].numpy() - w).mean() <= 0.2 * tol * scale, k
    assert np.abs(np.asarray(want["bev_feat"])[..., :-2]).max() > 0.1


@pytest.mark.parametrize("option", ["max", "attn"])
def test_bevnet_fusion_gradients_match_jax(option):
    """The gradients of bev_proj, the attention's Dense layers and the
    applied encoder projection, of a fixed functional of the eval-mode
    outputs, against jax.grad from the same weights. The max runs over
    views that tie at 0 wherever a cell lies outside their images."""
    raw = _raw(option)
    model, v = _variables(jcfg.from_dict(raw), seed=11)
    images, K, Rt = _inputs(13)
    rng = np.random.default_rng(2)
    probe = {k: rng.standard_normal((B, *BEV, c)).astype(np.float32)
             for k, c in (("heatmap_logits", 1), ("offset", 2), ("size_raw", 2))}
    own = [k for k in ("bev_proj", "AttentionFusion_0") if k in v["params"]]

    def loss(sub):
        params = {**v["params"], **{k: sub[k] for k in own}, "encoder": {**v["params"]["encoder"], "proj": sub["proj"]}}
        out = model.apply({"params": params, "batch_stats": v["batch_stats"]}, images, K, Rt, train=False)
        return sum(jnp.sum(out[k] * probe[k]) for k in probe)

    sub = {**{k: v["params"][k] for k in own}, "proj": v["params"]["encoder"]["proj"]}
    want = _tree_np(jax.jit(jax.grad(loss))(sub))
    # through the converter: a gradient tree has the params' shape
    full = jax.tree.map(np.zeros_like, v["params"])
    full.update({k: want[k] for k in own})
    full["encoder"]["proj"] = want["proj"]
    want_sd = params_from_flax(full)
    names = ["encoder.proj.weight", "encoder.proj.bias", "bev_proj.weight", "bev_proj.bias"]
    if option == "attn":
        names += [f"attn_fusion.{n}.{t}" for n in ("hidden", "logit") for t in ("weight", "bias")]
    net = BEVNet.from_config(tcfg.from_dict(raw))
    net.load_state_dict(state_dict_from_flax(v))
    net.eval()
    out = net(*(torch.from_numpy(a) for a in (images, K, Rt)))
    total = sum((out[k] * torch.from_numpy(probe[k])).sum() for k in probe)
    named = dict(net.named_parameters())
    grads = torch.autograd.grad(total, [named[k] for k in names])
    for k, g in zip(names, grads):
        w = want_sd[k].numpy()
        assert np.abs(w).max() > 1e-6, k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()) + 1e-5, err_msg=k)


@pytest.mark.parametrize("option", ["mean", "attn", "concat-gather"])
def test_init_state_dict_starts_where_flax_starts(option):
    """The same keys and shapes as the Flax initialisation through the
    converter, zero biases, LeCun-normal spreads for bev_proj, the
    attention's Dense layers and the view projection."""
    raw = _raw(option)
    _, v = _variables(jcfg.from_dict(raw), seed=0, randomize=False)
    want = state_dict_from_flax(v)
    got = init_state_dict(tcfg.from_dict(raw), seed=0)
    assert got.keys() == want.keys() == BEVNet.from_config(tcfg.from_dict(raw)).state_dict().keys()
    assert all(got[k].shape == want[k].shape for k in want)
    own = [k for k in want if k.split(".")[0] in ("bev_proj", "attn_fusion", "view_proj", "view_proj_bias")]
    assert own
    for k in own:
        if k.endswith("bias"):
            assert not got[k].any() and not want[k].any(), k
        elif want[k].numel() >= 256:
            np.testing.assert_allclose(float(got[k].std()), float(want[k].std()), rtol=0.25, err_msg=k)
        else:  # the 32 -> 1 logit layer: too few draws for a spread; hold the scale
            assert 0.3 < float(got[k].std()) / float(want[k].std()) < 3.0, k
    np.testing.assert_allclose(float(got["encoder.proj.weight"].std()), float(want["encoder.proj.weight"].std()), rtol=0.25)


def test_converter_refuses_an_unknown_key():
    _, v = _variables(jcfg.from_dict(_raw("mean")), seed=0, randomize=False)
    v["params"]["SurpriseFusion_0"] = {"kernel": np.zeros((1, 1))}
    with pytest.raises(KeyError, match="SurpriseFusion_0"):
        state_dict_from_flax(v)


@pytest.mark.parametrize("static", [True, False], ids=["static", "perframe"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_from_config_builds_every_option(option, static):
    net = BEVNet.from_config(tcfg.from_dict(_raw(option, static)))
    fusion, warp_impl = OPTIONS[option]
    assert (net.fusion, net.warp_impl, net.static_cameras) == (fusion, warp_impl, static)
    assert net.fold_proj == (option == "concat-fused")
    assert hasattr(net, "bev_proj") == (fusion != "concat")
    assert hasattr(net, "attn_fusion") == (fusion == "attn")

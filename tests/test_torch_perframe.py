"""Per-frame cameras (MODEL.STATIC_CAMERAS false): vsta_tpu_torch's dense
warp, the per-batch branches of the fused warp + projection, warp_views,
the BEVNet branches and one train step against the JAX package, on the
CPU, weights through convert.py.

Every frame has its own calibration: ring cameras whose radius and height
are drawn per frame from the seed. The JAX side runs the dense Pallas
kernel (warp_views_sum_pallas) in interpret mode, as tests/test_warp_pallas.py
does; on the CPU the port's wrapper takes its plain version.

Tolerances. The dense warp alone: float32 1e-5 (the TPU kernel sums a
one-hot matmul over the whole map, the port four taps a view); bfloat16
maps 1e-6 of the largest output (weights and products are float32 on both
sides). The fused warp + projection in bfloat16: one bfloat16 ulp (2**-7)
of the largest output, since the projection einsum rounds to bfloat16 on
both sides after sums in other orders. Model forwards: float32 1e-4
(convolutions sum in other orders); bfloat16, where both sides round at
every layer, 5e-2 of the largest magnitude for any one element and 1e-2
for the mean (the static-camera models of tests/test_torch_deform.py
differ from JAX by as much: mean 2e-3, worst element 2.5e-2 against the
per-frame models' 2e-3 and 4.3e-2 at these shapes). The train step uses the rules of
tests/test_torch_train.py: 1e-4 of each tensor's largest magnitude plus
1e-5 for gradients and statistics, rtol 1e-4 for scalars.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vsta_tpu import config as jcfg
from vsta_tpu.data.synthetic import make_ring_camera
from vsta_tpu.geometry import bev_sample_coords, ground_grid
from vsta_tpu.models import BEVNet as JBEVNet
from vsta_tpu.models import bevnet as jbevnet
from vsta_tpu.ops import losses as jlosses
from vsta_tpu.ops import splat as jsplat
from vsta_tpu.ops import warp as jwarp
from vsta_tpu.ops import warp_pallas as jwp
from vsta_tpu.training import optim as joptim
from vsta_tpu.training import state as jstate
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.convert import batch_stats_from_flax, params_from_flax, state_dict_from_flax
from vsta_tpu_torch.models import BEVNet
from vsta_tpu_torch.ops import grouped_cuda as gc
from vsta_tpu_torch.ops import warp as twarp
from vsta_tpu_torch.ops.warp_cuda import FusedWarpProj, fused_warp_proj, fused_warp_proj_cuda, warp_tiles_ref
from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum, warp_views_sum_ref
from vsta_tpu_torch.training.state import create_state, make_train_step

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


B, V, H, W = 2, 3, 64, 96
BOUNDS = (-12.0, 12.0, -4.0, 4.0)
BEV = (16, 48)
FEAT = (8, 12)  # the stride-8 map of a 64 x 96 image
SPE = 2
F32 = dict(atol=1e-5, rtol=1e-5)
RAW = {
    "DATA": {"BATCH_SIZE": B, "IMG_SIZE": [3, H, W], "VIEWS": V},
    "MODEL": {
        "BACKBONE": "efficientnet_b0", "FEAT_DIM": 48, "OUT_INDEX": 2,
        "BEV_SIZE": [32, *BEV], "BEV_BOUNDS": list(BOUNDS),
        "BEV_PROJ_CH": 48, "HEAD_MID1": 64, "HEAD_MID2": 32,
        "WARP_IMPL": "pallas", "FUSION": "concat", "STATIC_CAMERAS": False,
    },
    "TRAIN": {
        "EPOCHS": 10, "LR": 1e-3, "OPT": "Adam", "WEIGHT_DECAY": 1e-4,
        "LR_SCHEDULER": "cosine_warm", "WARMUP_EPOCHS": 3, "ACCUM_STEPS": 1,
    },
    "LOSS": {"MAX_OBJECTS": 8},
    "RUNTIME": {"USE_AMP": False},
    "EVAL": {"CONF_THRESH": 0.3, "NMS_DIST_M": 1.0, "MAX_DETS": 16},
}
DEFORM = {"FUSION": "deform_attn", "WARP_IMPL": "fused", "FEAT_DIM": 16, "BEV_PROJ_CH": 32,
          "ATTN_HEADS": 2, "ATTN_POINTS": 2, "ATTN_STRIDE": 2}


def _raw(over):
    raw = {k: dict(v) for k, v in RAW.items()}
    for k, v in over.items():
        raw[k].update(v)
    return raw


def _cameras(rng, frames=B, views=V, same=False):
    """K [frames, views, 3, 3], Rt [frames, views, 4, 4]: a ring a frame,
    its radius and height drawn from ``rng`` (one draw for all frames when
    ``same``)."""
    draws = [(rng.uniform(8.0, 12.0), rng.uniform(3.0, 5.0)) for _ in range(frames)]
    if same:
        draws = draws[:1] * frames
    Ks, Rts = [], []
    for radius, height in draws:
        k, rt = zip(*(make_ring_camera(v, views, radius=radius, height=height, img_hw=(H, W)) for v in range(views)))
        Ks.append(np.stack(k))
        Rts.append(np.stack(rt))
    return np.stack(Ks).astype(np.float32), np.stack(Rts).astype(np.float32)


def _coords(rng, bev=BEV, feat=FEAT):
    """[B, V, Hb, Wb, 2] feature-pixel coordinates, every frame its own."""
    K, Rt = _cameras(rng)
    grid = ground_grid(bev[0], bev[1], BOUNDS)
    return np.array(bev_sample_coords(jnp.asarray(K), jnp.asarray(Rt), (H, W), feat, grid))


def _batch(seed, same=False):
    rng = np.random.default_rng(seed)
    K, Rt = _cameras(rng, same=same)
    boxes = np.zeros((B, 8, 4), np.float32)
    n = 6
    boxes[:, :n, 0] = rng.uniform(-11.0, 11.0, (B, n))
    boxes[:, :n, 1] = rng.uniform(-3.5, 3.5, (B, n))
    boxes[:, :n, 2:] = rng.uniform(0.4, 1.2, (B, n, 2))
    return {
        "images": rng.integers(0, 256, (B, V, H, W, 3)).astype(np.uint8),
        "K": K, "Rt": Rt, "boxes_world": boxes, "num_boxes": np.array([n, n - 1], np.int32),
    }


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


def _variables(cfg, seed):
    model = JBEVNet.from_config(cfg)
    b = _batch(0)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), b["images"].astype(np.float32), b["K"], b["Rt"])
    rng = np.random.default_rng(seed)
    v = _randomize(_tree_np(v), rng)
    if "deform_fusion" in v["params"]:  # wake the sampling heads (Flax zeroes their kernels)
        for name, scale in (("offsets", 0.3), ("attn", 0.5)):
            k = v["params"]["deform_fusion"][name]["kernel"]
            v["params"]["deform_fusion"][name]["kernel"] = (scale * rng.standard_normal(k.shape)).astype(np.float32)
    return model, v


@pytest.fixture
def interpret():
    """The JAX model's Pallas kernels in interpret mode."""
    jbevnet.FORCE_PALLAS_INTERPRET = True
    jwarp.FORCE_GROUPED_INTERPRET = True
    try:
        yield
    finally:
        jbevnet.FORCE_PALLAS_INTERPRET = False
        jwarp.FORCE_GROUPED_INTERPRET = False


# -- the dense warp kernel's plain version ----------------------------------


def test_per_frame_cameras_differ_and_see_the_map(rng):
    coords = _coords(rng)
    assert np.abs(coords[0] - coords[1]).max() > 0.5  # another calibration a frame
    idx, wts = twarp.precompute_warp_lut(torch.from_numpy(coords), FEAT)
    assert idx.shape == wts.shape == (B, V, *BEV, 4) and idx.dtype == torch.int32
    assert (wts.reshape(B * V, -1) > 0).any(dim=1).all() and float((wts > 0).float().mean()) > 0.3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [8, 13])
def test_warp_views_sum_ref_matches_pallas(rng, dtype, C):
    """The plain version against warp_views_sum_pallas in interpret mode,
    on the LUT of per-frame cameras with non-finite coordinates mixed in."""
    coords = _coords(rng)
    coords.reshape(-1, 2)[::37, 0] = np.nan
    coords.reshape(-1, 2)[5::41, 1] = np.inf
    coords.reshape(-1, 2)[7::43] = -np.inf
    N, P = BEV[0] * BEV[1], FEAT[0] * FEAT[1]
    feats = rng.standard_normal((B, V, P, C)).astype(np.float32)
    jidx, jwts = jwarp.precompute_warp_lut(jnp.asarray(coords), FEAT)
    jidx, jwts = jidx.reshape(B, V, N, 4), jwts.reshape(B, V, N, 4)
    tidx, twts = twarp.precompute_warp_lut(torch.from_numpy(coords), FEAT)
    np.testing.assert_array_equal(tidx.reshape(B, V, N, 4).numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(twts.reshape(B, V, N, 4).numpy(), np.asarray(jwts))
    bad = ~np.isfinite(coords).all(-1).reshape(B, V, N)
    assert bad.any() and not (twts.reshape(B, V, N, 4).numpy()[bad] != 0).any()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jwp.warp_views_sum_pallas(jnp.asarray(feats).astype(getattr(jnp, dtype)), jidx, jwts))
    before = warp_views_sum.launches
    got = warp_views_sum(
        torch.from_numpy(feats).to(getattr(torch, dtype)), tidx.reshape(B, V, N, 4), twts.reshape(B, V, N, 4)
    )
    assert warp_views_sum.launches == before  # the plain version on the CPU
    assert got.dtype == torch.float32 and got.shape == want.shape == (B, N, C)
    assert np.isfinite(want).all() and np.abs(want).max() > 0.5
    tol = dict(atol=1e-6 * np.abs(want).max(), rtol=0) if dtype == "bfloat16" else F32
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_views_sum_ref_blind_frame_on_poisoned_maps(rng, dtype):
    """A frame none of whose views sees any cell gives exact zeros whatever
    its maps hold, in the plain version and in the TPU kernel."""
    coords = _coords(rng)
    N, P, C = BEV[0] * BEV[1], FEAT[0] * FEAT[1], 8
    feats = rng.standard_normal((B, V, P, C)).astype(np.float32)
    feats[1] = 1e6
    idx, wts = twarp.precompute_warp_lut(torch.from_numpy(coords), FEAT)
    idx, wts = idx.reshape(B, V, N, 4), wts.reshape(B, V, N, 4).clone()
    wts[1] = 0.0
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = warp_views_sum_ref(torch.from_numpy(feats).to(tdt), idx, wts)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jwp.warp_views_sum_pallas(
            jnp.asarray(feats).astype(jdt), jnp.asarray(idx.numpy()), jnp.asarray(wts.numpy())))
    assert not got[1].any() and not want[1].any()
    assert got[0].abs().max() > 0.5
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5 * np.abs(want[0]).max(), rtol=1e-5)


def test_warp_views_sum_checks_its_inputs():
    f, i, w = torch.zeros(2, 3, 6, 4), torch.zeros(2, 3, 5, 4, dtype=torch.int32), torch.zeros(2, 3, 5, 4)
    assert warp_views_sum(f, i, w).shape == (2, 5, 4)
    with pytest.raises(ValueError, match="wants feats"):
        warp_views_sum(f[0], i, w)
    with pytest.raises(ValueError, match="shape mismatch"):
        warp_views_sum(f, i, w[:, :2])
    with pytest.raises(TypeError, match="int32 idx"):
        warp_views_sum(f, i.long(), w)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        warp_views_sum(f.half(), i, w)


# -- the per-batch branch of the warp + projection --------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,Cout", [(8, 16), (21, 6)])
def test_fused_warp_proj_cuda_per_frame_matches_pallas(rng, dtype, C, Cout):
    """The per-frame twin of _fwp_pallas_impl on CPU tensors against
    fused_warp_proj_pallas(interpret=True) with [B, V, Hb, Wb, 2] coords."""
    coords = _coords(rng)
    feats = rng.standard_normal((B, V, *FEAT, C)).astype(np.float32)
    kernel = (0.1 * rng.standard_normal((V, C, Cout))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((Cout,))).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jwp.fused_warp_proj_pallas(
        jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(kernel), jnp.asarray(bias),
        compute_dtype=jdt, interpret=True,
    )
    got = fused_warp_proj_cuda(
        torch.from_numpy(feats), torch.from_numpy(coords), torch.from_numpy(kernel), torch.from_numpy(bias), tdt
    )
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == want.shape == (B, *BEV, Cout)
    tol = F32 if dtype == "float32" else dict(atol=2.0**-7 * np.abs(want).max(), rtol=2.0**-7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("C,Cout", [(8, 16), (21, 6)])
def test_fused_warp_proj_per_frame_and_gradients_match_jax(rng, C, Cout):
    """The differentiable twin with per-frame coords (always project
    first, then warp_views and the sum over views) against the XLA
    fused_warp_proj: values and the gradients of feats, kernel and bias."""
    coords = _coords(rng)
    feats = rng.standard_normal((B, V, *FEAT, C)).astype(np.float32)
    kernel = (0.1 * rng.standard_normal((V, C, Cout))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((Cout,))).astype(np.float32)
    g = rng.standard_normal((B, *BEV, Cout)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda f, k, b: jwarp.fused_warp_proj(f, jnp.asarray(coords), k, b),
        jnp.asarray(feats), jnp.asarray(kernel), jnp.asarray(bias),
    )
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (feats, kernel, bias)]
    got = fused_warp_proj(leaves[0], torch.from_numpy(coords), leaves[1], leaves[2], torch.float32)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **F32)
    for leaf, w, what in zip(leaves, want, ("d feats", "d kernel", "d bias")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), err_msg=what, **F32)


def test_fused_warp_proj_function_per_frame_matches_fwp_pallas_vjp(rng, interpret):
    """FusedWarpProj with per-frame coords (dense warp forward, plain-VJP
    backward through the grouped sampler at G = B * V) against jax.vjp of
    fused_warp_proj_pallas, f32: 1e-5 of each tensor's largest magnitude (the
    kernel's gradient sums 768 cells' cotangents and reaches 50)."""
    C, Cout = 8, 16
    coords = _coords(rng)
    feats = rng.standard_normal((B, V, *FEAT, C)).astype(np.float32)
    kernel = (0.1 * rng.standard_normal((V, C, Cout))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((Cout,))).astype(np.float32)
    g = rng.standard_normal((B, *BEV, Cout)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda f, k, b: jwp.fused_warp_proj_pallas(
            f, jnp.asarray(coords), k, b, compute_dtype=jnp.float32, interpret=True),
        jnp.asarray(feats), jnp.asarray(kernel), jnp.asarray(bias),
    )
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (feats, kernel, bias)]
    got = FusedWarpProj.apply(
        leaves[0], torch.from_numpy(coords), leaves[1], leaves[2], torch.float32,
        warp_tiles_ref, gc.KERNELS, warp_views_sum_ref,
    )
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **F32)
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_views_and_map_gradient_match_jax(rng, dtype):
    """warp_views against vsta_tpu.ops.warp.warp_views: values and the
    gradient of the maps. bfloat16 within one ulp of the largest value
    (the weights are rounded to bfloat16 on both sides)."""
    C = 8
    coords = _coords(rng)
    feats = rng.standard_normal((B, V, *FEAT, C)).astype(np.float32)
    g = rng.standard_normal((B, V, *BEV, C)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda f: jwarp.warp_views(f, jnp.asarray(coords)), jnp.asarray(feats).astype(jdt))
    (want_g,) = vjp(jnp.asarray(g).astype(jdt))
    leaf = torch.from_numpy(feats).to(tdt).requires_grad_(True)
    got = gc.warp_views(leaf, torch.from_numpy(coords))
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.shape == (B, V, *BEV, C) and got.dtype == tdt and leaf.grad.dtype == tdt
    for a, w, what in ((got, out, "values"), (leaf.grad, want_g, "d maps")):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        tol = F32 if dtype == "float32" else dict(atol=2.0**-7 * np.abs(w).max(), rtol=2.0**-7)
        np.testing.assert_allclose(a.detach().float().numpy(), w, err_msg=what, **tol)


# -- BEVNet ------------------------------------------------------------------


@pytest.mark.parametrize(
    "family,amp,tol",
    [("concat", False, 1e-4), ("concat", True, 5e-2), ("deform_attn", False, 1e-4), ("deform_attn", True, 5e-2)],
    ids=["concat-f32", "concat-bf16", "deform-f32", "deform-bf16"],
)
def test_bevnet_per_frame_forward_matches_flax(interpret, family, amp, tol):
    """Every head output and bev_feat, from the same weights, with another
    calibration in every frame."""
    raw = _raw({"MODEL": DEFORM if family == "deform_attn" else {}, "RUNTIME": {"USE_AMP": amp}})
    model, v = _variables(jcfg.from_dict(raw), seed=5)
    b = _batch(7)
    want = jax.jit(lambda v, i, k, r: model.apply(v, i, k, r, train=False))(v, b["images"], b["K"], b["Rt"])
    net = BEVNet.from_config(tcfg.from_dict(raw))
    assert not net.static_cameras
    net.load_state_dict(state_dict_from_flax(v))
    net.eval()
    with torch.no_grad():
        got = net(*(torch.from_numpy(b[k]) for k in ("images", "K", "Rt")))
    assert set(got) == set(want)
    for k in ("heatmap_logits", "heatmap", "offset", "size_raw", "bev_feat") + (() if amp else ("size",)):
        w = np.asarray(want[k], dtype=np.float32)
        assert got[k].shape == w.shape, k
        scale = max(1.0, np.abs(w).max())
        np.testing.assert_allclose(got[k].numpy(), w, atol=tol * scale, rtol=tol, err_msg=k)
        assert np.abs(got[k].numpy() - w).mean() <= 0.2 * tol * scale, k
    # the calibrations matter: frame 1 under frame 0's cameras is another map
    with torch.no_grad():
        swapped = net(torch.from_numpy(b["images"]), torch.from_numpy(b["K"][[0, 0]]), torch.from_numpy(b["Rt"][[0, 0]]))
    assert float((swapped["bev_feat"][1] - got["bev_feat"][1]).abs().max()) > 0.1
    np.testing.assert_allclose(swapped["bev_feat"][0].numpy(), got["bev_feat"][0].numpy(), atol=1e-5)


@pytest.mark.parametrize("family", ["concat", "deform_attn"])
def test_bevnet_per_frame_equals_static_on_equal_cameras(family):
    """With one calibration in every frame the per-frame model equals the
    static one in f32 (in bf16 they differ by the weights' rounding: the
    dense warp keeps f32 weights)."""
    over = DEFORM if family == "deform_attn" else {}
    b = _batch(9, same=True)
    nets = []
    for static in (True, False):
        net = BEVNet.from_config(tcfg.from_dict(_raw({"MODEL": {**over, "STATIC_CAMERAS": static}})))
        if nets:
            net.load_state_dict(nets[0].state_dict())
        else:
            torch.manual_seed(3)
            for p in net.parameters():
                torch.nn.init.normal_(p, std=0.1)
        nets.append(net.eval())
    with torch.no_grad():
        outs = [net(*(torch.from_numpy(b[k]) for k in ("images", "K", "Rt"))) for net in nets]
    for k in ("heatmap_logits", "offset", "size_raw", "bev_feat"):
        ref = outs[0][k]
        assert float(ref.abs().max()) > 0
        np.testing.assert_allclose(outs[1][k].numpy(), ref.numpy(), atol=1e-5 * max(1.0, float(ref.abs().max())), rtol=1e-4, err_msg=k)


def test_deform_per_frame_fusion_gradients_match_jax(interpret):
    """The gradients of the deformable family's own parameters (query
    projection, value/offsets/attn/out, the applied encoder projection)
    with per-frame cameras, of a fixed functional of the eval-mode
    outputs, against jax.grad."""
    raw = _raw({"MODEL": DEFORM})
    model, v = _variables(jcfg.from_dict(raw), seed=11)
    b = _batch(13)
    rng = np.random.default_rng(2)
    probe = {k: rng.standard_normal((B, *BEV, c)).astype(np.float32)
             for k, c in (("heatmap_logits", 1), ("offset", 2), ("size_raw", 2))}
    keys = ("query_proj", "query_proj_bias", "deform_fusion")

    def loss(sub):
        params = {**v["params"], **sub, "encoder": {**v["params"]["encoder"], "proj": sub["proj"]}}
        params.pop("proj")
        out = model.apply({"params": params, "batch_stats": v["batch_stats"]}, b["images"], b["K"], b["Rt"], train=False)
        return sum(jnp.sum(out[k] * probe[k]) for k in probe)

    sub = {k: v["params"][k] for k in keys}
    sub["proj"] = v["params"]["encoder"]["proj"]
    want = _tree_np(jax.jit(jax.grad(loss))(sub))
    want_sd = {
        "query_proj": want["query_proj"], "query_proj_bias": want["query_proj_bias"],
        "encoder.proj.weight": np.transpose(want["proj"]["kernel"], (3, 2, 0, 1)), "encoder.proj.bias": want["proj"]["bias"],
        **{f"deform_fusion.{n}.{t}": (want["deform_fusion"][n]["kernel"].T if t == "weight" else want["deform_fusion"][n]["bias"])
           for n in ("value", "offsets", "attn", "out") for t in ("weight", "bias")},
    }
    net = BEVNet.from_config(tcfg.from_dict(raw))
    net.load_state_dict(state_dict_from_flax(v))
    net.eval()
    out = net(*(torch.from_numpy(b[k]) for k in ("images", "K", "Rt")))
    total = sum((out[k] * torch.from_numpy(probe[k])).sum() for k in probe)
    named = dict(net.named_parameters())
    grads = torch.autograd.grad(total, [named[k] for k in want_sd])
    for (k, w), g in zip(want_sd.items(), grads):
        assert np.abs(w).max() > 1e-6, k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()) + 1e-5, err_msg=k)


# -- the train step ----------------------------------------------------------


def _train_step_pair(raw, weight_seed, batch_seed, interpret):
    """One call of both train steps on the same weights and batch: metrics,
    gradients, parameters, statistics of JAX (``want``) and of the port
    (``got``). ``interpret``: the JAX model's Pallas kernels in interpret
    mode; else its XLA path, the plain reference off the TPU."""
    cfg = jcfg.from_dict(raw)
    batch = _batch(batch_seed)
    model, v = _variables(cfg, seed=weight_seed)
    tx = joptim.build_optimizer(cfg, steps_per_epoch=SPE)
    jst = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
        opt_state=tx.init(v["params"]), apply_fn=model.apply, tx=tx,
    )
    jstep = jstate.make_train_step(cfg)
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

    fn = jax.jit(lambda s, b: (*jstep(s, b), grads_of(s, b)))
    jbevnet.FORCE_PALLAS_INTERPRET = interpret
    jwarp.FORCE_GROUPED_INTERPRET = interpret
    try:
        jst, metrics, grads = fn(jst, batch)
    finally:
        jbevnet.FORCE_PALLAS_INTERPRET = False
        jwarp.FORCE_GROUPED_INTERPRET = False
    want = (
        {k: float(x) for k, x in metrics.items()},
        params_from_flax(_tree_np(grads)),
        params_from_flax(_tree_np(jst.params)),
        {k: t for k, t in batch_stats_from_flax(_tree_np(jst.batch_stats)).items()
         if k.endswith(("running_mean", "running_var"))},
    )
    tc = tcfg.from_dict(raw)
    state = create_state(tc, state_dict_from_flax(v), device="cpu", steps_per_epoch=SPE)
    initial = {k: t.clone() for k, t in state.model.state_dict().items()}
    captured = {}
    apply = state.tx.update

    def spy(opt_state, mod, grads):
        captured["grads"] = {k: g.clone() for k, g in grads.items()}
        return apply(opt_state, mod, grads)

    state.tx.update = spy
    metrics = make_train_step(tc)(state, batch)
    sd = state.model.state_dict()
    got = (
        {k: float(x) for k, x in metrics.items()},
        captured["grads"],
        {k: t.clone() for k, t in sd.items() if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))},
        {k: t.clone() for k, t in sd.items() if k.endswith(("running_mean", "running_var"))},
    )
    return SimpleNamespace(cfg=cfg, want=want, got=got, initial=initial)


@pytest.fixture(scope="module")
def step():
    """One call of both train steps (concat through the dense warp, a
    calibration a frame), the JAX side's Pallas kernels in interpret mode."""
    return _train_step_pair(_raw({}), weight_seed=3, batch_seed=31, interpret=True)


@pytest.fixture(scope="module")
def deform_step():
    """One call of both train steps of the deformable family with a
    calibration a frame (the per-frame query warp and the sampler at
    G = B * V groups, ATTN_STRIDE 2 with the residual upsample); the JAX
    side through its XLA path. The seeds keep every sample off a pixel
    border and every ReLU and clip off its corner, where the derivative
    jumps and rounding decides the side: seeds that put one there move
    single gradients (an offsets weight, a GroupNorm bias) by up to 4e-3
    and, through the query, the encoder's."""
    return _train_step_pair(_raw({"MODEL": DEFORM}), weight_seed=23, batch_seed=43, interpret=False)


def _close(got, want, what):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()) + 1e-5, err_msg=what)


def _check_losses(step):
    assert step.got[0].keys() == step.want[0].keys()
    for k, w in step.want[0].items():
        np.testing.assert_allclose(step.got[0][k], w, rtol=1e-4, err_msg=k)
    assert step.got[0]["grad_norm"] > 0


def _check_gradients(step, nonzero):
    assert step.got[1].keys() == step.want[1].keys()
    for k, w in step.want[1].items():
        _close(step.got[1][k], w, f"d/d {k}")
    for k in nonzero:
        assert float(step.got[1][k].abs().max()) > 1e-6, k


def _check_updated_params(step):
    lr, wd = step.cfg.train.lr, step.cfg.train.weight_decay
    assert step.got[2].keys() == step.want[2].keys()
    for k, w in step.want[2].items():
        grad = np.asarray(step.want[1][k])
        noise = np.abs(grad + wd * step.initial[k].numpy()) <= 1e-4 * np.abs(grad).max() + 1e-5
        want_p, got_p = np.asarray(w), step.got[2][k].numpy()
        np.testing.assert_allclose(got_p[~noise], want_p[~noise], rtol=1e-4, atol=1e-4 * lr, err_msg=k)
        assert np.all(np.abs(got_p - want_p)[noise] <= 2 * lr), k
    assert any(not torch.equal(step.got[2][k], step.initial[k]) for k in step.got[2])


def _check_batch_stats(step):
    assert step.got[3].keys() == step.want[3].keys()
    for k, w in step.want[3].items():
        _close(step.got[3][k], w, k)


def test_per_frame_train_step_losses_and_grad_norm_match_jax(step):
    _check_losses(step)


def test_per_frame_train_step_gradients_match_jax(step):
    _check_gradients(step, ("view_proj", "encoder.proj.weight", "encoder.backbone.stem_conv.weight"))


def test_per_frame_train_step_updated_params_match_jax(step):
    """As tests/test_torch_train.py: where gradient + decay is within the
    gradient rule's tolerance of 0, Adam's first step has a sign of
    rounding noise, and those elements are held to 2 * lr."""
    _check_updated_params(step)


def test_per_frame_train_step_batch_stats_match_jax(step):
    _check_batch_stats(step)


def test_per_frame_deform_train_step_losses_and_grad_norm_match_jax(deform_step):
    _check_losses(deform_step)


def test_per_frame_deform_train_step_gradients_match_jax(deform_step):
    """Every parameter's gradient, the sampling heads' (which learn only
    through the sampler's d_wts) among them."""
    _check_gradients(deform_step, ("query_proj", "encoder.proj.weight", "deform_fusion.offsets.weight",
                                   "deform_fusion.attn.weight", "encoder.backbone.stem_conv.weight"))


def test_per_frame_deform_train_step_updated_params_match_jax(deform_step):
    _check_updated_params(deform_step)


def test_per_frame_deform_train_step_batch_stats_match_jax(deform_step):
    _check_batch_stats(deform_step)

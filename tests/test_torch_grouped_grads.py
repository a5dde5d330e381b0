"""vsta_tpu_torch grouped sampler, the two one-sided gradients: the plain
versions of scatter_taps_grouped and taps_dot_grouped against the TPU
kernels scatter_taps_windowed and taps_dot_grouped in Pallas interpret
mode, the dispatch of GroupedSample.backward, and the size rule that
draws the line between the fused and the one-sided kernels, on the CPU.
The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py.

Tolerances: float32 to 1e-5 (sums run in other orders). bfloat16 exactly,
on inputs chosen so that every product and every sum is exact in float32
(small integers for maps and cotangents, live weights in [2**-5, 1]),
which is inside the 2 bf16 ulps of the reference's magnitude that the
kernels owe: both sides then round once, to the same value. Both tap
constructions are covered: the unpadded LUT (precompute_warp_lut, whose
masked taps clamp onto live rows) and the padded anchored taps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vsta_tpu.ops import warp_pallas as jwp
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.convert import init_state_dict
from vsta_tpu_torch.data.synthetic import make_ring_camera
from vsta_tpu_torch.models import BEVNet
from vsta_tpu_torch.ops import grouped_cuda as gc
from vsta_tpu_torch.ops.warp import anchored_taps, flat_taps, precompute_warp_lut

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


HF, WF = 6, 9
G, N = 3, 300
F32 = dict(atol=1e-5, rtol=1e-5)


def _coords(rng, shape):
    c = np.stack(
        [rng.uniform(-1.5, WF + 0.5, shape), rng.uniform(-1.5, HF + 0.5, shape)], axis=-1
    ).astype(np.float32)
    flat = c.reshape(-1, 2)
    flat[::37, 0] = np.nan
    flat[5::41, 1] = np.inf
    return c


def _taps(rng, taps, exact):
    """(idx [G, N, 4] int32, wts [G, N, 4] float32, P) for one of the two
    tap constructions; ``exact`` swaps the live weights for random ones in
    [2**-5, 1] (masked taps stay at 0)."""
    coords = torch.from_numpy(_coords(rng, (G, N)))
    if taps == "lut":
        idx, w = precompute_warp_lut(coords, (HF, WF))
        P = HF * WF
    else:
        anchors, w = anchored_taps(coords, (HF, WF))
        idx, P = flat_taps(anchors, WF + 1), (HF + 1) * (WF + 1)
    if exact:
        r = torch.from_numpy(rng.uniform(2.0**-5, 1.0, (G, N, 4)).astype(np.float32))
        w = torch.where(w != 0, r, torch.zeros_like(w))
    return idx.contiguous(), w.contiguous(), P


def _values(rng, shape, exact):
    if exact:
        return rng.integers(-4, 5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _t(a, dtype):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _compare(got, want, exact):
    got, want = got.detach().float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32))
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **F32)


CASES = [
    pytest.param(taps, K, dtype, id=f"{taps}-{dtype}-K{K}")
    for taps in ("lut", "anchored")
    for dtype in ("float32", "bfloat16")
    for K in (16, 13)
]


@pytest.mark.parametrize("taps,K,dtype", CASES)
def test_scatter_taps_grouped_ref_matches_pallas(rng, taps, K, dtype):
    exact = dtype == "bfloat16"
    idx, wts, P = _taps(rng, taps, exact)
    gout = _values(rng, (G, N, K), exact)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jwp.scatter_taps_windowed(
            jnp.asarray(gout).astype(jdt), jnp.asarray(idx.numpy()), jnp.asarray(wts.numpy()), P,
            compute_dtype=jdt,
        )
    got = gc.scatter_taps_grouped_ref(_t(gout, tdt), idx, wts, P)
    assert got.dtype == torch.float32 and got.shape == (G, P, K)
    _compare(got, want, exact)


# row 5 also at K = 26, an even ragged K like the flagship's 82, which the
# CUDA kernel takes two channels a load
DOT_CASES = CASES + [
    pytest.param(taps, 26, dtype, id=f"{taps}-{dtype}-K26")
    for taps in ("lut", "anchored")
    for dtype in ("float32", "bfloat16")
]


@pytest.mark.parametrize("taps,K,dtype", DOT_CASES)
def test_taps_dot_grouped_ref_matches_pallas(rng, taps, K, dtype):
    exact = dtype == "bfloat16"
    idx, wts, P = _taps(rng, taps, exact)
    maps = _values(rng, (G, P, K), exact)
    gout = _values(rng, (G, N, K), exact)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jwp.taps_dot_grouped(
        jnp.asarray(maps).astype(jdt), jnp.asarray(gout).astype(jdt), jnp.asarray(idx.numpy()),
        jnp.asarray(wts.numpy()), compute_dtype=jdt, interpret=True,
    )
    got = gc.taps_dot_grouped_ref(_t(maps, tdt), _t(gout, tdt), idx)
    assert got.dtype == torch.float32 and got.shape == (G, N, 4)
    _compare(got, want, exact)


def test_one_sided_refs_equal_the_fused_ref(rng):
    idx, wts, P = _taps(rng, "anchored", exact=False)
    maps, gout = _t(_values(rng, (G, P, 8), False), torch.float32), _t(_values(rng, (G, N, 8), False), torch.float32)
    dm, dw = gc.scatter_tapdot_grouped_ref(maps, gout, idx, wts)
    assert torch.equal(dm, gc.scatter_taps_grouped_ref(gout, idx, wts, P))
    assert torch.equal(dw, gc.taps_dot_grouped_ref(maps, gout, idx))


def test_taps_dot_keeps_zero_weight_taps(rng):
    """d_wts is taken for every tap, whatever its weight."""
    idx, wts, P = _taps(rng, "anchored", exact=False)
    maps, gout = _t(_values(rng, (G, P, 8), False), torch.float32), _t(_values(rng, (G, N, 8), False), torch.float32)
    dw = gc.taps_dot_grouped(maps, gout, idx)
    assert torch.equal(dw, gc.scatter_tapdot_grouped(maps, gout, idx, torch.zeros_like(wts))[1])
    assert torch.count_nonzero(dw) == dw.numel()
    assert torch.count_nonzero(gc.scatter_taps_grouped(gout, idx, torch.zeros_like(wts), P)) == 0


def test_inverse_taps_leaves_out_dead_taps(rng):
    """tap_lut: every tap of weight 0 sorts after every live tap, in flat
    order, with the dead key G*P; the live ones as numpy's stable argsort
    orders them, for both tap constructions' masked taps."""
    for taps in ("anchored", "lut"):
        idx, wts, P = _taps(rng, taps, exact=False)
        live = wts != 0
        lut = gc.tap_lut(idx, wts, P)
        n_live = int(live.sum())
        assert 0 < n_live < G * N * 4
        flat = (idx.long() + torch.arange(G)[:, None, None] * P).reshape(-1).numpy()
        key = np.where(live.reshape(-1).numpy(), flat, G * P)
        order = np.argsort(key, kind="stable")
        np.testing.assert_array_equal(lut.order.numpy(), order)
        np.testing.assert_array_equal(lut.rows.numpy(), key[order])
        np.testing.assert_array_equal(lut.order[n_live:].numpy(), np.nonzero(~live.reshape(-1).numpy())[0])
        assert bool((lut.rows[n_live:] == G * P).all()) and bool((lut.rows[:n_live] < G * P).all())


def test_one_sided_wrappers_on_cpu_take_the_plain_versions(rng):
    idx, wts, P = _taps(rng, "anchored", exact=False)
    maps, gout = _t(_values(rng, (G, P, 8), False), torch.float32), _t(_values(rng, (G, N, 8), False), torch.float32)
    before = (gc.scatter_taps_grouped.launches, gc.taps_dot_grouped.launches)
    assert torch.equal(gc.scatter_taps_grouped(gout, idx, wts, P), gc.scatter_taps_grouped_ref(gout, idx, wts, P))
    assert torch.equal(gc.taps_dot_grouped(maps, gout, idx), gc.taps_dot_grouped_ref(maps, gout, idx))
    assert (gc.scatter_taps_grouped.launches, gc.taps_dot_grouped.launches) == before


def test_one_sided_wrappers_reject_bad_inputs():
    maps, gout = torch.zeros(2, 10, 8), torch.zeros(2, 5, 8)
    idx, wts = torch.zeros(2, 5, 4, dtype=torch.int32), torch.zeros(2, 5, 4)
    with pytest.raises(ValueError):
        gc.scatter_taps_grouped(gout[:, :4], idx, wts, 10)
    with pytest.raises(ValueError):
        gc.scatter_taps_grouped(gout[0], idx, wts, 10)
    with pytest.raises(TypeError):
        gc.scatter_taps_grouped(gout.half(), idx, wts, 10)
    with pytest.raises(TypeError):
        gc.scatter_taps_grouped(gout, idx.long(), wts, 10)
    with pytest.raises(ValueError):
        gc.taps_dot_grouped(maps, gout.to(torch.bfloat16), idx)
    with pytest.raises(ValueError):
        gc.taps_dot_grouped(maps[:1], gout, idx)
    with pytest.raises(TypeError):
        gc.taps_dot_grouped(maps, gout, idx.long())


# -- the dispatch of GroupedSample.backward -------------------------------


def _counting_kernels(calls):
    def wrap(name, fn):
        def counted(*args):
            calls.append(name)
            return fn(*args)
        return counted

    return gc.GroupedKernels(*(wrap(n, f) for n, f in zip(gc.GroupedKernels._fields, gc.PLAIN)))


@pytest.mark.parametrize(
    "need_maps,need_wts,fits,want",
    [
        (True, False, True, ["scatter_taps"]),
        (True, False, False, ["scatter_taps"]),
        (False, True, True, ["taps_dot"]),
        (True, True, True, ["scatter_tapdot"]),
        (True, True, False, ["scatter_taps", "taps_dot"]),
    ],
    ids=["maps-only", "maps-only-large", "wts-only", "both-fused", "both-split"],
)
def test_grouped_sample_backward_dispatch(rng, monkeypatch, need_maps, need_wts, fits, want):
    """Which kernels the backward runs, by what needs a gradient and by the
    size rule, and that every route gives the same gradients."""
    idx, wts, P = _taps(rng, "anchored", exact=False)
    maps = _t(_values(rng, (G, P, 8), False), torch.float32)
    gout = _t(_values(rng, (G, N, 8), False), torch.float32)
    monkeypatch.setattr(gc, "fused_backward_fits", lambda *a: fits)
    calls = []
    m, w = maps.clone().requires_grad_(need_maps), wts.clone().requires_grad_(need_wts)
    out = gc.GroupedSample.apply(m, idx, w, _counting_kernels(calls))
    assert calls == ["sample"]
    del calls[:]
    out.backward(gout)
    assert calls == want
    ref_dm, ref_dw = gc.scatter_tapdot_grouped_ref(maps, gout, idx, wts)
    assert (m.grad is not None) == need_maps and (w.grad is not None) == need_wts
    if need_maps:
        assert torch.equal(m.grad, ref_dm)
    if need_wts:
        assert torch.equal(w.grad, ref_dw)


# the four callers of the flagship and deformable configurations:
# (P, N, K, bf16) -> whether the reference takes its fused kernel
P_FLAG = 35 * 61
ROUTES = [
    pytest.param(P_FLAG, 43_200, 2 * 64, True, id="query-warp-batch2"),
    pytest.param(P_FLAG, 43_200, 2 * 41, True, id="flagship-warp-batch2"),
    pytest.param(P_FLAG, 43_200, 4 * 41, False, id="flagship-warp-batch4"),
    pytest.param(P_FLAG, 43_200, 8 * 64, False, id="query-warp-batch8"),
    pytest.param(P_FLAG, 10_800, 32, True, id="deform-sampler-stride4"),
    pytest.param(P_FLAG, 172_800, 32, False, id="deform-sampler-stride1"),
]


@pytest.mark.parametrize("P,N,K,fused", ROUTES)
def test_fused_backward_fits_at_the_model_shapes(P, N, K, fused):
    assert gc.fused_backward_fits(P, N, K, torch.bfloat16) == fused


@pytest.mark.parametrize("n,dtype", [(300, "float32"), (46_000, "float32"), (300, "bfloat16"), (90_000, "bfloat16")])
def test_fused_backward_fits_matches_the_reference_rule(rng, n, dtype):
    """The port's copy of the rule against the JAX package's
    scatter_tapdot_grouped, which returns None where it does not take the
    fused kernel (the large N return before any arithmetic)."""
    P, K = (HF + 1) * (WF + 1), 16
    jdt = getattr(jnp, dtype)
    maps, gout = jnp.zeros((1, P, K), jdt), jnp.zeros((1, n, K), jdt)
    idx, wts = jnp.zeros((1, n, 4), jnp.int32), jnp.zeros((1, n, 4), jnp.float32)
    took = jwp.scatter_tapdot_grouped(maps, gout, idx, wts, compute_dtype=jdt, interpret=True) is not None
    assert gc.fused_backward_fits(P, n, K, getattr(torch, dtype)) == took
    assert took == (n == 300)


def test_flagship_gradients_unchanged_by_the_dispatch(rng):
    """The flagship warp's weights come from the calibration, so its
    backward now runs scatter_taps alone. Its gradients equal those of a
    backward forced through the fused function."""
    cfg = tcfg.from_dict({
        "DATA": {"IMG_SIZE": [3, 64, 96], "VIEWS": 3},
        "MODEL": {"BACKBONE": "efficientnet_b0", "FEAT_DIM": 48, "BEV_SIZE": [32, 16, 48],
                  "BEV_BOUNDS": [-12.0, 12.0, -4.0, 4.0], "BEV_PROJ_CH": 48, "HEAD_MID1": 64,
                  "HEAD_MID2": 32, "WARP_IMPL": "pallas"},
        "RUNTIME": {"USE_AMP": False},
    })
    model = BEVNet.from_config(cfg)
    model.load_state_dict(init_state_dict(cfg, seed=2))
    model.eval()
    Ks, Rts = zip(*(make_ring_camera(v, 3, radius=10.0, height=4.0, img_hw=(64, 96)) for v in range(3)))
    K = torch.from_numpy(np.stack(Ks)[None].astype(np.float32))
    Rt = torch.from_numpy(np.stack(Rts)[None].astype(np.float32))
    images = torch.from_numpy(rng.standard_normal((1, 3, 64, 96, 3)).astype(np.float32))
    calls = []

    def fused_only(gout, idx, wts, P):  # dmaps through the fused function
        calls.append("fused")
        maps = torch.zeros((gout.shape[0], P, gout.shape[2]), dtype=gout.dtype)
        return gc.scatter_tapdot_grouped_ref(maps, gout, idx, wts)[0]

    def grads(grouped):
        model.grouped = grouped
        params = [p for p in model.parameters() if p.requires_grad]
        out = model(images, K, Rt)["heatmap_logits"]
        return torch.autograd.grad(out.square().sum(), params, allow_unused=True)

    counted = []
    got = grads(_counting_kernels(counted))
    assert counted == ["sample", "scatter_taps"]
    want = grads(gc.PLAIN._replace(scatter_taps=fused_only))
    assert calls == ["fused"]
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)

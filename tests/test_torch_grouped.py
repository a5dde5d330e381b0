"""vsta_tpu_torch grouped sampler: the plain versions of the two CUDA kernels
(sample_tiles_grouped, scatter_tapdot_grouped) against the TPU kernels in
Pallas interpret mode, the sampler's autograd Function against the custom
VJP of _warp_pairs_shared, and the differentiable fused warp + projection
against the JAX one, on the CPU. The kernels themselves are held against
the plain versions on the card by chip_smoke.py.

Tolerances: float32 to 1e-5 (sums run in other orders). bfloat16 exactly,
on inputs chosen so that every product and every sum is exact in float32:
maps and cotangents are small integers and live weights lie in
[2**-5, 1], so a bf16-rounded weight is a multiple of 2**-12 and no sum
needs more than 24 bits. Both sides then round once, to the same value;
a side that skipped the bf16 rounding of the weights would not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsta_tpu.ops import warp as jwarp
from vsta_tpu.ops import warp_pallas as jwp
from vsta_tpu_torch.ops import grouped_cuda as gc
from vsta_tpu_torch.ops.warp import anchored_taps, flat_taps, gather_taps, pad_feat_br
from vsta_tpu_torch.ops.warp_cuda import FusedWarpProj, fused_warp_proj, warp_tiles_ref

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


HF, WF = 6, 9
P = (HF + 1) * (WF + 1)
G, N = 3, 300
F32 = dict(atol=1e-5, rtol=1e-5)


def _coords(rng, shape):
    """(x, y) sample coordinates over the map and a cell beyond each edge,
    with some non-finite ones."""
    c = np.stack(
        [rng.uniform(-1.5, WF + 0.5, shape), rng.uniform(-1.5, HF + 0.5, shape)], axis=-1
    ).astype(np.float32)
    flat = c.reshape(-1, 2)
    flat[::37, 0] = np.nan
    flat[5::41, 1] = np.inf
    return c


def _taps(rng, exact):
    """idx [G, N, 4] int32 from the anchored taps of random coordinates;
    wts their bilinear weights, or (exact) random weights in [2**-5, 1]
    with a fifth of them 0."""
    anchors, w = anchored_taps(torch.from_numpy(_coords(rng, (G, N))), (HF, WF))
    idx = flat_taps(anchors, WF + 1)
    if exact:
        w = rng.uniform(2.0**-5, 1.0, (G, N, 4)).astype(np.float32)
        w[rng.random((G, N, 4)) < 0.2] = 0.0
        w = torch.from_numpy(w)
    return idx, w.contiguous()


def _values(rng, shape, exact):
    if exact:
        return rng.integers(-4, 5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a)).astype(dtype)


def _t(a, dtype):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _compare(got, want, exact):
    if exact:
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), **F32)


CASES = [
    pytest.param(K, dtype, id=f"{dtype}-K{K}")
    for dtype in ("float32", "bfloat16")
    for K in (16, 13, 26)  # 13 and 26: ragged Ks, odd and even (the flagship's 82 = 2 x 41)
]


@pytest.mark.parametrize("K,dtype", CASES)
def test_sample_tiles_grouped_ref_matches_pallas(rng, K, dtype):
    exact = dtype == "bfloat16"
    idx, wts = _taps(rng, exact)
    maps = _values(rng, (G, P, K), exact)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jwp.sample_tiles_grouped(
        _j(maps, jdt), jnp.asarray(idx.numpy()), jnp.asarray(wts.numpy()),
        compute_dtype=jdt, interpret=True,
    )
    got = gc.sample_tiles_grouped_ref(_t(maps, tdt), idx, wts)
    assert got.dtype == tdt and got.shape == (G, N, K)
    _compare(got, want, exact)


@pytest.mark.parametrize("K,dtype", CASES)
def test_scatter_tapdot_grouped_ref_matches_pallas(rng, K, dtype):
    exact = dtype == "bfloat16"
    idx, wts = _taps(rng, exact)
    maps = _values(rng, (G, P, K), exact)
    gout = _values(rng, (G, N, K), exact)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_dm, want_dw = jwp.scatter_tapdot_grouped(
        _j(maps, jdt), _j(gout, jdt), jnp.asarray(idx.numpy()), jnp.asarray(wts.numpy()),
        compute_dtype=jdt, interpret=True,
    )
    dm, dw = gc.scatter_tapdot_grouped_ref(_t(maps, tdt), _t(gout, tdt), idx, wts)
    assert dm.dtype == dw.dtype == torch.float32
    assert dm.shape == (G, P, K) and dw.shape == (G, N, 4)
    _compare(dm, want_dm, exact)
    _compare(dw, want_dw, exact)


def test_zero_weight_taps_keep_their_d_wts(rng):
    """Every weight 0 and a poisoned map: dmaps is exactly 0, and d_wts is
    still <maps[idx], gout> for every tap (clamped indices are valid rows),
    as the TPU kernel computes it."""
    idx, wts = _taps(rng, exact=False)
    wts = torch.zeros_like(wts)
    maps = _values(rng, (G, P, 16), exact=False)
    maps[:, ::7] = 1e6
    gout = _values(rng, (G, N, 16), exact=False)
    dm, dw = gc.scatter_tapdot_grouped_ref(_t(maps, torch.float32), _t(gout, torch.float32), idx, wts)
    assert torch.count_nonzero(dm) == 0
    assert torch.count_nonzero(dw) == dw.numel()
    want = jwp.scatter_tapdot_grouped(
        jnp.asarray(maps), jnp.asarray(gout), jnp.asarray(idx.numpy()), jnp.asarray(wts.numpy()),
        compute_dtype=jnp.float32, interpret=True,
    )[1]
    np.testing.assert_allclose(dw.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    assert np.array_equal(_np(gc.sample_tiles_grouped_ref(_t(maps, torch.float32), idx, wts)), np.zeros((G, N, 16)))


def _numpy_lut(idx, wts, P):
    """The scatter kernels' inverse LUT in numpy: keys g*P + idx of the live
    taps, G*P for the dead ones, sorted stably."""
    G = idx.shape[0]
    live = (idx >= 0) & (idx < P) & (wts != 0)
    key = np.where(live, np.arange(G)[:, None, None] * P + idx, G * P).reshape(-1)
    order = np.argsort(key, kind="stable")
    return key[order], order


def test_inverse_taps_is_a_csr_by_source_row(rng):
    """tap_lut: the taps sorted by the source row they read, the live ones
    by g*P + idx and within a row by flat index, the dead ones (weight 0 or
    an index outside [0, P)) last, as numpy's stable argsort orders them."""
    idx, wts = _taps(rng, exact=True)
    idx[0, 3, 1] = P  # out of range: dead whatever its weight
    idx[2, 7, 0] = -1
    wts[0, 3, 1] = wts[2, 7, 0] = 0.5
    lut = gc.tap_lut(idx, wts, P)
    assert lut.rows.dtype == lut.order.dtype == torch.int32
    assert lut.rows.shape == lut.order.shape == (G * N * 4,)
    want_rows, want_order = _numpy_lut(idx.numpy(), wts.numpy(), P)
    np.testing.assert_array_equal(lut.rows.numpy(), want_rows)
    np.testing.assert_array_equal(lut.order.numpy(), want_order)
    n_live = int(((idx >= 0) & (idx < P) & (wts != 0)).sum())
    assert int((lut.rows < G * P).sum()) == n_live < G * N * 4
    assert bool((lut.rows[n_live:] == G * P).all())
    dead = set(lut.order[n_live:].tolist())
    assert {3 * 4 + 1, (2 * N + 7) * 4} <= dead


@pytest.mark.parametrize("case", ["hot-rows", "all-dead", "one-group-one-sample"])
def test_tap_lut_edge_cases(rng, case):
    """tap_lut where one row takes every live tap of a group, where no tap
    is live, and at the smallest shape: the numpy order, dead taps last."""
    if case == "one-group-one-sample":
        idx = torch.tensor([[[3, 4, 3 + WF + 1, 4 + WF + 1]]], dtype=torch.int32)
        wts = torch.tensor([[[0.5, 0.0, 0.25, 0.25]]])
    else:
        idx = torch.full((G, N, 4), 7, dtype=torch.int32)
        idx[..., 1] = 8
        wts = torch.from_numpy(rng.uniform(0.1, 1.0, (G, N, 4)).astype(np.float32))
        if case == "all-dead":
            wts[...] = 0.0
    lut = gc.tap_lut(idx, wts, P)
    want_rows, want_order = _numpy_lut(idx.numpy(), wts.numpy(), P)
    np.testing.assert_array_equal(lut.rows.numpy(), want_rows)
    np.testing.assert_array_equal(lut.order.numpy(), want_order)
    dead = lut.rows == idx.shape[0] * P
    assert int(dead.sum()) == int((wts == 0).sum())
    assert not bool(dead[:int((~dead).sum())].any())


def test_grouped_wrappers_on_cpu_take_the_plain_versions(rng):
    idx, wts = _taps(rng, exact=False)
    maps = _t(_values(rng, (G, P, 8), False), torch.float32)
    gout = _t(_values(rng, (G, N, 8), False), torch.float32)
    before = (gc.sample_tiles_grouped.launches, gc.scatter_tapdot_grouped.launches)
    assert torch.equal(gc.sample_tiles_grouped(maps, idx, wts), gc.sample_tiles_grouped_ref(maps, idx, wts))
    for a, b in zip(gc.scatter_tapdot_grouped(maps, gout, idx, wts), gc.scatter_tapdot_grouped_ref(maps, gout, idx, wts)):
        assert torch.equal(a, b)
    assert (gc.sample_tiles_grouped.launches, gc.scatter_tapdot_grouped.launches) == before


def test_grouped_wrappers_reject_bad_inputs():
    maps = torch.zeros(2, 10, 8)
    idx = torch.zeros(2, 5, 4, dtype=torch.int32)
    wts = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError):
        gc.sample_tiles_grouped(maps, idx[:1], wts[:1])
    with pytest.raises(TypeError):
        gc.sample_tiles_grouped(maps, idx.long(), wts)
    with pytest.raises(TypeError):
        gc.sample_tiles_grouped(maps.half(), idx, wts)
    with pytest.raises(ValueError):
        gc.scatter_tapdot_grouped(maps, torch.zeros(2, 5, 8, dtype=torch.bfloat16), idx, wts)
    with pytest.raises(ValueError):
        gc.scatter_tapdot_grouped(maps, torch.zeros(2, 6, 8), idx, wts)


def test_tap_helpers_match_jax(rng):
    coords = _coords(rng, (G, N))
    anchors, w = anchored_taps(torch.from_numpy(coords), (HF, WF))
    j_anchors, j_w = jwarp._anchored_taps(jnp.asarray(coords), (HF, WF))
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(j_anchors))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-6, atol=1e-7)
    assert anchors.dtype == torch.int32 and w.dtype == torch.float32
    idx = flat_taps(anchors, WF + 1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jwarp._flat_taps(j_anchors, WF + 1)))
    feats = rng.standard_normal((G, HF, WF, 5)).astype(np.float32)
    padded = pad_feat_br(torch.from_numpy(feats))
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jwarp._pad_feat_br(jnp.asarray(feats))))
    taps = gather_taps(padded.reshape(G, P, 5), idx)
    want = jwarp._gather_taps(jnp.asarray(padded.numpy()).reshape(G, P, 5), j_anchors, (HF, WF))
    np.testing.assert_array_equal(taps.numpy(), np.asarray(want))


@pytest.fixture
def force_grouped_interpret():
    jwarp.FORCE_GROUPED_INTERPRET = True
    try:
        yield
    finally:
        jwarp.FORCE_GROUPED_INTERPRET = False


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_sample_function_matches_warp_pairs_shared_vjp(rng, force_grouped_interpret, dtype):
    """GroupedSample's forward and both gradients (maps, weights) against
    jax.vjp of _warp_pairs_shared with the grouped Pallas kernels in
    interpret mode; the cotangent is in the compute dtype, as in the
    model."""
    exact = dtype == "bfloat16"
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    coords = _coords(rng, (G, N))
    j_anchors, j_w = jwarp._anchored_taps(jnp.asarray(coords), (HF, WF))
    if exact:
        j_w = jnp.asarray(_taps(rng, exact=True)[1].numpy())
    maps = _values(rng, (G, P, 12), exact)
    gout = _values(rng, (G, N, 12), exact)
    out, vjp = jax.vjp(
        lambda f, w: jwarp._warp_pairs_shared(f, j_anchors, w, (HF, WF)), _j(maps, jdt), j_w
    )
    want_df, want_dw = vjp(_j(gout, jdt))

    t_maps = _t(maps, tdt).requires_grad_(True)
    t_w = torch.from_numpy(np.array(j_w)).requires_grad_(True)
    idx = flat_taps(torch.from_numpy(np.array(j_anchors)), WF + 1)
    got = gc.GroupedSample.apply(t_maps, idx, t_w, gc.KERNELS)
    got.backward(_t(gout, tdt))
    assert got.dtype == tdt and t_maps.grad.dtype == tdt and t_w.grad.dtype == torch.float32
    _compare(got, out, exact)
    _compare(t_maps.grad, want_df, exact)
    _compare(t_w.grad, want_dw, exact)


@pytest.mark.parametrize("C,Cout", [(8, 16), (21, 6)], ids=["warp-first", "project-first"])
def test_plain_fused_warp_proj_grads_match_jax(rng, force_grouped_interpret, C, Cout):
    """fused_warp_proj (the plain, differentiable twin) against the XLA
    fused_warp_proj with the grouped sampler's Pallas kernels, f32: the
    output and the gradients of feats, kernel and bias, in both branches."""
    B, V, Hb, Wb = 2, 3, 5, 7
    coords = _coords(rng, (V, Hb, Wb))
    feats = rng.standard_normal((B, V, HF, WF, C)).astype(np.float32)
    kernel = (0.1 * rng.standard_normal((V, C, Cout))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((Cout,))).astype(np.float32)
    g = rng.standard_normal((B, Hb, Wb, Cout)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda f, k, b: jwarp.fused_warp_proj(f, jnp.asarray(coords), k, b),
        jnp.asarray(feats), jnp.asarray(kernel), jnp.asarray(bias),
    )
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (feats, kernel, bias)]
    got = fused_warp_proj(leaves[0], torch.from_numpy(coords), leaves[1], leaves[2], torch.float32)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **F32)
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("C,Cout", [(8, 16), (21, 6)], ids=["warp-first", "project-first"])
def test_fused_warp_proj_function_matches_fwp_pallas_vjp(rng, force_grouped_interpret, C, Cout):
    """FusedWarpProj (warp kernel forward, plain-VJP backward) on CPU
    tensors against jax.vjp of fused_warp_proj_pallas (resident kernel
    forward, XLA VJP with the grouped Pallas kernels backward), f32."""
    B, V, Hb, Wb = 2, 3, 5, 7
    coords = _coords(rng, (V, Hb, Wb))
    feats = rng.standard_normal((B, V, HF, WF, C)).astype(np.float32)
    kernel = (0.1 * rng.standard_normal((V, C, Cout))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((Cout,))).astype(np.float32)
    g = rng.standard_normal((B, Hb, Wb, Cout)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda f, k, b: jwp.fused_warp_proj_pallas(
            f, jnp.asarray(coords), k, b, compute_dtype=jnp.float32, interpret=True
        ),
        jnp.asarray(feats), jnp.asarray(kernel), jnp.asarray(bias),
    )
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (feats, kernel, bias)]
    got = FusedWarpProj.apply(
        leaves[0], torch.from_numpy(coords), leaves[1], leaves[2], torch.float32, warp_tiles_ref, gc.KERNELS
    )
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **F32)
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **F32)

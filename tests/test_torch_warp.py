"""vsta_tpu_torch warp: the plain version of the CUDA warp kernel against
the TPU kernels (Pallas interpret mode on the CPU), and the shared-camera
fused warp + projection against the JAX package. The kernel itself is
held against the plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vsta_tpu.data.synthetic import make_ring_camera
from vsta_tpu.geometry import bev_sample_coords, ground_grid
from vsta_tpu.ops import warp_pallas as jwp
from vsta_tpu.ops.warp import fused_warp_proj as j_fused
from vsta_tpu.ops.warp import precompute_warp_lut as j_lut
from vsta_tpu_torch.ops import warp_cuda
from vsta_tpu_torch.ops.warp_cuda import (
    fused_warp_proj_cuda,
    warp_out_dtype,
    warp_tiles,
    warp_tiles_ref,
)

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


BOUNDS = (-12.0, 12.0, -6.0, 6.0)
IMG, FEAT, BEV = (108, 192), (14, 24), (16, 32)
N = BEV[0] * BEV[1]


# ring cameras with intrinsics for IMG, so every BEV cell lands on the
# 14x24 map and the taps carry real weights
CAMERAS = tuple(
    np.stack(a).astype(np.float32)
    for a in zip(*(make_ring_camera(v, 7, img_hw=IMG) for v in range(7)))
)


def _lut(V):
    Ks, Rts = CAMERAS
    grid = ground_grid(BEV[0], BEV[1], BOUNDS)
    coords = bev_sample_coords(jnp.asarray(Ks[:V]), jnp.asarray(Rts[:V]), IMG, FEAT, grid)
    idx, wts = j_lut(coords.reshape(V, N, 2), FEAT)
    return coords, np.array(idx), np.array(wts)


def test_lut_cameras_see_the_map():
    """The warp tests hold real taps: every ring camera samples the map
    (cameras for another image size saw none of it, and every weight the
    tests compared was 0)."""
    _, _, wts = _lut(7)
    assert (wts.reshape(7, -1) > 0).any(axis=1).all()
    assert (wts > 0).mean() > 0.5


def _ref(flat, idx, wts, out_dtype=torch.float32):
    return warp_tiles_ref(
        torch.from_numpy(flat), torch.from_numpy(idx), torch.from_numpy(wts), out_dtype=out_dtype
    ).numpy()


@pytest.mark.parametrize(
    "kernel,K,dtype",
    [
        pytest.param(kernel, K, dtype, id=f"{kernel}-{K}" + ("-bf16" if dtype == "bfloat16" else ""))
        for dtype in ("float32", "bfloat16")
        for kernel in ("resident", "windowed")
        for K in (16, 21)
    ],
)
def test_warp_tiles_ref_matches_pallas_kernels(rng, kernel, K, dtype):
    """warp_tiles_ref == warp_tiles_resident (compute-dtype out) and
    warp_tiles_windowed (f32 out), for a K that is a multiple of 8 and one
    that is not. In bf16 both round each tap weight to bf16 before the
    product (the TPU kernels cast their one-hot weight matrix to the
    compute dtype), so every product is exact in f32 and only the order of
    the f32 sum differs: the resident kernel's bf16 output is then equal
    exactly, the windowed kernel's f32 output to 1e-5, as in f32. Weights
    left in f32 miss by up to 1 bf16 ulp on 41 % of the outputs."""
    V = 7
    _, idx, wts = _lut(V)
    flat = rng.standard_normal((V, FEAT[0] * FEAT[1], K)).astype(np.float32)
    fn = jwp.warp_tiles_resident if kernel == "resident" else jwp.warp_tiles_windowed
    jdt = getattr(jnp, dtype)
    feats = jnp.asarray(flat).astype(jdt)
    with pltpu.force_tpu_interpret_mode():
        want = fn(feats, jnp.asarray(idx), jnp.asarray(wts), compute_dtype=jdt)
    out_dtype = torch.float32 if kernel == "windowed" else getattr(torch, dtype)
    assert want.dtype == (jnp.float32 if kernel == "windowed" else jdt)
    got = warp_tiles_ref(
        torch.from_numpy(np.array(feats.astype(jnp.float32))).to(getattr(torch, dtype)),
        torch.from_numpy(idx), torch.from_numpy(wts), out_dtype=out_dtype,
    ).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if kernel == "resident" and dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_warp_tiles_all_views_blind_is_exactly_zero(rng):
    """Every tap masked: zero output whatever the (poisoned) source holds,
    for the TPU kernels and the port alike."""
    V = 7
    _, idx, wts = _lut(V)
    wts = wts * 0.0
    poisoned = np.full((V, FEAT[0] * FEAT[1], 8), 1e6, np.float32)
    with pltpu.force_tpu_interpret_mode():
        for fn in (jwp.warp_tiles_resident, jwp.warp_tiles_windowed):
            out = fn(jnp.asarray(poisoned), jnp.asarray(idx), jnp.asarray(wts), compute_dtype=jnp.float32)
            np.testing.assert_array_equal(np.asarray(out), 0.0)
    np.testing.assert_array_equal(_ref(poisoned, idx, wts), 0.0)


def test_warp_tiles_blind_view_ignores_its_source(rng):
    V = 7
    _, idx, wts = _lut(V)
    wts[0] = 0.0
    flat = rng.standard_normal((V, FEAT[0] * FEAT[1], 8)).astype(np.float32)
    poisoned = flat.copy()
    poisoned[0] = 1e6
    np.testing.assert_array_equal(_ref(flat, idx, wts), _ref(poisoned, idx, wts))


def test_warp_tiles_on_cpu_takes_the_plain_version(rng):
    V = 3
    _, idx, wts = _lut(V)
    flat = torch.from_numpy(rng.standard_normal((V, FEAT[0] * FEAT[1], 8)).astype(np.float32))
    before = warp_tiles.launches
    out = warp_tiles(flat, torch.from_numpy(idx), torch.from_numpy(wts), out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (N, 8)
    assert warp_tiles.launches == before  # no kernel on the CPU
    want = warp_tiles_ref(flat, torch.from_numpy(idx), torch.from_numpy(wts), out_dtype=torch.bfloat16)
    assert torch.equal(out, want)


def test_warp_tiles_rejects_bad_inputs():
    f = torch.zeros(2, 10, 8)
    idx = torch.zeros(2, 5, 4, dtype=torch.int32)
    wts = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError):
        warp_tiles(f, idx[:1], wts[:1], out_dtype=torch.float32)
    with pytest.raises(TypeError):
        warp_tiles(f, idx.long(), wts, out_dtype=torch.float32)
    with pytest.raises(TypeError):
        warp_tiles(f.half(), idx, wts, out_dtype=torch.float32)


@pytest.mark.parametrize(
    "V,P,K,dtype",
    [
        (7, 34 * 60, 16 * 128, "bfloat16"),  # flagship AMP, batch 16: resident
        (7, 34 * 60, 19 * 128, "bfloat16"),
        (7, 34 * 60, 20 * 128, "bfloat16"),  # windowed
        (7, 34 * 60, 16 * 128, "float32"),  # windowed
        (7, 34 * 60, 1 * 128, "float32"),
        (3, 96, 64, "float32"),
    ],
)
def test_warp_out_dtype_follows_the_tpu_dispatch(V, P, K, dtype):
    """The port stores the compute dtype exactly where the TPU dispatch
    picks the resident kernel (warp_pallas.py:540-544) and f32 elsewhere."""
    itemsize = jnp.dtype(dtype).itemsize
    p_res = jwp._round_up(P, 8) + jwp.RWIN
    resident = V * p_res * jwp._round_up(K, 128) * itemsize <= jwp.RESIDENT_BUDGET_BYTES
    tdtype = getattr(torch, dtype)
    assert warp_out_dtype(V, P, K, tdtype) == (tdtype if resident else torch.float32)


@pytest.mark.parametrize("C,Cout", [(8, 16), (21, 6)])
def test_fused_warp_proj_cuda_matches_pallas(rng, C, Cout):
    """The shared-camera twin of _fwp_pallas_impl on CPU tensors against
    fused_warp_proj_pallas(interpret=True), f32."""
    B, V = 2, 7
    coords, _, _ = _lut(V)
    feats = rng.standard_normal((B, V, FEAT[0], FEAT[1], C)).astype(np.float32)
    kernel = (rng.standard_normal((V, C, Cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((Cout,)) * 0.1).astype(np.float32)
    want = jwp.fused_warp_proj_pallas(
        jnp.asarray(feats), coords, jnp.asarray(kernel), jnp.asarray(bias),
        compute_dtype=jnp.float32, interpret=True,
    )
    got = fused_warp_proj_cuda(
        torch.from_numpy(feats), torch.from_numpy(np.array(coords)),
        torch.from_numpy(kernel), torch.from_numpy(bias), torch.float32,
    )
    assert got.shape == (B, BEV[0], BEV[1], Cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("C,Cout", [(8, 16), (21, 6)])
def test_plain_fused_warp_proj_matches_jax(rng, C, Cout):
    """fused_warp_proj_cuda on CPU tensors, the plain shared-camera fused
    warp + projection, against the XLA one (which warps first when
    C_out >= C and projects first otherwise), f32."""
    B, V = 2, 5
    coords, _, _ = _lut(V)
    feats = rng.standard_normal((B, V, FEAT[0], FEAT[1], C)).astype(np.float32)
    kernel = (rng.standard_normal((V, C, Cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((Cout,)) * 0.1).astype(np.float32)
    want = j_fused(jnp.asarray(feats), coords, jnp.asarray(kernel), jnp.asarray(bias))
    before = warp_tiles.launches
    got = fused_warp_proj_cuda(
        torch.from_numpy(feats), torch.from_numpy(np.array(coords)),
        torch.from_numpy(kernel), torch.from_numpy(bias), torch.float32,
    )
    assert warp_tiles.launches == before  # the plain version on the CPU
    assert got.shape == (B, BEV[0], BEV[1], Cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_fused_warp_proj_cuda_rejects_per_frame_cameras():
    """Per-frame coordinates [B, V, Hb, Wb, 2] now run (the dense warp,
    held to the JAX package in test_torch_perframe.py); what is rejected
    is a layout that is neither that nor the shared [V, Hb, Wb, 2]."""
    feats = torch.zeros(1, 2, 4, 4, 3)
    out = warp_cuda.fused_warp_proj_cuda(
        feats, torch.zeros(1, 2, 3, 3, 2), torch.zeros(2, 3, 5), None, torch.float32
    )
    assert out.shape == (1, 3, 3, 5)
    for bad in (torch.zeros(3, 3, 2), torch.zeros(2, 2, 3, 3, 2), torch.zeros(3, 3, 3, 2)):
        with pytest.raises(ValueError, match="coords must be"):
            warp_cuda.fused_warp_proj_cuda(feats, bad, torch.zeros(2, 3, 5), None, torch.float32)

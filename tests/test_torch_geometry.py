"""vsta_tpu_torch geometry, LUT and config against the JAX package (CPU)."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsta_tpu import config as jcfg
from vsta_tpu import geometry as jgeo
from vsta_tpu.data.synthetic import make_ring_camera as j_ring
from vsta_tpu.geometry.bev import bev_sample_coords_with_depth as j_coords
from vsta_tpu.ops.warp import precompute_warp_lut as j_lut
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch import geometry as tgeo
from vsta_tpu_torch.data.synthetic import make_ring_camera as t_ring
from vsta_tpu_torch.ops.warp import precompute_warp_lut as t_lut

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


CONFIGS = sorted(Path(__file__).resolve().parent.parent.glob("configs/*.yaml"))
BOUNDS = (-12.0, 12.0, -4.0, 4.0)


def _cams(V=3, img_hw=(64, 96)):
    Ks, Rts = zip(*(j_ring(v, V, radius=10.0, height=4.0, img_hw=img_hw) for v in range(V)))
    return np.stack(Ks).astype(np.float32), np.stack(Rts).astype(np.float32)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_matches_jax(path):
    """Every field of the JAX package's config reads the same in the port;
    the port's own fields (MVDet's keys) hold their defaults, which build
    the models the JAX package builds."""
    got = dataclasses.asdict(tcfg.load_config(str(path)))
    want = dataclasses.asdict(jcfg.load_config(str(path)))
    defaults = dataclasses.asdict(tcfg.Config())
    assert set(got) == set(want)
    for section, fields in want.items():
        assert set(fields) <= set(got[section]), section
        assert {k: got[section][k] for k in fields} == fields, section
        own = {k: v for k, v in got[section].items() if k not in fields}
        assert own == {k: defaults[section][k] for k in own}, section


def test_ring_camera_matches_jax():
    for v in range(4):
        for a, b in zip(t_ring(v, 4, img_hw=(270, 480)), j_ring(v, 4, img_hw=(270, 480))):
            np.testing.assert_array_equal(a, b)


def test_homography_and_projection_match_jax(rng):
    Ks, Rts = _cams(V=5)
    H_t = tgeo.compute_homography(torch.from_numpy(Ks), torch.from_numpy(Rts))
    H_j = jgeo.compute_homography(jnp.asarray(Ks), jnp.asarray(Rts))
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-5)
    pts = np.concatenate(
        [rng.uniform(-10, 10, (5, 40, 2)), np.ones((5, 40, 1))], -1
    ).astype(np.float32)
    uv_t, w_t = tgeo.project_points(H_t, torch.from_numpy(pts))
    uv_j, w_j = jgeo.project_points(H_j, jnp.asarray(pts))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-5)


def test_homography_and_projection_batch_invariant(rng):
    """A view's homography and projected points are the same bits whether
    its call holds the other views or not (a view mesh's rank computes its
    views alone), and ``small_matmul`` is the product within rounding."""
    Ks, Rts = (torch.from_numpy(a) for a in _cams(V=4))
    pts = torch.from_numpy(np.concatenate([rng.uniform(-10, 10, (40, 2)), np.ones((40, 1))], -1).astype(np.float32))
    H = tgeo.compute_homography(Ks, Rts)
    uv, w = tgeo.project_points(H, pts)
    for lo, hi in ((0, 1), (1, 3), (3, 4)):
        H_part = tgeo.compute_homography(Ks[lo:hi], Rts[lo:hi])
        assert torch.equal(H_part, H[lo:hi])
        uv_part, w_part = tgeo.project_points(H_part, pts)
        assert torch.equal(uv_part, uv[lo:hi]) and torch.equal(w_part, w[lo:hi])
    np.testing.assert_allclose(H.numpy(), (Ks.double() @ Rts[:, :3][:, :, [0, 1, 3]].double()).numpy(), rtol=1e-6)


def test_invert_homography_and_rodrigues_match_jax(rng):
    H = rng.standard_normal((4, 3, 3)).astype(np.float32)
    H[1] = np.outer([1.0, 2.0, 3.0], [1.0, 0.5, 2.0])  # singular: pinv branch
    np.testing.assert_allclose(
        tgeo.invert_homography(torch.from_numpy(H)).numpy(),
        np.asarray(jgeo.invert_homography(jnp.asarray(H))),
        rtol=1e-5, atol=1e-5,
    )
    for rv in (np.zeros(3), np.array([0.3, -1.2, 0.7]), np.array([[1e-9, 0.0, 0.0]])):
        rv = rv.astype(np.float32)
        np.testing.assert_allclose(
            tgeo.rodrigues(torch.from_numpy(rv)).numpy(),
            np.asarray(jgeo.rodrigues(jnp.asarray(rv))),
            rtol=1e-5, atol=1e-6,
        )


def test_bev_grid_coords_and_cells_match_jax(rng):
    Ks, Rts = _cams()
    g_t = tgeo.ground_grid(16, 48, BOUNDS)
    g_j = jgeo.ground_grid(16, 48, BOUNDS)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-6)
    c_t, w_t = tgeo.bev_sample_coords_with_depth(
        torch.from_numpy(Ks), torch.from_numpy(Rts), (64, 96), (8, 12), g_t
    )
    c_j, w_j = j_coords(jnp.asarray(Ks), jnp.asarray(Rts), (64, 96), (8, 12), g_j)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-5)
    xy = rng.uniform(-15, 15, (50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.meters_to_bev_indices(torch.from_numpy(xy), BOUNDS, (16, 48)).numpy(),
        np.asarray(jgeo.meters_to_bev_indices(jnp.asarray(xy), BOUNDS, (16, 48))),
        rtol=1e-5, atol=1e-5,
    )
    ij = rng.uniform(0, 16, (50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.bev_indices_to_meters(torch.from_numpy(ij), BOUNDS, (16, 48)).numpy(),
        np.asarray(jgeo.bev_indices_to_meters(jnp.asarray(ij), BOUNDS, (16, 48))),
        rtol=1e-5, atol=1e-5,
    )


def test_warp_lut_matches_jax(rng):
    """Taps inside, on the edge of and outside the map, and non-finite
    coordinates: indices exactly equal, weights to 1e-6."""
    Hf, Wf = 8, 12
    coords = rng.uniform(-3.0, 15.0, (3, 200, 2)).astype(np.float32)
    coords[0, :4] = [[np.nan, 1.0], [2.0, np.inf], [-np.inf, -np.inf], [np.nan, np.nan]]
    coords[1, :4] = [[-1.0, -1.0], [11.0, 7.0], [11.5, 3.25], [0.0, 7.999]]
    idx_t, wts_t = t_lut(torch.from_numpy(coords), (Hf, Wf))
    idx_j, wts_j = j_lut(jnp.asarray(coords), (Hf, Wf))
    assert idx_t.dtype == torch.int32 and wts_t.dtype == torch.float32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(wts_t.numpy(), np.asarray(wts_j), rtol=0, atol=1e-6)
    assert (wts_t[0, :4] == 0).all() and (idx_t[0, :4] == 0).all()

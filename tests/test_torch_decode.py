"""vsta_tpu_torch decode against vsta_tpu.ops.decode on the CPU: peak
suppression, top-k order among equal scores and the greedy NMS keep set
must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsta_tpu.ops.decode import decode_detections as j_decode
from vsta_tpu.ops.decode import nms2d as j_nms2d
from vsta_tpu_torch.ops.decode import decode_detections as t_decode
from vsta_tpu_torch.ops.decode import nms2d as t_nms2d

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


BOUNDS = (-12.0, 12.0, -4.0, 4.0)


def _maps(seed, B=3, H=16, W=48, levels=None):
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0.0, 1.0, (B, H, W, 1))
    if levels:  # few distinct scores: plateaus and ties everywhere
        hm = np.round(hm * levels) / levels
    off = rng.uniform(0.0, 1.0, (B, H, W, 2))
    size = rng.uniform(0.5, 3.0, (B, H, W, 2))
    return [a.astype(np.float32) for a in (hm, off, size)]


@pytest.mark.parametrize("levels", [None, 4])
def test_nms2d_matches_jax(levels):
    hm = _maps(0, levels=levels)[0][..., 0]
    np.testing.assert_array_equal(t_nms2d(torch.from_numpy(hm)).numpy(), np.asarray(j_nms2d(jnp.asarray(hm))))


@pytest.mark.parametrize(
    "levels,conf,nms_m,max_dets",
    [
        (None, 0.3, 0.5, 128),
        (4, 0.2, 1.0, 128),  # equal-score plateaus
        (3, 0.0, 2.0, 64),
        (None, 0.5, 0.5, 1000),  # more slots than cells: zero padding
    ],
)
def test_decode_matches_jax(levels, conf, nms_m, max_dets):
    hm, off, size = _maps(1, levels=levels)
    kw = dict(bounds=BOUNDS, conf_thresh=conf, nms_dist_m=nms_m, max_dets=max_dets)
    want = j_decode(jnp.asarray(hm), jnp.asarray(off), jnp.asarray(size), **kw)
    got = t_decode(torch.from_numpy(hm), torch.from_numpy(off), torch.from_numpy(size), **kw)
    assert got["valid"].dtype == torch.bool and got["boxes"].shape == (3, max_dets, 4)
    assert got["valid"].any()
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["scores"].numpy(), np.asarray(want["scores"]))
    np.testing.assert_array_equal(got["boxes"].numpy(), np.asarray(want["boxes"]))

"""vsta_tpu_torch.utils.timing's chained-N slope protocol against the JAX
package's vsta_tpu/utils/timing.py, on the CPU.

The constants are JAX's; the chain calls its step ``1 + repeat * (n_lo +
n_hi)`` times, each call's first argument carrying the previous call's
scalar; the forward-and-decode scalar of the tiny ``simple`` config from
JAX's initial weights (moved through convert.py) is JAX's own within
1e-4 relative; ``forward_decode_fps`` returns a finite positive rate.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsta_tpu import config as jcfg
from vsta_tpu.models import BEVNet as JBEVNet
from vsta_tpu.ops.decode import decode_detections as jdecode
from vsta_tpu.utils import timing as jtiming
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.convert import state_dict_from_flax
from vsta_tpu_torch.data.synthetic import make_ring_camera
from vsta_tpu_torch.models import BEVNet
from vsta_tpu_torch.utils import timing

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)

B, V, H, W = 2, 3, 32, 48
RAW = {
    "DATA": {"BATCH_SIZE": B, "IMG_SIZE": [3, H, W], "VIEWS": V},
    "MODEL": {"BACKBONE": "simple", "FEAT_DIM": 8, "OUT_INDEX": 2, "BEV_SIZE": [32, 16, 32],
              "BEV_BOUNDS": [-8.0, 8.0, -4.0, 4.0], "BEV_PROJ_CH": 12, "WARP_IMPL": "fused"},
    "EVAL": {"CONF_THRESH": 0.12, "NMS_DIST_M": 0.5, "MAX_DETS": 16},
    "RUNTIME": {"USE_AMP": False, "DEVICE": "cpu"},
}


def test_constants_are_jax():
    assert (timing.N_LO, timing.N_HI, timing.N_REPEAT) == (jtiming.N_LO, jtiming.N_HI, jtiming.N_REPEAT) == (2, 12, 3)


@pytest.mark.parametrize("n_lo,n_hi,repeat", [(timing.N_LO, timing.N_HI, timing.N_REPEAT), (1, 4, 2)])
def test_chain_calls_and_carries_the_scalar(n_lo, n_hi, repeat):
    """One warm chain of one call, then ``repeat`` chains of n_hi and
    ``repeat`` of n_lo, as JAX's ``(timed(n_hi) - timed(n_lo))``; every
    chain's first call gets ``arg0 + 0 * 1e-30``, every later one
    ``arg0 + (previous scalar) * 1e-30``, and the other arguments as
    they are."""
    arg0, other = torch.full((3,), 0.5), torch.arange(4.0)
    calls = []

    def step(a, b):
        calls.append((a.clone(), b))
        return torch.tensor(float(len(calls)))

    dt = timing.chained_slope_time(step, arg0, other, n_lo=n_lo, n_hi=n_hi, repeat=repeat)
    assert math.isfinite(dt)
    lengths = [1] + [n_hi] * repeat + [n_lo] * repeat
    assert len(calls) == sum(lengths) == 1 + repeat * (n_lo + n_hi)
    i = 0
    for n in lengths:
        acc = torch.zeros(())
        for _ in range(n):
            a, b = calls[i]
            assert torch.equal(a, arg0 + acc * 1e-30) and b is other
            i += 1
            acc = torch.tensor(float(i))


@pytest.fixture(scope="module")
def simple_models():
    """JAX's tiny ``simple`` model with its initial weights, the port's
    with the same weights, and one batch of ring cameras."""
    rng = np.random.default_rng(0)
    Ks, Rts = zip(*(make_ring_camera(v, V, radius=10.0, height=4.0, img_hw=(H, W)) for v in range(V)))
    images = rng.integers(0, 256, (B, V, H, W, 3)).astype(np.uint8)
    K = np.broadcast_to(np.stack(Ks), (B, V, 3, 3)).astype(np.float32).copy()
    Rt = np.broadcast_to(np.stack(Rts), (B, V, 4, 4)).astype(np.float32).copy()
    jcfg_ = jcfg.from_dict(RAW)
    jmodel = JBEVNet.from_config(jcfg_)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(K), jnp.asarray(Rt), train=False)
    cfg = tcfg.from_dict(RAW)
    model = BEVNet.from_config(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, variables)))
    return jcfg_, jmodel, variables, cfg, model, (images, K, Rt)


def test_forward_decode_scalar_matches_jax(simple_models):
    """The chained scalar, ``sum(boxes) + sum(scores) + sum(heatmap)``,
    with the ``1e-30`` fold of a zero scalar as in a chain's first call,
    within 1e-4 relative of JAX's from the same weights and inputs, with
    detections to sum (CONF_THRESH 0.12; the heatmap peaks at 0.165)."""
    jcfg_, jmodel, variables, cfg, model, (images, K, Rt) = simple_models
    e = jcfg_.eval

    def jstep(images, K, Rt):
        out = jmodel.apply(variables, images, K, Rt, train=False)
        det = jdecode(out["heatmap"], out["offset"], out["size"], bounds=jcfg_.model.bev_bounds,
                      conf_thresh=e.conf_thresh, nms_dist_m=e.nms_dist_m, max_dets=e.max_dets)
        return (jnp.sum(det["boxes"]).astype(jnp.float32) + jnp.sum(det["scores"]) + jnp.sum(out["heatmap"]),
                jnp.sum(det["valid"]))

    want, n_dets = jax.jit(jstep)(jnp.asarray(images) + jnp.float32(0.0) * 1e-30, jnp.asarray(K), jnp.asarray(Rt))
    model.eval()
    with torch.no_grad():
        got = timing.forward_decode_step(cfg, model)(
            torch.from_numpy(images) + torch.zeros(()) * 1e-30, torch.from_numpy(K), torch.from_numpy(Rt)
        )
    assert got.shape == () and got.dtype == torch.float32
    assert int(n_dets) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_forward_decode_fps_is_a_rate(simple_models):
    """A short chain on the CPU: a finite, positive frame rate; the model
    goes back to training mode after."""
    *_, cfg, model, (images, K, Rt) = simple_models
    model.train()
    fps = timing.forward_decode_fps(
        cfg, model, torch.from_numpy(images), torch.from_numpy(K), torch.from_numpy(Rt), n_lo=1, n_hi=3, repeat=2
    )
    assert math.isfinite(fps) and fps > 0
    assert model.training

"""The slice as a whole: vsta_tpu_torch's BEVNet and serving function
against the JAX BEVNet (Pallas warp in interpret mode) and
vsta_tpu.export.build_serving_fn, weights through convert.py, f32 on the
CPU. Tolerance 1e-4: convolution sums run in other orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsta_tpu import config as jcfg
from vsta_tpu import export as jexport
from vsta_tpu.data.synthetic import make_ring_camera
from vsta_tpu.models import BEVNet as JBEVNet
from vsta_tpu.models import bevnet as jbevnet
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.convert import init_state_dict, state_dict_from_flax
from vsta_tpu_torch.models import BEVNet
from vsta_tpu_torch.ops.warp_cuda import warp_tiles
from vsta_tpu_torch.serving import build_serving_fn

TOL = dict(atol=1e-4, rtol=1e-4)
RAW = {
    "DATA": {"BATCH_SIZE": 2, "IMG_SIZE": [3, 64, 96], "VIEWS": 3},
    "MODEL": {
        "BACKBONE": "efficientnet_b0", "FEAT_DIM": 48, "OUT_INDEX": 2,
        "BEV_SIZE": [32, 16, 48], "BEV_BOUNDS": [-12.0, 12.0, -4.0, 4.0],
        "BEV_PROJ_CH": 32, "HEAD_MID1": 64, "HEAD_MID2": 32,
        "WARP_IMPL": "pallas", "FUSION": "concat",
    },
    "RUNTIME": {"USE_AMP": False},
    "EVAL": {"CONF_THRESH": 0.45, "NMS_DIST_M": 1.0, "MAX_DETS": 32},
}


def _inputs(seed=0, uint8=False):
    rng = np.random.default_rng(seed)
    B, V, H, W = 2, 3, 64, 96
    if uint8:
        images = rng.integers(0, 256, (B, V, H, W, 3)).astype(np.uint8)
    else:
        images = rng.standard_normal((B, V, H, W, 3)).astype(np.float32)
    Ks, Rts = zip(*(make_ring_camera(v, V, radius=10.0, height=4.0, img_hw=(H, W)) for v in range(V)))
    K = np.broadcast_to(np.stack(Ks), (B, V, 3, 3)).astype(np.float32)
    Rt = np.broadcast_to(np.stack(Rts), (B, V, 4, 4)).astype(np.float32)
    return images, K, Rt


def _numpy_tree(tree, rng):
    """Numpy copy with random norm parameters and BatchNorm statistics."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _numpy_tree(v, rng)
            continue
        a = np.array(v, dtype=np.float32)
        if k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k == "mean":
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[k] = a
    return out


@pytest.fixture(scope="module")
def slice_setup():
    cfg = jcfg.from_dict(RAW)
    images, K, Rt = _inputs()
    model = JBEVNet.from_config(cfg)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(K), jnp.asarray(Rt))
    v = _numpy_tree(v, np.random.default_rng(1))
    # lift the heatmap so a share of the cells clears CONF_THRESH
    v["params"]["detector"]["heatmap_head"]["bias"][:] = 0.0
    jbevnet.FORCE_PALLAS_INTERPRET = True
    try:
        want = jax.jit(lambda v, i, k, r: model.apply(v, i, k, r))(v, images, K, Rt)
        u8 = _inputs(seed=2, uint8=True)
        want_serve = jax.jit(jexport.build_serving_fn(cfg, v))(*u8)
    finally:
        jbevnet.FORCE_PALLAS_INTERPRET = False
    return cfg, v, (images, K, Rt), want, u8, want_serve


def test_bevnet_matches_jax(slice_setup):
    _, v, (images, K, Rt), want, _, _ = slice_setup
    model = BEVNet.from_config(tcfg.from_dict(RAW))
    model.load_state_dict(state_dict_from_flax(v))
    model.eval()
    with torch.no_grad():
        got = model(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (images, K, Rt)))
    assert got["bev_feat"].shape == (2, 16, 48, 34)
    for k in ("bev_feat", "heatmap", "heatmap_logits", "offset", "size"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def test_serving_fn_matches_jax_export(slice_setup):
    """uint8 frames through both serving functions: heatmaps to 1e-4, the
    same detections kept, boxes and scores to 1e-4."""
    _, v, _, _, u8, want = slice_setup
    serve = build_serving_fn(tcfg.from_dict(RAW), state_dict_from_flax(v), device="cpu")
    before = warp_tiles.launches
    got = serve(*u8)
    assert warp_tiles.launches == before
    assert set(got) == {"boxes", "scores", "valid", "heatmap"}
    assert got["boxes"].shape == (2, 32, 4) and got["valid"].dtype == torch.bool
    np.testing.assert_allclose(got["heatmap"].numpy(), np.asarray(want["heatmap"]), **TOL)
    valid = np.asarray(want["valid"])
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), **TOL)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), **TOL)


def test_init_state_dict_is_seeded_and_loads():
    cfg = tcfg.from_dict(RAW)
    a, b, c = init_state_dict(cfg, seed=0), init_state_dict(cfg, seed=0), init_state_dict(cfg, seed=1)
    assert a.keys() == b.keys() == BEVNet.from_config(cfg).state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["view_proj"], c["view_proj"])
    assert (a["detector.heatmap_head.bias"] == -2.19).all()
    serve = build_serving_fn(cfg, a, device="cpu")
    out = serve(*_inputs(seed=3, uint8=True))
    assert out["heatmap"].shape == (2, 16, 48, 1) and torch.isfinite(out["heatmap"]).all()


def test_state_dict_from_flax_covers_every_port_weight(slice_setup):
    _, v, _, _, _, _ = slice_setup
    sd = state_dict_from_flax(v)
    want = BEVNet.from_config(tcfg.from_dict(RAW)).state_dict()
    assert sd.keys() == want.keys()
    assert all(sd[k].shape == want[k].shape for k in sd)


@pytest.mark.parametrize(
    "model_key,value",
    [
        ("FUSION", "mean"),
        ("WARP_IMPL", "fused"),
        ("STATIC_CAMERAS", False),
        ("BACKBONE", "resnet18"),
        ("OUT_INDEX", [1, 2]),
    ],
)
def test_once_unported_options_build_and_serve(model_key, value):
    """Options that the port once refused, naming their ROADMAP item: the
    fusions, the other concat warps, per-frame cameras, the ResNets and a
    multi-scale OUT_INDEX. Each now builds, loads random weights and serves
    (test_torch_fusions.py, test_torch_perframe.py, test_torch_resnet.py and
    test_torch_resnet_configs.py hold them to the JAX package)."""
    raw = {**RAW, "MODEL": {**RAW["MODEL"], model_key: value}}
    cfg = tcfg.from_dict(raw)
    serve = build_serving_fn(cfg, init_state_dict(cfg, seed=0), device="cpu")
    enc = serve.model.encoder
    got = {"FUSION": serve.model.fusion, "WARP_IMPL": serve.model.warp_impl,
           "STATIC_CAMERAS": serve.model.static_cameras, "BACKBONE": type(enc.backbone).__name__,
           "OUT_INDEX": list(enc.levels)}[model_key]
    assert got == ("ResNetFeatures" if model_key == "BACKBONE" else value)
    out = serve(*_inputs(seed=4, uint8=True))
    assert out["heatmap"].shape == (2, 16, 48, 1) and torch.isfinite(out["heatmap"]).all()

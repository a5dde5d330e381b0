"""The three shipped ResNet configs as small BEVNets, vsta_tpu_torch against
the JAX package on the CPU: configs/wildtrack_sanity.yaml (ResNet-18,
concat under WARP_IMPL fused, float32, batch 1),
configs/wildtrack_v1_resnet50.yaml (ResNet-50, bf16, batch 2,
ACCUM_STEPS 2) and configs/wildtrack_ms_max.yaml (ResNet-18, OUT_INDEX
[1, 2], FUSION max, 2 views, bf16), plus the sanity config with
MODEL.NORM group. Each is cut to 66x98 images (odd maps down the
pyramid), a 16x48 BEV grid, a 64/32 head and, for ResNet-50, 2 views;
every other field is the file's.

Compared: the eval forward in the config's dtype and in float32,
``return_per_view`` (ms_max's unfused path returns every view's BEV map;
the fused paths return none, in both packages) and the initial weights;
the train step is in tests/test_torch_resnet_train.py. The JAX side runs
its XLA paths (the grouped sampler's plain reference); the port's
wrappers take their plain versions on CPU tensors.

Tolerances: float32 forwards 1e-4 (convolutions sum in other orders);
bfloat16 forwards by their distance from the float32 result, against
JAX's own bfloat16 distance (see the forward test).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from vsta_tpu import config as jcfg
from vsta_tpu.data.synthetic import make_ring_camera
from vsta_tpu.models import BEVNet as JBEVNet
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.convert import init_state_dict, state_dict_from_flax
from vsta_tpu_torch.models import BEVNet

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


H, W = 66, 98
CONFIGS = {
    "sanity": ("configs/wildtrack_sanity.yaml", {}),
    "resnet50": ("configs/wildtrack_v1_resnet50.yaml", {"DATA": {"VIEWS": 2}}),
    "ms_max": ("configs/wildtrack_ms_max.yaml", {"DATA": {"BATCH_SIZE": 2}}),
    "sanity-group": ("configs/wildtrack_sanity.yaml", {"MODEL": {"NORM": "group"}}),
}


def _raw(name, amp=None):
    path, over = CONFIGS[name]
    raw = yaml.safe_load((Path(__file__).resolve().parents[1] / path).read_text())
    raw["DATA"].update({"IMG_SIZE": [3, H, W], **over.get("DATA", {})})
    raw["MODEL"].update({"BEV_SIZE": [32, 16, 48], "BEV_BOUNDS": [-12.0, 12.0, -4.0, 4.0],
                         "HEAD_MID1": 64, "HEAD_MID2": 32, **over.get("MODEL", {})})
    raw["LOSS"]["MAX_OBJECTS"] = 8
    raw["TRAIN"].update({"EPOCHS": 10, "WARMUP_EPOCHS": 3})
    if amp is not None:
        raw["RUNTIME"]["USE_AMP"] = amp
    return raw


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    B, V = cfg.data.batch_size, cfg.data.views
    Ks, Rts = zip(*(make_ring_camera(v, V, radius=10.0, height=4.0, img_hw=(H, W)) for v in range(V)))
    boxes = np.zeros((B, 8, 4), np.float32)
    boxes[:, :6, 0] = rng.uniform(-11.0, 11.0, (B, 6))
    boxes[:, :6, 1] = rng.uniform(-3.5, 3.5, (B, 6))
    boxes[:, :6, 2:] = rng.uniform(0.4, 1.2, (B, 6, 2))
    return {
        "images": rng.integers(0, 256, (B, V, H, W, 3)).astype(np.uint8),
        "K": np.broadcast_to(np.stack(Ks), (B, V, 3, 3)).astype(np.float32),
        "Rt": np.broadcast_to(np.stack(Rts), (B, V, 4, 4)).astype(np.float32),
        "boxes_world": boxes,
        "num_boxes": np.full((B,), 6, np.int32),
    }


def _tree_np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), jax.tree.map(np.asarray, dict(tree)))


def _randomize(tree, rng):
    """Random norm scales (the zero-initialised closing norms included),
    1-D biases and BatchNorm statistics."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(v, rng)
            continue
        a = np.array(v, dtype=np.float32)
        if k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k == "mean" or (k == "bias" and a.ndim == 1):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[k] = a
    return out


_INIT = {}


def _init(cfg):
    """The Flax model of ``cfg`` and its initial variables (numpy), which
    do not depend on the compute dtype: made once a config."""
    model = JBEVNet.from_config(cfg)
    key = (cfg.data, cfg.model)
    if key not in _INIT:
        b = _batch(cfg, 0)
        _INIT[key] = _tree_np(jax.jit(model.init)(jax.random.PRNGKey(0), b["images"].astype(np.float32), b["K"], b["Rt"]))
    return model, jax.tree.map(np.copy, _INIT[key])


def _close(got, want, what, atol_rel=1e-4):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol_rel * float(np.abs(want).max()) + 1e-5, err_msg=what)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shipped_config_builds_and_starts_where_flax_starts(name):
    """The port builds the config; its random weights have the Flax
    initialisation's keys and shapes, and the same norm scales: 1, and 0
    for the norm that closes each block's main branch."""
    raw = _raw(name)
    _, v = _init(jcfg.from_dict(raw))
    want = state_dict_from_flax(v)
    got = init_state_dict(tcfg.from_dict(raw), seed=0)
    assert got.keys() == want.keys() == BEVNet.from_config(tcfg.from_dict(raw)).state_dict().keys()
    assert all(got[k].shape == want[k].shape for k in want)
    norms = [k for k in want if ".norms." in k or "stem_bn" in k]
    assert norms and any(not want[k].any() for k in norms if k.endswith("weight"))
    for k in norms:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert ("encoder.backbone.stem_bn.running_var" in got) == (name != "sanity-group")


def _forwards(name, amp):
    """JAX's and the port's eval forward (with ``return_per_view``) of the
    config from the same random weights and inputs, as float32 numpy."""
    raw = _raw(name, amp)
    cfg = jcfg.from_dict(raw)
    model, v = _init(cfg)
    v = _randomize(v, np.random.default_rng(5))
    b = _batch(cfg, 7)
    args = (b["images"], b["K"], b["Rt"])
    want = jax.jit(lambda v, i, k, r: model.apply(v, i, k, r, train=False, return_per_view=True))(v, *args)
    net = BEVNet.from_config(tcfg.from_dict(raw))
    net.load_state_dict(state_dict_from_flax(v))
    net.eval()
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in args), return_per_view=True)
    assert set(got) == set(want)
    assert ("bev_per_view" in got) == (name == "ms_max")
    keys = [k for k in ("heatmap_logits", "heatmap", "offset", "size_raw", "bev_feat", "bev_per_view") if k in want]
    return cfg, {k: np.asarray(want[k], np.float32) for k in keys}, {k: got[k].float().numpy() for k in keys}


@pytest.mark.parametrize("amp", [None, False], ids=["as-shipped", "f32"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_shipped_config_forward_matches_flax(name, amp):
    """float32: 1e-4. bfloat16 (ResNet-50 and ms_max as shipped): through
    a bf16 ResNet the roundings add up to a few percent of an output (JAX's
    own bf16 heatmap logits lie 2.6e-2 from its float32 ones, by
    ||a - b|| / ||b||), so each output of the port is held, by that
    distance, to 1.5 times JAX's own bf16-to-float32 distance from the
    same float32 result."""
    cfg, want, got = _forwards(name, amp)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
    assert np.abs(want["bev_feat"][..., :-2]).max() > 0.1
    if not cfg.runtime.use_amp:
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, atol=1e-4 * max(1.0, np.abs(w).max()), rtol=1e-4, err_msg=k)
        return
    _, want32, _ = _forwards(name, False)
    dist = lambda a, b: float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))  # noqa: E731
    for k, w in want.items():
        assert dist(got[k], want32[k]) <= 1.5 * dist(w, want32[k]) + 1e-6, (k, dist(got[k], want32[k]), dist(w, want32[k]))


def test_group_norm_on_efficientnet_raises_in_both_packages():
    raw = _raw("sanity")
    raw["MODEL"].update(BACKBONE="efficientnet_b0", NORM="group")
    with pytest.raises(ValueError, match="only supported for resnet"):
        BEVNet.from_config(tcfg.from_dict(raw))
    cfg = jcfg.from_dict(raw)
    b = _batch(cfg, 0)
    with pytest.raises(ValueError, match="only supported for resnet"):
        jax.eval_shape(JBEVNet.from_config(cfg).init, jax.random.PRNGKey(0), b["images"].astype(np.float32),
                       b["K"], b["Rt"])

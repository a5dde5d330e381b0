"""The int8 head of the port (vsta_tpu_torch/ops/quant.py) against the JAX
package's (vsta_tpu/ops/quant.py) on the CPU.

The int8 product is exact integer arithmetic in both packages, so it is
held bit for bit (``torch.equal``) on the same int8 inputs. The quantizers
are the same f32 operations in the same order (round half to even), so
they are held bit for bit too. Float stages are held to stated bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsta_tpu.ops import quant as jq
from vsta_tpu_torch.convert import quant_head_from_jax
from vsta_tpu_torch.ops import quant as tq

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _hwio_to_port(w):
    """int8 HWIO [KH, KW, Cin, Cout] -> the port's [Cout, KH, KW, Cin]."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 0, 1, 2))))


@pytest.mark.parametrize("cin", [130, 66])
@pytest.mark.parametrize("dilation,stride", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("impl", ["dots", "conv"])
def test_conv_int8_bit_equal(impl, dilation, stride, cin):
    """Both JAX lowerings against the port's one route, on the head's odd
    channel counts (padded to 136 / 72 in the port): equal int32."""
    rng = np.random.default_rng(cin + 10 * dilation + stride)
    x = _i8(rng, (2, 9, 11, cin))
    w = _i8(rng, (3, 3, cin, 16))
    want = jq.conv_int8(jnp.asarray(x), jnp.asarray(w), stride=stride, dilation=dilation, impl=impl)
    got = tq.conv_int8(torch.from_numpy(x), _hwio_to_port(w), stride=stride, dilation=dilation)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.from_numpy(np.array(want)))


def test_conv_int8_few_rows_and_bad_impl(head_setup):
    """Fewer than 17 output rows (padded for _int_mm, then cut) stay exact;
    a JAX tree naming an unknown lowering raises when it is converted."""
    rng = np.random.default_rng(1)
    x = _i8(rng, (1, 2, 3, 8))
    w = _i8(rng, (1, 1, 8, 8))
    want = jq.conv_int8(jnp.asarray(x), jnp.asarray(w), impl="conv")
    assert torch.equal(tq.conv_int8(torch.from_numpy(x), _hwio_to_port(w)), torch.from_numpy(np.array(want)))
    with pytest.raises(ValueError, match="im2col"):
        quant_head_from_jax({**head_setup[3], "impl": "im2col"})


def test_quantizers_bit_equal():
    """quantize_weight_per_cout and quantize_act on the same f32 inputs,
    ties at .5 included (half to even in both)."""
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((3, 3, 24, 16)) * 0.1).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    wq_j, sc_j = jq.quantize_weight_per_cout(jnp.asarray(w))
    wq_t, sc_t = tq.quantize_weight_per_cout(torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()))
    assert torch.equal(wq_t, _hwio_to_port(np.asarray(wq_j)))
    assert torch.equal(sc_t, torch.from_numpy(np.asarray(sc_j)))

    scale = np.float32(0.25)
    ties = np.arange(-80, 81, dtype=np.float32) * np.float32(0.125)  # x / scale = k / 2 exactly
    x = np.concatenate([ties, rng.standard_normal(999).astype(np.float32) * 20, [1e9, -1e9]]).astype(np.float32)
    for s in (scale, np.float32(0.0371)):
        want = np.asarray(jq.quantize_act(jnp.asarray(x), jnp.float32(s)))
        got = tq.quantize_act(torch.from_numpy(x), torch.tensor(s))
        assert torch.equal(got, torch.from_numpy(want))


def test_group_norm_matches_jax():
    """F.group_norm against the JAX formula: 1e-5 (another summation order
    of the same f32 statistics)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 7, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jq._group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    got = tq._group_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _ulp(x):
    return np.spacing(np.abs(np.float32(x))).astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 1000, 10001, 54321])
@pytest.mark.parametrize("q", [0.0, 50.0, 99.99, 100.0])
def test_percentile_matches_jnp(n, q):
    """Small inputs with many ties: within 1 f32 ulp of jnp.percentile
    (XLA may fuse the final multiply-add)."""
    rng = np.random.default_rng(n)
    x = np.abs(rng.integers(-40, 40, n).astype(np.float32) * np.float32(0.3))
    want = float(jnp.percentile(jnp.asarray(x), q))
    got = float(tq.percentile(torch.from_numpy(x), q))
    assert abs(got - want) <= _ulp(want), (got, want)


def test_percentile_nan():
    x = torch.tensor([1.0, float("nan"), 2.0])
    assert torch.isnan(tq.percentile(x, 99.99))


def test_percentile_above_torch_quantile_limit():
    """2^24 + 4,321 elements, where torch.quantile refuses. numpy computes
    the index in float64, the port (as jnp) in float32, so the two may pick
    order statistics a few places apart: the port's value must lie within
    the values 3 places either side of numpy's pair."""
    n = 2**24 + 4321
    x = np.abs(np.random.default_rng(5).standard_normal(n).astype(np.float32))
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(x), 0.9999)
    want = np.percentile(x, 99.99)
    got = float(tq.percentile(torch.from_numpy(x), 99.99))
    pos = 0.9999 * (n - 1)
    lo, hi = int(np.floor(pos)) - 3, int(np.ceil(pos)) + 3
    near = np.partition(x, (lo, hi))
    assert near[lo] <= got <= near[hi], (got, want, near[lo], near[hi])
    assert abs(got - want) <= near[hi] - near[lo]


def _head_params(rng, cin, mid1=64, mid2=32):
    def k(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    p = {
        "stem0": {"kernel": k(3, 3, cin, mid1)},
        "stem1": {"kernel": k(3, 3, mid1, mid2)},
        "stem2": {"kernel": k(3, 3, mid2, mid2)},
        "heatmap_head": {"kernel": k(3, 3, mid2, 1), "bias": np.full((1,), -2.19, np.float32)},
        "offset_head": {"kernel": k(3, 3, mid2, 2), "bias": np.zeros((2,), np.float32)},
        "size_head": {"kernel": k(3, 3, mid2, 2), "bias": np.asarray([1.5, 1.5], np.float32)},
    }
    for i, c in enumerate((mid1, mid2, mid2)):
        p[f"GroupNorm_{i}"] = {"scale": 1.0 + 0.1 * k(c, s=1.0), "bias": 0.1 * k(c, s=1.0)}
    return p


def _head_state(p):
    """The JAX head params under the port's head state-dict names."""
    oihw = lambda w: torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy())
    sd = {}
    for i in range(3):
        sd[f"stem{i}.weight"] = oihw(p[f"stem{i}"]["kernel"])
        sd[f"gn{i}.weight"] = torch.from_numpy(p[f"GroupNorm_{i}"]["scale"])
        sd[f"gn{i}.bias"] = torch.from_numpy(p[f"GroupNorm_{i}"]["bias"])
    for name in ("heatmap_head", "offset_head", "size_head"):
        sd[f"{name}.weight"] = oihw(p[name]["kernel"])
        sd[f"{name}.bias"] = torch.from_numpy(p[name]["bias"])
    return sd


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return tree if isinstance(tree, str) else np.asarray(tree)


@pytest.fixture(scope="module")
def head_setup():
    rng = np.random.default_rng(6)
    p = _head_params(rng, cin=66)
    calib = [rng.standard_normal((2, 8, 12, 66)).astype(np.float32) for _ in range(2)]
    x = rng.standard_normal((2, 8, 12, 66)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    qj = _np_tree(jq.quantize_head(jp, [jnp.asarray(c) for c in calib], conv_impl="dots"))
    return p, calib, x, qj


def test_quantize_head_matches_jax(head_setup):
    """Same weights: int8 kernels and weight scales bit-equal; activation
    scales within 1e-4 relative (the float stem's convolutions sum in
    another order, and its GroupNorm, 1e-5 apart, feeds the next input)."""
    p, calib, _, qj = head_setup
    qt = tq.quantize_head(_head_state(p), [torch.from_numpy(c) for c in calib])
    conv = quant_head_from_jax(qj)
    assert qt["impl"] == tq.CONV_IMPL and conv["impl"] == "dots"
    for st, sj in zip(qt["stems"], conv["stems"]):
        assert torch.equal(st["w_i8"], sj["w_i8"]) and torch.equal(st["w_scale"], sj["w_scale"])
        assert st["x_scale"].shape == () and st["x_scale"].dtype == torch.float32
        rel = abs(float(st["x_scale"]) / float(sj["x_scale"]) - 1.0)
        assert rel < 1e-4, rel
        assert torch.equal(st["gn_scale"], sj["gn_scale"]) and torch.equal(st["gn_bias"], sj["gn_bias"])
    for name in ("heatmap_head", "offset_head", "size_head"):
        assert torch.equal(qt["out"][name]["kernel"], conv["out"][name]["kernel"])


def test_apply_quant_head_on_jax_tree(head_setup):
    """JAX's tree converted: each stem's int32 product bit-equal on JAX's
    int8 input to that stem; the whole head within 2e-3 (a float input a
    hair from a rounding boundary may quantize one step apart, moving a
    logit by x_scale * w_scale * |w| summed over the few taps it feeds)."""
    _, _, x, qj = head_setup
    qt = quant_head_from_jax(qj)
    xj = jnp.asarray(x)
    for i, (sj, st) in enumerate(zip(qj["stems"], qt["stems"])):
        x_i8 = jq.quantize_act(xj, jnp.asarray(sj["x_scale"]))
        yj = jq.conv3x3_int8(x_i8, jnp.asarray(sj["w_i8"]), dilation=jq._STEM_DILATIONS[i], impl=qj["impl"])
        yt = tq.conv3x3_int8(torch.from_numpy(np.asarray(x_i8)), st["w_i8"], dilation=tq._STEM_DILATIONS[i])
        assert torch.equal(yt, torch.from_numpy(np.array(yj))), f"stem {i}"
        y = yj.astype(jnp.float32) * (jnp.asarray(sj["x_scale"]) * jnp.asarray(sj["w_scale"]))
        xj = jax.nn.relu(jq._group_norm(y, jnp.asarray(sj["gn_scale"]), jnp.asarray(sj["gn_bias"])))
    want = jq.apply_quant_head(jax.tree_util.tree_map(lambda a: a if isinstance(a, str) else jnp.asarray(a), qj),
                               jnp.asarray(x))
    got = tq.apply_quant_head(qt, torch.from_numpy(x))
    assert set(got) == set(want)
    for k in ("heatmap_logits", "offset_raw", "size_raw", "heatmap"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-3, rtol=0, err_msg=k)


def test_quant_head_tracks_float_head(head_setup):
    """The port's own calibration: the int8 head within the JAX package's
    PTQ bounds of the float head (0.15 on logits, 0.05 on the heatmap)."""
    p, calib, x, _ = head_setup
    sd = _head_state(p)
    qt = tq.quantize_head(sd, [torch.from_numpy(c) for c in calib])
    xs = torch.from_numpy(x)
    got = tq.apply_quant_head(qt, xs)
    stem2_in = tq._float_stem_inputs(sd, xs)[2]
    y = tq._nhwc(torch.nn.functional.conv2d(tq._nchw(stem2_in), sd["stem2.weight"], None, 1, 1))
    shared = torch.relu(tq._group_norm(y, sd["gn2.weight"], sd["gn2.bias"]))
    hm = tq._conv3x3_f32(shared, sd["heatmap_head.weight"], sd["heatmap_head.bias"])
    assert float((got["heatmap_logits"] - hm).abs().max()) < 0.15
    assert float((got["heatmap"] - torch.sigmoid(hm)).abs().max()) < 0.05


def test_bevnet_quant_head_seam():
    """BEVNet(quant_head=) in both packages on the same weights and JAX's
    int8 tree converted: heatmaps within 2e-3 (the bound above; the f32
    model ahead of the head adds 1e-5). The port's own calibration keeps
    the heatmap within 0.05 of the float model, as the JAX test asks."""
    from vsta_tpu import config as jcfg
    from vsta_tpu.data.synthetic import make_ring_camera
    from vsta_tpu.models import BEVNet as JBEVNet
    from vsta_tpu_torch import config as tcfg
    from vsta_tpu_torch.convert import state_dict_from_flax
    from vsta_tpu_torch.export import calibrate_quant_head
    from vsta_tpu_torch.models import BEVNet

    raw = {
        "DATA": {"BATCH_SIZE": 1, "IMG_SIZE": [3, 48, 64], "VIEWS": 2},
        "MODEL": {"BACKBONE": "simple", "FEAT_DIM": 16, "OUT_INDEX": 1, "BEV_SIZE": [32, 16, 32],
                  "BEV_BOUNDS": [-8.0, 8.0, -4.0, 4.0], "BEV_PROJ_CH": 30, "HEAD_MID1": 64, "HEAD_MID2": 32,
                  "WARP_IMPL": "fused", "FUSION": "concat"},
        "RUNTIME": {"USE_AMP": False},
    }
    B, V, H, W = 1, 2, 48, 64
    rng = np.random.default_rng(4)
    images = rng.standard_normal((B, V, H, W, 3)).astype(np.float32)
    Ks, Rts = zip(*(make_ring_camera(v, V, img_hw=(H, W), radius=8.0, height=3.0) for v in range(V)))
    K = np.stack(Ks).astype(np.float32)[None]
    Rt = np.stack(Rts).astype(np.float32)[None]
    jmodel = JBEVNet.from_config(jcfg.from_dict(raw))
    v = jmodel.init(jax.random.PRNGKey(0), images, K, Rt, train=False)
    ref = jmodel.apply(v, images, K, Rt, train=False)
    qj = jq.quantize_head(v["params"]["detector"], [ref["bev_feat"]])
    want = jmodel.apply(v, images, K, Rt, train=False, quant_head=qj)

    cfg = tcfg.from_dict(raw)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v))
    model = BEVNet.from_config(cfg)
    model.load_state_dict(sd)
    model.eval()
    args = tuple(torch.from_numpy(a) for a in (images, K, Rt))
    with torch.no_grad():
        got = model(*args, quant_head=quant_head_from_jax(_np_tree(qj)))
        assert set(got) == set(want)
        np.testing.assert_allclose(got["heatmap"].numpy(), np.asarray(want["heatmap"]), atol=2e-3, rtol=0)
        own = calibrate_quant_head(cfg, sd, [(images, K, Rt)], device="cpu")
        float_hm = model(*args)["heatmap"]
        err = float((model(*args, quant_head=own)["heatmap"] - float_hm).abs().max())
    assert err < 0.05, err

"""The int8 ResNet encoder of the port (vsta_tpu_torch/ops/quant_resnet.py)
against the JAX package's (vsta_tpu/ops/quant_resnet.py) on the CPU, at
48x64 images.

Every folded site's int32 product is held bit for bit on the int8 input
JAX gave it; the float stages to stated bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsta_tpu.models.encoders.encoder import ViewEncoder as JViewEncoder
from vsta_tpu.ops import quant as jq
from vsta_tpu.ops import quant_resnet as jqr
from vsta_tpu_torch.convert import _conv, _resnet, quant_encoder_from_jax
from vsta_tpu_torch.models.encoders.encoder import ViewEncoder
from vsta_tpu_torch.ops import quant as tq
from vsta_tpu_torch.ops import quant_resnet as tqr

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


HW = (48, 64)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not all(isinstance(i, int) for i in tree):
        return [_np_tree(v) for v in tree]
    return tree if isinstance(tree, (str, bool, int, tuple, list)) else np.asarray(tree)


def _jax_tree(tree):
    return {k: _jax_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else (
        jnp.asarray(tree) if isinstance(tree, np.ndarray) else tree)


def _encoder(variant, out_index=2, seed=0, fold_proj=False):
    """A JAX ViewEncoder with random BatchNorm statistics and scales (the
    zero-init closing scales would hide the residual branch), and the
    port's ViewEncoder with the same weights."""
    V = 2
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((1, V, *HW, 3)).astype(np.float32)
    jenc = JViewEncoder(backbone=variant, feat_dim=8, out_index=out_index, fold_proj=fold_proj)
    v = jax.tree_util.tree_map(np.asarray, jenc.init(jax.random.PRNGKey(seed), jnp.asarray(images), train=False))
    rng = np.random.default_rng(seed + 1)

    def redraw(tree):
        out = {}
        for k, a in tree.items():
            if isinstance(a, dict):
                out[k] = redraw(a)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k in ("mean", "bias") and a.ndim == 1:
                out[k] = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
            else:
                out[k] = a
        return out

    v = {"params": redraw(v["params"]), "batch_stats": redraw(v["batch_stats"])}
    sd = {}
    _resnet(v["params"]["backbone"], v["batch_stats"]["backbone"], sd, "backbone")
    _conv(v["params"]["proj"], sd, "proj")
    enc = ViewEncoder(variant, feat_dim=8, out_index=out_index, fold_proj=fold_proj)
    enc.load_state_dict({k: t for k, t in sd.items() if not k.endswith("num_batches_tracked")}, strict=False)
    enc.eval()
    return jenc, v, enc, images


@pytest.mark.parametrize("variant", ["resnet18", "resnet50"])
def test_folded_twin_matches_port_trunk(variant):
    """BatchNorm folded into the convolutions against the port's trunk in
    eval mode: 2e-4, the JAX package's bound for its own fold (w * s then
    the product, against the product then * s)."""
    _, _, enc, images = _encoder(variant)
    x = torch.from_numpy(images[0])
    with torch.no_grad():
        ref = enc.backbone(x.permute(0, 3, 1, 2), 5)
        folded = tqr._fold_backbone(variant, enc.backbone.state_dict())

        def site(key, xin, stride, ksize):
            w, b = folded[key]
            return tqr._conv_f32(xin, w, stride, ksize) + b

        got = tqr._forward_backbone(variant, x, site, lambda k: k in folded)
    assert len(got) == len(ref) == 5
    for lvl, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.permute(0, 3, 1, 2).numpy(), r.numpy(), atol=2e-4, rtol=0, err_msg=f"level {lvl}")


def test_max_pool_pads_with_minus_inf():
    """F.max_pool2d(3, 2, 1) against the JAX walk's reduce_window with -inf
    padding, on an all-negative map: equal."""
    x = -1.0 - np.random.default_rng(3).random((2, 7, 9, 4)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                                 ((0, 0), (1, 1), (1, 1), (0, 0)))
    got = tqr._nhwc(torch.nn.functional.max_pool2d(tqr._nchw(torch.from_numpy(x)), 3, 2, 1))
    assert torch.equal(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("ksize,stride", [(1, 1), (1, 2), (3, 2), (7, 2)])
def test_conv_int8_encoder_shapes_bit_equal(ksize, stride):
    """The encoder's other site shapes (1x1, strided): both JAX lowerings
    against the port's one route, equal int32."""
    rng = np.random.default_rng(ksize * 10 + stride)
    x = rng.integers(-127, 128, (2, 10, 14, 16)).astype(np.int8)
    w = rng.integers(-127, 128, (ksize, ksize, 16, 24)).astype(np.int8)
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 0, 1, 2))))
    got = tq.conv_int8(torch.from_numpy(x), wt, stride=stride)
    for impl in tq.CONV_IMPLS:
        want = jq.conv_int8(jnp.asarray(x), jnp.asarray(w), stride=stride, impl=impl)
        assert torch.equal(got, torch.from_numpy(np.array(want))), impl


def _jax_qe(jenc, v, images, out_index, fold):
    flat = jnp.asarray(images.reshape(-1, *HW, 3))
    variant = jenc.backbone
    return _np_tree(jqr.quantize_encoder(variant, v["params"], v["batch_stats"], [flat], out_index, fold))


@pytest.mark.parametrize("variant", ["resnet18", "resnet50"])
def test_every_site_int32_bit_equal(variant):
    """JAX's int8 tree converted: at every site the port's int32 product on
    JAX's int8 input to that site equals JAX's."""
    jenc, v, _, images = _encoder(variant)
    qj = _jax_qe(jenc, v, images, 2, False)
    qt = quant_encoder_from_jax(qj)
    assert set(qt["sites"]) == set(qj["sites"])

    @jax.jit
    def walk(x):
        recs = {}

        def site(key, xin, stride, ksize):
            if key == "stem":
                return jqr._conv_f32(xin, jnp.asarray(qj["stem"]["w"]), stride, ksize) + qj["stem"]["b"]
            qs = qj["sites"][key]
            x_i8 = jq.quantize_act(xin, qs["x_scale"])
            y = jq.conv_int8(x_i8, jnp.asarray(qs["w_i8"]), stride=stride, impl=qj["impl"])
            recs[key] = (x_i8, y)
            return y.astype(jnp.float32) * (qs["x_scale"] * qs["w_scale"]) + qs["b"]

        jqr._forward_backbone(variant, x, site, lambda k: k in qj["sites"])
        return recs

    recs = walk(jnp.asarray(images.reshape(-1, *HW, 3)))
    strides = {}
    main, down = tqr._block_convs(variant)
    for key in qt["sites"]:
        blk, cname = key.split("/")
        i, j = (int(t) for t in blk[len("stage"):].split("_block"))
        s = 2 if (i > 0 and j == 0) else 1
        strides[key] = s if cname == down or dict((c, st) for c, _, st in main)[cname] else 1
    for key, (x_i8, y) in recs.items():
        got = tq.conv_int8(torch.from_numpy(np.array(x_i8)), qt["sites"][key]["w_i8"], stride=strides[key])
        assert torch.equal(got, torch.from_numpy(np.array(y))), key


@pytest.mark.parametrize("out_index,fold", [(2, False), ((1, 2), True), ((1, 2), False)])
def test_apply_quant_encoder_matches_jax(out_index, fold):
    """The whole int8 encoder on JAX's converted tree, fold_proj true and
    false, one level and a multi-scale OUT_INDEX: within 2e-2 of the
    output's standard deviation (an f32 input a hair from a rounding
    boundary may quantize one step apart and carry through the sites
    behind it; the int8 encoder itself lies up to 0.35 from the float
    one, the JAX package's bound)."""
    jenc, v, _, images = _encoder("resnet18", out_index=out_index, fold_proj=fold, seed=4)
    qj = _jax_qe(jenc, v, images, out_index, fold)
    qt = quant_encoder_from_jax(qj)
    want = jqr.apply_quant_encoder(_jax_tree(qj), jnp.asarray(images))
    got = tqr.apply_quant_encoder(qt, torch.from_numpy(images))
    if fold:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        got, want = got[0], want[0]
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max()) / (float(want.std()) + 1e-6)
    assert err < 2e-2, err


def test_quantize_encoder_matches_jax():
    """The port's calibration on the same weights and images: activation
    scales within 1e-3 relative of JAX's (the folded f32 trunk ahead of each
    site sums in another order, 2e-4 apart at most), weight scales within
    1e-6 (rsqrt may differ by an ulp) and the int8 kernels equal but for
    values a hair from a rounding boundary (under 0.1 %)."""
    jenc, v, enc, images = _encoder("resnet18", seed=5)
    qj = quant_encoder_from_jax(_jax_qe(jenc, v, images, 2, False))
    qt = tqr.quantize_encoder("resnet18", enc.state_dict(), [torch.from_numpy(images.reshape(-1, *HW, 3))], 2, False)
    assert set(qt["sites"]) == set(qj["sites"]) and qt["variant"] == "resnet18"
    for key, st in qt["sites"].items():
        sj = qj["sites"][key]
        assert abs(float(st["x_scale"]) / float(sj["x_scale"]) - 1) < 1e-3, key
        np.testing.assert_allclose(st["w_scale"].numpy(), sj["w_scale"].numpy(), rtol=1e-6)
        assert float((st["w_i8"] != sj["w_i8"]).float().mean()) < 1e-3, key
    np.testing.assert_allclose(qt["proj"]["kernel"].numpy(), qj["proj"]["kernel"].numpy())


def _tiny_cfg_raw(**model):
    return {
        "DATA": {"BATCH_SIZE": 1, "IMG_SIZE": [3, *HW], "VIEWS": 2},
        "MODEL": {"BACKBONE": "resnet18", "FEAT_DIM": 16, "OUT_INDEX": 2, "BEV_SIZE": [32, 16, 32],
                  "BEV_BOUNDS": [-8.0, 8.0, -4.0, 4.0], "BEV_PROJ_CH": 30, "HEAD_MID1": 32, "HEAD_MID2": 32,
                  "WARP_IMPL": "fused", "FUSION": "concat", **model},
        "RUNTIME": {"USE_AMP": False},
    }


def test_calibrate_quant_encoder_raises_as_jax():
    """A non-ResNet backbone and MODEL.NORM group raise the JAX package's
    ValueError in both packages."""
    from vsta_tpu import config as jcfg
    from vsta_tpu import export as jexport
    from vsta_tpu_torch import config as tcfg
    from vsta_tpu_torch import export as texport
    from vsta_tpu_torch.convert import init_state_dict

    for model, match in (({"BACKBONE": "simple"}, "resnet family"), ({"NORM": "group"}, "running stats")):
        raw = _tiny_cfg_raw(**model)
        with pytest.raises(ValueError, match=match):
            jexport.calibrate_quant_encoder(jcfg.from_dict(raw), {}, [])
        cfg = tcfg.from_dict(raw)
        with pytest.raises(ValueError, match=match):
            texport.calibrate_quant_encoder(cfg, init_state_dict(cfg), [], device="cpu")


def test_bevnet_quant_encoder_and_head_seam():
    """BEVNet with both int8 stages in both packages (JAX's trees
    converted, fold_proj true): heatmaps within 5e-3 (the two bounds
    above, through the warp and the head). The port's own calibration of
    both stages keeps the heatmap within 0.15 of the float model, the JAX
    package's bound; a tree made for the other fold_proj raises."""
    from vsta_tpu import config as jcfg
    from vsta_tpu import export as jexport
    from vsta_tpu.data.synthetic import make_ring_camera
    from vsta_tpu.models import BEVNet as JBEVNet
    from vsta_tpu_torch import config as tcfg
    from vsta_tpu_torch.convert import quant_head_from_jax, state_dict_from_flax
    from vsta_tpu_torch.export import calibrate_quant_encoder, calibrate_quant_head
    from vsta_tpu_torch.models import BEVNet

    raw = _tiny_cfg_raw()
    V, (H, W) = 2, HW
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (1, V, H, W, 3)).astype(np.uint8)
    Ks, Rts = zip(*(make_ring_camera(v, V, img_hw=(H, W), radius=8.0, height=3.0) for v in range(V)))
    K = np.stack(Ks).astype(np.float32)[None]
    Rt = np.stack(Rts).astype(np.float32)[None]
    jcf = jcfg.from_dict(raw)
    jmodel = JBEVNet.from_config(jcf)
    v = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), images, K, Rt, train=False))
    qe = jexport.calibrate_quant_encoder(jcf, v, [(images, K, Rt)])
    qh = jexport.calibrate_quant_head(jcf, v, [(images, K, Rt)], quant_encoder=qe)
    want = jmodel.apply(v, images, K, Rt, train=False, quant_encoder=qe, quant_head=qh)

    cfg = tcfg.from_dict(raw)
    sd = state_dict_from_flax(v)
    model = BEVNet.from_config(cfg)
    model.load_state_dict(sd)
    model.eval()
    args = tuple(torch.from_numpy(a) for a in (images, K, Rt))
    with torch.no_grad():
        got = model(*args, quant_encoder=quant_encoder_from_jax(_np_tree(qe)),
                    quant_head=quant_head_from_jax(_np_tree(qh)))
        np.testing.assert_allclose(got["heatmap"].numpy(), np.asarray(want["heatmap"]), atol=5e-3, rtol=0)
        own_e = calibrate_quant_encoder(cfg, sd, [(images, K, Rt)], device="cpu")
        own_h = calibrate_quant_head(cfg, sd, [(images, K, Rt)], quant_encoder=own_e, device="cpu")
        err = float((model(*args, quant_encoder=own_e, quant_head=own_h)["heatmap"] - model(*args)["heatmap"]).abs().max())
        assert err < 0.15, err
        with pytest.raises(ValueError, match="fold_proj"):
            model(*args, quant_encoder={**own_e, "fold_proj": False})

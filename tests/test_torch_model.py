"""vsta_tpu_torch model modules against the Flax ones, weights through
vsta_tpu_torch.convert, f32 on the CPU.

Tolerance 1e-4: XLA-CPU and torch-CPU sum convolutions in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsta_tpu.models.bevnet import positional_encoding as j_pos
from vsta_tpu.models.encoders.efficientnet import EfficientNetFeatures as JTrunk
from vsta_tpu.models.encoders.encoder import ViewEncoder as JEncoder
from vsta_tpu.models.encoders.encoder import build_backbone as j_build_backbone
from vsta_tpu.models.heads import BEVDetectorHead as JHead
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.convert import _bn, _conv, _mbconv
from vsta_tpu_torch.models import BEVNet
from vsta_tpu_torch.models.bevnet import positional_encoding as t_pos
from vsta_tpu_torch.models.encoders.efficientnet import B0_STAGES, EfficientNetFeatures
from vsta_tpu_torch.models.encoders.encoder import ViewEncoder
from vsta_tpu_torch.models.heads import BEVDetectorHead

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


TOL = dict(atol=1e-4, rtol=1e-4)


def randomize_norms(tree, rng):
    """Numpy copy of a Flax variables tree with random norm scales,
    biases and BatchNorm statistics, so the mapping of each is exercised."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize_norms(v, rng)
            continue
        a = np.array(v, dtype=np.float32)
        if k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k in ("mean",) or (k == "bias" and a.ndim == 1):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[k] = a
    return out


def _trunk_state(params, stats, prefix=""):
    sd = {}
    _conv(params["stem_conv"], sd, f"{prefix}stem_conv")
    _bn(params["stem_bn"], stats["stem_bn"], sd, f"{prefix}stem_bn")
    for si, (_, _, repeats, _, _) in enumerate(B0_STAGES):
        for r in range(repeats):
            key = f"stage{si}_block{r}"
            _mbconv(params[key], stats[key], sd, f"{prefix}stages.{si}.{r}")
    return sd


@pytest.fixture(scope="module")
def trunk_vars():
    m = JTrunk()
    v = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))
    return m, randomize_norms(v, np.random.default_rng(1))


@pytest.mark.parametrize("hw", [(64, 96), (66, 98)])
def test_efficientnet_trunk_matches_flax(trunk_vars, hw):
    """All five pyramid levels; 64x96 pads every stride-2 conv
    asymmetrically, 66x98 gives odd maps."""
    m, v = trunk_vars
    x = np.random.default_rng(2).standard_normal((2,) + hw + (3,)).astype(np.float32)
    want = jax.jit(lambda v, x: m.apply(v, x, train=False))(v, jnp.asarray(x))
    trunk = EfficientNetFeatures()
    trunk.load_state_dict(_trunk_state(v["params"], v["batch_stats"]))
    trunk.eval()  # running statistics, as train=False
    with torch.no_grad():
        got = trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), **TOL)
    with torch.no_grad():
        first3 = trunk(torch.from_numpy(x).permute(0, 3, 1, 2), levels=3)
    assert len(first3) == 3 and torch.equal(first3[2], got[2])


@pytest.mark.parametrize("fold", [True, False])
def test_view_encoder_matches_flax(fold):
    B, V, H, W, F = 2, 3, 64, 96, 24
    jm = JEncoder(backbone="efficientnet_b0", feat_dim=F, out_index=2, fold_proj=fold)
    images = np.random.default_rng(3).standard_normal((B, V, H, W, 3)).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(images[:1, :1]))
    v = randomize_norms(v, np.random.default_rng(4))
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(images))
    sd = _trunk_state(v["params"]["backbone"], v["batch_stats"]["backbone"], "backbone.")
    _conv(v["params"]["proj"], sd, "proj")
    enc = ViewEncoder(feat_dim=F, out_index=2, fold_proj=fold)
    enc.load_state_dict(sd)
    enc.eval()
    with torch.no_grad():
        got = enc(torch.from_numpy(images))
    if fold:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
        assert got[0].shape == (B, V, 8, 12, 40)
    else:
        assert got.shape == (B, V, 8, 12, F)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_detector_head_matches_flax():
    B, H, W, C = 2, 16, 48, 34
    bounds, size = (-12.0, 12.0, -4.0, 4.0), (H, W)
    jm = JHead(bev_bounds=bounds, bev_size=size, mid1=64, mid2=32)
    x = np.random.default_rng(5).standard_normal((B, H, W, C)).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    v = randomize_norms(v, np.random.default_rng(6))
    # a nonzero offset head, so its mapping is exercised too
    v["params"]["offset_head"]["kernel"] = (
        0.05 * np.random.default_rng(7).standard_normal(v["params"]["offset_head"]["kernel"].shape)
    ).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(x))
    p = v["params"]
    sd = {}
    for i in range(3):
        _conv(p[f"stem{i}"], sd, f"stem{i}")
        sd[f"gn{i}.weight"] = torch.from_numpy(p[f"GroupNorm_{i}"]["scale"])
        sd[f"gn{i}.bias"] = torch.from_numpy(p[f"GroupNorm_{i}"]["bias"])
    for head in ("heatmap_head", "offset_head", "size_head"):
        _conv(p[head], sd, head)
    head = BEVDetectorHead(C, bounds, size, mid1=64, mid2=32)
    head.load_state_dict(sd)
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def test_head_init_constants_match_flax():
    """CenterNet init: heatmap bias -2.19, offset head zero, size bias
    log of the default footprint in cells."""
    bounds, size = (-24.0, 24.0, -7.2, 7.2), (120, 360)
    jm = JHead(bev_bounds=bounds, bev_size=size, mid1=64, mid2=32)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 34)))["params"]
    head = BEVDetectorHead(34, bounds, size, mid1=64, mid2=32)
    head.init_centernet_()
    np.testing.assert_allclose(head.heatmap_head.bias.detach().numpy(), p["heatmap_head"]["bias"])
    np.testing.assert_allclose(head.size_head.bias.detach().numpy(), p["size_head"]["bias"], rtol=1e-6)
    assert not head.offset_head.weight.any() and not head.offset_head.bias.any()


def test_positional_encoding_matches_jax():
    bounds = (-24.0, 24.0, -7.2, 7.2)
    np.testing.assert_allclose(
        t_pos(12, 36, bounds).numpy(), np.asarray(j_pos(12, 36, bounds)), atol=1e-5
    )


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_norm_other_than_batch_on_efficientnet_raises_in_both_packages(norm):
    """MODEL.NORM reaches the encoder: on EfficientNet-B0 anything but
    'batch' raises ValueError with the reference's message, in the JAX
    package (build_backbone, called by its ViewEncoder) and in the port
    (BEVNet.from_config), instead of a BatchNorm model built in silence."""
    with pytest.raises(ValueError, match="MODEL.NORM") as want:
        j_build_backbone("efficientnet_b0", norm=norm)
    raw = {"DATA": {"IMG_SIZE": [3, 64, 96], "VIEWS": 2},
           "MODEL": {"BACKBONE": "efficientnet_b0", "NORM": norm, "FEAT_DIM": 16, "BEV_SIZE": [32, 16, 24],
                     "BEV_PROJ_CH": 16, "HEAD_MID1": 64, "HEAD_MID2": 32}}
    with pytest.raises(ValueError, match="MODEL.NORM") as got:
        BEVNet.from_config(tcfg.from_dict(raw))
    assert str(got.value) == str(want.value)
    raw["MODEL"]["NORM"] = "batch"
    assert isinstance(BEVNet.from_config(tcfg.from_dict(raw)).encoder, ViewEncoder)

"""The ResNet family of vsta_tpu_torch against the JAX package on the CPU:
the trunk (18 and 50 on every pyramid level, BatchNorm in eval and in
training mode, GroupNorm), the converter's coverage of 34 and 101, the
bilinear resize of the multi-scale levels, and ViewEncoder with
OUT_INDEX (1, 2) in float32 and bfloat16, forward and VJP.

Weights come from the Flax initialisation with every norm scale, bias and
statistic redrawn at random (the closing norm of each block starts at a
zero scale, which would hide its whole branch), through convert.py.

Tolerances: float32 1e-4 of each tensor's largest magnitude (XLA and
torch sum convolutions in other orders). In training mode BatchNorm
normalises by statistics of the batch, and each level amplifies the
rounding of the one before: a one-ulp change of JAX's own input moves
ResNet-50's deepest level by 1.4e-4 of its largest magnitude. A level is
therefore held to the larger of 1e-4 and four times JAX's own change
under that one-ulp perturbation. The bfloat16 resize is bit-equal to
``jax.image.resize`` forward, the float32 one within 1e-6. The bfloat16
encoder's outputs and gradients are held, each by its relative distance
to JAX's, to JAX's own bfloat16-to-float32 distance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsta_tpu.models.encoders.encoder import ViewEncoder as JEncoder
from vsta_tpu.models.encoders.resnet import ResNetFeatures as JTrunk
from vsta_tpu_torch.convert import _resnet
from vsta_tpu_torch.models.encoders.encoder import ViewEncoder, build_backbone
from vsta_tpu_torch.models.encoders.resnet import ResNetFeatures, resnet_channels
from vsta_tpu_torch.ops.resize import resize_bilinear

HW = (66, 98)  # 33x49 -> 17x25 -> 9x13 -> 5x7 -> 3x4: odd maps down the pyramid


def _tree_np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), jax.tree.map(np.asarray, dict(tree)))


def randomize(tree, rng):
    """Numpy copy with random norm scales, 1-D biases and statistics."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
            continue
        a = np.array(v, dtype=np.float32)
        if k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k == "mean" or (k == "bias" and a.ndim == 1):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[k] = a
    return out


def trunk_state(params, stats):
    sd = {}
    _resnet(params, stats, sd, "t")
    return {k[2:]: v for k, v in sd.items()}


def _close(got, want, tol, what):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()) + 1e-6, err_msg=what)


@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def variant(request):
    return request.param


@pytest.mark.parametrize("mode", ["bn-eval", "bn-train", "gn"])
def test_resnet_trunk_matches_flax(variant, mode):
    """Every pyramid level; in training mode also the updated BatchNorm
    statistics of every stage, the two past the requested levels included."""
    norm = "group" if mode == "gn" else "batch"
    train = mode == "bn-train"
    m = JTrunk(variant=variant, norm_layer=norm)
    v = randomize(_tree_np(m.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))), np.random.default_rng(1))
    assert ("batch_stats" in v) == (norm == "batch")
    x = np.random.default_rng(2).standard_normal((2, *HW, 3)).astype(np.float32)
    trunk = ResNetFeatures(variant, norm=norm)
    trunk.load_state_dict(trunk_state(v["params"], v.get("batch_stats")))
    trunk.train(train)

    if train:
        fn = jax.jit(lambda v, x: m.apply(v, x, train=True, mutable=["batch_stats"]))
        want, upd = fn(v, jnp.asarray(x))
        ulp, _ = fn(v, jnp.asarray(x * np.float32(1 + 2**-23)))
        tols = [max(1e-4, 4 * float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(a)).max()))
                for a, b in zip(want, ulp)]
        with torch.no_grad():
            got = trunk(torch.from_numpy(x).permute(0, 3, 1, 2), levels=3)
        assert len(got) == 3
        stats = trunk_state(v["params"], _tree_np(upd["batch_stats"]))
        sd = trunk.state_dict()
        for k, w in stats.items():
            if k.endswith(("running_mean", "running_var")):
                _close(sd[k], w, 1e-4, k)
        moved = "stages.3.0.norms.0.running_mean"
        assert not np.array_equal(sd[moved].numpy(), trunk_state(v["params"], v["batch_stats"])[moved].numpy())
    else:
        want = jax.jit(lambda v, x: m.apply(v, x, train=False))(v, jnp.asarray(x))
        tols = [1e-4] * 5
        with torch.no_grad():
            got = trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert len(got) == 5
    shapes = [(17, 25), (9, 13), (5, 7), (3, 4)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape[1:]) == (resnet_channels(variant)[i], *((33, 49) if i == 0 else shapes[i - 1]))
        _close(g.permute(0, 2, 3, 1), w, tols[i], f"level {i}")


@pytest.mark.parametrize("variant", ["resnet34", "resnet101"])
@pytest.mark.parametrize("norm", ["batch", "group"])
def test_resnet_converter_covers_34_and_101(variant, norm):
    """Key coverage and parameter count from the Flax tree's shapes alone."""
    m = JTrunk(variant=variant, norm_layer=norm)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    v = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = trunk_state(v["params"], v.get("batch_stats"))
    trunk = ResNetFeatures(variant, norm=norm)
    want = trunk.state_dict()
    assert sd.keys() == want.keys()
    assert all(sd[k].shape == want[k].shape for k in sd)
    n_flax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(v["params"]))
    assert n_flax == sum(p.numel() for p in trunk.parameters())
    assert len(trunk.stages[2]) == (6 if variant == "resnet34" else 23)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("src,dst", [((5, 7), (9, 13)), ((17, 30), (34, 60)), ((9, 13), (9, 26))])
def test_resize_bilinear_matches_jax_image_resize(dtype, src, dst):
    """The bfloat16 forward bit-equal (the weights and the intermediate
    product rounded as JAX rounds them), the float32 one to 1e-6 (XLA
    fuses the two-tap sums with other roundings); the VJP to one
    rounding of the dtype."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, *src, 5)).astype(np.float32)
    g = rng.standard_normal((2, *dst, 5)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fn = lambda a: jax.image.resize(a, (2, *dst, 5), "bilinear").astype(a.dtype)  # noqa: E731
    want, vjp = jax.vjp(fn, jnp.asarray(x).astype(jdt))
    (want_g,) = vjp(jnp.asarray(g).astype(jdt))
    leaf = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt).requires_grad_(True)
    got = resize_bilinear(leaf, dst)
    got.backward(torch.from_numpy(g).permute(0, 3, 1, 2).to(tdt))
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2.0**-8
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.detach().permute(0, 2, 3, 1).float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    else:
        _close(got.permute(0, 2, 3, 1), want, tol, "forward")
    _close(leaf.grad.permute(0, 2, 3, 1), want_g.astype(jnp.float32), tol, "vjp")


def _encoder_pair(dtype, fold=False):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jenc = JEncoder(backbone="resnet18", feat_dim=16, out_index=(1, 2), dtype=jdt, fold_proj=fold)
    x = np.random.default_rng(4).standard_normal((1, 2, *HW, 3)).astype(np.float32)
    v = randomize(_tree_np(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))), np.random.default_rng(5))
    enc = ViewEncoder("resnet18", 16, (1, 2), tdt, fold_proj=fold)
    sd = {f"backbone.{k}": t for k, t in trunk_state(v["params"]["backbone"], v["batch_stats"]["backbone"]).items()}
    p = v["params"]["proj"]
    sd["proj.weight"] = torch.from_numpy(np.transpose(p["kernel"], (3, 2, 0, 1)).copy())
    sd["proj.bias"] = torch.from_numpy(p["bias"])
    enc.load_state_dict(sd)
    enc.eval()
    return jenc, v, enc, x


def _encoder_vjp(dtype):
    """JAX's and the port's forward, d images and d proj kernel under one
    cotangent, float32 numpy, as ([JAX], [port])."""
    jenc, v, enc, x = _encoder_pair(dtype)
    assert enc.proj.in_channels == 64 + 128
    want, vjp = jax.vjp(lambda p, a: jenc.apply({"params": p, "batch_stats": v["batch_stats"]}, a, train=False),
                        v["params"], jnp.asarray(x))
    assert want.dtype == getattr(jnp, dtype)
    g = np.random.default_rng(6).standard_normal(want.shape).astype(np.float32)
    want_gp, want_gx = vjp(jnp.asarray(g).astype(want.dtype))
    leaf = torch.from_numpy(x).requires_grad_(True)
    got = enc(leaf)
    assert got.shape == want.shape == (1, 2, 17, 25, 16) and got.dtype == getattr(torch, dtype)
    got.backward(torch.from_numpy(g).to(got.dtype))
    kernel_g = np.transpose(np.asarray(want_gp["proj"]["kernel"], np.float32), (3, 2, 0, 1))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return ([f32(want), f32(want_gx), kernel_g],
            [t.detach().float().numpy() for t in (got, leaf.grad, enc.proj.weight.grad)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_view_encoder_multiscale_matches_flax(dtype):
    """OUT_INDEX (1, 2): the stride-8 map (128 channels) resized to the
    stride-4 one (64) and concatenated, 192 channels into the 1x1
    projection; the forward and the VJP of the images and of the
    projection's kernel under one cotangent. float32: 1e-4. bfloat16:
    through two bf16 ResNet stages forward and back the roundings add up
    (JAX's own bf16 d-images lies 12% from its float32 one), so each
    tensor's relative distance to JAX's, ||a - b|| / ||b||, is held to
    JAX's own bf16-to-float32 distance."""
    what = ("forward", "d images", "d proj kernel")
    want, got = _encoder_vjp(dtype)
    if dtype == "float32":
        for a, b, w in zip(got, want, what):
            _close(a, b, 1e-4, w)
        return
    want32, _ = _encoder_vjp("float32")
    dist = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    for a, b, ref, w in zip(got, want, want32, what):
        assert dist(a, b) <= dist(b, ref), (w, dist(a, b), dist(b, ref))


def test_view_encoder_multiscale_fold_proj():
    """fold_proj with a tuple: the raw 192-channel map, the kernel
    [192, F] and the bias, as the JAX encoder returns them."""
    jenc, v, enc, x = _encoder_pair("float32", fold=True)
    feat, kernel, bias = jenc.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got_f, got_k, got_b = enc(torch.from_numpy(x))
    assert got_f.shape == feat.shape == (1, 2, 17, 25, 192)
    _close(got_f, feat, 1e-4, "raw map")
    np.testing.assert_array_equal(got_k.detach().numpy(), np.asarray(kernel))
    np.testing.assert_array_equal(got_b.detach().numpy(), np.asarray(bias))


def test_build_backbone_takes_every_name_and_group_norm_on_resnets_only():
    from vsta_tpu.models.encoders.encoder import build_backbone as j_build

    for name in ("resnet18", "resnet34", "resnet50", "resnet101"):
        assert isinstance(build_backbone(name, norm="group"), ResNetFeatures)
    for name in ("efficientnet_b0", "simple"):
        for build in (build_backbone, j_build):
            with pytest.raises(ValueError, match="only supported for resnet"):
                build(name, norm="group")

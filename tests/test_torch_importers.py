"""The pretrained-backbone and reference-checkpoint importers of
vsta_tpu_torch against the JAX package's, on the CPU.

Every state_dict here is built from a numpy seed with torchvision's ResNet
names (or the reference's fallback stack and head) and written with
``torch.save``; nothing is downloaded. Both packages load the same file
or dict: the tensors they load must be the same ones (compared exactly,
through convert.py), their outputs agree to 1e-4 of the largest magnitude
(float32; XLA and torch sum convolutions in other orders), they count the
same tensors and print the same lines. A shape-mismatch line names the
shapes in each package's own layout (HWIO in JAX, OIHW in the port), so
it is compared up to its colon.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vsta_tpu import config as jcfg
from vsta_tpu.data.synthetic import make_ring_camera
from vsta_tpu.models import BEVNet as JBEVNet
from vsta_tpu.models.encoders.pretrained import load_pretrained_backbone as j_load_pretrained
from vsta_tpu.models.encoders.resnet import ResNetFeatures as JTrunk
from vsta_tpu.models.reference_import import load_reference_weights as j_load_reference
from vsta_tpu.training.state import create_state as j_create_state
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch.convert import state_dict_from_flax
from vsta_tpu_torch.models import BEVNet
from vsta_tpu_torch.models.encoders.pretrained import load_pretrained_backbone
from vsta_tpu_torch.models.reference_import import _guess_resnet_variant, load_reference_weights
from vsta_tpu_torch.training.state import create_state

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


B, V, H, W = 1, 2, 66, 98
SPECS = {"resnet18": (False, (2, 2, 2, 2)), "resnet50": (True, (3, 4, 6, 3))}


def torchvision_resnet(variant, rng):
    """Random tensors under torchvision's ResNet names and shapes (fc included)."""
    bottleneck, blocks = SPECS[variant]
    sd = {}

    def conv(key, o, i, k):
        sd[key] = torch.from_numpy((rng.standard_normal((o, i, k, k)) * (2.0 / (i * k * k)) ** 0.5).astype(np.float32))

    def bn(prefix, n):
        sd[f"{prefix}.weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
        sd[f"{prefix}.bias"] = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
        sd[f"{prefix}.running_mean"] = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
        sd[f"{prefix}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(100)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    in_ch = 64
    for i, n in enumerate(blocks):
        w = 64 * 2**i
        out = 4 * w if bottleneck else w
        for j in range(n):
            t = f"layer{i + 1}.{j}"
            c_in = in_ch if j == 0 else out
            shapes = [(w, c_in, 1), (w, w, 3), (out, w, 1)] if bottleneck else [(w, c_in, 3), (w, w, 3)]
            for k, (o, ci, ks) in enumerate(shapes):
                conv(f"{t}.conv{k + 1}.weight", o, ci, ks)
                bn(f"{t}.bn{k + 1}", o)
            if j == 0 and (i > 0 or bottleneck):
                conv(f"{t}.downsample.0.weight", out, c_in, 1)
                bn(f"{t}.downsample.1", out)
        in_ch = out
    sd["fc.weight"] = torch.zeros(1000, in_ch)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def _raw(backbone="resnet18", norm="batch", **model):
    return {
        "DATA": {"BATCH_SIZE": B, "IMG_SIZE": [3, H, W], "VIEWS": V},
        "MODEL": {"BACKBONE": backbone, "NORM": norm, "FEAT_DIM": 16, "OUT_INDEX": 2, "BEV_SIZE": [32, 16, 48],
                  "BEV_BOUNDS": [-12.0, 12.0, -4.0, 4.0], "BEV_PROJ_CH": 32, "HEAD_MID1": 64, "HEAD_MID2": 32,
                  "WARP_IMPL": "fused", "FUSION": "concat", **model},
        "RUNTIME": {"USE_AMP": False},
    }


def _inputs(seed=7):
    rng = np.random.default_rng(seed)
    Ks, Rts = zip(*(make_ring_camera(v, V, radius=10.0, height=4.0, img_hw=(H, W)) for v in range(V)))
    return (rng.integers(0, 256, (B, V, H, W, 3)).astype(np.uint8),
            np.broadcast_to(np.stack(Ks), (B, V, 3, 3)).astype(np.float32),
            np.broadcast_to(np.stack(Rts), (B, V, 4, 4)).astype(np.float32))


def _jax_variables(raw):
    model = JBEVNet.from_config(jcfg.from_dict(raw))
    images, K, Rt = _inputs()
    return model, jax.tree.map(np.asarray, dict(jax.jit(model.init)(jax.random.PRNGKey(0), images.astype(np.float32), K, Rt)))


def _lines(text, tag):
    return [ln.split(":")[0] if "shape mismatch" in ln else ln for ln in text.splitlines() if ln.startswith(f"[{tag}]")]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), jax.tree.map(np.asarray, dict(tree)))


@pytest.mark.parametrize("case", ["resnet18", "resnet50", "resnet18-group", "resnet18-mismatch"])
def test_pretrained_backbone_loads_as_in_jax(case, tmp_path, capsys):
    """The same .pth into both packages' backbones: the same tensors, the
    same counts and lines, the same pyramid. "mismatch" drops a key and
    gives one conv a wrong shape; "group" loads into a GroupNorm ResNet,
    whose block norms are no target."""
    variant = case.split("-")[0]
    sd = torchvision_resnet(variant, np.random.default_rng(1))
    if case.endswith("mismatch"):
        del sd["layer2.1.bn2.running_var"]
        sd["layer3.0.conv1.weight"] = sd["layer3.0.conv1.weight"][:, :, :1, :1].contiguous()
    path = tmp_path / "backbone.pth"
    torch.save(sd, path)
    norm = "group" if case.endswith("group") else "batch"
    raw = _raw(variant, norm)

    _, v = _jax_variables(raw)
    net = BEVNet.from_config(tcfg.from_dict(raw))
    net.load_state_dict(state_dict_from_flax(v))
    capsys.readouterr()
    v = j_load_pretrained(v, str(path), variant)  # a new tree: the old one stays as it was
    want_out = capsys.readouterr().out
    n = load_pretrained_backbone(net.encoder.backbone, str(path), variant)
    got_out = capsys.readouterr().out
    assert _lines(got_out, "pretrained") == _lines(want_out, "pretrained")
    assert f"loaded {n[0]} param + {n[1]} batch-stat tensors" in want_out
    if case.endswith("mismatch"):
        assert "torch keys missing" in got_out and "shape mismatch at stage2_block0/Conv_0/kernel" in got_out
    if norm == "group":
        assert n[1] == 0 and "no target for stage0_block0/BatchNorm_0, skipped" in got_out

    want = state_dict_from_flax(_np_tree(v))
    got = net.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    if norm == "batch" and not case.endswith("mismatch"):
        np.testing.assert_array_equal(got["encoder.backbone.stem_conv.weight"].numpy(), sd["conv1.weight"].numpy())

    # the loaded pyramid, eval mode
    trunk = JTrunk(variant=variant, norm_layer=norm)
    x = np.random.default_rng(2).standard_normal((2, H, W, 3)).astype(np.float32)
    bb = {"params": v["params"]["encoder"]["backbone"]}
    if "batch_stats" in v:
        bb["batch_stats"] = v["batch_stats"]["encoder"]["backbone"]
    want_p = jax.jit(trunk.apply)(bb, jnp.asarray(x))
    net.eval()
    with torch.no_grad():
        got_p = net.encoder.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got_p, want_p):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("backbone", ["resnet18", "efficientnet_b0"])
def test_create_state_loads_pretrained_or_goes_on(backbone, tmp_path, capsys):
    """MODEL.PRETRAINED with PRETRAINED_PATH: a ResNet loads the file; an
    EfficientNet fails the load and both packages print the same line and
    train from scratch."""
    path = tmp_path / "r18.pth"
    torch.save(torchvision_resnet("resnet18", np.random.default_rng(3)), path)
    raw = _raw(backbone, PRETRAINED=True, PRETRAINED_PATH=str(path))
    raw["MODEL"]["OUT_INDEX"] = 2
    capsys.readouterr()
    j_create_state(jcfg.from_dict(raw), optax.sgd(1e-3), jax.random.PRNGKey(0))
    want = capsys.readouterr().out
    state = create_state(tcfg.from_dict(raw), device="cpu", steps_per_epoch=1)
    got = capsys.readouterr().out
    assert _lines(got, "pretrained") == _lines(want, "pretrained") != []
    if backbone == "resnet18":
        assert "loaded 60 param + 40 batch-stat tensors" in got
        sd = torch.load(path, weights_only=True)
        assert torch.equal(state.model.encoder.backbone.stem_conv.weight, sd["conv1.weight"])
    else:
        assert got.strip().endswith("training from scratch")


def reference_state_dict(kind, rng, feat=16, c_out=32, mid1=64, mid2=32):
    """A reference BEVNet state_dict: the fallback conv stack (no encoder
    proj) or a torchvision ResNet-18 with an encoder proj; the concat
    fusion's 1x1 proj over V * FEAT_DIM channels; the detector's stem
    (conv, GroupNorm, ReLU three times) and three heads."""
    r = lambda *s: torch.from_numpy((0.1 * rng.standard_normal(s)).astype(np.float32))  # noqa: E731
    if kind == "fallback":
        sd = {"encoder.backbone.0.weight": r(16, 3, 3, 3), "encoder.backbone.0.bias": r(16),
              "encoder.backbone.2.weight": r(feat, 16, 3, 3), "encoder.backbone.2.bias": r(feat)}
    else:
        sd = {f"encoder.backbone.{k}": t for k, t in torchvision_resnet("resnet18", rng).items()}
        sd["encoder.proj.weight"], sd["encoder.proj.bias"] = r(feat, 128, 1, 1), r(feat)
    sd["proj.weight"], sd["proj.bias"] = r(c_out, V * feat, 1, 1), r(c_out)
    for src, (i, o) in zip((0, 3, 6), ((c_out + 2, mid1), (mid1, mid2), (mid2, mid2))):
        sd[f"detector.stem.{src}.weight"] = r(o, i, 3, 3)
        sd[f"detector.stem.{src + 1}.weight"] = 1.0 + r(o)
        sd[f"detector.stem.{src + 1}.bias"] = r(o)
    for head, o in (("heatmap_head", 1), ("offset_head", 2), ("size_head", 2)):
        sd[f"detector.{head}.weight"], sd[f"detector.{head}.bias"] = r(o, mid2, 3, 3), r(o)
    return sd


@pytest.mark.parametrize("kind", ["fallback", "resnet18", "resnet18-mismatch"])
def test_reference_import_matches_jax(kind, capsys):
    """One reference state_dict into both packages' BEVNet: the same loaded
    tensors, the same count and lines, the same heatmap. "mismatch" gives
    the concat proj an in_ch that V does not divide and the size head a
    wrong shape."""
    sd = reference_state_dict(kind.split("-")[0], np.random.default_rng(4))
    if kind.endswith("mismatch"):
        sd["proj.weight"] = sd["proj.weight"][:, :-1].contiguous()
        sd["detector.size_head.weight"] = sd["detector.size_head.weight"][:, :, :1, :1].contiguous()
    raw = _raw("simple" if kind == "fallback" else "resnet18", FEAT_DIM=16,
               OUT_INDEX=1 if kind == "fallback" else 2)
    model, v0 = _jax_variables(raw)
    sd_np = {k: t.numpy() for k, t in sd.items()}
    capsys.readouterr()
    v, n_want = j_load_reference(v0, sd_np, views=V, feat_dim=16)
    want_out = capsys.readouterr().out
    net = BEVNet.from_config(tcfg.from_dict(raw))
    net.load_state_dict(state_dict_from_flax(v0))
    _, n = load_reference_weights(net, sd, views=V, feat_dim=16)
    got_out = capsys.readouterr().out
    assert n == n_want and n >= 20
    assert _lines(got_out, "reference-import") == _lines(want_out, "reference-import")
    if kind.endswith("mismatch"):
        assert "not divisible by V=2; skipped" in got_out and "shape mismatch at detector/size_head/kernel" in got_out
    want = state_dict_from_flax(_np_tree(v))
    got = net.state_dict()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    images, K, Rt = _inputs(9)
    want_hm = np.asarray(jax.jit(model.apply)(v, images, K, Rt)["heatmap_logits"])
    net.eval()
    with torch.no_grad():
        got_hm = net(*(torch.from_numpy(a) for a in (images, K, Rt)))["heatmap_logits"].numpy()
    np.testing.assert_allclose(got_hm, want_hm, rtol=1e-4, atol=1e-4 * np.abs(want_hm).max())


def test_guess_resnet_variant():
    from vsta_tpu.models.reference_import import _guess_resnet_variant as j_guess

    for variant in SPECS:
        sd = torchvision_resnet(variant, np.random.default_rng(0))
        assert _guess_resnet_variant(sd) == j_guess(sd) == variant

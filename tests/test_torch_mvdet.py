"""MVDet (``HEAD: mvdet``) in the port against the benchmark's plain
reference (``benchmark/reference/mvdet.py``), on the CPU at a tiny size,
with seeded random weights: the dilated trunk, the map classifier, the
whole forward, the served artifact's detections, and the configuration's
keys. MVDet has no JAX twin: the reference is its yardstick, as on the
card."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness.inputs import FrameSets, calibrate, make_weights, model_dict
from benchmark.reference import mvdet, resnet
from benchmark.reference.decode import decode
from vsta_tpu_torch.config import from_dict, load_config, to_dict
from vsta_tpu_torch.models import bevnet
from vsta_tpu_torch.models.bevnet import BEVNet
from vsta_tpu_torch.models.encoders.encoder import ViewEncoder
from vsta_tpu_torch.models.encoders.resnet import ResNetFeatures
from vsta_tpu_torch.models.heads import MVDetHead

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "wildtrack_mvdet.json").read_text())["config"]
SEED = 2**31 + 19


def tiny(amp: bool = False) -> dict:
    """The published configuration at 3 views of 96 x 160, maps resized to
    36 x 60 (the published 720 x 1280 -> 270 x 480 ratio), a 12 x 36 grid;
    every width as published."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg["DATA"].update(IMG_SIZE=[3, 96, 160], VIEWS=3)
    cfg["MODEL"].update(FEAT_SIZE=[36, 60], BEV_SIZE=[1, 12, 36])
    cfg["RUNTIME"].update(USE_AMP=amp, DEVICE="cpu")
    return cfg


@pytest.fixture(scope="module")
def setup():
    """Calibrated weights, two frame sets and the reference's maps, f32."""
    cfg = tiny()
    w = make_weights(mvdet, cfg, SEED, "cpu")
    ds = FrameSets(cfg, 2, SEED, "cpu")
    calibrate(mvdet, cfg, w, ds[0], "cpu")
    b = ds.batch([0, 1])
    args = [torch.as_tensor(b[k]) for k in ("images", "K", "Rt")]
    with torch.no_grad():
        ref = mvdet.Reference(cfg, w)(*args)
    return cfg, w, args, ref


def model_of(cfg: dict, w) -> BEVNet:
    net = BEVNet.from_config(from_dict(cfg))
    net.load_state_dict(w)
    return net.eval()


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_published_configuration_reads_as_published():
    m = load_config(str(ROOT / "configs" / "torch" / "wildtrack_mvdet.yaml")).model
    assert (m.backbone, m.out_index, m.dilation) == ("resnet18", 4, (False, True, True))
    assert (m.feat_dim, m.feat_size, m.bev_size, m.head) == (512, (270, 480), (120, 360), "mvdet")
    assert load_config(str(ROOT / "configs" / "torch" / "wildtrack_mvdet.yaml")) == from_dict(CONFIG)


def test_dilated_trunk_matches_the_reference(setup):
    """Stride 8 and 512 channels at C5; layer3's blocks dilated 1 then 2,
    layer4's 2 then 4, as torchvision builds replace_stride_with_dilation."""
    cfg, w, args, _ = setup
    net = model_of(cfg, w)
    convs = [c for b in net.encoder.backbone.blocks() for c in b.convs if c.kernel_size == (3, 3)]
    assert [c.dilation[0] for c in convs] == [1] * 4 + [1] * 4 + [1, 1, 2, 2] + [2, 2, 4, 4]
    assert all(c.padding == c.dilation for c in convs) and all(c.stride == (1, 1) for c in convs[8:])
    x = mvdet.normalise(args[0].reshape(-1, *args[0].shape[2:]))
    with torch.no_grad():
        got = net.encoder.backbone(x, 5)[4]
        want = mvdet.Reference(cfg, w).trunk()(x)
    assert got.shape == want.shape == (6, 512, 12, 20)
    assert rel_gap(got, want) < 1e-5


@pytest.mark.parametrize("variant,level", [("resnet18", 2), ("resnet50", 2)])
def test_undilated_resnets_unchanged(variant, level):
    """Without dilation the trunk is resnet.py's, projection included, and
    the reference's schedule is resnet.py's with dilation 1."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "wildtrack_v1_resnet50.json").read_text())["config"]
    cfg["MODEL"].update(BACKBONE=variant, OUT_INDEX=level)
    cfg["DATA"]["IMG_SIZE"] = [3, 64, 96]
    w = make_weights(resnet, cfg, SEED, "cpu")
    enc = ViewEncoder(variant, feat_dim=cfg["MODEL"]["FEAT_DIM"], out_index=level)
    enc.load_state_dict({k[len("encoder."):]: v for k, v in w.items() if k.startswith("encoder.")})
    images = torch.as_tensor(FrameSets(cfg, 1, SEED, "cpu").images[0][None])
    with torch.no_grad():
        got = enc.eval()(mvdet.normalise(images[0]).permute(0, 2, 3, 1)[None])
        want = resnet.Reference(cfg, w).trunk()(mvdet.normalise(images[0]))
    assert rel_gap(got[0].permute(0, 3, 1, 2), want) < 1e-5
    plain = [(p, s, [c[:4] for c in convs], pr) for p, s, convs, pr in mvdet.dilated_blocks(variant)]
    assert plain == resnet.blocks(variant)
    assert all(c[4] == 1 for _, _, convs, _ in mvdet.dilated_blocks(variant) for c in convs)


def test_mvdet_head_matches_the_reference_head(setup):
    """The classifier with its coordinate channels as a per-cell bias map
    against the plain convolution over all 3 * 512 + 2 channels."""
    cfg, w, _, _ = setup
    head = model_of(cfg, w).detector
    assert isinstance(head, MVDetHead) and head.stem0.in_channels == 3 * 512 + 2
    bev = torch.randn(2, 12, 36, 3 * 512, generator=torch.Generator().manual_seed(SEED))
    ref = mvdet.Reference(cfg, w)
    pos = mvdet.coord_map(12, 36, "cpu").expand(2, 12, 36, 2)
    with torch.no_grad():
        got, want = head(bev), ref.head(torch.cat([bev, pos], dim=-1))
    assert rel_gap(got["heatmap_logits"], want["heatmap_logits"]) < 1e-5
    for k in ("offset", "size"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("amp,tol", [(False, 1e-5), (True, 0.06)], ids=["float32", "bfloat16"])
def test_bevnet_matches_the_reference_forward(setup, amp, tol):
    """The whole forward's logits against the reference's, relative to
    their largest: within 1e-5 in float32; in bfloat16 (the trunk, the
    resize, the warp and the classifier's stem in bf16) within 6 %, the
    rounding of 20 bf16 layers and a 1,538-channel sum."""
    cfg, w, args, ref = setup
    net = model_of(tiny(amp), w)
    with torch.no_grad():
        out = net(*args)
    assert out["heatmap_logits"].dtype == torch.float32
    assert rel_gap(out["heatmap_logits"], ref["heatmap_logits"]) < tol
    assert out["bev_feat"].shape == (2, 12, 36, 3 * 512)


def test_grad_mode_and_runs_resize_alike(setup, monkeypatch):
    """The resize in equal runs (CUDA's channels-last limit, made small
    here) equals one F.interpolate; with a gradient wanted it raises, as
    MVDet serves only."""
    cfg, w, _, _ = setup
    net = model_of(cfg, w)
    feats = torch.randn(2, 3, 12, 20, 8).contiguous(memory_format=torch.contiguous_format)
    want = F.interpolate(feats.reshape(6, 12, 20, 8).permute(0, 3, 1, 2), size=(36, 60), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1).reshape(2, 3, 36, 60, 8)
    monkeypatch.setattr(bevnet, "RESIZE_ELEMENTS", 4 * 8 * 36 * 60 + 1)  # runs of 4 and 2 -> 3 and 3
    with torch.no_grad():
        assert torch.equal(net.resize_views(feats), want)
    with pytest.raises(NotImplementedError, match="mvdet"):
        net.resize_views(feats.requires_grad_())


def test_served_artifact_detects_as_the_reference(setup, tmp_path):
    """export -> save -> load on the CPU: the served detections are the
    reference's maps decoded by the plain decode."""
    from vsta_tpu_torch.export import export_serving, load_serving, save_exported

    cfg, w, args, ref = setup
    path = tmp_path / "mvdet.pt"
    save_exported(export_serving(from_dict(cfg), w, batch_size=2, platforms=("cpu",)), path)
    out = load_serving(path, device="cpu")(*args)
    e = cfg["EVAL"]
    det = decode(ref["heatmap"][..., 0], ref["offset"], ref["size"], bounds=tuple(cfg["MODEL"]["BEV_BOUNDS"]),
                 conf=e["CONF_THRESH"], nms_dist_m=e["NMS_DIST_M"], max_dets=e["MAX_DETS"])
    assert int(det["valid"].sum()) > 0
    assert torch.equal(out["valid"], det["valid"])
    np.testing.assert_allclose(out["boxes"].numpy(), det["boxes"].numpy(), atol=1e-5)
    np.testing.assert_allclose(out["scores"].numpy(), det["scores"].numpy(), atol=1e-5)


def test_reference_weights_load_strictly(setup):
    cfg, w, _, _ = setup
    names = [n for n, _, _ in mvdet.param_specs(model_dict(cfg))]
    assert set(names) == set(BEVNet.from_config(from_dict(cfg)).state_dict())
    assert "detector.heatmap_head.bias" in names and not any(n.startswith("encoder.proj") for n in names)


def test_new_keys_round_trip_and_default():
    cfg = from_dict(CONFIG)
    assert from_dict(to_dict(cfg)) == cfg
    assert to_dict(cfg)["MODEL"]["DILATION"] == [False, True, True]
    m = from_dict({}).model
    assert (m.dilation, m.feat_size, m.head) == ((False, False, False), (0, 0), "centernet")


@pytest.mark.parametrize("change", [
    {"HEAD": "detr"}, {"WARP_IMPL": "pallas"}, {"OUT_INDEX": [3, 4]}, {"FEAT_SIZE": [0, 0]},
    {"BEV_PROJ_CH": 128}, {"FUSION": "max"},
], ids=lambda c: next(iter(c)))
def test_mvdet_keys_are_checked(change):
    raw = json.loads(json.dumps(CONFIG))
    raw["MODEL"].update(change)
    with pytest.raises(ValueError):
        from_dict(raw)


def test_port_only_keys_refuse_the_centernet_head():
    for change in ({"FEAT_SIZE": [270, 480]}, {"BACKBONE": "efficientnet_b0", "DILATION": [False, True, True]}):
        with pytest.raises(ValueError):
            from_dict({"MODEL": change})
    raw = json.loads(json.dumps(CONFIG))
    raw["MODEL"].update(FEAT_DIM=256, BEV_PROJ_CH=256)  # no projection: FEAT_DIM is C5's 512
    with pytest.raises(ValueError, match="FEAT_DIM must be 512"):
        BEVNet.from_config(from_dict(raw))


def test_training_and_int8_refuse_mvdet(setup):
    from vsta_tpu_torch.export import calibrate_quant_encoder, calibrate_quant_head
    from vsta_tpu_torch.training.state import make_train_step

    cfg, w, args, _ = setup
    with pytest.raises(NotImplementedError, match="mvdet"):
        make_train_step(from_dict(cfg))
    batches = [tuple(a.numpy() for a in args)]
    for fn in (calibrate_quant_head, calibrate_quant_encoder):
        with pytest.raises(ValueError):
            fn(from_dict(cfg), w, batches, device="cpu")


def test_dilation_default_builds_the_same_trunk():
    """The default dilates nothing: the same convolutions, strides and
    paddings as before the key, so every shipped configuration's trunk."""
    a = ResNetFeatures("resnet50")
    b = ResNetFeatures("resnet50", dilation=(False, False, False))
    spec = lambda m: [(c.stride, c.padding, c.dilation, tuple(c.weight.shape))
                      for blk in m.blocks() for c in blk.convs]
    assert spec(a) == spec(b)
    assert all(d == (1, 1) for _, _, d, _ in spec(a))
    assert dataclasses.asdict(from_dict({}))["model"]["head"] == "centernet"

"""The counts on shapes whose answer is known by hand."""

import hashlib
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import kernels
from benchmark.counts.flops import model_flops, sampler_flops
from benchmark.counts.peaks import HBM_BYTES_PER_S
from benchmark.harness.inputs import FrameSets, calibrate, make_weights, ring_rig
from benchmark.reference import model

from .conftest import configuration, tiny

# what the parent of the resolver counted and listed for the two B0
# configurations, read from model.py directly: the operations of a frame set
# (forward; forward and backward), the number of parameter entries and the
# sha256 of their (name, shape, kind) list in order
BEFORE_THE_RESOLVER = {
    "wildtrack": (126492466810.0, 469330761594.0, 371,
                  "957a88b501cbc54216826c8b7fd96dc8607e43ca45523f1417326ee022a0586f"),
    "wildtrack_deform": (125885946106.0, 467511199482.0, 379,
                         "744d039d5cd3ca97789d9403053c6612c0d99bb6a95757fa9f84e03fa89b9096"),
}


def test_taps_live_and_rows():
    # one point inside a 4x4 map between four pixels, one on a pixel, one
    # off the map, one not finite
    xy = torch.tensor([[[1.5, 1.5], [2.0, 2.0], [-3.0, 0.0], [float("nan"), 1.0]]])
    rows, live = kernels.plain_taps(xy, (4, 4))
    assert live[0, 0].tolist() == [True] * 4 and sorted(rows[0, 0].tolist()) == [5, 6, 9, 10]
    assert live[0, 1].tolist() == [True, False, False, False] and rows[0, 1, 0] == 10
    assert not live[0, 2:].any()
    assert kernels.distinct_rows(rows, live, 16) == 4


def test_warp_bound_bytes_by_hand():
    xy = torch.tensor([[[1.5, 1.5], [1.5, 1.5]]])  # 2 cells, 4 shared rows
    b = kernels.warp_tiles(xy, (4, 4), K=8)
    assert b.nbytes == 4 * 8 * 2 + 2 * 8 * 2 + 1 * 2 * 4 * 8
    assert b.flops == 2 * 8 * 8
    assert b.seconds == b.nbytes / HBM_BYTES_PER_S


def test_sampler_scale_kills_taps():
    xy = torch.tensor([[[1.5, 1.5], [0.5, 0.5]]])
    b = kernels.sample_grouped(xy, (4, 4), K=4, scale=torch.tensor([[1.0, 0.0]]))
    assert b.flops == 2 * 4 * 4


def test_flop_counter_on_a_conv_by_hand():
    x, w = torch.empty(1, 3, 8, 8, device="meta"), torch.empty(5, 3, 3, 3, device="meta")
    with FlopCounterMode(display=False) as fc:
        torch.nn.functional.conv2d(x, w, padding=1)
    assert fc.get_total_flops() == 2 * 8 * 8 * 5 * 3 * 9


def test_model_flops_train_is_about_three_forwards():
    ref, cfg = configuration("wildtrack")
    K, Rt = ring_rig(cfg)
    f, t = model_flops(ref, cfg, K, Rt), model_flops(ref, cfg, K, Rt, train=True)
    assert 100e9 < f < 160e9 and 2.5 * f < t < 4 * f


def test_resnet50_flops_by_hand():
    """The ResNet-50 configuration's count of a frame set, by hand: seven
    views of the trunk to C3 (the stem and the first two stages of
    bottlenecks), the encoder's projection and the view projection, then
    the ground-plane homographies (K @ [r1 r2 t], then every cell's point
    through it), the head on the BEV grid and the samplers' taps."""
    ref, cfg = configuration("wildtrack_v1_resnet50")
    K, Rt = ring_rig(cfg)

    def conv(hw, cin, cout, k):
        return 2 * hw[0] * hw[1] * cin * cout * k * k

    s2, s4, s8, bev = (135, 240), (68, 120), (34, 60), (120, 360)
    trunk = conv(s2, 3, 64, 7)
    for j in range(3):  # stage 0 at stride 4: bottlenecks of width 64 out to 256
        trunk += conv(s4, 64 if j == 0 else 256, 64, 1) + conv(s4, 64, 64, 3) + conv(s4, 64, 256, 1)
    trunk += conv(s4, 64, 256, 1)  # the first block's residual projection
    for j in range(4):  # stage 1: width 128 out to 512, the stride on the first block's 3x3
        trunk += conv(s4 if j == 0 else s8, 256 if j == 0 else 512, 128, 1) + conv(s8, 128, 128, 3)
        trunk += conv(s8, 128, 512, 1)
    trunk += conv(s8, 256, 512, 1)
    assert 9.0e9 < trunk < 9.8e9
    views = 7 * (trunk + conv(s8, 512, 256, 1) + conv(s8, 256, 128, 1))
    geometry = 7 * (2 * 3 * 3 * 3 + 2 * bev[0] * bev[1] * 3 * 3)
    head = conv(bev, 130, 512, 3) + conv(bev, 512, 128, 3) + conv(bev, 128, 128, 3) + conv(bev, 128, 5, 3)
    assert model_flops(ref, cfg, K, Rt) == views + geometry + head + sampler_flops(ref, cfg, K, Rt)


@pytest.mark.parametrize("name", sorted(BEFORE_THE_RESOLVER))
def test_resolved_reference_reads_as_model_py(name):
    """The B0 configurations resolve to ``model.py``, and read through the
    resolver what they read from it directly before the resolver: the same
    parameter list, the same operations at full shapes (on ``meta``), the
    same weights and calibrated BatchNorm statistics at a tiny size."""
    ref, cfg = configuration(name)
    assert ref is model
    flops, flops_train, n, digest = BEFORE_THE_RESOLVER[name]
    specs = ref.param_specs(dict(cfg["MODEL"], VIEWS=cfg["DATA"]["VIEWS"]))
    assert len(specs) == n and hashlib.sha256(json.dumps(specs).encode()).hexdigest() == digest
    K, Rt = ring_rig(cfg)
    assert model_flops(ref, cfg, K, Rt) == flops and model_flops(ref, cfg, K, Rt, train=True) == flops_train
    cfg = tiny(cfg)
    w, direct = make_weights(ref, cfg, 2**31 + 17, "cpu"), make_weights(model, cfg, 2**31 + 17, "cpu")
    assert list(w) == [s[0] for s in specs] and all(torch.equal(w[k], direct[k]) for k in w)
    frame_set = FrameSets(cfg, 2, 2**31 + 17, "cpu")[0]
    calibrate(ref, cfg, w, frame_set, "cpu")
    stats = {}  # model.py's trunk called directly, as calibration did before the resolver
    model.Trunk(direct, cfg["MODEL"]["OUT_INDEX"], train=True, stats=stats)(
        model.normalise(torch.as_tensor(frame_set["images"])))
    for p, (mean, var) in stats.items():
        assert torch.equal(w[p + "running_mean"], mean) and torch.equal(w[p + "running_var"], var)


@pytest.mark.parametrize("name", ["wildtrack", "wildtrack_deform", "wildtrack_v1_resnet50"])
def test_request_bounds_at_a_tiny_size(name):
    ref, cfg = configuration(name)
    cfg = tiny(cfg)
    b = FrameSets(cfg, 2, 3, "cpu").batch([0, 1])
    if cfg["MODEL"]["FUSION"] == "deform_attn":
        bound = kernels.deform_request(ref, cfg, make_weights(ref, cfg, 3, "cpu"), b, "cpu")
    elif cfg["MODEL"]["WARP_IMPL"] == "fused":
        bound = kernels.concat_grouped_request(ref, cfg, b["K"][0], b["Rt"][0], 2)
    else:
        bound = kernels.concat_request(ref, cfg, b["K"][0], b["Rt"][0], 2)
    assert bound.nbytes > 0 and bound.flops > 0 and bound.seconds > 0

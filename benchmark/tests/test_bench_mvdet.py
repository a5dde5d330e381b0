"""The MVDet configuration's pieces of the benchmark: its operations by
hand, the per-view warp's bound against a direct count, its reference
against the contract, its two new readers, and the comparison failing what
it must on a run of its cell cut to a size the CPU holds."""

import ast
import json
import math
import time
from pathlib import Path

import pytest
import torch

from benchmark.counts import kernels
from benchmark.counts.flops import model_flops, sampler_flops
from benchmark.counts.views import views_grouped_request
from benchmark.harness import cell as cells
from benchmark.harness.inputs import FrameSets, ring_rig
from benchmark.harness.judge import verdict
from benchmark.harness.trace import DeviceTrace
from benchmark.reference import CONTRACT
from benchmark.tools.faults import Control, altered, half_batch, heatmap_as

from .conftest import configuration

ROOT = Path(__file__).resolve().parents[2]
CELL = "wildtrack_mvdet.offline_b16"


def conv(hw, cin, cout, k=3):
    return 2 * hw[0] * hw[1] * cin * cout * k * k


def test_mvdet_flops_by_hand():
    """A frame set: seven views of the dilated ResNet-18 at 720 x 1280
    (the stem at stride 2, layer1 at 4, layer2 to 8, then layer3 and
    layer4 at 8), the ground-plane homographies, the map classifier on the
    120 x 360 grid over 7 * 512 + 2 channels, and 2 operations a live tap
    and channel of the per-view warp of 512 channels."""
    ref, cfg = configuration("wildtrack_mvdet")
    K, Rt = ring_rig(cfg)
    s2, s4, s8, bev = (360, 640), (180, 320), (90, 160), (120, 360)
    trunk = conv(s2, 3, 64, 7) + 4 * conv(s4, 64, 64)
    trunk += conv(s8, 64, 128) + conv(s8, 64, 128, 1) + 3 * conv(s8, 128, 128)  # layer2, the stride on block 0
    trunk += conv(s8, 128, 256) + conv(s8, 128, 256, 1) + 3 * conv(s8, 256, 256)  # layer3, dilated
    trunk += conv(s8, 256, 512) + conv(s8, 256, 512, 1) + 3 * conv(s8, 512, 512)  # layer4, dilated
    assert 7 * trunk == pytest.approx(2368.9e9, rel=1e-4)
    head = conv(bev, 7 * 512 + 2, 512) + conv(bev, 512, 512) + conv(bev, 512, 1)
    assert head == pytest.approx(1631.9e9, rel=1e-4)
    geometry = 7 * (2 * 3 * 3 * 3 + 2 * bev[0] * bev[1] * 3 * 3)
    assert 7 * trunk + head + geometry == pytest.approx(4000.8e9, rel=1e-4)
    coords, hw = kernels.static_coords(ref, cfg, K, Rt)
    assert hw == (270, 480)
    _, live = kernels.plain_taps(coords, hw)
    taps = 2.0 * int(live.sum()) * 512
    assert sampler_flops(ref, cfg, K, Rt) == taps
    assert model_flops(ref, cfg, K, Rt) == 7 * trunk + head + geometry + taps


def tiny_mvdet(cfg: dict) -> dict:
    """The configuration at 96 x 160 a view (seven of them), maps resized
    to 36 x 60, a 24 x 72 grid: the widths as published."""
    cfg["DATA"]["IMG_SIZE"] = [3, 96, 160]
    cfg["MODEL"]["FEAT_SIZE"] = [36, 60]
    cfg["MODEL"]["BEV_SIZE"] = [1, 24, 72]
    return cfg


def test_views_bound_against_a_direct_count():
    """One request's bound is the grouped sampler's over every frame's
    views as groups of their own (B * V groups, K = FEAT_DIM), counted
    directly; by hand for one cell between four pixels of a 4 x 4 map."""
    ref, cfg = configuration("wildtrack_mvdet")
    cfg = tiny_mvdet(cfg)
    b = FrameSets(cfg, 3, 5, "cpu").batch([0, 1, 2])
    bound = views_grouped_request(ref, cfg, b["K"][0], b["Rt"][0], 3)
    coords, hw = kernels.static_coords(ref, cfg, b["K"][0], b["Rt"][0])
    direct = kernels.sample_grouped(coords.repeat(3, 1, 1), hw, 512)
    assert (bound.nbytes, bound.flops) == (direct.nbytes, direct.flops) and bound.nbytes > 0
    one = kernels.sample_grouped(torch.tensor([[[1.5, 1.5]]]), (4, 4), 8)
    assert (one.nbytes, one.flops) == (4 * 8 * 2 + 1 * 8 * 2 + 1 * 4 * 8, 2 * 4 * 8)


def test_reference_meets_the_contract_and_stands_apart():
    ref, cfg = configuration("wildtrack_mvdet")
    assert ref.__name__ == "benchmark.reference.mvdet"
    assert all(hasattr(ref, k) for k in CONTRACT)
    r = ref.Reference(cfg, {})
    assert r.feature_hw() == (270, 480) and r.bev_hw == (120, 360)
    tree = ast.parse(Path(ref.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    assert names <= {"__future__", "typing", "torch"}, names


def test_reference_forward_keys_and_refuses_training():
    ref, cfg = configuration("wildtrack_mvdet")
    cfg = tiny_mvdet(cfg)
    from benchmark.harness.inputs import make_weights

    w = make_weights(ref, cfg, 3, "cpu")
    b = FrameSets(cfg, 1, 3, "cpu").batch([0])
    args = [torch.as_tensor(b[k]) for k in ("images", "K", "Rt")]
    with torch.no_grad():
        out = ref.Reference(cfg, w)(*args)
    assert set(out) == {"heatmap_logits", "heatmap", "offset", "size"}
    assert out["heatmap"].shape == (1, 24, 72, 1) and out["size"].shape == (1, 24, 72, 2)
    with pytest.raises(NotImplementedError):
        ref.Reference(cfg, w)(*args, train=True)


def ops_of(*replays):
    """A device trace of whole replays: each a list of (name, us)."""
    ops, t = [], 0.0
    for replay in replays:
        for name, us in replay:
            ops.append((name, t, t + us))
            t += us
    return DeviceTrace(window_s=t / 1e6, ops=ops, spans=[])


class Rec:
    def __init__(self, trace):
        self.trace = trace


def test_upsample_reader_counts_complete_replays():
    up = "void at::native::upsample_bilinear2d_nhwc_out_frame<c10::BFloat16, float>"
    replay = [("vsta_stage_encoder", 1), ("conv", 50), ("vsta_stage_fusion", 1), (up, 70), (up, 30),
              ("sample_kernel", 5), ("vsta_stage_head", 1), ("conv", 40), ("vsta_stage_end", 1)]
    read = cells.load_module(ROOT / "benchmark" / "metrics" / "upsample_ms.serve.py", "t_upsample").read
    cut_head = replay[4:]  # a replay the stretch's start cut: its upsample is dropped
    assert read(Rec(ops_of(cut_head, replay, replay))) == pytest.approx(0.1)
    assert read(Rec(ops_of([("conv", 5)]))) is None and read(Rec(None)) is None
    assert read(Rec(ops_of([op for op in replay if op[0] != up]))) is None


def test_views_roofline_reader_needs_its_launches():
    read = cells.load_module(ROOT / "benchmark" / "metrics" / "sample_tiles_grouped_views_roofline.py",
                             "t_views_roofline").read

    class R(Rec):
        extra = {"batch": None}

    assert read(R(None)) is None and read(R(ops_of([("conv", 5)]))) is None


def test_cell_is_found_with_its_metrics(bench):
    c = cells.find(bench, CELL)
    per = {m["name"] for m in c.per_layer}
    assert {"upsample_ms.serve", "sample_tiles_grouped_views_roofline", "mfu.serve", "device_idle_pct.serve",
            "encoder_ms.serve", "fusion_ms.serve", "head_ms.serve", "decode_ms.serve"} <= per
    assert [m["name"] for m in c.end_to_end] == ["frames_per_s", "setup_s"]
    assert set(c.limits) == {"heatmap_gap", "heatmap_rms", "det_gap", "missed_gap", "recall_gap"}


def tiny_cell():
    c = cells.find(json.loads((ROOT / "BENCHMARK.json").read_text()), CELL)
    tiny_mvdet(c.cfg)
    c.traffic.update({"frame_sets": 4, "batch": 2, "warmup_requests": 1, "sample_requests": 2,
                      "profile_after_s": 0.1, "profile_s": 0.3})
    return c


def run(c, fault=None, seconds=1.5):
    while True:
        out = cells.driver(c).run(c, seed=2**31 + 21, seconds=seconds, trace=False, t0=time.perf_counter(),
                                  device="cpu", fault=fault)
        if out.numbers.get("sampled_requests", 1) > 0 or seconds > 30:
            break
        seconds *= 2
    assert out.numbers.get("sampled_requests", 1) > 0, out.numbers
    return verdict(out.numbers, c.limits)[0], out.numbers


@pytest.mark.parametrize("fault", [None, "control", altered, half_batch, heatmap_as(0.0), heatmap_as(math.nan)],
                         ids=["sound", "control", "altered", "half_batch", "blank", "not_a_number"])
def test_cell_fails_what_it_must(fault):
    """The sound program is correct; the fp8 control, a box moved half a
    metre, half the batch never computed and a heatmap all 0 or not a
    number are not, under the cell's own limits. The whole map's two
    numbers fail the control and half the batch each on its own, and hold
    the sound program."""
    c = tiny_cell()
    ok, numbers = run(c, Control(c) if fault == "control" else fault)
    assert ok == (fault is None), numbers
    if fault is None or fault in ("control", half_batch):
        for name in ("heatmap_gap", "heatmap_rms"):
            assert verdict(numbers, {name: c.limits[name]})[0] == (fault is None), (name, numbers)

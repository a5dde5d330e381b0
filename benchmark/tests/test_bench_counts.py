"""The counts on shapes whose answer is known by hand."""

import json
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import kernels
from benchmark.counts.flops import model_flops
from benchmark.counts.peaks import HBM_BYTES_PER_S
from benchmark.harness.inputs import ring_rig


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
    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs" / "wildtrack.json").read_text())["config"]
    K, Rt = ring_rig(cfg)
    f, t = model_flops(cfg, K, Rt), model_flops(cfg, K, Rt, train=True)
    assert 100e9 < f < 160e9 and 2.5 * f < t < 4 * f


def test_request_bounds_at_a_tiny_size():
    from benchmark.harness.inputs import FrameSets, make_weights

    from .conftest import tiny

    for name in ("wildtrack", "wildtrack_deform"):
        cfg = tiny(json.loads((Path(__file__).resolve().parents[1] / "configs" / f"{name}.json").read_text())["config"])
        b = FrameSets(cfg, 2, 3, "cpu").batch([0, 1])
        if name == "wildtrack":
            bound = kernels.concat_request(cfg, b["K"][0], b["Rt"][0], 2)
        else:
            bound = kernels.deform_request(cfg, make_weights(cfg, 3, "cpu"), b, "cpu")
        assert bound.nbytes > 0 and bound.flops > 0 and bound.seconds > 0

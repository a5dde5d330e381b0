"""The comparison fails what it must. At a size the CPU holds, a run of
each cell with the timed path broken underneath comes out not correct,
under the cell's own limits: the control (the reference computed in the
precision below the configuration's, put in the program's place), an
answer altered where it is produced, half of the batch left out, a heatmap
that comes out all low or not a number; for training also a step that
returns its state unchanged and a gradient altered. The sound program comes
out correct."""

import json
import math
import time
from pathlib import Path

import pytest

from benchmark.harness import cell as cells
from benchmark.harness.judge import verdict
from benchmark.tools.faults import (Control, altered, gradient_altered, half_batch, heatmap_as, train_half_batch,
                                    unchanged)

from .conftest import tiny

ROOT = Path(__file__).resolve().parents[2]


# cells whose files are in place and which BENCHMARK.json does not list
# yet: their runs spread too far for a bound (PERF.md)
WAITING = [{"name": "wildtrack.train_b2", "config": "wildtrack", "traffic": "train_b2", "chips": 1},
           {"name": "wildtrack.offline_prefetch_b16", "config": "wildtrack", "traffic": "offline_prefetch_b16",
            "chips": 1}]


def tiny_cell(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [w for w in WAITING if w["name"] not in listed]
    c = cells.find(bench, name)
    tiny(c.cfg)
    tr = c.traffic
    tr.update({"frame_sets": 4, "workers": 1, "warmup_requests": 1, "warmup_calls": 1, "sample_requests": 2,
               "profile_after_s": 0.1, "profile_s": 0.3})
    if tr["driver"] == "closed_loop":
        tr["batch"] = 2
    if tr.get("feed") == "prefetcher":
        tr["requests_per_pass"] = 2
    return c


def run(c, fault=None, seconds=1.5, answered=True):
    """The verdict and numbers of a run on the CPU; with ``answered`` the
    window doubles until some request is judged, so that no verdict stands
    on an empty sample (a loaded host may answer none in a short window)."""
    while True:
        out = cells.driver(c).run(c, seed=2**31 + 21, seconds=seconds, trace=False, t0=time.perf_counter(),
                                  device="cpu", fault=fault)
        if not answered or out.numbers.get("sampled_requests", 1) > 0 or seconds > 30:
            break
        seconds *= 2
    if answered:
        assert out.numbers.get("sampled_requests", 1) > 0, out.numbers
    return verdict(out.numbers, c.limits)[0], out.numbers


SERVING = ["wildtrack.offline_b16", "wildtrack_deform.offline_b16", "wildtrack.live_b1",
           "wildtrack.offline_prefetch_b16", "wildtrack_v1_resnet50.offline_b16"]
CLOSED = [n for n in SERVING if n != "wildtrack.live_b1"]


@pytest.mark.parametrize("name", SERVING)
def test_sound_serving_is_correct(name):
    ok, numbers = run(tiny_cell(name))
    assert ok, numbers


@pytest.mark.parametrize("name", SERVING)
def test_control_fails(name):
    c = tiny_cell(name)
    ok, numbers = run(c, Control(c))
    assert not ok, numbers


@pytest.mark.parametrize("name", SERVING)
def test_altered_answer_fails(name):
    ok, numbers = run(tiny_cell(name), altered)
    assert not ok, numbers


@pytest.mark.parametrize("name", CLOSED)
def test_half_batch_fails(name):
    ok, numbers = run(tiny_cell(name), half_batch)
    assert not ok, numbers


@pytest.mark.parametrize("value", [0.0, math.nan], ids=["blank", "not_a_number"])
@pytest.mark.parametrize("name", SERVING)
def test_heatmap_with_nobody_fails(name, value):
    """A heatmap that comes out all low or not a number reports nobody: the
    people of the reference's that it leaves out fail the comparison."""
    ok, numbers = run(tiny_cell(name), heatmap_as(value))
    assert not ok, numbers


def test_sound_training_is_correct():
    ok, numbers = run(tiny_cell("wildtrack.train_b2"))
    assert ok, numbers


@pytest.mark.parametrize("fault", [unchanged, train_half_batch, gradient_altered], ids=lambda f: f.__name__)
def test_training_faults_fail(fault):
    ok, numbers = run(tiny_cell("wildtrack.train_b2"), fault)
    assert not ok, numbers


def test_training_control_reads_above_the_program():
    """The int8 control of the training comparison, at a CPU size: its
    median leaf's gradient gap stands above twice the sound program's on
    the same seed (on the chip, at the cell's size, its worst leaf's fails
    the cell's limit: PERF.md)."""
    c = tiny_cell("wildtrack.train_b2")
    out = cells.driver(c).run(c, seed=2**31 + 21, seconds=0.3, trace=False, t0=time.perf_counter(), device="cpu",
                              control="int8")
    n = out.numbers
    assert n["control.grad_gap_median"] > 2 * n["grad_gap_median"], n
    assert n["control.loss_gap"] > 2 * n["loss_gap"], n


def test_nothing_answered_is_not_correct():
    ok, numbers = run(tiny_cell("wildtrack.offline_b16"), seconds=1e-3, answered=False)
    assert numbers["sampled_requests"] == 0 and not ok, numbers

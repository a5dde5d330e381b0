"""The stage walk over the profiled stretch's device operations
(``harness/stages.py``) on synthetic traces, the nine readers built on it
and on the program's spans."""

import math
import sys
import time

import pytest

from benchmark.harness.cell import HERE, Records, load_module
from benchmark.harness.stages import END, MARK, STAGES, stage_ms, walk
from benchmark.harness.trace import DeviceTrace

STAGE_METRICS = [f"{s}_ms.{kind}" for s in STAGES for kind in ("serve", "live")]


def replay(t, lens, copy_in=3.0, clone=2.0):
    """One request from microsecond ``t``: a copy in, a 1-us mark at each
    stage's start and op(s) of ``lens[stage]`` us, the end mark, a clone.
    Returns (ops, the time after it)."""
    ops = [("Memcpy HtoD", t, t + copy_in)]
    t += copy_in
    for s in STAGES:
        ops.append((MARK + s, t, t + 1.0))
        ops.append((f"kernel_of_{s}", t + 1.0, t + 1.0 + lens[s]))
        t += 1.0 + lens[s]
    ops.append((MARK + END, t, t + 1.0))
    ops.append(("clone", t + 1.0, t + 1.0 + clone))
    return ops, t + 1.0 + clone + 5.0


LENS = {"encoder": 300.0, "fusion": 20.0, "head": 60.0, "decode": 25.0}


def trace_of(ops, window_us):
    return DeviceTrace(window_s=window_us / 1e6, ops=ops, spans=[])


def test_stage_seconds_and_replays():
    ops, t = [], 0.0
    for _ in range(3):
        more, t = replay(t, LENS)
        ops += more
    got = walk(ops)
    assert got.replays == 3
    for s in STAGES:
        assert math.isclose(got.stage_s[s], 3 * LENS[s] / 1e6)
    assert math.isclose(got.outside_s, 3 * (3.0 + 2.0) / 1e6)
    assert math.isclose(got.marks_s, 3 * 5 / 1e6) and got.dropped_s == 0
    tr = trace_of(ops, t)
    assert math.isclose(got.total_s(), tr.busy_s())
    for s in STAGES:
        assert math.isclose(stage_ms(tr, s), LENS[s] / 1e3)


def test_replays_cut_at_both_edges_are_dropped():
    """The stretch opens at a replay's head mark and closes inside the
    fusion of the replay after the next."""
    first, t = replay(0.0, LENS)
    full, t = replay(t, LENS)
    last, _ = replay(t, LENS)
    ops = first[5:] + full + last[:5]  # [5]: the head mark; [:5]: up to the fusion kernel
    got = walk(ops)
    assert got.replays == 1
    for s in STAGES:
        assert math.isclose(got.stage_s[s], LENS[s] / 1e6)
    cut = LENS["head"] + LENS["decode"] + LENS["encoder"] + LENS["fusion"]
    assert math.isclose(got.dropped_s, cut / 1e6)
    assert math.isclose(got.outside_s, (2.0 + 3.0 + 2.0 + 3.0) / 1e6)  # the clones and copies around them
    assert math.isclose(got.total_s(), sum(b - a for _, a, b in ops) / 1e6)


def test_ops_before_the_first_encoder_mark_are_outside():
    ops, t = replay(10.0, LENS)
    ops = [("Memset", 0.0, 4.0)] + ops
    got = walk(ops)
    assert got.replays == 1 and math.isclose(got.outside_s, (4.0 + 3.0 + 2.0) / 1e6)


def test_no_marks_gives_none():
    ops = [("kernel", 0.0, 5.0), ("Memcpy HtoD", 6.0, 9.0)]
    assert walk(ops) is None and walk([]) is None
    tr = trace_of(ops, 10.0)
    assert stage_ms(tr, "encoder") is None and stage_ms(None, "encoder") is None
    for m in STAGE_METRICS:
        reader = load_module(HERE / "metrics" / f"{m}.py", f"stage_reader_{m.replace('.', '_')}")
        assert reader.read(Records(cfg={}, traffic={}, trace=tr)) is None
        assert reader.read(Records(cfg={}, traffic={})) is None


def test_a_cut_replay_alone_gives_none():
    whole, _ = replay(0.0, LENS)
    got = walk(whole[5:])  # from the head mark on
    assert got.replays == 0 and stage_ms(trace_of(whole[5:], 1e3), "head") is None


@pytest.mark.parametrize("metric", STAGE_METRICS)
def test_stage_readers(metric):
    ops, t = [], 0.0
    for _ in range(2):
        more, t = replay(t, LENS)
        ops += more
    reader = load_module(HERE / "metrics" / f"{metric}.py", f"stage_reader_{metric.replace('.', '_')}")
    got = reader.read(Records(cfg={}, traffic={}, trace=trace_of(ops, t)))
    assert math.isclose(got, LENS[metric.split("_ms.")[0]] / 1e3)


def test_stages_match_the_program():
    from vsta_tpu_torch.utils import tracing

    assert (*STAGES, END) == tracing.STAGES


def test_serving_host_ms_reads_the_programs_serve_spans(monkeypatch):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vsta_tpu_torch.utils import tracing

    reader = load_module(HERE / "metrics" / "serving_host_ms.live.py", "serving_host_reader")
    tracing.clear()
    assert reader.read(Records(cfg={}, traffic={})) is None
    with tracing.span("serve", 0):  # recorded with no profiler running too
        time.sleep(0.002)
    with profile(activities=[ProfilerActivity.CPU]):
        for r, ms in enumerate((4.0, 30.0), start=1):
            with tracing.span("serve", r):
                time.sleep(ms / 1e3)
            with tracing.span("other", r):
                time.sleep(0.05)
            torch.ones(1).add_(1)
    got = reader.read(Records(cfg={}, traffic={}))
    assert 4.0 <= got < 30.0  # the median of the three serve spans, not the others
    import vsta_tpu_torch.utils

    monkeypatch.delattr(vsta_tpu_torch.utils, "tracing")  # a program without the module: its import fails
    monkeypatch.setitem(sys.modules, "vsta_tpu_torch.utils.tracing", None)
    assert reader.read(Records(cfg={}, traffic={})) is None
    tracing.clear()

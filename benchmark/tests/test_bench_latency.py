"""The live cell's latency arithmetic: from the due time, and a request
left open at the window's end counts at its age then."""

import math

import numpy as np

from benchmark.drivers.open_poisson import arrivals, latencies, percentile


def test_open_request_counts_at_its_age():
    due = np.array([0.0, 1.0, 2.0, 9.5])
    done = np.array([0.2, 1.5, np.nan, np.nan])
    lat = latencies(due, done, t_end=10.0)
    assert lat.tolist() == [0.2, 0.5, 8.0, 0.5]


def test_answer_after_the_close_counts_at_the_close():
    lat = latencies(np.array([9.0]), np.array([12.0]), t_end=10.0)
    assert lat.tolist() == [1.0]


def test_a_stall_moves_the_tail():
    due = np.linspace(0, 9.9, 100)
    ok = latencies(due, due + 0.01, 10.0)
    stalled = latencies(due, np.where(due > 5, np.nan, due + 0.01), 10.0)
    assert math.isclose(percentile(ok, 95), 0.01, rel_tol=1e-6)
    assert percentile(stalled, 95) > 4.0


def test_arrivals_fixed_count_seeded_order():
    a, b = arrivals(100, 10, 2**31 + 7), arrivals(100, 10, 2**31 + 8)
    assert len(a) == len(b) == 1000 and not np.array_equal(a, b)
    assert np.all(np.diff(a) >= 0) and a.min() >= 0 and a.max() < 10
    assert np.array_equal(a, arrivals(100, 10, 2**31 + 7))


def test_tail_reader_reads_every_request():
    from benchmark.harness.cell import HERE, Records, load_module

    reader = load_module(HERE / "metrics" / "latency_p95_ms.live.py", "tail_reader")
    lat = latencies(np.linspace(0, 9.9, 100), np.linspace(0, 9.9, 100) + 0.01, 10.0)
    lat[-10:] = 2.0
    assert reader.read(Records(cfg={}, traffic={}, extra={"latency_s": lat})) == 1e3 * percentile(lat, 95)
    assert reader.read(Records(cfg={}, traffic={})) is None

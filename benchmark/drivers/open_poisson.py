"""Open loop of single frame sets: live monitoring.

Requests arrive as independent camera sites, a Poisson process at the
traffic's fixed ``rate``: ``rate * seconds`` arrival times drawn uniformly
over the window from the traffic's ``arrival_seed``, the same schedule
for every run, so that every seed offers the same work; the seed draws
which frame set each arrival carries. The frame
sets wait in pinned host memory, as a deployment stages what it receives.
One server takes the requests in order, polling its queue as a
low-latency server does (it spins, so that no wake-up from a sleep is
timed): at a request's due time (or at once, when it is late) it calls ``Serving.__call__`` of the batch-1
artifact on the frame set (the copy into the graph's buffers, the
replay, the clone of the outputs) and copies the detections to host
memory. A request is
timed from its due time to its detections in host memory; one still open
when the window ends counts at its age then. After the window the server
finishes the requests due in it, untimed, so that each is judged.

Traffic parameters: ``rate`` (requests a second), ``arrival_seed``, ``frame_sets``,
``warmup_requests``, ``sample_requests``, ``profile_s`` (the traced
stretch of a ``--trace 1`` run, the last seconds of the window).
"""

from __future__ import annotations

import gc
import time
from itertools import islice
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from benchmark.counts.flops import model_flops
from benchmark.drivers.closed_loop import finish_fetch, staged, start_fetch
from benchmark.harness import common
from benchmark.harness.cell import Cell, Records
from benchmark.harness.inputs import FrameSets, calibrate, make_weights, order
from benchmark.harness.trace import Recorder


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    n = max(1, int(round(rate * seconds)))
    return np.sort(np.random.default_rng(seed + 5).uniform(0.0, seconds, n))


def latencies(due: np.ndarray, done: np.ndarray, t_end: float) -> np.ndarray:
    """Each request's time from its due time to its answer, on the host
    clock; a request not answered by ``t_end`` (``done`` NaN or later)
    counts at its age then, so that a stall shows."""
    return np.where(np.isnan(done) | (done > t_end), t_end - due, done - due)


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", control: Optional[str] = None, fault=None) -> common.Outcome:
    cfg, tr = cell.cfg, cell.traffic
    dev = torch.device(device)
    rec = Recorder(active=trace, cuda=dev.type == "cuda")
    marks = [("imports", time.perf_counter())]
    weights = make_weights(cell.reference, cfg, seed, dev)
    ds = FrameSets(cfg, int(tr["frame_sets"]), seed, dev)
    calibrate(cell.reference, cfg, weights, ds[0], dev)
    staged_sets = staged(ds, 1, dev)
    marks.append(("inputs", time.perf_counter()))
    tmp = common.workdir()
    serve = common.load_artifact(cfg, weights, 1, dev, Path(tmp.name))
    if fault is not None:
        serve = fault(serve)
    marks.append(("artifact", time.perf_counter()))
    due = arrivals(float(tr["rate"]), seconds, int(tr["arrival_seed"]))
    items = list(islice(order(len(ds), seed), len(due)))
    sample = common.Sample(int(tr["sample_requests"]), seed)

    def request(i: int):
        x = staged_sets[i]
        with rec.span("serve"):
            out = serve(x["images"], x["K"], x["Rt"])
        with rec.span("d2h"):
            host = finish_fetch(start_fetch(out, dev))
        return {**host, "heatmap": out["heatmap"]}

    for k in range(int(tr["warmup_requests"])):
        request(items[k % len(items)])
    rec.warm_up()
    gc.collect()
    gc.freeze()  # set-up's objects leave the collector's scans: no full collection pauses the window
    common.sync(dev)
    t_start = time.perf_counter()
    setup_s = t_start - t0
    marks.append(("warmup", t_start))
    common.log_setup(t0, marks)

    t_end = t_start + seconds
    done_at = np.full(len(due), np.nan)
    service, served, prof_done = [], 0, 0
    # the traced stretch ends at the close: stopping the profiler takes
    # seconds, which no request in the window may wait for
    prof_at = t_end - float(tr["profile_s"])
    for i, d in enumerate(due):
        at = t_start + d
        now = time.perf_counter()
        if rec.active and not rec.profiling and now >= prof_at:
            rec.start_profile()
        if now >= t_end:
            break
        if now < at:
            with rec.span("queue_empty"):
                while time.perf_counter() < at:
                    pass
        t_deq = time.perf_counter()
        out = request(items[i])
        t_done = time.perf_counter()
        done_at[i] = t_done
        if t_done <= t_end:
            service.append(t_done - t_deq)
            served += 1
            prof_done += rec.profiling
        sample.offer(lambda: ([items[i]], out))
    if rec.profiling:
        rec.stop_profile()
    gc.unfreeze()
    lat = latencies(t_start + due, done_at, t_end)
    open_left = np.isnan(done_at)
    for i in np.nonzero(open_left)[0]:  # answers still due: served after the close, judged, not timed
        out = request(items[i])
        sample.offer(lambda: ([items[i]], out))
    common.sync(dev)
    peak = common.memory_peak(dev)
    rec.read()
    sample.items = [(w, {k: v.cpu() for k, v in o.items()}) for w, o in sample.items]
    del serve, out, staged_sets
    tmp.cleanup()
    common.free_program(dev)

    numbers = common.judge_serving(cell.reference, cfg, weights, ds, sample, dev, control)
    numbers["requests_open_at_close"] = int(open_left.sum())
    rec.counters.update({"profiled_requests": prof_done, "profiled_items": prof_done})
    records = Records(cfg=cfg, traffic=tr, reference=cell.reference,
                      requests=served, counters=rec.counters, trace=rec.trace,
                      extra={"service_s": service, "latency_s": lat})
    if trace:
        records.counts["model_flops_per_item"] = model_flops(cell.reference, cfg, ds.K, ds.Rt)
    e2e = {"latency_p50_ms": 1e3 * percentile(lat, 50), "latency_p95_ms": 1e3 * percentile(lat, 95),
           "setup_s": setup_s}
    return common.Outcome(attempted=len(due), failed=0, end_to_end=e2e, records=records, memory_peak_bytes=peak,
                          numbers=numbers)

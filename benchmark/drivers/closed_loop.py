"""Closed loop at a full batch: offline analysis.

Each request of ``batch`` frame sets goes through ``Serving.__call__`` of
an artifact exported at the batch (the copy into the graph's buffers, the
replay, the clone of the outputs), and its detections are copied to
pinned host memory. As ``.serve --overlap`` does, request i + 1 is issued
before request i's detections are awaited. A request counts when its
detections are in host memory inside the window.

Where the requests come from is the traffic's ``feed``:

* ``pinned``: the frame sets staged once in pinned host memory,
  ``frame_sets / batch`` requests served in seeded permutations, as a
  deployment that stages its own frames does;
* ``prefetcher``: the port's ``Prefetcher`` (collate, pinning, the copy
  on a side stream) pass after pass over the frame sets in seeded order,
  ``requests_per_pass`` requests a pass, with ``workers`` threads and
  ``prefetch`` batches ahead, as ``.serve`` feeds its artifact.

Traffic parameters: ``feed``, ``batch``, ``frame_sets`` (distinct frame
sets), ``warmup_requests``, ``sample_requests`` (how many the comparison
reads), ``profile_after_s`` and ``profile_s`` (the traced stretch of a
``--trace 1`` run); with the ``prefetcher`` feed also
``requests_per_pass``, ``workers`` and ``prefetch``.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, Optional

import torch

from benchmark.counts.flops import model_flops
from benchmark.harness import common
from benchmark.harness.cell import Cell, Records
from benchmark.harness.inputs import FrameSets, calibrate, make_weights, order
from benchmark.harness.trace import Recorder

DET_KEYS = ("boxes", "scores", "valid")


def start_fetch(out: Dict[str, torch.Tensor], dev: torch.device):
    """Queue the detections' copies to pinned host memory; (host tensors,
    the event they end at)."""
    if dev.type != "cuda":
        return {k: out[k] for k in DET_KEYS}, None
    host = {k: torch.empty(out[k].shape, dtype=out[k].dtype, pin_memory=True).copy_(out[k], non_blocking=True)
            for k in DET_KEYS}
    return host, torch.cuda.current_stream(dev).record_event()


def finish_fetch(fetched) -> Dict[str, torch.Tensor]:
    host, event = fetched
    if event is not None:
        event.synchronize()
    return host


def staged(ds: FrameSets, B: int, dev: torch.device):
    """The requests' inputs: pinned on the card's host, as they are on the CPU."""
    if dev.type == "cuda":
        return ds.pinned(B)
    return [{k: torch.as_tensor(v) for k, v in ds.batch(list(range(j * B, (j + 1) * B))).items()
             if k in ("images", "K", "Rt")} for j in range(len(ds) // B)]


def pinned_feed(requests, B: int, seed: int):
    """(dataset indices, inputs) of the staged requests in seeded
    permutations, without end."""
    for j in order(len(requests), seed):
        yield list(range(j * B, (j + 1) * B)), requests[j]


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", control: Optional[str] = None, fault=None) -> common.Outcome:
    cfg, tr = cell.cfg, cell.traffic
    dev = torch.device(device)
    B = int(tr["batch"])
    rec = Recorder(active=trace, cuda=dev.type == "cuda")
    marks = [("imports", time.perf_counter())]
    weights = make_weights(cell.reference, cfg, seed, dev)
    ds = FrameSets(cfg, int(tr["frame_sets"]), seed, dev)
    calibrate(cell.reference, cfg, weights, ds[0], dev)
    prefetcher = tr["feed"] == "prefetcher"
    if not prefetcher and tr["feed"] != "pinned":
        raise ValueError(f"no feed {tr['feed']!r}: 'pinned' or 'prefetcher'")
    requests = None if prefetcher else staged(ds, B, dev)
    marks.append(("inputs", time.perf_counter()))
    tmp = common.workdir()
    serve = common.load_artifact(cfg, weights, B, dev, Path(tmp.name))
    if fault is not None:
        serve = fault(serve)
    marks.append(("artifact", time.perf_counter()))
    if prefetcher:  # its threads start copying after the capture, as in .serve
        feed = common.Feed(ds, B, int(tr["requests_per_pass"]), seed, int(tr["workers"]), int(tr["prefetch"]), dev)
    else:
        feed = pinned_feed(requests, B, seed)
    sample = common.Sample(int(tr["sample_requests"]), seed)

    def request():
        with rec.span("prefetch_wait") if prefetcher else nullcontext():
            idx, x = next(feed)
        with rec.span("serve"):
            out = serve(x["images"], x["K"], x["Rt"])
        return out, start_fetch(out, dev), idx

    for _ in range(int(tr["warmup_requests"])):
        finish_fetch(request()[1])
    rec.warm_up()
    common.sync(dev)
    t_start = time.perf_counter()
    setup_s = t_start - t0
    marks.append(("warmup", t_start))
    common.log_setup(t0, marks)
    t_end = t_start + seconds
    wait0 = feed.wait_s if prefetcher else None
    done = issued = prof_done = 0
    prof_at, prof_until = t_start + float(tr["profile_after_s"]), None
    pending = None
    while True:
        now = time.perf_counter()
        if rec.active and prof_until is None and now >= prof_at:
            rec.start_profile()
            prof_until = time.perf_counter() + float(tr["profile_s"])
        elif rec.profiling and now >= prof_until:
            rec.stop_profile()
        if now >= t_end:
            break
        out, fetched, idx = request()
        issued += 1
        if pending is not None:
            p_fetched, p_idx, p_heat = pending
            with rec.span("d2h"):
                host = finish_fetch(p_fetched)
            if time.perf_counter() <= t_end:
                done += 1
                prof_done += rec.profiling
                sample.offer(lambda: (p_idx, {**host, "heatmap": p_heat}))
        pending = (fetched, idx, out["heatmap"])
    if pending is not None:
        finish_fetch(pending[0])
    common.sync(dev)
    if rec.profiling:
        rec.stop_profile()
    if wait0 is not None:
        rec.counters.update({"input_wait_s": feed.wait_s - wait0, "batches": issued})
    feed.close()
    peak = common.memory_peak(dev)
    rec.read()
    sample.items = [(w, {k: v.cpu() for k, v in o.items()}) for w, o in sample.items]
    del serve, out, pending, feed, requests
    tmp.cleanup()
    common.free_program(dev)

    numbers = common.judge_serving(cell.reference, cfg, weights, ds, sample, dev, control)
    rec.counters.update({"profiled_items": prof_done * B})
    records = Records(cfg=cfg, traffic=tr, reference=cell.reference,
                      requests=done, counters=rec.counters, trace=rec.trace)
    if trace:
        records.counts["model_flops_per_item"] = model_flops(cell.reference, cfg, ds.K, ds.Rt)
        records.extra.update({"weights": weights, "batch": ds.batch(sample.items[0][0]) if sample.items else None,
                              "device": dev, "B": B})
    e2e = {"frames_per_s": done * B / seconds, "setup_s": setup_s}
    return common.Outcome(attempted=issued, failed=0, end_to_end=e2e, records=records, memory_peak_bytes=peak,
                          numbers=numbers)

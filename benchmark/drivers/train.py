"""Training as the configuration states it: ``make_train_step``'s
``train_step`` on one train state, fed by the port's ``Prefetcher``, a
new pass (epoch) every ``steps_per_epoch`` calls.

Set-up builds the state from the seed's weights and drives it through its
first calls on the window's own feed; the reference follows the first
``ref_calls`` of them. The window then runs the same state. A rate counts
the calls issued in the window, over the time from its start until the
device has finished them.

Traffic parameters: ``batch``, ``frame_sets``, ``workers``, ``prefetch``,
``ref_calls`` (the calls the reference follows), ``warmup_calls`` (more
calls before the window), ``steps_per_epoch`` (the schedule's epoch),
``profile_after_s`` and ``profile_s``.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from benchmark.counts.flops import model_flops
from benchmark.harness import common
from benchmark.harness.cell import Cell, Records
from benchmark.harness.inputs import FrameSets, calibrate, make_weights
from benchmark.harness.judge import training_numbers
from benchmark.harness.trace import Recorder
from benchmark.reference.precision import PRECISIONS
from benchmark.reference.train import kinds_of, steps


def first_gradient(state) -> dict:
    """The first call's gradient as the optimizer holds it: its running
    mean of the calls' gradients after one call."""
    if not state.opt_state.acc:
        raise ValueError("the comparison reads the first gradient from the running mean (ACCUM_STEPS > 1)")
    return {k: v.detach().cpu().clone() for k, v in state.opt_state.acc.items()}


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", control: Optional[str] = None, fault=None) -> common.Outcome:
    from vsta_tpu_torch.training.state import create_state, make_train_step

    cfg, tr = cell.cfg, cell.traffic
    dev = torch.device(device)
    B = int(tr["batch"])
    rec = Recorder(active=trace, cuda=dev.type == "cuda")
    marks = [("imports", time.perf_counter())]
    weights = make_weights(cell.reference, cfg, seed, dev)
    ds = FrameSets(cfg, int(tr["frame_sets"]), seed, dev)
    calibrate(cell.reference, cfg, weights, ds[0], dev)
    marks.append(("inputs", time.perf_counter()))
    pcfg = common.program_config(cfg)
    state = create_state(pcfg, state_dict=weights, device=dev, steps_per_epoch=int(tr["steps_per_epoch"]))
    train_step = make_train_step(pcfg)
    if fault is not None:
        train_step = fault(train_step)
    marks.append(("state", time.perf_counter()))
    feed = common.Feed(ds, B, int(tr["steps_per_epoch"]), seed, int(tr["workers"]), int(tr["prefetch"]), dev)

    start = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()}
    losses, grad1, ref_idx = [], None, []
    n_ref = int(tr["ref_calls"])
    for call in range(n_ref):
        idx, batch = next(feed)
        ref_idx.append(idx)
        m = train_step(state, batch)
        losses.append(float(m["total_loss"]))
        if call == 0:
            grad1 = first_gradient(state)
    update = {k: p.detach().cpu() - start[k] for k, p in state.model.named_parameters()}
    for _ in range(int(tr["warmup_calls"])):
        train_step(state, next(feed)[1])
    rec.warm_up()
    common.sync(dev)
    t_start = time.perf_counter()
    setup_s = t_start - t0
    marks.append(("first calls", t_start))
    common.log_setup(t0, marks)

    t_end = t_start + seconds
    wait0, calls = feed.wait_s, 0
    prof_at, prof_until, prof_calls = t_start + float(tr["profile_after_s"]), None, 0
    while True:
        now = time.perf_counter()
        if rec.active and prof_until is None and now >= prof_at:
            rec.start_profile()
            prof_until = time.perf_counter() + float(tr["profile_s"])
        elif rec.profiling and now >= prof_until:
            rec.stop_profile()
        if now >= t_end:
            break
        with rec.span("prefetch_wait"):
            batch = next(feed)[1]
        with rec.span("train_step"):
            train_step(state, batch)
        calls += 1
        prof_calls += rec.profiling
        if rec.profiling and time.perf_counter() >= prof_until:
            rec.stop_profile()  # the stretch ends when the device has finished its calls
    common.sync(dev)
    window_s = time.perf_counter() - t_start
    if rec.profiling:
        rec.stop_profile()
    wait_s = feed.wait_s - wait0
    peak = common.memory_peak(dev)
    rec.read()
    feed.close()
    del state, feed, train_step
    common.free_program(dev)

    t = time.perf_counter()
    kinds = kinds_of(cell.reference, cfg)
    batches = []
    for idx in ref_idx:
        b = ds.batch(idx)
        batches.append({k: torch.as_tensor(v, device=dev) for k, v in b.items()})
    ref = steps(cell.reference, cfg, weights, kinds, batches, int(tr["steps_per_epoch"]))
    prog = {"losses": losses, "grad": grad1, "update": update}
    numbers = training_numbers(prog, {k: ({n: x.cpu() for n, x in v.items()} if isinstance(v, dict) else v)
                                      for k, v in ref.items()})
    numbers["loss_first"] = losses[0]
    if control:
        ctl = steps(cell.reference, cfg, weights, kinds, batches, int(tr["steps_per_epoch"]), PRECISIONS[control])
        cnum = training_numbers({k: ({n: x.cpu() for n, x in v.items()} if isinstance(v, dict) else v)
                                 for k, v in ctl.items()},
                                {k: ({n: x.cpu() for n, x in v.items()} if isinstance(v, dict) else v)
                                 for k, v in ref.items()})
        numbers.update({f"control.{k}": v for k, v in cnum.items()})
    numbers["reference_s"] = time.perf_counter() - t

    rec.counters.update({"input_wait_s": wait_s, "batches": calls, "profiled_items": prof_calls * B})
    records = Records(cfg=cfg, traffic=tr, reference=cell.reference,
                      requests=calls, counters=rec.counters, trace=rec.trace)
    if trace:
        records.counts["model_flops_per_item"] = model_flops(cell.reference, cfg, ds.K, ds.Rt, train=True)
    e2e = {"train_frames_per_s": calls * B / window_s, "setup_s": setup_s}
    return common.Outcome(attempted=calls, failed=0, end_to_end=e2e, records=records, memory_peak_bytes=peak,
                          numbers=numbers)

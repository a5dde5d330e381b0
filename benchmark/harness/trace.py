"""Counters and the device trace of a run.

:class:`Recorder` keeps what the per-layer metrics read. In a ``--trace 1``
run it runs ``torch.profiler`` around one bounded stretch of the window,
in which the benchmark's own host spans (``serve``, ``d2h``,
``queue_empty``, ``prefetch_wait``, ``train_step``) are
``record_function`` ranges, so that the device's idle gaps can be
labelled by what the host was doing. With tracing off it records nothing.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
PREFIX = "bench."
NAME_CHARS = 160  # a kernel's name in the breakdown, cut (templates make some thousands long)


@dataclass
class DeviceTrace:
    """The profiled stretch: its host-clock length, the device's activity
    in it and the benchmark's host spans, in microseconds from its start."""

    window_s: float
    ops: List[Tuple[str, float, float]]  # (name, start, end) of every kernel, copy or set
    spans: List[Tuple[str, float, float]]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        total, cur_a, cur_b = 0.0, None, None
        for _, a, b in sorted((o for o in self.ops), key=lambda o: o[1]):
            a, b = max(a, 0.0), min(b, self.window_s * 1e6)
            if b <= a:
                continue
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    total += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            total += cur_b - cur_a
        return total / 1e6

    def kernel_s(self, part: str) -> Tuple[float, int]:
        """Device seconds and count of the operations whose name holds ``part``."""
        hits = [(b - a) for n, a, b in self.ops if part in n]
        return sum(hits) / 1e6, len(hits)

    def idle_gaps(self) -> List[Tuple[str, float, float]]:
        """(label, start, end) of every stretch with nothing on the device,
        labelled by the innermost benchmark span open at its middle."""
        gaps, t = [], 0.0
        end = self.window_s * 1e6
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if a > t:
                gaps.append((t, min(a, end)))
            t = max(t, b)
            if t >= end:
                break
        if t < end:
            gaps.append((t, end))
        out = []
        for a, b in gaps:
            if b <= a:
                continue
            mid = (a + b) / 2
            open_spans = [(s1 - s0, n) for n, s0, s1 in self.spans if s0 <= mid <= s1]
            out.append((min(open_spans)[1] if open_spans else "untraced", a, b))
        return out

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        by_op: Dict[str, float] = defaultdict(float)
        for n, a, b in self.ops:
            by_op[n] += (b - a) / 1e6
        by_gap: Dict[str, float] = defaultdict(float)
        for n, a, b in self.idle_gaps():
            by_gap[n] += (b - a) / 1e6
        srt = lambda d: [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": srt(by_op), "idle_gaps": srt(by_gap)}


def read_profile(prof) -> Optional[DeviceTrace]:
    """The stretch inside the ``bench.window`` range of a finished profile;
    None when the profiler saw no device activity in it."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    # a record_function range appears twice: on the host, and mirrored on
    # the device's timeline; the host's is the span, the mirror no work
    win = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not win:
        return None
    t0 = win[0].start_ns()
    window_s = win[0].duration_ns() / 1e9
    ops, spans = [], []
    for e in events:
        a = (e.start_ns() - t0) / 1e3
        b = a + e.duration_ns() / 1e3
        if e.name().startswith(PREFIX):
            if e.device_type() == DeviceType.CPU and e.name() != WINDOW:
                spans.append((e.name()[len(PREFIX):], a, b))
        elif e.device_type() == DeviceType.CUDA:
            ops.append((e.name(), a, b))
    if not ops:
        return None
    return DeviceTrace(window_s, ops, spans)


@dataclass
class Recorder:
    """Spans and counters of a run; ``active`` in a ``--trace 1`` run."""

    active: bool = False
    cuda: bool = True
    counters: Dict[str, float] = field(default_factory=dict)
    trace: Optional[DeviceTrace] = None
    _prof: object = None
    _win: object = None

    @contextlib.contextmanager
    def span(self, name: str):
        """A ``record_function`` range inside the profiled stretch: the
        label of the device's idle gaps under it."""
        with torch.profiler.record_function(PREFIX + name) if self.profiling else contextlib.nullcontext():
            yield

    def warm_up(self) -> None:
        """Start and stop the profiler once during set-up (a ``--trace 1``
        run only): its first start takes seconds, which would otherwise
        fall inside the window."""
        if not self.active:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=acts):
            torch.zeros(1, device="cuda" if self.cuda else "cpu").add_(1)
            self._sync()

    def start_profile(self) -> None:
        """Open the profiled stretch (a ``--trace 1`` run only)."""
        if not self.active or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._win = torch.profiler.record_function(WINDOW)
        self._win.__enter__()

    def stop_profile(self) -> None:
        if self._prof is None or self._win is None:
            return
        self._sync()
        self._win.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._win = None

    def read(self) -> None:
        """Read the finished stretch's profile (after the window: reading
        it takes seconds)."""
        if self._prof is not None and self.trace is None:
            self.trace = read_profile(self._prof)

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    @property
    def profiling(self) -> bool:
        return self._win is not None

"""The device time of each stage of a request, from the program's stage
marks in the profiled stretch.

The port launches an empty marker kernel, ``vsta_stage_<stage>``, at the
start of each stage of a request (``vsta_tpu_torch/utils/tracing.py``):
``encoder``, ``fusion``, ``head``, ``decode``, then ``end`` after the last.
A CUDA graph carries them, so every replay does. :func:`walk` takes the
device operations in start order and gives each to the latest mark
before it; an operation after an ``end`` mark (the copies in, the clones,
the fetches) lies outside every stage. Only replays whose ``encoder`` and
``end`` marks both fall inside the stretch count: the operations of a
replay that the stretch's edges cut are dropped.

``DeviceTrace.ops`` carries no stream id, so the walk assumes that the
operations of one request follow each other on one stream, as in the
serving cells, where every operation runs on the current stream. An
operation of another stream that overlapped a replay would be given to
the replay's stage.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

MARK = "vsta_stage_"
STAGES = ("encoder", "fusion", "head", "decode")  # each followed by the next, the last by "end"
END = "end"


@dataclass
class StageTimes:
    """Device seconds of the complete replays' stages, of the operations
    outside every stage, of the marks themselves and of the dropped
    operations (replays cut by the stretch's edges)."""

    stage_s: Dict[str, float] = field(default_factory=lambda: dict.fromkeys(STAGES, 0.0))
    outside_s: float = 0.0
    marks_s: float = 0.0
    dropped_s: float = 0.0
    replays: int = 0

    def total_s(self) -> float:
        return sum(self.stage_s.values()) + self.outside_s + self.marks_s + self.dropped_s


def walk(ops) -> Optional[StageTimes]:
    """The stage times of ``ops`` [(name, start, end)] in microseconds;
    None when no operation is a stage mark."""
    out = StageTimes()
    where, lead = None, 0.0  # None: before the first mark; "replay", "outside" or "cut" after it
    acc: Dict[str, float] = {}
    cur = None
    for name, a, b in sorted(ops, key=lambda o: o[1]):
        d = (b - a) / 1e6
        if name.startswith(MARK):
            stage = name[len(MARK):]
            out.marks_s += d
            if where is None:  # what came before the first mark: outside, or the tail of a cut replay
                if stage == STAGES[0]:
                    out.outside_s += lead
                else:
                    out.dropped_s += lead
                where = "cut"
            if stage == STAGES[0]:
                if where == "replay":  # a replay that never ended
                    out.dropped_s += sum(acc.values())
                where, cur, acc = "replay", stage, dict.fromkeys(STAGES, 0.0)
            elif stage == END:
                if where == "replay":
                    for s, v in acc.items():
                        out.stage_s[s] += v
                    out.replays += 1
                where, cur = "outside", None
            elif where == "replay":
                cur = stage
            else:  # a stage whose replay began before the stretch
                where = "cut"
            continue
        if where is None:
            lead += d
        elif where == "replay":
            acc[cur] += d
        elif where == "outside":
            out.outside_s += d
        else:
            out.dropped_s += d
    if where is None:
        return None
    if where == "replay":  # cut by the stretch's end
        out.dropped_s += sum(acc.values())
    return out


def stage_ms(trace, stage: str) -> Optional[float]:
    """Milliseconds of ``stage`` a complete replay in the profiled stretch;
    None without a trace, marks or a complete replay."""
    if trace is None:
        return None
    times = walk(trace.ops)
    if times is None or times.replays == 0:
        return None
    return 1e3 * times.stage_s[stage] / times.replays

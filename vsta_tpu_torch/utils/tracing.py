"""Stage marks on the device and host spans: what a trace of the port
names inside a request.

:func:`mark` launches a stage's empty marker kernel
(``csrc/stage_marks.cu``, named ``vsta_stage_<stage>`` on the device) on
the current stream. A CUDA graph captures the marks as kernel nodes, so
every replay carries them, and the device operations between one mark
and the next are that stage's: the forward marks ``encoder``, ``fusion``
and ``head`` (``models/bevnet.py``), the serving function ``decode`` and
``end`` (``serving.py``), the train step ``end`` after its loss
(``training/state.py``). Marks are always on; on a CPU tensor they do
nothing.

:func:`span` times a stretch of host code: ``(name, request, start_ns,
end_ns)`` appended to a bounded store in memory, read with :func:`spans`
and emptied with :func:`clear`. While a torch profiler runs
(``torch.autograd._profiler_enabled()``) the span is also the range
``vsta.<name>`` on the profiler's clock, beside the device operations.
The store records whether or not a profiler runs, because the profiler
changes what it would time: under it, the replay of a serving graph
takes about 3 ms of host time, 0.08 ms without (H100). The range is
recorded at the scope of an operator, not of a user annotation, so the
profiler does not mirror it onto the device's timeline, where it would
read as device time.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import time
from typing import List, Optional, Tuple

import torch

from .. import kernels

STAGES = ("encoder", "fusion", "head", "decode", "end")
PREFIX = "vsta."
MAX_SPANS = 16384  # the store keeps the newest

Span = Tuple[str, Optional[int], int, int]  # (name, request, start_ns, end_ns), perf_counter_ns

_spans: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built marker library, its C functions typed (built on first use;
    typed once, since eager calls mark on every forward)."""
    lib = kernels.load("stage_marks")
    lib.stage_mark_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.stage_mark_launch.restype = ctypes.c_int
    lib.stage_mark_error_string.argtypes = [ctypes.c_int]
    lib.stage_mark_error_string.restype = ctypes.c_char_p
    return lib


def mark(stage: str, like: torch.Tensor) -> None:
    """Launch ``stage``'s marker kernel on the current stream of ``like``'s
    device when ``like`` is a CUDA tensor; otherwise do nothing. The marker
    reads no tensor and touches no autograd."""
    if not like.is_cuda:
        return
    dev = like.device
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.stage_mark_launch(STAGES.index(stage), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stage mark {stage!r} failed ({rc}): {lib.stage_mark_error_string(rc).decode()}")


class span:
    """A context manager over host code: an entry of the store and, while
    a torch profiler runs, the range ``vsta.<name>`` tagged with
    ``request``."""

    __slots__ = ("name", "request", "_range", "_t0")

    def __init__(self, name: str, request: Optional[int] = None):
        self.name, self.request, self._range = name, request, None

    def __enter__(self) -> "span":
        if torch.autograd._profiler_enabled():
            args = () if self.request is None else (str(self.request),)
            self._range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name, args)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _spans.append((self.name, self.request, self._t0, t1))


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most ``MAX_SPANS``)."""
    return list(_spans)


def clear() -> None:
    _spans.clear()

"""Device timing with CUDA events.

The host returns before the device finishes, so a host clock without a
synchronise measures the enqueue. :func:`cuda_ms` records events around
a run of back-to-back calls on the current stream and divides the
elapsed device time by the count.
"""

from __future__ import annotations

from typing import Callable

import torch


def cuda_ms(fn: Callable, *args, warmup: int = 3, iters: int = 20, **kwargs) -> float:
    """Mean milliseconds per ``fn(*args, **kwargs)`` on the CUDA device.

    Every tensor argument must lie on a CUDA device: a CPU run is not a
    device time, so it raises.
    """
    tensors = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
    if not torch.cuda.is_available() or any(t.device.type != "cuda" for t in tensors):
        raise RuntimeError("cuda_ms times CUDA work only; got CPU tensors or no CUDA device")
    for _ in range(warmup):
        fn(*args, **kwargs)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args, **kwargs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters

"""Device timing: CUDA events, and the chained-N slope protocol of the JAX
package's ``vsta_tpu/utils/timing.py``.

The host returns before the device finishes, so a host clock without a
synchronise measures the enqueue. :func:`cuda_ms` records events around
a run of back-to-back calls on the current stream and divides the
elapsed device time by the count. :func:`chained_slope_time` chains N
data-dependent calls, ends the chain with one scalar fetch and takes the
slope between a short and a long chain, which cancels the fixed cost of
the fetch; :func:`forward_decode_fps` applies it to the forward and the
decode, as the JAX package's benchmarks do.

One divergence from the JAX protocol: XLA runs the chain inside one
program, while here the host launches every call of it, so the slope
includes the host's launch cost wherever the host is slower than the
device.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

N_LO, N_HI, N_REPEAT = 2, 12, 3


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


def chained_slope_time(
    step_scalar: Callable,
    *args,
    n_lo: int = N_LO,
    n_hi: int = N_HI,
    repeat: int = N_REPEAT,
) -> float:
    """Seconds per evaluation of ``step_scalar(*args)`` -> 0-dim float32
    tensor.

    ``step_scalar``'s first argument is the tensor the serial dependency
    folds into: each call gets ``args[0] + acc * 1e-30``, ``acc`` the
    previous call's scalar (0 for the first), numerically negligible but
    it makes call i+1 wait for call i. A chain of n calls ends with one
    ``.item()``; each length takes the best of ``repeat`` chains, after
    one warm call. Returns ``(t(n_hi) - t(n_lo)) / (n_hi - n_lo)``. The
    tensors stay where the caller put them: CPU tensors time the CPU.
    """
    arg0, rest = args[0], args[1:]

    def run_n(n: int) -> float:
        acc = torch.zeros((), dtype=torch.float32, device=arg0.device)
        for _ in range(n):
            acc = step_scalar(arg0 + acc * 1e-30, *rest)
        return acc.item()  # the scalar's fetch: the one synchronisation

    def timed(n: int) -> float:
        best = float("inf")
        for _ in range(repeat):
            t0 = time.perf_counter()
            run_n(n)
            best = min(best, time.perf_counter() - t0)
        return best

    run_n(1)
    return (timed(n_hi) - timed(n_lo)) / (n_hi - n_lo)


def forward_decode_step(
    cfg, model, quant_head: Optional[Dict] = None, quant_encoder: Optional[Dict] = None
) -> Callable:
    """``step(images, K, Rt)`` -> the scalar JAX's ``forward_decode_fps``
    chains: ``sum(boxes) + sum(scores) + sum(heatmap)`` of the model's
    forward and ``ops.decode.decode_detections`` with the config's
    ``EVAL`` thresholds. Run it under ``torch.no_grad()`` with the model
    in eval mode."""
    from ..ops.decode import decode_detections

    e = cfg.eval

    def step_scalar(images, K, Rt):
        out = model(images, K, Rt, quant_head=quant_head, quant_encoder=quant_encoder)
        det = decode_detections(
            out["heatmap"], out["offset"], out["size"], bounds=cfg.model.bev_bounds,
            conf_thresh=e.conf_thresh, nms_dist_m=e.nms_dist_m, max_dets=e.max_dets,
        )
        return det["boxes"].sum().float() + det["scores"].sum() + out["heatmap"].sum()

    return step_scalar


def forward_decode_fps(
    cfg, model, images, K, Rt, quant_head: Optional[Dict] = None, quant_encoder: Optional[Dict] = None,
    n_lo: int = N_LO, n_hi: int = N_HI, repeat: int = N_REPEAT,
) -> float:
    """Frames a second of the forward and the decode
    (:func:`forward_decode_step`) of ``model`` (a ``BEVNet`` holding its
    weights) on ``images`` [B, V, H, W, 3], ``K``, ``Rt``, by
    :func:`chained_slope_time`: ``B / max(dt, 1e-9)``. The model runs in
    eval mode under ``torch.no_grad()`` and goes back to its mode after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            dt = chained_slope_time(
                forward_decode_step(cfg, model, quant_head, quant_encoder), images, K, Rt,
                n_lo=n_lo, n_hi=n_hi, repeat=repeat,
            )
    finally:
        model.train(was_training)
    return images.shape[0] / max(dt, 1e-9)

"""Eval-mode BatchNorm and the activation after it in one pass
(``csrc/bn_act.cu``).

:func:`bn_act` normalises a bfloat16 map [N, C, H, W] with the running
statistics in float32, rounds to bfloat16 and, with ``act="silu"``, applies
SiLU to that value and rounds again: the work of
``F.batch_norm(x.float(), ...).to(x.dtype)`` followed by ``F.silu``, which
is :func:`bn_act_ref`, its plain PyTorch version. It replaces no TPU
kernel: on the TPU, XLA fuses both into the convolution before them.

A CPU tensor takes the plain version; a CUDA tensor that :func:`takes`
launches the kernel, any other CUDA tensor raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels

ACTS = (None, "silu")
MAX_CHANNELS = 4096  # the kernels keep 3 floats a channel in 48 KB of shared memory
THREADS = 256  # a block's threads (csrc/bn_act.cu)
BLOCKS_PER_SM = 8  # 2,048 threads: an SM full


def bn_act_ref(x, mean, var, weight, bias, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`bn_act`: float32 BatchNorm with the
    running statistics, cast to x's dtype, then ``F.silu`` if asked."""
    y = F.batch_norm(x.float(), mean, var, weight, bias, False, 0.0, eps).to(x.dtype)
    return F.silu(y) if act == "silu" else y


def layout(x: torch.Tensor) -> Optional[str]:
    """``"nhwc"`` for a channels-last-contiguous 4-D tensor, ``"nchw"`` for
    an NCHW-contiguous one, None for any other (a strided view)."""
    if x.ndim != 4:
        return None
    if x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    return "nchw" if x.is_contiguous() else None


def takes(x: torch.Tensor, mean, var, weight, bias) -> bool:
    """Whether the kernel takes these arguments, on whatever device: x a
    bfloat16 map [N, C, H, W] of 1 to MAX_CHANNELS channels in either
    dense layout, the four vectors float32 [C] contiguous on x's device."""
    if x.dtype != torch.bfloat16 or layout(x) is None or not 1 <= x.shape[1] <= MAX_CHANNELS:
        return False
    return all(
        p is not None and p.dtype == torch.float32 and p.shape == (x.shape[1],) and p.is_contiguous()
        and p.device == x.device
        for p in (mean, var, weight, bias)
    )


def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (built on first use)."""
    lib = kernels.load("bn_act")
    lib.bn_act_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.bn_act_launch.restype = ctypes.c_int
    lib.bn_act_error_string.argtypes = [ctypes.c_int]
    lib.bn_act_error_string.restype = ctypes.c_char_p
    return lib


def grid_blocks(dev: torch.device, work: int) -> int:
    """Blocks of the grid-stride loop over ``work`` items (words or
    elements): enough to fill every SM, no more than the work needs."""
    return max(1, min(kernels.sm_count(dev) * BLOCKS_PER_SM, -(-work // THREADS)))


def bn_act(x, mean, var, weight, bias, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """BatchNorm with the running statistics, then ``act`` (None or
    ``"silu"``), in one pass.

    x [N, C, H, W] bfloat16, NCHW- or channels-last-contiguous; mean, var,
    weight, bias [C] float32. Returns a tensor of x's shape, dtype and
    layout. ``bn_act.launches`` counts kernel launches. No gradient flows
    through the kernel: the caller takes :func:`bn_act_ref` where one is
    needed.
    """
    if act not in ACTS:
        raise ValueError(f"bn_act: act must be one of {ACTS}, got {act!r}")
    dev = x.device
    if dev.type == "cpu":
        return bn_act_ref(x, mean, var, weight, bias, eps, act)
    if dev.type != "cuda" or not takes(x, mean, var, weight, bias):
        raise ValueError(
            f"bn_act takes a bfloat16 [N, C <= {MAX_CHANNELS}, H, W] map in a dense layout and float32 [C] "
            f"vectors on one CUDA device, got {x.dtype} {tuple(x.shape)} on {dev} "
            f"(layout {layout(x)})"
        )
    y = torch.empty_like(x)  # x's strides: the same index, the same element
    n = x.numel()
    if n == 0:
        return y
    N, C, H, W = x.shape
    nhwc = layout(x) == "nhwc"
    vec = int(
        x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0 and (C if nhwc else H * W) % 8 == 0
    )
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.bn_act_launch(
            x.data_ptr(), y.data_ptr(), mean.data_ptr(), var.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            float(eps), n, C, H * W, int(nhwc), int(act == "silu"), vec,
            grid_blocks(dev, n // 8 if vec else n), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.bn_act_error_string(rc).decode()
        raise RuntimeError(f"bn_act launch failed ({rc}): {msg}")
    bn_act.launches += 1
    return y


bn_act.launches = 0

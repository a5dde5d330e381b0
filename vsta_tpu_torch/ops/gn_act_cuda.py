"""GroupNorm and the activation after it in one bfloat16 pass
(``csrc/gn_act.cu``).

:func:`gn_act` normalises a bfloat16 channels-last map [N, C, H, W] by
the statistics of each frame's groups in float32, rounds to bfloat16 and,
with ``act="relu"``, applies the ReLU: the work of
``F.group_norm(x.float(), ...).to(x.dtype)`` followed by ``F.relu``, which
is :func:`gn_act_ref`, its plain PyTorch version. It replaces no TPU
kernel: on the TPU, XLA fuses Flax's GroupNorm and ReLU into the passes
around them.

A CPU tensor takes the plain version; a CUDA tensor that :func:`takes`
launches the kernel, any other CUDA tensor raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels

ACTS = (None, "relu")
MAX_CHANNELS = 2048  # a block's 256 threads hold one cell's C / 8 words at least once (csrc/gn_act.cu)
THREADS = 256
BLOCKS_PER_SM = 4  # the kernels' launch bounds: 4 blocks of 256 threads an SM


def gn_act_ref(x, weight, bias, groups: int, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`gn_act`: float32 GroupNorm, cast to
    x's dtype, then ``F.relu`` if asked."""
    y = F.group_norm(x.float(), groups, weight, bias, eps).to(x.dtype)
    return F.relu(y) if act == "relu" else y


def takes(x: torch.Tensor, weight, bias, groups: int) -> bool:
    """Whether the kernel takes these arguments, on whatever device: x a
    bfloat16 channels-last-contiguous map [N <= 65,535, C, H, W], 16-byte
    aligned, C a multiple of 8 from 8 to MAX_CHANNELS that ``groups``
    divides; weight and bias float32 [C] contiguous on x's device."""
    if x.dtype != torch.bfloat16 or x.ndim != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        return False
    N, C = x.shape[:2]
    if not (1 <= N <= 65535 and 8 <= C <= MAX_CHANNELS and C % 8 == 0 and groups >= 1 and C % groups == 0):
        return False
    if x.numel() and x.data_ptr() % 16:
        return False
    return all(
        p is not None and p.dtype == torch.float32 and p.shape == (C,) and p.is_contiguous() and p.device == x.device
        for p in (weight, bias)
    )


def chunks(dev: torch.device, N: int, hw: int, C: int) -> int:
    """Blocks a frame: the cells of each frame split so that the N frames'
    blocks fill every SM once (BLOCKS_PER_SM), no more than a block a row
    of cells (256 / (C / 8) cells side by side)."""
    rows = THREADS // (C // 8)
    return max(1, min(-(-kernels.sm_count(dev) * BLOCKS_PER_SM // N), -(-hw // rows)))


def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (built on first use)."""
    lib = kernels.load("gn_act")
    lib.gn_act_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    lib.gn_act_launch.restype = ctypes.c_int
    lib.gn_act_error_string.argtypes = [ctypes.c_int]
    lib.gn_act_error_string.restype = ctypes.c_char_p
    return lib


def gn_act(x, weight, bias, groups: int, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm over ``groups`` groups, then ``act`` (None or ``"relu"``),
    in one pass over the map after one pass for the statistics.

    x [N, C, H, W] bfloat16, channels-last-contiguous; weight, bias [C]
    float32. Returns a tensor of x's shape, dtype and layout.
    ``gn_act.launches`` counts kernel launches (one a call: the three
    kernels of ``csrc/gn_act.cu``). No gradient flows through the kernel:
    the caller takes :func:`gn_act_ref` where one is needed.
    """
    if act not in ACTS:
        raise ValueError(f"gn_act: act must be one of {ACTS}, got {act!r}")
    dev = x.device
    if dev.type == "cpu":
        return gn_act_ref(x, weight, bias, groups, eps, act)
    if dev.type != "cuda" or not takes(x, weight, bias, groups):
        raise ValueError(
            f"gn_act takes a bfloat16 channels-last [N, C, H, W] map, C a multiple of 8 up to {MAX_CHANNELS} "
            f"that groups divides, and float32 [C] vectors on one CUDA device, got {x.dtype} {tuple(x.shape)} "
            f"strides {x.stride()} on {dev}, {groups} groups"
        )
    y = torch.empty_like(x)  # x's strides: channels-last
    N, C, H, W = x.shape
    hw = H * W
    if hw == 0:
        return y
    k = chunks(dev, N, hw, C)
    part = -(-2 * N * k * groups // 4) * 4  # the chunks' partials, then each frame's coefficients 16-byte aligned
    scratch = torch.empty(part + 2 * N * C, dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_act_launch(
            x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), scratch.data_ptr(), float(eps),
            N, C, hw, groups, int(act == "relu"), k, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.gn_act_error_string(rc).decode()
        raise RuntimeError(f"gn_act launch failed ({rc}): {msg}")
    gn_act.launches += 1
    return y


gn_act.launches = 0

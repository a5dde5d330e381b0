"""The per-frame multi-view warp kernel (``csrc/warp_views_sum.cu``).

:func:`warp_views_sum` computes
``out[b, n, c] = sum_v sum_t wts[b,v,n,t] * feats[b, v, idx[b,v,n,t], c]``
for cameras whose calibration differs from frame to frame; it replaces the
TPU kernel ``warp_views_sum_pallas`` (``vsta_tpu/ops/warp_pallas.py``).
:func:`warp_views_sum_ref` is its plain PyTorch version.

Unlike the other warp kernels it keeps the tap weights in float32 (the map
value is widened to float32 before the product) and returns float32
whatever the maps' dtype, as the TPU kernel does; the caller adds the bias
in float32 and casts once.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def warp_views_sum_ref(feats: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_views_sum`: float32 weights,
    float32 products and sums, views then taps in order."""
    B, V, P, C = feats.shape
    N = idx.shape[2]
    flat = feats.reshape(B * V * P, C)
    base = torch.arange(B * V, device=feats.device, dtype=torch.int64).reshape(B, V, 1) * P
    out = torch.zeros((B, N, C), dtype=torch.float32, device=feats.device)
    for v in range(V):
        for t in range(4):
            rows = flat.index_select(0, (base[:, v] + idx[:, v, :, t].long()).reshape(-1))
            out.addcmul_(wts[:, v, :, t, None], rows.reshape(B, N, C).to(torch.float32))
    return out


def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (built on first use)."""
    lib = kernels.load("warp_views_sum")
    lib.warp_views_sum_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.warp_views_sum_launch.restype = ctypes.c_int
    lib.warp_views_sum_error_string.argtypes = [ctypes.c_int]
    lib.warp_views_sum_error_string.restype = ctypes.c_char_p
    return lib


def _check(feats, idx, wts):
    if feats.ndim != 4 or idx.ndim != 4 or idx.shape[-1] != 4:
        raise ValueError(
            f"warp_views_sum wants feats [B, V, P, C] and idx/wts [B, V, N, 4], got "
            f"{tuple(feats.shape)}, {tuple(idx.shape)}"
        )
    if idx.shape != wts.shape or idx.shape[:2] != feats.shape[:2]:
        raise ValueError(
            f"warp_views_sum shape mismatch: feats {tuple(feats.shape)}, idx "
            f"{tuple(idx.shape)}, wts {tuple(wts.shape)}"
        )
    if feats.dtype not in _DTYPE_CODE:
        raise TypeError(f"warp_views_sum takes float32/bfloat16 maps, got {feats.dtype}")
    if idx.dtype != torch.int32 or wts.dtype != torch.float32:
        raise TypeError(f"warp_views_sum wants int32 idx and float32 wts, got {idx.dtype}, {wts.dtype}")


def warp_views_sum(feats: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """Sum over views of the bilinear warp, one set of taps a frame.

    feats [B, V, P, C] float32/bfloat16; idx [B, V, N, 4] int32 flat taps
    in [0, P); wts [B, V, N, 4] float32 (0 = masked tap). Returns
    [B, N, C] float32. ``warp_views_sum.launches`` counts kernel launches.
    """
    _check(feats, idx, wts)
    dev = feats.device
    if dev.type == "cpu":
        return warp_views_sum_ref(feats, idx, wts)
    if dev.type != "cuda" or idx.device != dev or wts.device != dev:
        raise ValueError(
            f"warp_views_sum needs all inputs on one CUDA device, got {dev}, {idx.device}, {wts.device}"
        )
    if not (feats.is_contiguous() and idx.is_contiguous() and wts.is_contiguous()):
        raise ValueError("warp_views_sum needs contiguous inputs")
    B, V, P, C = feats.shape
    N = idx.shape[2]
    if max(N, V * P, C) >= 2**31 or B > 65535:
        raise ValueError(f"warp_views_sum shape too large: B={B} V={V} P={P} N={N} C={C}")
    out = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.warp_views_sum_launch(
            feats.data_ptr(), idx.data_ptr(), wts.data_ptr(), out.data_ptr(),
            B, V, P, N, C, _DTYPE_CODE[feats.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.warp_views_sum_error_string(rc).decode()
        raise RuntimeError(f"warp_views_sum launch failed ({rc}): {msg}")
    warp_views_sum.launches += 1
    return out


warp_views_sum.launches = 0

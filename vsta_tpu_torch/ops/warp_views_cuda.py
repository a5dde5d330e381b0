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
from typing import Optional

import torch

from .. import kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def grid_width(N: int, grid_w: Optional[int]) -> int:
    """The grid width the kernels tile by (8x8 cells), or 0 for runs of 64
    consecutive cells where none is given or it does not divide N."""
    if grid_w is None or grid_w <= 0 or N % grid_w:
        return 0
    return grid_w


def warp_views_sum_ref(
    feats: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, grid_w: Optional[int] = None
) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_views_sum`: float32 weights,
    float32 products and sums, views then taps in order (``grid_w``, the
    kernel's tiling, does not change the function)."""
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


# the kernels' tile (csrc/warp_mma.cuh): 8 x 8 cells of a grid whose width
# is given, else 64 consecutive cells; the weight tile holds A_SLOTS[n]
# distinct source rows at once with n bf16 planes a weight (more are taken
# piece by piece)
TILE_CELLS = 64
A_SLOTS = {1: 96, 3: 64}


def tile_of_cells(N: int, grid_w: Optional[int] = None, device=None) -> torch.Tensor:
    """[N] int64: the kernels' tile of each of the N cells."""
    n = torch.arange(N, device=device)
    gw = grid_width(N, grid_w)
    if not gw:
        return n // TILE_CELLS
    return (n // gw // 8) * ((gw + 7) // 8) + (n % gw) // 8


def distinct_rows_per_tile(idx: torch.Tensor, wts: torch.Tensor, P: int, grid_w: Optional[int] = None) -> torch.Tensor:
    """[tiles] int64: how many distinct source rows (view, pixel) the live
    taps of each tile touch over all views, for one frame's idx/wts
    [V, N, 4]: the kernels' slot count ``T`` where no tap repeats a row of
    its cell and view (the LUT's taps never do; a repeat takes a slot of
    the next level), which sets how much of the weight tile and of the
    staging a tile takes."""
    V, N, _ = idx.shape
    tile = tile_of_cells(N, grid_w, idx.device)
    live = (wts != 0) & (idx >= 0) & (idx < P)
    rows = torch.arange(V, device=idx.device)[:, None, None] * P + idx.long()
    keys = torch.unique((tile[None, :, None] * (V * P) + rows)[live])
    return torch.bincount(keys // (V * P), minlength=int(tile.max()) + 1)


def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (built on first use)."""
    lib = kernels.load("warp_views_sum")
    lib.warp_views_sum_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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


def warp_views_sum(
    feats: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, grid_w: Optional[int] = None
) -> torch.Tensor:
    """Sum over views of the bilinear warp, one set of taps a frame.

    feats [B, V, P, C] float32/bfloat16; idx [B, V, N, 4] int32 flat taps
    in [0, P); wts [B, V, N, 4] float32 (0 = masked tap). Returns
    [B, N, C] float32. ``grid_w``: the width of the BEV grid the N cells
    fill row by row, so the kernel takes 8x8 tiles of it (without it, runs
    of 64 cells). ``warp_views_sum.launches`` counts kernel launches.
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
            B, V, P, N, C, _DTYPE_CODE[feats.dtype], grid_width(N, grid_w),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.warp_views_sum_error_string(rc).decode()
        raise RuntimeError(f"warp_views_sum launch failed ({rc}): {msg}")
    warp_views_sum.launches += 1
    return out


warp_views_sum.launches = 0

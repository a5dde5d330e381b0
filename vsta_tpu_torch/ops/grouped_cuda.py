"""The grouped bilinear sampler (``csrc/grouped_taps.cu``) and its gradient.

:func:`sample_tiles_grouped` computes
``out[g, n, k] = sum_t wts[g,n,t] * maps[g, idx[g,n,t], k]``, and
:func:`scatter_tapdot_grouped` both of its gradients in one pass:

* ``dmaps[g, p, k] = sum_{n,t: idx[g,n,t] = p} wts[g,n,t] * gout[g,n,k]``;
* ``d_wts[g, n, t] = <maps[g, idx[g,n,t]], gout[g,n]>``, for every tap,
  zero-weight taps included (clamped indices are valid rows).

They replace the TPU kernels ``sample_tiles_grouped`` and
``scatter_tapdot_grouped`` (``vsta_tpu/ops/warp_pallas.py``); the
``*_ref`` functions are their plain PyTorch versions. A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises. In bf16
every tap weight is rounded to bf16 before its product, as the TPU kernels
cast their one-hot weight matrix to the compute dtype; sums are float32.

:class:`GroupedSample` is the sampler as an autograd Function, the twin of
the custom VJP of ``_warp_pairs_shared`` (``vsta_tpu/ops/warp.py``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Tuple

import torch

from .. import kernels
from .warp import gather_taps, tap_weights

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def sample_tiles_grouped_ref(maps: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`sample_tiles_grouped`."""
    G, P, K = maps.shape
    w = tap_weights(wts, maps.dtype)
    base = torch.arange(G, device=maps.device, dtype=torch.int64)[:, None] * P
    flat = maps.reshape(G * P, K)
    out = torch.zeros(idx.shape[:2] + (K,), dtype=torch.float32, device=maps.device)
    for t in range(4):
        rows = flat.index_select(0, (base + idx[..., t].long()).reshape(-1))
        out.addcmul_(w[..., t, None], rows.reshape(out.shape).to(torch.float32))
    return out.to(maps.dtype)


def scatter_tapdot_grouped_ref(
    maps: torch.Tensor, gout: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`scatter_tapdot_grouped`."""
    G, P, K = maps.shape
    w = tap_weights(wts, maps.dtype)
    g = gout.to(torch.float32)
    base = torch.arange(G, device=maps.device, dtype=torch.int64)[:, None, None] * P
    rows = (base + idx.long()).reshape(-1)  # (g, n, t) order, as the kernel sums
    contrib = (w[..., None] * g[:, :, None, :]).reshape(-1, K)
    dmaps = torch.zeros((G * P, K), dtype=torch.float32, device=maps.device)
    dmaps.index_add_(0, rows, contrib)
    taps = gather_taps(maps, idx).to(torch.float32)
    d_wts = (taps * g[:, :, None, :]).sum(-1)
    return dmaps.reshape(G, P, K), d_wts


def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (built on first use)."""
    lib = kernels.load("grouped_taps")
    lib.grouped_sample_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.grouped_sample_launch.restype = ctypes.c_int
    lib.grouped_scatter_tapdot_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.grouped_scatter_tapdot_launch.restype = ctypes.c_int
    lib.grouped_taps_error_string.argtypes = [ctypes.c_int]
    lib.grouped_taps_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, maps, idx, wts, *others):
    if maps.ndim != 3 or idx.ndim != 3 or idx.shape[-1] != 4 or idx.shape != wts.shape:
        raise ValueError(
            f"{name} wants maps [G, P, K] and idx/wts [G, N, 4], got "
            f"{tuple(maps.shape)}, {tuple(idx.shape)}, {tuple(wts.shape)}"
        )
    if idx.shape[0] != maps.shape[0]:
        raise ValueError(f"{name}: {maps.shape[0]} maps but {idx.shape[0]} tap groups")
    if maps.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32/bfloat16 maps, got {maps.dtype}")
    if idx.dtype != torch.int32 or wts.dtype != torch.float32:
        raise TypeError(f"{name} wants int32 idx and float32 wts, got {idx.dtype}, {wts.dtype}")
    G, P, K = maps.shape
    if max(G * P, G * idx.shape[1] * 4, K) >= 2**31:
        raise ValueError(f"{name} shape too large: G={G} P={P} N={idx.shape[1]} K={K}")
    dev = maps.device
    tensors = (maps, idx, wts) + others
    if dev.type == "cpu":
        return False
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs all inputs on one CUDA device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    return True


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed ({rc}): {lib.grouped_taps_error_string(rc).decode()}")


def sample_tiles_grouped(maps: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """Per-group bilinear sampling.

    maps [G, P, K] float32/bfloat16; idx [G, N, 4] int32 flat taps in
    [0, P); wts [G, N, 4] float32. Returns [G, N, K] in the dtype of
    ``maps``, accumulated in float32. ``sample_tiles_grouped.launches``
    counts kernel launches.
    """
    if not _check("sample_tiles_grouped", maps, idx, wts):
        return sample_tiles_grouped_ref(maps, idx, wts)
    G, P, K = maps.shape
    N = idx.shape[1]
    out = torch.empty((G, N, K), dtype=maps.dtype, device=maps.device)
    lib = _library()
    with torch.cuda.device(maps.device):
        rc = lib.grouped_sample_launch(
            maps.data_ptr(), idx.data_ptr(), wts.data_ptr(), out.data_ptr(),
            G, P, N, K, _DTYPE_CODE[maps.dtype], torch.cuda.current_stream(maps.device).cuda_stream,
        )
    _raise_on(lib, rc, "sample_tiles_grouped")
    sample_tiles_grouped.launches += 1
    return out


sample_tiles_grouped.launches = 0


def inverse_taps(idx: torch.Tensor, P: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The taps grouped by the source row they read: CSR over the G*P rows.

    Returns (offsets [G*P + 1] int32, order [G*N*4] int32): the taps of row
    ``r = g*P + p`` are ``order[offsets[r]:offsets[r+1]]``, flat indices
    ``(g*N + n)*4 + t`` in increasing order. A tap outside [0, P) belongs
    to no row.
    """
    G = idx.shape[0]
    base = torch.arange(G, device=idx.device, dtype=torch.int64)[:, None, None] * P
    ok = (idx >= 0) & (idx < P)
    key = torch.where(ok, base + idx.long(), G * P).reshape(-1)
    order = torch.argsort(key, stable=True).to(torch.int32)
    counts = torch.bincount(key, minlength=G * P + 1)[: G * P]
    offsets = torch.zeros(G * P + 1, dtype=torch.int32, device=idx.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets, order


def scatter_tapdot_grouped(
    maps: torch.Tensor, gout: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both gradients of :func:`sample_tiles_grouped` in one pass.

    maps [G, P, K] and gout [G, N, K] in the compute dtype (float32 or
    bfloat16, the same for both); idx/wts [G, N, 4]. Returns
    ``(dmaps [G, P, K] float32, d_wts [G, N, 4] float32)``. Deterministic:
    the kernel walks source rows over :func:`inverse_taps` and never adds
    across threads. ``scatter_tapdot_grouped.launches`` counts launches.
    """
    if gout.shape != idx.shape[:2] + maps.shape[2:] or gout.dtype != maps.dtype:
        raise ValueError(
            f"scatter_tapdot_grouped wants gout [G, N, K] in the maps' dtype, got "
            f"{tuple(gout.shape)} {gout.dtype} for maps {tuple(maps.shape)} {maps.dtype}"
        )
    if not _check("scatter_tapdot_grouped", maps, idx, wts, gout):
        return scatter_tapdot_grouped_ref(maps, gout, idx, wts)
    G, P, K = maps.shape
    offsets, order = inverse_taps(idx, P)
    dmaps = torch.empty((G, P, K), dtype=torch.float32, device=maps.device)
    d_wts = torch.zeros(wts.shape, dtype=torch.float32, device=maps.device)
    lib = _library()
    with torch.cuda.device(maps.device):
        rc = lib.grouped_scatter_tapdot_launch(
            maps.data_ptr(), gout.data_ptr(), wts.data_ptr(), order.data_ptr(), offsets.data_ptr(),
            dmaps.data_ptr(), d_wts.data_ptr(), G, P, K, _DTYPE_CODE[maps.dtype],
            torch.cuda.current_stream(maps.device).cuda_stream,
        )
    _raise_on(lib, rc, "scatter_tapdot_grouped")
    scatter_tapdot_grouped.launches += 1
    return dmaps, d_wts


scatter_tapdot_grouped.launches = 0


class GroupedKernels(NamedTuple):
    """The two functions the sampler runs: the kernels, or (for a check on
    the card) their plain versions."""

    sample: Callable
    scatter_tapdot: Callable


KERNELS = GroupedKernels(sample_tiles_grouped, scatter_tapdot_grouped)
PLAIN = GroupedKernels(sample_tiles_grouped_ref, scatter_tapdot_grouped_ref)


class GroupedSample(torch.autograd.Function):
    """Grouped bilinear sampling with the fused backward.

    ``apply(maps, idx, wts, kernels)``: maps [G, P, K] in the compute
    dtype, idx [G, N, 4] int32, wts [G, N, 4] float32. The backward runs
    ``kernels.scatter_tapdot`` once in the cotangent's precision and
    returns dmaps in the cotangent's dtype, nothing for idx, and d_wts in
    the weights' dtype when asked for.
    """

    @staticmethod
    def forward(ctx, maps, idx, wts, kernels: GroupedKernels):
        ctx.save_for_backward(maps, idx, wts)
        ctx.kernels = kernels
        return kernels.sample(maps, idx, wts)

    @staticmethod
    def backward(ctx, g):
        maps, idx, wts = ctx.saved_tensors
        kdtype = torch.bfloat16 if g.dtype == torch.bfloat16 else torch.float32
        dmaps, d_wts = ctx.kernels.scatter_tapdot(
            maps.to(kdtype).contiguous(), g.to(kdtype).contiguous(), idx, wts
        )
        return (
            dmaps.to(g.dtype) if ctx.needs_input_grad[0] else None,
            None,
            d_wts.to(wts.dtype) if ctx.needs_input_grad[2] else None,
            None,
        )

"""The grouped bilinear sampler (``csrc/grouped_taps.cu``) and its gradients.

Four kernels. :func:`sample_tiles_grouped` computes
``out[g, n, k] = sum_t wts[g,n,t] * maps[g, idx[g,n,t], k]`` over 4 taps
a sample (the bilinear sample) or 9 (a bilinear upsample folded into it,
:func:`~vsta_tpu_torch.ops.warp.folded_taps`). Its gradients, of the
4-tap sample:

* ``dmaps[g, p, k] = sum_{n,t: idx[g,n,t] = p} wts[g,n,t] * gout[g,n,k]``;
* ``d_wts[g, n, t] = <maps[g, idx[g,n,t]], gout[g,n]>``, for every tap,
  zero-weight taps included (clamped indices are valid rows).

:func:`scatter_tapdot_grouped` computes both in one pass,
:func:`scatter_taps_grouped` dmaps alone and :func:`taps_dot_grouped`
d_wts alone; the two scatters walk the taps sorted by the source row they
read (:func:`tap_lut`), cut into chunks of :data:`CHUNK_TAPS`: a segmented
reduction with no float atomics. They replace the TPU kernels
``sample_tiles_grouped``, ``scatter_tapdot_grouped``,
``scatter_taps_windowed`` and ``taps_dot_grouped``
(``vsta_tpu/ops/warp_pallas.py``); the ``*_ref``
functions are their plain PyTorch versions. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. In bf16 every weight
of a 4-tap sample is rounded to bf16 before its product, as the TPU
kernels cast their one-hot weight matrix to the compute dtype; 9-tap
weights multiply as the float32 they are; sums are float32.

:class:`GroupedSample` is the sampler as an autograd Function, the twin of
the custom VJP of ``_warp_pairs_shared`` (``vsta_tpu/ops/warp.py``). Its
backward computes what is asked for: dmaps alone through
:func:`scatter_taps_grouped` (constant tap weights: the calibrated warps),
d_wts alone through :func:`taps_dot_grouped`, and both (learned sampling
locations: the deformable fusion) through the fused kernel where the
reference takes its fused kernel (:func:`fused_backward_fits`), else
through the two one-sided kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import kernels
from .warp import anchored_taps, flat_taps, gather_taps, pad_feat_br, tap_weights

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def sample_tiles_grouped_ref(maps: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`sample_tiles_grouped`."""
    G, P, K = maps.shape
    taps = idx.shape[-1]
    w = tap_weights(wts, maps.dtype) if taps == 4 else wts
    base = torch.arange(G, device=maps.device, dtype=torch.int64)[:, None] * P
    flat = maps.reshape(G * P, K)
    out = torch.zeros(idx.shape[:2] + (K,), dtype=torch.float32, device=maps.device)
    for t in range(taps):
        rows = flat.index_select(0, (base + idx[..., t].long()).reshape(-1))
        out.addcmul_(w[..., t, None], rows.reshape(out.shape).to(torch.float32))
    return out.to(maps.dtype)


def scatter_taps_grouped_ref(
    gout: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, P: int
) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_taps_grouped`."""
    G, _, K = gout.shape
    w = tap_weights(wts, gout.dtype)
    g = gout.to(torch.float32)
    base = torch.arange(G, device=gout.device, dtype=torch.int64)[:, None, None] * P
    rows = (base + idx.long()).reshape(-1)  # (g, n, t) order, as the kernel sums
    contrib = (w[..., None] * g[:, :, None, :]).reshape(-1, K)
    dmaps = torch.zeros((G * P, K), dtype=torch.float32, device=gout.device)
    dmaps.index_add_(0, rows, contrib)
    return dmaps.reshape(G, P, K)


def taps_dot_grouped_ref(maps: torch.Tensor, gout: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`taps_dot_grouped`."""
    taps = gather_taps(maps, idx).to(torch.float32)
    return (taps * gout.to(torch.float32)[:, :, None, :]).sum(-1)


def scatter_tapdot_grouped_ref(
    maps: torch.Tensor, gout: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`scatter_tapdot_grouped`."""
    return (
        scatter_taps_grouped_ref(gout, idx, wts, maps.shape[1]),
        taps_dot_grouped_ref(maps, gout, idx),
    )


def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (built on first use)."""
    lib = kernels.load("grouped_taps")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args in (
        ("grouped_sample_launch", [ptr] * 4 + [i32] * 6 + [ptr]),
        ("grouped_tap_lut_workspace", [i32] * 3 + [ctypes.POINTER(ctypes.c_size_t)]),
        ("grouped_tap_lut_launch", [ptr] * 5 + [ctypes.c_size_t] + [i32] * 3 + [ptr]),
        ("grouped_scatter_tapdot_launch", [ptr] * 9 + [i32] * 6 + [ptr]),
        ("grouped_scatter_taps_launch", [ptr] * 6 + [i32] * 6 + [ptr]),
        ("grouped_taps_dot_launch", [ptr] * 4 + [i32] * 5 + [ptr]),
        ("grouped_partition", [i32] * 4 + [ptr] * 3),
    ):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i32
    lib.grouped_taps_error_string.argtypes = [i32]
    lib.grouped_taps_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, maps_shape, dtype, idx, wts, *tensors, taps=(4,)):
    """Validate one call's shapes and dtypes (``maps_shape`` is [G, P, K];
    ``wts`` is None for a kernel that reads no weights; ``tensors`` are its
    float inputs, maps and/or gout; ``taps``: the taps a sample it takes).
    False for CPU tensors, which take the plain version; True for tensors
    on one CUDA device, contiguous; raises otherwise."""
    wts_shape = idx.shape if wts is None else wts.shape
    if len(maps_shape) != 3 or idx.ndim != 3 or idx.shape[-1] not in taps or idx.shape != wts_shape:
        raise ValueError(
            f"{name} wants maps [G, P, K] and idx/wts [G, N, T], T in {taps}, got "
            f"{tuple(maps_shape)}, {tuple(idx.shape)}, {tuple(wts_shape)}"
        )
    G, P, K = maps_shape
    if idx.shape[0] != G:
        raise ValueError(f"{name}: {G} maps but {idx.shape[0]} tap groups")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32/bfloat16 maps and cotangents, got {dtype}")
    if idx.dtype != torch.int32 or (wts is not None and wts.dtype != torch.float32):
        raise TypeError(
            f"{name} wants int32 idx and float32 wts, got {idx.dtype}, {None if wts is None else wts.dtype}"
        )
    if max(G * P, G * idx.shape[1] * idx.shape[2], K) >= 2**31:
        raise ValueError(f"{name} shape too large: G={G} P={P} N={idx.shape[1]} K={K}")
    tensors = tensors + ((idx,) if wts is None else (idx, wts))
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs all inputs on one CUDA device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    return True


def _check_gout(name, gout, idx, K, dtype):
    if gout.shape != idx.shape[:2] + (K,) or gout.dtype != dtype:
        raise ValueError(
            f"{name} wants gout [G, N, K] in the maps' dtype, got {tuple(gout.shape)} "
            f"{gout.dtype} for K = {K}, taps {tuple(idx.shape)}, maps' dtype {dtype}"
        )


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed ({rc}): {lib.grouped_taps_error_string(rc).decode()}")


def sample_tiles_grouped(maps: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """Per-group sampling over T taps a sample.

    maps [G, P, K] float32/bfloat16; idx [G, N, T] int32 flat taps in
    [0, P); wts [G, N, T] float32; T = ``idx.shape[-1]``, 4 (bilinear
    taps, each weight rounded to the maps' dtype) or 9 (an upsample folded
    in, :func:`~vsta_tpu_torch.ops.warp.folded_taps`: float32 weights).
    Returns [G, N, K] in the dtype of ``maps``, accumulated in float32.
    ``sample_tiles_grouped.launches`` counts kernel launches, and
    ``sample_tiles_grouped.launches_by_taps`` them by T.
    """
    if not _check("sample_tiles_grouped", maps.shape, maps.dtype, idx, wts, maps, taps=SAMPLE_TAPS):
        return sample_tiles_grouped_ref(maps, idx, wts)
    G, P, K = maps.shape
    N, taps = idx.shape[1:]
    out = torch.empty((G, N, K), dtype=maps.dtype, device=maps.device)
    lib = _library()
    with torch.cuda.device(maps.device):
        rc = lib.grouped_sample_launch(
            maps.data_ptr(), idx.data_ptr(), wts.data_ptr(), out.data_ptr(),
            G, P, N, K, taps, _DTYPE_CODE[maps.dtype], torch.cuda.current_stream(maps.device).cuda_stream,
        )
    _raise_on(lib, rc, "sample_tiles_grouped")
    sample_tiles_grouped.launches += 1
    sample_tiles_grouped.launches_by_taps[taps] += 1
    return out


SAMPLE_TAPS = (4, 9)  # taps a sample sample_tiles_grouped takes
sample_tiles_grouped.launches = 0
sample_tiles_grouped.launches_by_taps = dict.fromkeys(SAMPLE_TAPS, 0)


# sorted taps a warp of the two scatter kernels: both must use the same for
# their dmaps to agree bit for bit (a chunk's partial sums are its order of
# addition). 128 was the fastest or within 10 % of it from 64 to 1,024 at
# the main shapes on the H100 (a sweep of the chunk size over rows 3 and 6)
CHUNK_TAPS = 128


class TapLut(NamedTuple):
    """The taps sorted by the source row they read (:func:`tap_lut`).

    ``rows`` [G*N*4] int32: ``g*P + idx`` of every live tap (idx in
    [0, P), weight != 0) in increasing order, then ``G*P`` once for each
    dead tap. ``order`` [G*N*4] int32: the flat tap indices
    ``(g*N + n)*4 + t`` in the same order, increasing within a row (a
    stable sort), the dead taps last."""

    rows: torch.Tensor
    order: torch.Tensor


def tap_lut_ref(idx: torch.Tensor, wts: torch.Tensor, P: int) -> TapLut:
    """Plain PyTorch version of :func:`tap_lut` (any device)."""
    G = idx.shape[0]
    base = torch.arange(G, device=idx.device, dtype=torch.int32)[:, None, None] * P
    live = (idx >= 0) & (idx < P) & (wts != 0)
    key = torch.where(live, base + idx, G * P).reshape(-1)
    rows, order = torch.sort(key, stable=True)
    return TapLut(rows, order.to(torch.int32))


@functools.lru_cache(maxsize=None)
def _lut_workspace(G: int, P: int, N: int) -> int:
    """Bytes of scratch the sort of G*N*4 taps takes (a host-side query)."""
    lib = _library()
    nbytes = ctypes.c_size_t()
    _raise_on(lib, lib.grouped_tap_lut_workspace(G, P, N, ctypes.byref(nbytes)), "tap_lut")
    return nbytes.value


def tap_lut(idx: torch.Tensor, wts: torch.Tensor, P: int) -> TapLut:
    """The scatter kernels' inverse LUT, rebuilt each call: one int32 key a
    tap and one stable radix sort over the key's bits (``csrc/grouped_taps.cu``),
    with no counts and no offsets, so nothing is read back to the host.
    idx/wts [G, N, 4] int32/float32; see :class:`TapLut`."""
    G, N = idx.shape[:2]
    if not _check("tap_lut", (G, P, 1), torch.float32, idx, wts):
        return tap_lut_ref(idx, wts, P)
    lib = _library()
    nbytes = _lut_workspace(G, P, N)
    work = torch.empty(nbytes, dtype=torch.uint8, device=idx.device)
    lut = torch.empty((2, G * N * 4), dtype=torch.int32, device=idx.device)
    with torch.cuda.device(idx.device):
        rc = lib.grouped_tap_lut_launch(
            idx.data_ptr(), wts.data_ptr(), lut[0].data_ptr(), lut[1].data_ptr(), work.data_ptr(), nbytes,
            G, P, N, torch.cuda.current_stream(idx.device).cuda_stream,
        )
    _raise_on(lib, rc, "tap_lut")
    return TapLut(lut[0], lut[1])


def _carry(lut: TapLut, idx: torch.Tensor, K: int) -> torch.Tensor:
    """The scatter kernels' scratch: two partial rows a chunk of taps."""
    if not (lut.rows.device == lut.order.device == idx.device and lut.rows.dtype == lut.order.dtype == torch.int32
            and lut.rows.shape == lut.order.shape == (idx.numel(),)):
        raise ValueError("the scatter kernels want the TapLut that tap_lut builds from their idx and wts")
    chunks = -(-lut.rows.numel() // CHUNK_TAPS)
    return torch.empty((chunks, 2, K), dtype=torch.float32, device=lut.rows.device)


def scatter_tapdot_grouped(
    maps: torch.Tensor, gout: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, lut: Optional[TapLut] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both gradients of :func:`sample_tiles_grouped` in one pass.

    maps [G, P, K] and gout [G, N, K] in the compute dtype (float32 or
    bfloat16, the same for both); idx/wts [G, N, 4]; ``lut``:
    :func:`tap_lut` of these idx/wts, built here when None (given, the
    call times the walk alone). Returns
    ``(dmaps [G, P, K] float32, d_wts [G, N, 4] float32)``. Deterministic,
    with no float atomics. Taps of weight 0 get their d_wts and add nothing
    to dmaps (where ``gout`` holds an inf or a NaN at such a tap's sample,
    the plain version gives NaN, 0 * inf, in that tap's row, and the kernel
    a finite value: they agree for finite cotangents).
    ``scatter_tapdot_grouped.launches`` counts its calls on the card, each
    one launch of the walk and one of the carries.
    """
    _check_gout("scatter_tapdot_grouped", gout, idx, maps.shape[-1], maps.dtype)
    if not _check("scatter_tapdot_grouped", maps.shape, maps.dtype, idx, wts, maps, gout):
        return scatter_tapdot_grouped_ref(maps, gout, idx, wts)
    G, P, K = maps.shape
    N = idx.shape[1]
    lut = tap_lut(idx, wts, P) if lut is None else lut
    dmaps = torch.empty((G, P, K), dtype=torch.float32, device=maps.device)
    d_wts = torch.empty(wts.shape, dtype=torch.float32, device=maps.device)
    carry = _carry(lut, idx, K)
    lib = _library()
    with torch.cuda.device(maps.device):
        rc = lib.grouped_scatter_tapdot_launch(
            maps.data_ptr(), gout.data_ptr(), wts.data_ptr(), idx.data_ptr(), lut.rows.data_ptr(),
            lut.order.data_ptr(), dmaps.data_ptr(), carry.data_ptr(), d_wts.data_ptr(), G, P, N, K,
            CHUNK_TAPS, _DTYPE_CODE[maps.dtype], torch.cuda.current_stream(maps.device).cuda_stream,
        )
    _raise_on(lib, rc, "scatter_tapdot_grouped")
    scatter_tapdot_grouped.launches += 1
    return dmaps, d_wts


scatter_tapdot_grouped.launches = 0


def scatter_taps_grouped(
    gout: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, P: int, lut: Optional[TapLut] = None
) -> torch.Tensor:
    """dmaps alone: the transpose of :func:`sample_tiles_grouped`.

    gout [G, N, K] float32/bfloat16 (the compute dtype); idx/wts
    [G, N, 4]; P rows a map; ``lut`` as for
    :func:`scatter_tapdot_grouped`. Returns dmaps [G, P, K] float32, equal
    bit for bit to :func:`scatter_tapdot_grouped`'s: the same sort, the
    same chunks, the same order of addition, taps of weight 0 left out as
    there. It needs no maps.
    ``scatter_taps_grouped.launches`` counts its calls on the card, each
    one launch of the walk and one of the carries.
    """
    if gout.ndim != 3:
        raise ValueError(f"scatter_taps_grouped wants gout [G, N, K], got {tuple(gout.shape)}")
    G, N, K = gout.shape
    _check_gout("scatter_taps_grouped", gout, idx, K, gout.dtype)
    if not _check("scatter_taps_grouped", (G, P, K), gout.dtype, idx, wts, gout):
        return scatter_taps_grouped_ref(gout, idx, wts, P)
    lut = tap_lut(idx, wts, P) if lut is None else lut
    dmaps = torch.empty((G, P, K), dtype=torch.float32, device=gout.device)
    carry = _carry(lut, idx, K)
    lib = _library()
    with torch.cuda.device(gout.device):
        rc = lib.grouped_scatter_taps_launch(
            gout.data_ptr(), wts.data_ptr(), lut.rows.data_ptr(), lut.order.data_ptr(), dmaps.data_ptr(),
            carry.data_ptr(), G, P, N, K, CHUNK_TAPS, _DTYPE_CODE[gout.dtype],
            torch.cuda.current_stream(gout.device).cuda_stream,
        )
    _raise_on(lib, rc, "scatter_taps_grouped")
    scatter_taps_grouped.launches += 1
    return dmaps


scatter_taps_grouped.launches = 0


def taps_dot_grouped(maps: torch.Tensor, gout: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """d_wts alone: ``d_wts[g, n, t] = <maps[g, idx[g,n,t]], gout[g,n]>``.

    maps [G, P, K] and gout [G, N, K] in the compute dtype; idx
    [G, N, 4]. It takes no weights: every tap's dot is taken, whatever its
    weight. Returns [G, N, 4] float32, summed in float32.
    ``taps_dot_grouped.launches`` counts launches.
    """
    _check_gout("taps_dot_grouped", gout, idx, maps.shape[-1], maps.dtype)
    if not _check("taps_dot_grouped", maps.shape, maps.dtype, idx, None, maps, gout):
        return taps_dot_grouped_ref(maps, gout, idx)
    G, P, K = maps.shape
    N = idx.shape[1]
    d_wts = torch.empty((G, N, 4), dtype=torch.float32, device=maps.device)
    lib = _library()
    with torch.cuda.device(maps.device):
        rc = lib.grouped_taps_dot_launch(
            maps.data_ptr(), gout.data_ptr(), idx.data_ptr(), d_wts.data_ptr(),
            G, P, N, K, _DTYPE_CODE[maps.dtype], torch.cuda.current_stream(maps.device).cuda_stream,
        )
    _raise_on(lib, rc, "taps_dot_grouped")
    taps_dot_grouped.launches += 1
    return d_wts


taps_dot_grouped.launches = 0

# The work partition of the two sample-major kernels, sample_tiles_grouped
# and taps_dot_grouped (csrc/grouped_taps.cu, whose comments give the
# reasons): the C rules mirrored here for the CPU model of them in
# tests/test_torch_grouped_partition.py. chip_smoke.py holds this mirror to
# the library's own (grouped_partition) at every case it runs.
THREADS = 256  # a block
SAMPLES_PER_LANE = 8  # samples a sub-warp takes in a block (fewer where shared memory would pass MAX_SMEM)
MAX_SMEM = 48 * 1024  # bytes of dynamic shared memory a launch gets without opting in


class Partition(NamedTuple):
    """How one launch cuts its work."""

    vec: int  # channels a load (V): 16 bytes at most
    lanes: int  # lanes a sample (L)
    samples: int  # samples a sub-warp takes in a block (S)
    cells: int  # samples a block: (THREADS // lanes) * samples
    staged: bool  # sample_tiles_grouped: the block's output goes through shared memory


def vector_width(K: int, itemsize: int, addrs) -> int:
    """The widest load of at most 16 bytes, in elements, that divides K and
    to which every address is aligned."""
    v = 16 // itemsize
    while v > 1 and not (K % v == 0 and all(a % (v * itemsize) == 0 for a in addrs)):
        v //= 2
    return v


def sub_warp_lanes(runs: int, least: int) -> int:
    """Lanes a sample: the least power of two from ``least`` up to 32 that
    covers the row's runs, halved while that leaves fewer lanes idle with
    at most 4 runs a lane (never below 8)."""
    L = least
    while L < runs and L < 32:
        L *= 2
    while L > 8 and -(-runs // (L // 2)) <= 4 and -(-runs // (L // 2)) * (L // 2) < -(-runs // L) * L:
        L //= 2
    return L


def sample_smem(cells: int, K: int, itemsize: int, staged: bool, taps: int = 4) -> int:
    """Bytes of shared memory a block of sample_tiles_grouped takes: its
    taps (an int32 index and a float32 weight a tap) and, if staged, its
    output tile."""
    return cells * taps * 8 + (cells * K * itemsize + 16 if staged else 0)


def sample_partition(K: int, itemsize: int, maps_addr: int, out_addr: int, taps: int = 4) -> Partition:
    """sample_tiles_grouped's partition for K channels of ``itemsize``
    bytes, maps and out at these addresses, ``taps`` taps a sample: the
    output staged where a load is narrower than 16 bytes and a block of
    one sample a sub-warp fits in shared memory."""
    V = vector_width(K, itemsize, (maps_addr, out_addr))
    L = sub_warp_lanes(K // V, 1)
    groups = THREADS // L
    staged = V * itemsize < 16 and sample_smem(groups, K, itemsize, True, taps) <= MAX_SMEM
    S = SAMPLES_PER_LANE
    while S > 1 and sample_smem(groups * S, K, itemsize, staged, taps) > MAX_SMEM:
        S //= 2
    return Partition(V, L, S, groups * S, staged)


def taps_dot_partition(K: int, itemsize: int, maps_addr: int, gout_addr: int) -> Partition:
    """taps_dot_grouped's partition: a sub-warp of 4 to 32 lanes a sample."""
    V = vector_width(K, itemsize, (maps_addr, gout_addr))
    L = sub_warp_lanes(K // V, 4)
    return Partition(V, L, SAMPLES_PER_LANE, THREADS // L * SAMPLES_PER_LANE, False)


def library_partition(
    kernel: str, K: int, dtype: torch.dtype, a: torch.Tensor, b: torch.Tensor, taps: int = 4
) -> Partition:
    """The partition the built library takes for ``kernel``
    ("sample_tiles_grouped": a = maps, b = out, ``taps`` taps a sample;
    "taps_dot_grouped": a = maps, b = gout), as it reports it (builds the
    library)."""
    lib = _library()
    shape = (ctypes.c_int * 5)()
    code = {"sample_tiles_grouped": 0, "taps_dot_grouped": 1}[kernel]
    rc = lib.grouped_partition(code, K, taps, _DTYPE_CODE[dtype], a.data_ptr(), b.data_ptr(), shape)
    _raise_on(lib, rc, kernel)
    return Partition(shape[0], shape[1], shape[2], shape[3], bool(shape[4]))


# the reference's rule for its fused backward kernel
# (scatter_tapdot_grouped, warp_pallas.py): one group's blocks, double
# buffered, must fit this much VMEM, in spans of 512 rows and tiles of 128
FUSED_BUDGET_BYTES = 48 * 1024 * 1024
_SPAN_ROWS = 512


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def fused_backward_fits(P: int, N: int, K: int, compute_dtype: torch.dtype) -> bool:
    """Whether the reference takes its fused backward kernel for groups of
    P rows, N samples and K channels: the map in the compute dtype, dmaps
    in f32, the cotangent, and 48 bytes a sample of taps and d_wts, all
    double-buffered, within :data:`FUSED_BUDGET_BYTES`. Where it does not,
    the reference runs the two one-sided kernels, and so does
    :class:`GroupedSample`: the same shapes take the same family of
    kernels in both packages."""
    itemsize = torch.empty((), dtype=compute_dtype).element_size()
    p_res, k_pad, n_pad = _round_up(P, 8) + _SPAN_ROWS, _round_up(K, 128), _round_up(N, 128)
    return 2 * (p_res * k_pad * (itemsize + 4) + n_pad * k_pad * itemsize + n_pad * 48) <= FUSED_BUDGET_BYTES


class GroupedKernels(NamedTuple):
    """The four functions the sampler runs: the kernels, or (for a check
    on the card) their plain versions."""

    sample: Callable
    scatter_tapdot: Callable
    scatter_taps: Callable
    taps_dot: Callable


KERNELS = GroupedKernels(
    sample_tiles_grouped, scatter_tapdot_grouped, scatter_taps_grouped, taps_dot_grouped
)
PLAIN = GroupedKernels(
    sample_tiles_grouped_ref, scatter_tapdot_grouped_ref, scatter_taps_grouped_ref, taps_dot_grouped_ref
)


class GroupedSample(torch.autograd.Function):
    """Grouped bilinear sampling with its gradients.

    ``apply(maps, idx, wts, kernels)``: maps [G, P, K] in the compute
    dtype, idx [G, N, 4] int32, wts [G, N, 4] float32. The backward runs
    in the cotangent's precision and computes what is asked for: dmaps
    alone with ``kernels.scatter_taps``, d_wts alone with
    ``kernels.taps_dot``, both with ``kernels.scatter_tapdot`` where
    :func:`fused_backward_fits`, else with the two one-sided kernels. It
    returns dmaps in the cotangent's dtype, nothing for idx, and d_wts in
    the weights' dtype.
    """

    @staticmethod
    def forward(ctx, maps, idx, wts, kernels: GroupedKernels):
        ctx.save_for_backward(maps, idx, wts)
        ctx.kernels = kernels
        return kernels.sample(maps, idx, wts)

    @staticmethod
    def backward(ctx, g):
        maps, idx, wts = ctx.saved_tensors
        need_maps, _, need_wts, _ = ctx.needs_input_grad
        k = ctx.kernels
        kdtype = torch.bfloat16 if g.dtype == torch.bfloat16 else torch.float32
        g = g.to(kdtype).contiguous()
        P, N, K = maps.shape[1], idx.shape[1], maps.shape[2]
        dmaps = d_wts = None
        if need_maps and need_wts and fused_backward_fits(P, N, K, kdtype):
            dmaps, d_wts = k.scatter_tapdot(maps.to(kdtype).contiguous(), g, idx, wts)
        else:
            if need_maps:
                dmaps = k.scatter_taps(g, idx, wts, P)
            if need_wts:
                d_wts = k.taps_dot(maps.to(kdtype).contiguous(), g, idx)
        return (
            None if dmaps is None else dmaps.to(g.dtype),
            None,
            None if d_wts is None else d_wts.to(wts.dtype),
            None,
        )


def sample_bilinear_many_scaled(
    feats: torch.Tensor,
    coords: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    *,
    grouped: GroupedKernels = KERNELS,
) -> torch.Tensor:
    """Batched bilinear sampling through :class:`GroupedSample`, with a
    per-sample scalar folded into the 4 tap weights: the twin of
    ``sample_bilinear_many_scaled`` (``vsta_tpu/ops/warp.py``).

    feats [G, Hf, Wf, C] in the compute dtype; coords [G, S, 2] (x, y)
    feature pixels; scale [G, S] or None. Returns [G, S, C] =
    ``scale[..., None] * bilinear_sample(feats, coords)`` with zeros
    outside the map. The scale multiplies the float32 weights before the
    kernel rounds them to the compute dtype. Differentiable in feats, in
    scale and, through the tap weights, in coords.
    """
    G, Hf, Wf, C = feats.shape
    anchors, wts = anchored_taps(coords, (Hf, Wf))
    if scale is not None:
        wts = wts * scale[..., None].to(wts.dtype)
    fp = pad_feat_br(feats).reshape(G, (Hf + 1) * (Wf + 1), C)
    return GroupedSample.apply(fp, flat_taps(anchors, Wf + 1), wts.contiguous(), grouped)


def sample_bilinear_many(
    feats: torch.Tensor, coords: torch.Tensor, *, grouped: GroupedKernels = KERNELS
) -> torch.Tensor:
    """:func:`sample_bilinear_many_scaled` without a scale: the twin of
    ``sample_bilinear_many`` (``vsta_tpu/ops/warp.py``)."""
    return sample_bilinear_many_scaled(feats, coords, None, grouped=grouped)


def warp_views(
    feats: torch.Tensor, coords: torch.Tensor, *, grouped: GroupedKernels = KERNELS
) -> torch.Tensor:
    """Warp every frame's per-view maps onto the BEV grid, unfused: the
    twin of ``warp_views`` (``vsta_tpu/ops/warp.py``).

    feats [B, V, Hf, Wf, C] in the compute dtype; coords
    [B, V, Hb, Wb, 2] feature-pixel sample coordinates. Returns
    [B, V, Hb, Wb, C]: :func:`sample_bilinear_many` with one group a
    (frame, view).
    """
    B, V, Hf, Wf, C = feats.shape
    Hb, Wb = coords.shape[2], coords.shape[3]
    out = sample_bilinear_many(
        feats.reshape(B * V, Hf, Wf, C), coords.reshape(B * V, Hb * Wb, 2), grouped=grouped
    )
    return out.reshape(B, V, Hb, Wb, C)

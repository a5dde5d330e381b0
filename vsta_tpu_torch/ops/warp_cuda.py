"""The multi-view warp kernel (``csrc/warp_tiles.cu``) and its callers.

:func:`warp_tiles` computes
``out[n, k] = sum_v sum_t wts[v,n,t] * feats[v, idx[v,n,t], k]``; it
replaces the TPU kernels ``warp_tiles_resident`` and
``warp_tiles_windowed`` (``vsta_tpu/ops/warp_pallas.py``), one CUDA
kernel for both. :func:`warp_tiles_ref` is its plain PyTorch version.
:func:`fused_warp_proj_cuda` is the shared-camera warp + ConcatFusion +
1x1 projection around it, the twin of ``_fwp_pallas_impl``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from .. import kernels
from .grouped_cuda import KERNELS, GroupedKernels, GroupedSample
from .warp import anchored_taps, flat_taps, pad_feat_br, precompute_warp_lut, warp_lut_sum

# the TPU dispatch between the two kernels (warp_pallas.py:537-544): the
# VMEM-resident kernel, which stores the compute dtype, while the padded
# projected block fits this budget; the windowed one, which stores f32,
# above it. The port keeps the rule so it rounds where the reference does.
RESIDENT_BUDGET_BYTES = 80 * 1024 * 1024
_RWIN = 384

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def warp_out_dtype(V: int, P: int, K: int, compute_dtype: torch.dtype) -> torch.dtype:
    """Output dtype of the warp as the TPU dispatch picks it: the compute
    dtype when ``V * P_res * K_pad * itemsize`` fits the resident budget,
    float32 otherwise."""
    itemsize = torch.empty((), dtype=compute_dtype).element_size()
    resident = V * (_round_up(P, 8) + _RWIN) * _round_up(K, 128) * itemsize
    return compute_dtype if resident <= RESIDENT_BUDGET_BYTES else torch.float32


def warp_tiles_ref(
    feats_vpk: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, *, out_dtype: torch.dtype
) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_tiles` (f32 accumulation)."""
    return warp_lut_sum(feats_vpk, idx, wts).to(out_dtype)


def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (built on first use)."""
    lib = kernels.load("warp_tiles")
    lib.warp_tiles_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.warp_tiles_launch.restype = ctypes.c_int
    lib.warp_tiles_error_string.argtypes = [ctypes.c_int]
    lib.warp_tiles_error_string.restype = ctypes.c_char_p
    return lib


def _check(feats_vpk, idx, wts, out_dtype):
    if feats_vpk.ndim != 3 or idx.ndim != 3 or idx.shape[-1] != 4:
        raise ValueError(
            f"warp_tiles wants feats [V, P, K] and idx/wts [V, N, 4], got "
            f"{tuple(feats_vpk.shape)}, {tuple(idx.shape)}"
        )
    if idx.shape != wts.shape or idx.shape[0] != feats_vpk.shape[0]:
        raise ValueError(
            f"warp_tiles shape mismatch: feats {tuple(feats_vpk.shape)}, idx "
            f"{tuple(idx.shape)}, wts {tuple(wts.shape)}"
        )
    if feats_vpk.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(
            f"warp_tiles takes float32/bfloat16, got {feats_vpk.dtype} -> {out_dtype}"
        )
    if idx.dtype != torch.int32 or wts.dtype != torch.float32:
        raise TypeError(f"warp_tiles wants int32 idx and float32 wts, got {idx.dtype}, {wts.dtype}")


def warp_tiles(
    feats_vpk: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, *, out_dtype: torch.dtype
) -> torch.Tensor:
    """Sum over views of the bilinear warp, batch folded into channels.

    feats_vpk [V, P, K] float32/bfloat16; idx [V, N, 4] int32 flat taps in
    [0, P); wts [V, N, 4] float32 (0 = masked tap). Returns [N, K] in
    ``out_dtype``, accumulated in float32. ``warp_tiles.launches`` counts
    kernel launches.
    """
    _check(feats_vpk, idx, wts, out_dtype)
    dev = feats_vpk.device
    if dev.type == "cpu":
        return warp_tiles_ref(feats_vpk, idx, wts, out_dtype=out_dtype)
    if dev.type != "cuda" or idx.device != dev or wts.device != dev:
        raise ValueError(
            f"warp_tiles needs all inputs on one CUDA device, got {dev}, {idx.device}, {wts.device}"
        )
    if not (feats_vpk.is_contiguous() and idx.is_contiguous() and wts.is_contiguous()):
        raise ValueError("warp_tiles needs contiguous inputs")
    V, P, K = feats_vpk.shape
    N = idx.shape[1]
    if max(N, V * P, K) >= 2**31:
        raise ValueError(f"warp_tiles shape too large: V={V} P={P} N={N} K={K}")
    out = torch.empty((N, K), dtype=out_dtype, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.warp_tiles_launch(
            feats_vpk.data_ptr(), idx.data_ptr(), wts.data_ptr(), out.data_ptr(),
            V, P, N, K, _DTYPE_CODE[feats_vpk.dtype], _DTYPE_CODE[out_dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.warp_tiles_error_string(rc).decode()
        raise RuntimeError(f"warp_tiles launch failed ({rc}): {msg}")
    warp_tiles.launches += 1
    return out


warp_tiles.launches = 0


def fused_warp_proj_cuda(
    feats: torch.Tensor,
    coords: torch.Tensor,
    proj_kernel: torch.Tensor,
    proj_bias: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
    *,
    warp: Callable = warp_tiles,
) -> torch.Tensor:
    """Shared-camera warp + ConcatFusion + 1x1 projection.

    feats [B, V, Hf, Wf, C]; coords [V, Hb, Wb, 2] feature-pixel sample
    coordinates (one calibration for the batch); proj_kernel [V, C, C_out];
    proj_bias [C_out] or None. Returns [B, Hb, Wb, C_out] in
    ``compute_dtype``. Projects per view first, then warps the
    ``K = B * C_out`` channels with ``warp`` (:func:`warp_tiles`; a test
    may pass :func:`warp_tiles_ref`), rounding as ``_fwp_pallas_impl``.
    On CPU tensors this is the plain version of the whole function.
    """
    B, V, Hf, Wf, C = feats.shape
    C_out = proj_kernel.shape[-1]
    if coords.ndim != 4:
        raise NotImplementedError(
            "per-frame cameras ([B, V, Hb, Wb, 2] coords) are ROADMAP Queue 1, "
            "'Per-frame cameras', with Queue 2's warp_views_sum_pallas"
        )
    Hb, Wb = coords.shape[1], coords.shape[2]
    N, P = Hb * Wb, Hf * Wf
    idx, wts = precompute_warp_lut(coords.reshape(V, N, 2), (Hf, Wf))
    proj = torch.einsum(
        "bvhwc,vco->vhwbo", feats.to(compute_dtype), proj_kernel.to(compute_dtype)
    )
    warped = warp(
        proj.reshape(V, P, B * C_out).contiguous(), idx, wts,
        out_dtype=warp_out_dtype(V, P, B * C_out, compute_dtype),
    )
    out = warped.reshape(N, B, C_out).permute(1, 0, 2).reshape(B, Hb, Wb, C_out)
    if proj_bias is not None:
        out = out + proj_bias.to(out.dtype)
    return out.to(compute_dtype)


def fused_warp_proj(
    feats: torch.Tensor,
    coords: torch.Tensor,
    proj_kernel: torch.Tensor,
    proj_bias: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
    *,
    grouped: GroupedKernels = KERNELS,
) -> torch.Tensor:
    """Shared-camera warp + ConcatFusion + 1x1 projection, differentiable:
    the twin of the XLA ``fused_warp_proj`` (``vsta_tpu/ops/warp.py``).

    Same contract as :func:`fused_warp_proj_cuda`, but the warp is the
    grouped sampler on the map padded by one zero row and column, with
    :class:`~vsta_tpu_torch.ops.grouped_cuda.GroupedSample`'s backward
    (the maps' gradient alone: the tap weights come from the calibration). Whichever side is narrower is warped: the projected
    ``C_out`` channels when ``C_out < C``, else the raw ``C`` channels,
    projected after the warp. ``grouped`` picks the kernels or their
    plain versions.
    """
    B, V, Hf, Wf, C = feats.shape
    C_out = proj_kernel.shape[-1]
    if coords.ndim != 4:
        raise NotImplementedError(
            "per-frame cameras ([B, V, Hb, Wb, 2] coords) are ROADMAP Queue 1, "
            "'Per-frame cameras', with Queue 2's warp_views_sum_pallas"
        )
    Hb, Wb = coords.shape[1], coords.shape[2]
    N, Pp = Hb * Wb, (Hf + 1) * (Wf + 1)
    anchors, wts = anchored_taps(coords.reshape(V, N, 2), (Hf, Wf))
    idx = flat_taps(anchors, Wf + 1)
    kernel = proj_kernel.to(compute_dtype)
    if C_out < C:
        # project first, warp C_out channels
        proj = torch.einsum("bvhwc,vco->vhwbo", feats.to(compute_dtype), kernel)
        fp = pad_feat_br(proj.reshape(V, Hf, Wf, B * C_out)).reshape(V, Pp, B * C_out)
        warped = GroupedSample.apply(fp, idx, wts, grouped)
        out = warped.sum(0).reshape(N, B, C_out)
    else:
        # warp the raw C channels, project after (per-view kernels summed)
        fv = feats.to(compute_dtype).permute(1, 2, 3, 0, 4).reshape(V, Hf, Wf, B * C)
        fp = pad_feat_br(fv).reshape(V, Pp, B * C)
        warped = GroupedSample.apply(fp, idx, wts, grouped).reshape(V, N, B, C)
        out = torch.einsum("vnbc,vco->nbo", warped, kernel)
    out = out.permute(1, 0, 2).reshape(B, Hb, Wb, C_out)
    if proj_bias is not None:
        out = out + proj_bias.to(out.dtype)
    return out


class FusedWarpProj(torch.autograd.Function):
    """:func:`fused_warp_proj_cuda` with a backward: the twin of
    ``_fwp_pallas``.

    ``apply(feats, coords, proj_kernel, proj_bias, compute_dtype, warp,
    grouped)``. The forward launches ``warp`` (the warp kernel); the
    backward is the VJP of :func:`fused_warp_proj` on the saved inputs
    with ``grouped``'s sampler, as ``_fwp_pallas_bwd`` takes the VJP of
    the XLA ``fused_warp_proj``. The coordinates get no gradient: they come
    from the calibration, not from parameters.
    """

    @staticmethod
    def forward(ctx, feats, coords, proj_kernel, proj_bias, compute_dtype, warp, grouped):
        ctx.save_for_backward(feats, coords, proj_kernel, proj_bias)
        ctx.compute_dtype, ctx.grouped = compute_dtype, grouped
        return fused_warp_proj_cuda(feats, coords, proj_kernel, proj_bias, compute_dtype, warp=warp)

    @staticmethod
    def backward(ctx, g):
        feats, coords, proj_kernel, proj_bias = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [
                None if t is None else t.detach().requires_grad_(n)
                for t, n in ((feats, need[0]), (proj_kernel, need[2]), (proj_bias, need[3]))
            ]
            out = fused_warp_proj(*leaves[:1], coords, *leaves[1:], ctx.compute_dtype, grouped=ctx.grouped)
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        df, dk, db = (next(grads) if t is not None and t.requires_grad else None for t in leaves)
        return df, None, dk, db, None, None, None

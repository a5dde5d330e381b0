"""The multi-view warp kernel (``csrc/warp_tiles.cu``) and its callers.

:func:`warp_tiles` computes
``out[n, k] = sum_v sum_t wts[v,n,t] * feats[v, idx[v,n,t], k]``; it
replaces the TPU kernels ``warp_tiles_resident`` and
``warp_tiles_windowed`` (``vsta_tpu/ops/warp_pallas.py``), one CUDA
kernel for both. :func:`warp_tiles_ref` is its plain PyTorch version.
:func:`fused_warp_proj_cuda` is the warp + ConcatFusion + 1x1 projection
around it, the twin of ``_fwp_pallas_impl``: shared cameras go through
:func:`warp_tiles`, per-frame cameras through
:func:`~vsta_tpu_torch.ops.warp_views_cuda.warp_views_sum`.

:func:`warp_tiles_variant` runs the kernel with one part taken out
(:data:`VARIANTS`), wrong by design, for cost attribution: the twin of
``_resident_variant`` (``scripts/roofline_warp.py``). No model path reaches
a variant.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from .. import kernels
from .grouped_cuda import KERNELS, GroupedKernels, GroupedSample, warp_views
from .warp import anchored_taps, flat_taps, pad_feat_br, precompute_warp_lut, tap_weights, warp_lut_sum
from .warp_views_cuda import grid_width, warp_views_sum

# the TPU dispatch between the two kernels (warp_pallas.py:537-544): the
# VMEM-resident kernel, which stores the compute dtype, while the padded
# projected block fits this budget; the windowed one, which stores f32,
# above it. The port keeps the rule so it rounds where the reference does.
RESIDENT_BUDGET_BYTES = 80 * 1024 * 1024
_RWIN = 384

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the ablated copies of the kernel, by the part each takes out (the code
# is the kernel's Variant enum): 'full' nothing; 'const_weights' the load
# of the weights (every tap weighs 0.25, none is skipped); 'row0' the
# scattered gather (every tap reads source row 0 of its view); 'no_gather'
# every read of the maps (each channel gets the sum of the cell's weights)
VARIANTS = ("full", "const_weights", "row0", "no_gather")


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
    feats_vpk: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, *, out_dtype: torch.dtype,
    grid_w: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_tiles` (f32 accumulation);
    ``grid_w``, the kernel's tiling, does not change the function."""
    return warp_lut_sum(feats_vpk, idx, wts).to(out_dtype)


def warp_tiles_variant_ref(
    feats_vpk: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, variant: str, *, out_dtype: torch.dtype,
    grid_w: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_tiles_variant`: the same wrong
    thing each variant computes."""
    if variant == "full":
        return warp_tiles_ref(feats_vpk, idx, wts, out_dtype=out_dtype)
    if variant == "const_weights":
        return warp_tiles_ref(feats_vpk, idx, torch.full_like(wts, 0.25), out_dtype=out_dtype)
    if variant == "row0":
        return warp_tiles_ref(feats_vpk, torch.zeros_like(idx), wts, out_dtype=out_dtype)
    if variant == "no_gather":
        w = tap_weights(wts, feats_vpk.dtype)
        total = torch.zeros(idx.shape[1], dtype=torch.float32, device=wts.device)
        for v in range(w.shape[0]):  # views then taps, as the kernel adds them
            for t in range(4):
                total += w[v, :, t]
        return total[:, None].expand(-1, feats_vpk.shape[2]).to(out_dtype)
    raise ValueError(f"unknown warp_tiles variant {variant!r}: one of {VARIANTS}")


def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (built on first use)."""
    lib = kernels.load("warp_tiles")
    lib.warp_tiles_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.warp_tiles_launch.restype = ctypes.c_int
    lib.warp_tiles_variant_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.warp_tiles_variant_launch.restype = ctypes.c_int
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


def _launch(feats_vpk, idx, wts, out_dtype, variant: int, name: str, grid_w) -> Optional[torch.Tensor]:
    """Check the inputs and launch the kernel's ``variant``; None for CPU
    tensors, which take the plain version."""
    _check(feats_vpk, idx, wts, out_dtype)
    dev = feats_vpk.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda" or idx.device != dev or wts.device != dev:
        raise ValueError(
            f"{name} needs all inputs on one CUDA device, got {dev}, {idx.device}, {wts.device}"
        )
    if not (feats_vpk.is_contiguous() and idx.is_contiguous() and wts.is_contiguous()):
        raise ValueError(f"{name} needs contiguous inputs")
    V, P, K = feats_vpk.shape
    N = idx.shape[1]
    if max(N, V * P, K) >= 2**31:
        raise ValueError(f"{name} shape too large: V={V} P={P} N={N} K={K}")
    out = torch.empty((N, K), dtype=out_dtype, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.warp_tiles_variant_launch(
            feats_vpk.data_ptr(), idx.data_ptr(), wts.data_ptr(), out.data_ptr(),
            V, P, N, K, _DTYPE_CODE[feats_vpk.dtype], _DTYPE_CODE[out_dtype], variant,
            grid_width(N, grid_w), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.warp_tiles_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed ({rc}): {msg}")
    return out


def warp_tiles(
    feats_vpk: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, *, out_dtype: torch.dtype,
    grid_w: Optional[int] = None,
) -> torch.Tensor:
    """Sum over views of the bilinear warp, batch folded into channels.

    feats_vpk [V, P, K] float32/bfloat16; idx [V, N, 4] int32 flat taps in
    [0, P); wts [V, N, 4] float32 (0 = masked tap). Returns [N, K] in
    ``out_dtype``, accumulated in float32. ``grid_w``: the width of the BEV
    grid the N cells fill row by row, so the kernel takes 8x8 tiles of it
    (without it, runs of 64 cells: the same sums, more rows a tile).
    ``warp_tiles.launches`` counts kernel launches.
    """
    out = _launch(feats_vpk, idx, wts, out_dtype, 0, "warp_tiles", grid_w)
    if out is None:
        return warp_tiles_ref(feats_vpk, idx, wts, out_dtype=out_dtype)
    warp_tiles.launches += 1
    return out


warp_tiles.launches = 0


def warp_tiles_variant(
    feats_vpk: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, variant: str, *, out_dtype: torch.dtype,
    grid_w: Optional[int] = None,
) -> torch.Tensor:
    """:func:`warp_tiles` with one part of the kernel taken out
    (``variant``, one of :data:`VARIANTS`): wrong by design, for cost
    attribution. ``'full'`` is the kernel as it is and equals
    :func:`warp_tiles` bit for bit. ``warp_tiles_variant.launches`` counts
    kernel launches."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown warp_tiles variant {variant!r}: one of {VARIANTS}")
    out = _launch(feats_vpk, idx, wts, out_dtype, VARIANTS.index(variant), "warp_tiles_variant", grid_w)
    if out is None:
        return warp_tiles_variant_ref(feats_vpk, idx, wts, variant, out_dtype=out_dtype)
    warp_tiles_variant.launches += 1
    return out


warp_tiles_variant.launches = 0


def _check_coords(coords: torch.Tensor, B: int, V: int) -> None:
    lead = (V,) if coords.ndim == 4 else (B, V)
    if coords.ndim not in (4, 5) or coords.shape[-1] != 2 or tuple(coords.shape[: len(lead)]) != lead:
        raise ValueError(
            f"coords must be [V, Hb, Wb, 2] or [B, V, Hb, Wb, 2] for B={B}, V={V}, got {tuple(coords.shape)}"
        )


def fused_warp_proj_cuda(
    feats: torch.Tensor,
    coords: torch.Tensor,
    proj_kernel: torch.Tensor,
    proj_bias: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
    *,
    warp: Callable = warp_tiles,
    views_sum: Callable = warp_views_sum,
) -> torch.Tensor:
    """Warp + ConcatFusion + 1x1 projection.

    feats [B, V, Hf, Wf, C]; coords feature-pixel sample coordinates,
    [V, Hb, Wb, 2] for one calibration shared by the batch or
    [B, V, Hb, Wb, 2] for one a frame; proj_kernel [V, C, C_out];
    proj_bias [C_out] or None. Returns [B, Hb, Wb, C_out] in
    ``compute_dtype``. Projects per view first. Shared cameras then warp
    the ``K = B * C_out`` channels with ``warp`` (:func:`warp_tiles`; a
    test may pass :func:`warp_tiles_ref`); per-frame cameras warp each
    frame's ``C_out`` channels with ``views_sum``
    (:func:`~vsta_tpu_torch.ops.warp_views_cuda.warp_views_sum` or its
    plain version), whose weights stay float32 and whose output is
    float32. Both round as ``_fwp_pallas_impl``. On CPU tensors this is
    the plain version of the whole function.
    """
    B, V, Hf, Wf, C = feats.shape
    C_out = proj_kernel.shape[-1]
    _check_coords(coords, B, V)
    if coords.ndim == 5:
        Hb, Wb = coords.shape[2], coords.shape[3]
        N, P = Hb * Wb, Hf * Wf
        proj = torch.einsum(
            "bvhwc,vco->bvhwo", feats.to(compute_dtype), proj_kernel.to(compute_dtype)
        )
        idx, wts = precompute_warp_lut(coords.reshape(B, V, N, 2), (Hf, Wf))
        out = views_sum(proj.reshape(B, V, P, C_out).contiguous(), idx, wts, grid_w=Wb).reshape(B, Hb, Wb, C_out)
        if proj_bias is not None:
            out = out + proj_bias.to(out.dtype)
        return out.to(compute_dtype)
    Hb, Wb = coords.shape[1], coords.shape[2]
    N, P = Hb * Wb, Hf * Wf
    idx, wts = precompute_warp_lut(coords.reshape(V, N, 2), (Hf, Wf))
    proj = torch.einsum(
        "bvhwc,vco->vhwbo", feats.to(compute_dtype), proj_kernel.to(compute_dtype)
    )
    warped = warp(
        proj.reshape(V, P, B * C_out).contiguous(), idx, wts,
        out_dtype=warp_out_dtype(V, P, B * C_out, compute_dtype), grid_w=Wb,
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
    """Warp + ConcatFusion + 1x1 projection, differentiable: the twin of
    the XLA ``fused_warp_proj`` (``vsta_tpu/ops/warp.py``).

    Same contract as :func:`fused_warp_proj_cuda`, but the warp is the
    grouped sampler on the map padded by one zero row and column, with
    :class:`~vsta_tpu_torch.ops.grouped_cuda.GroupedSample`'s backward
    (the maps' gradient alone: the tap weights come from the calibration).
    With shared cameras whichever side is narrower is warped: the
    projected ``C_out`` channels when ``C_out < C``, else the raw ``C``
    channels, projected after the warp. With per-frame cameras the
    projection always comes first, then
    :func:`~vsta_tpu_torch.ops.grouped_cuda.warp_views` (one group a frame
    and view) and the sum over views. ``grouped`` picks the kernels or
    their plain versions.
    """
    B, V, Hf, Wf, C = feats.shape
    C_out = proj_kernel.shape[-1]
    _check_coords(coords, B, V)
    kernel = proj_kernel.to(compute_dtype)
    if coords.ndim == 5:
        proj = torch.einsum("bvhwc,vco->bvhwo", feats.to(compute_dtype), kernel)
        out = warp_views(proj, coords, grouped=grouped).sum(dim=1)
        if proj_bias is not None:
            out = out + proj_bias.to(out.dtype)
        return out
    Hb, Wb = coords.shape[1], coords.shape[2]
    N, Pp = Hb * Wb, (Hf + 1) * (Wf + 1)
    anchors, wts = anchored_taps(coords.reshape(V, N, 2), (Hf, Wf))
    idx = flat_taps(anchors, Wf + 1)
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
    grouped, views_sum)``. The forward launches ``warp`` (shared cameras)
    or ``views_sum`` (per-frame cameras), the warp kernels; the backward
    is the VJP of :func:`fused_warp_proj` on the saved inputs with
    ``grouped``'s sampler, as ``_fwp_pallas_bwd`` takes the VJP of the XLA
    ``fused_warp_proj``. The coordinates get no gradient: they come from
    the calibration, not from parameters.
    """

    @staticmethod
    def forward(ctx, feats, coords, proj_kernel, proj_bias, compute_dtype, warp, grouped, views_sum=warp_views_sum):
        ctx.save_for_backward(feats, coords, proj_kernel, proj_bias)
        ctx.compute_dtype, ctx.grouped = compute_dtype, grouped
        return fused_warp_proj_cuda(
            feats, coords, proj_kernel, proj_bias, compute_dtype, warp=warp, views_sum=views_sum
        )

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
        return df, None, dk, db, None, None, None, None


def warp_proj(
    feats: torch.Tensor,
    coords: torch.Tensor,
    proj_kernel: torch.Tensor,
    proj_bias: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
    *,
    impl: str = "pallas",
    warp: Callable = warp_tiles,
    grouped: GroupedKernels = KERNELS,
    views_sum: Callable = warp_views_sum,
) -> torch.Tensor:
    """The warp + concat fusion + 1x1 projection by ``impl``: 'pallas'
    through the warp kernels (:func:`fused_warp_proj_cuda`; with autograd
    on, :class:`FusedWarpProj`), 'fused' through the differentiable
    grouped-sampler warp (:func:`fused_warp_proj`). The one dispatch of
    the model's concat path and of its sharded twin."""
    if impl == "fused":
        return fused_warp_proj(feats, coords, proj_kernel, proj_bias, compute_dtype, grouped=grouped)
    if impl != "pallas":
        raise ValueError(f"unknown warp impl {impl!r}: pallas or fused")
    if torch.is_grad_enabled():
        return FusedWarpProj.apply(feats, coords, proj_kernel, proj_bias, compute_dtype, warp, grouped, views_sum)
    return fused_warp_proj_cuda(feats, coords, proj_kernel, proj_bias, compute_dtype, warp=warp, views_sum=views_sum)

"""The least bytes and operations of the grouped sampler's one launch a
request of the per-view warp (``WARP_IMPL: gather``; MVDet): every frame's
views' maps warped apart, one group a (frame, view), so G = batch * views,
each map of ``FEAT_DIM`` channels at the reference's feature size, at the
static cameras' taps. Each input read once at the live taps' distinct
rows, each output written once (``kernels.sample_grouped``)."""

from __future__ import annotations

from .kernels import Bound, sample_grouped, static_coords


def views_grouped_request(reference, cfg, K, Rt, batch: int) -> Bound:
    """One request of ``batch`` frame sets under one calibration (K [V, 3,
    3], Rt [V, 4, 4]): ``batch`` times the bound of the views' V groups,
    as every frame's groups read their own maps at the same taps."""
    coords, hw = static_coords(reference, cfg, K, Rt)
    one = sample_grouped(coords, hw, cfg["MODEL"]["FEAT_DIM"])
    return Bound(batch * one.nbytes, batch * one.flops, one.dtype)

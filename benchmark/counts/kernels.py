"""Least bytes and operations of the port's hand-written kernels at the
data's own taps: each input read once, each output written once, over
the peaks (the arithmetic of ``chip_smoke.warp_reading`` and
``chip_smoke.measure``, copied). Taps are counted from coordinates the
benchmark works out itself; a tap is live where its bilinear weight is
not zero, and a source row counts once however many taps read it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .peaks import HBM_BYTES_PER_S, PEAK_FLOPS_PER_S

LUT_TAP_BYTES = 8  # an int32 index and a float32 weight a tap


@dataclass
class Bound:
    nbytes: float
    flops: float
    dtype: str = "bfloat16"

    @property
    def seconds(self) -> float:
        return max(self.nbytes / HBM_BYTES_PER_S, self.flops / PEAK_FLOPS_PER_S[self.dtype])

    def __add__(self, other: "Bound") -> "Bound":
        return Bound(self.nbytes + other.nbytes, self.flops + other.flops, self.dtype)


def plain_taps(coords: torch.Tensor, hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat rows [G, N, 4] into the h x w map and liveness [G, N, 4] of the
    bilinear taps of coords [G, N, 2] (zero outside the map)."""
    h, w = hw
    x, y = coords[..., 0], coords[..., 1]
    finite = torch.isfinite(x) & torch.isfinite(y)
    x0 = torch.floor(torch.where(finite, x, torch.zeros_like(x)))
    y0 = torch.floor(torch.where(finite, y, torch.zeros_like(y)))
    fx, fy = x - x0, y - y0
    rows, live = [], []
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h) & finite
            rows.append((yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long())
            live.append(inside & (wx * wy != 0))
    return torch.stack(rows, -1), torch.stack(live, -1)


def distinct_rows(rows: torch.Tensor, live: torch.Tensor, P: int) -> int:
    g = torch.arange(rows.shape[0], device=rows.device).view(-1, *([1] * (rows.dim() - 1))) * P
    return int(torch.unique((rows + g)[live]).numel())


def warp_tiles(coords: torch.Tensor, hw, K: int, item: int = 2) -> Bound:
    """One launch of the shared-camera warp: V maps of h x w rows of K
    channels, N cells, coords [V, N, 2]."""
    rows, live = plain_taps(coords, hw)
    V, N = coords.shape[:2]
    P = hw[0] * hw[1]
    nbytes = distinct_rows(rows, live, P) * K * item + N * K * item + V * N * 4 * LUT_TAP_BYTES
    return Bound(nbytes, 2.0 * int(live.sum()) * K)


def sample_grouped(coords: torch.Tensor, hw, K: int, scale: torch.Tensor = None, item: int = 2) -> Bound:
    """One launch of the grouped sampler: G maps of h x w rows (padded by a
    zero row and column) of K channels, coords [G, N, 2]; ``scale`` [G, N]
    multiplies the taps' weights (a zero scale kills them)."""
    rows, live = plain_taps(coords, hw)
    if scale is not None:
        live = live & (scale != 0)[..., None]
    G, N = coords.shape[:2]
    P = hw[0] * hw[1]
    nbytes = distinct_rows(rows, live, P) * K * item + G * N * K * item + G * N * 4 * LUT_TAP_BYTES
    return Bound(nbytes, 2.0 * int(live.sum()) * K)


def static_coords(reference, cfg, K, Rt) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Feature-pixel coordinates [V, Hb * Wb, 2] of the BEV cells under one
    calibration (K [V, 3, 3], Rt [V, 4, 4]) and the feature map's size, by
    the configuration's ``reference`` module."""
    ref = reference.Reference(cfg, {})
    hw = ref.feature_hw()
    Hb, Wb = ref.bev_hw
    coords, _ = reference.project_cells(torch.as_tensor(K), torch.as_tensor(Rt), ref.img_hw, hw, Hb, Wb,
                                        ref.bounds)
    return coords.reshape(coords.shape[0], Hb * Wb, 2), hw


def concat_request(reference, cfg, K, Rt, batch: int) -> Bound:
    """The warp's one launch a request of the concat fusion: every frame's
    BEV_PROJ_CH projected channels side by side (K = batch * channels)."""
    coords, hw = static_coords(reference, cfg, K, Rt)
    return warp_tiles(coords, hw, batch * cfg["MODEL"]["BEV_PROJ_CH"])


def concat_grouped_request(reference, cfg, K, Rt, batch: int) -> Bound:
    """The grouped sampler's one launch a request of the concat fusion under
    ``WARP_IMPL: fused``: the views' projected maps with every frame's
    BEV_PROJ_CH channels side by side (one group a view, K = batch *
    channels) at the static cameras' taps."""
    coords, hw = static_coords(reference, cfg, K, Rt)
    return sample_grouped(coords, hw, batch * cfg["MODEL"]["BEV_PROJ_CH"])


@torch.no_grad()
def deform_request(reference, cfg, weights, batch, device) -> Bound:
    """The grouped sampler's two launches a request of the deformable
    fusion, at the taps of ``batch`` (the stacked inputs of one request):
    the query warp (the views' FEAT_DIM channels of every frame side by
    side) and the deformable sampler (one group a frame, view and head,
    its taps weighted by the attention; a masked view's weigh nothing)."""
    reference.tf32_off()
    B = len(batch["images"])
    coords, hw = static_coords(reference, cfg, batch["K"][0], batch["Rt"][0])
    query = sample_grouped(coords, hw, B * cfg["MODEL"]["FEAT_DIM"])
    ref = reference.Reference(cfg, weights)
    args = [torch.as_tensor(batch[k], device=device) for k in ("images", "K", "Rt")]
    feats = ref.encode(args[0])
    _, coords_s, depth_s, q_in = ref.deform_inputs(feats, args[1], args[2])
    maps, xy, wts, _ = ref.sampling(feats, coords_s, depth_s, q_in)
    return query + sample_grouped(xy, hw, maps.shape[-1], scale=wts)

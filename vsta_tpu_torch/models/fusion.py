"""Cross-view BEV fusion: the twins of ``vsta_tpu/models/fusion.py``.

:func:`simple_fusion` (sum, mean or max over the view axis) and
:class:`AttentionFusion` (a softmax gate over the views of every cell)
fuse per-view BEV maps that are already warped;
:class:`DeformableFusion` is multi-view deformable cross-attention, which
samples the image-space maps itself. Each BEV
cell is a query; its reference point in view v is the projection of the
cell's ground point into v's feature map. The query predicts, per head,
``points`` sampling offsets and attention logits per (view, point); values
are sampled bilinearly from the per-view value maps at reference point +
offset and combined with a softmax over (view, point), masked by each
view's validity. The attention weights are folded into the sampler's tap
weights (:func:`~vsta_tpu_torch.ops.grouped_cuda.sample_bilinear_many_scaled`),
so their gradient and the offsets' ride the sampler's ``d_wts``.

Parameters are float32 and are cast to the compute dtype at use, as
Flax's ``dtype=`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.grouped_cuda import KERNELS, GroupedKernels, sample_bilinear_many_scaled


def ring_offsets(heads: int, points: int) -> torch.Tensor:
    """Deformable-DETR-style initial offsets: head m points along the angle
    2*pi*m/heads, point p at radius p + 1. Returns [heads, points, 2]
    float32 (x, y)."""
    ang = 2.0 * math.pi * torch.arange(heads, dtype=torch.float64) / max(1, heads)
    dirs = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)  # [M, 2]
    radii = torch.arange(1, points + 1, dtype=torch.float64)  # [P]
    return (dirs[:, None, :] * radii[None, :, None]).to(torch.float32)


class Dense(nn.Linear):
    """A linear layer in a compute dtype: float32 parameters cast at use,
    the bias added after the product is rounded, as Flax's ``Dense``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        y = torch.matmul(x, self.weight.to(x.dtype).t())
        return y + self.bias.to(x.dtype)


def simple_fusion(bev_views: torch.Tensor, mode: str) -> torch.Tensor:
    """sum, mean or max over the view axis: [B, V, H, W, C] -> [B, H, W, C]
    (``SimpleFusion``). Cells outside a view's image are exact zeros in
    that view, so ties in the max are common: ``amax`` splits a tie's
    gradient evenly, as ``jnp.max`` does."""
    if mode == "sum":
        return bev_views.sum(dim=1)
    if mode == "mean":
        return bev_views.mean(dim=1)
    if mode == "max":
        return bev_views.amax(dim=1)
    raise ValueError(f"unknown simple fusion mode: {mode}")


class AttentionFusion(nn.Module):
    """Per-cell softmax gate over the views. Each view's warped feature
    votes on its own relevance through a small projection (``hidden``
    units, tanh, one logit); a view whose ``coverage`` of a cell is at
    most 1e-6 (all-zero features after the zero-padded warp) is masked out
    of the softmax. A cell no view covers gets equal weights over zeros."""

    def __init__(self, in_ch: int, hidden: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.hidden = Dense(in_ch, hidden)
        self.logit = Dense(hidden, 1)

    def forward(self, bev_views: torch.Tensor, coverage: Optional[torch.Tensor] = None) -> torch.Tensor:
        """bev_views [B, V, H, W, C]; coverage [B, V, H, W] or None.
        Returns [B, H, W, C] in the compute dtype."""
        x = bev_views.to(self.dtype)
        logits = self.logit(torch.tanh(self.hidden(x)))[..., 0]  # [B, V, H, W]
        if coverage is not None:
            neg = torch.full((), -1e9, dtype=logits.dtype, device=logits.device)
            logits = torch.where(coverage > 1e-6, logits, neg)
        w = torch.softmax(logits, dim=1)
        return torch.einsum("bvhw,bvhwc->bhwc", w, x)


class DeformableFusion(nn.Module):
    def __init__(
        self,
        views: int,
        in_ch: int,
        query_ch: int,
        heads: int = 4,
        points: int = 4,
        out_ch: int = 128,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if out_ch % heads:
            raise ValueError(f"out_ch {out_ch} must divide by heads {heads}")
        self.views, self.heads, self.points, self.out_ch, self.dtype = views, heads, points, out_ch, dtype
        self.value = Dense(in_ch, out_ch)
        self.offsets = Dense(query_ch, views * heads * points * 2)
        self.attn = Dense(query_ch, views * heads * points)
        self.out = Dense(out_ch, out_ch)
        self.init_sampling_()

    @torch.no_grad()
    def init_sampling_(self) -> None:
        """The sampling heads' start: zero kernels, the ring of
        :func:`ring_offsets` as the offsets' bias (the same for every
        view), zero attention logits."""
        self.offsets.weight.zero_()
        self.attn.weight.zero_()
        self.attn.bias.zero_()
        ring = ring_offsets(self.heads, self.points)
        self.offsets.bias.copy_(ring[None].expand(self.views, -1, -1, -1).reshape(-1))

    def forward(
        self,
        feats: torch.Tensor,
        coords: torch.Tensor,
        query: torch.Tensor,
        depth_w: Optional[torch.Tensor] = None,
        *,
        grouped: GroupedKernels = KERNELS,
    ) -> torch.Tensor:
        """feats [B, V, Hf, Wf, C]; coords [B, V, Hq, Wq, 2] reference
        points in feature pixels; query [B, Hq, Wq, Cq]; depth_w
        [B, V, Hq, Wq] homogeneous scale (> 0: in front of the camera) or
        None. Returns [B, Hq, Wq, out_ch] in the compute dtype."""
        B, V, Hf, Wf, _ = feats.shape
        Hq, Wq = query.shape[1], query.shape[2]
        M, P = self.heads, self.points
        hc = self.out_ch // M

        values = self.value(feats.to(self.dtype)).reshape(B, V, Hf, Wf, M, hc)
        q = query.to(self.dtype)
        offsets = self.offsets(q).reshape(B, Hq, Wq, V, M, P, 2)
        logits = self.attn(q).reshape(B, Hq, Wq, V, M, P)

        # sampling locations: reference point + offset, in the coordinates' f32
        base = coords.permute(0, 2, 3, 1, 4)  # [B, Hq, Wq, V, 2]
        loc = base[:, :, :, :, None, None, :] + offsets.to(base.dtype)

        # a view is valid where its reference point is finite, inside the
        # map (with a margin of one pixel) and in front of the camera
        valid = (
            torch.isfinite(base).all(dim=-1)
            & (base[..., 0] >= -1.0) & (base[..., 0] <= Wf)
            & (base[..., 1] >= -1.0) & (base[..., 1] <= Hf)
        )
        if depth_w is not None:
            valid = valid & (depth_w.permute(0, 2, 3, 1) > 1e-6)
        any_valid = valid.any(dim=-1)  # [B, Hq, Wq]

        # masked softmax over (view, point) per head
        neg = torch.full((), -1e9, dtype=logits.dtype, device=logits.device)
        logits = torch.where(valid[:, :, :, :, None, None], logits, neg)
        flat = logits.permute(0, 1, 2, 4, 3, 5).reshape(B, Hq, Wq, M, V * P)
        attn = torch.softmax(flat, dim=-1).reshape(B, Hq, Wq, M, V, P)

        # one group a (frame, view, head); the attention weights ride the
        # tap weights, so the sum over (view, point) below is the fusion
        loc_s = loc.permute(0, 3, 4, 1, 2, 5, 6)  # [B, V, M, Hq, Wq, P, 2]
        vals_s = values.permute(0, 1, 4, 2, 3, 5)  # [B, V, M, Hf, Wf, hc]
        attn_s = attn.permute(0, 4, 3, 1, 2, 5)  # [B, V, M, Hq, Wq, P]
        G = B * V * M
        weighted = sample_bilinear_many_scaled(
            vals_s.reshape(G, Hf, Wf, hc),
            loc_s.reshape(G, Hq * Wq * P, 2),
            attn_s.reshape(G, Hq * Wq * P),
            grouped=grouped,
        ).reshape(B, V, M, Hq, Wq, P, hc)
        per_head = weighted.to(self.dtype).sum(dim=(1, 5))  # [B, M, Hq, Wq, hc]
        fused = per_head.permute(0, 2, 3, 1, 4).reshape(B, Hq, Wq, M * hc)
        fused = fused * any_valid[..., None].to(fused.dtype)
        return self.out(fused)

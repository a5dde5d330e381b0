"""BEVNet: encoder -> shared-camera warp + concat fusion + projection ->
positional encoding -> CenterNet head.

The port carries the JAX flagship path: ``FUSION: concat`` with
``WARP_IMPL: pallas`` and static cameras. The encoder's 1x1 projection is
folded into the per-view projection (a ones channel carries its bias),
and :func:`~vsta_tpu_torch.ops.warp_cuda.fused_warp_proj_cuda` runs the
warp; with autograd on, :class:`~vsta_tpu_torch.ops.warp_cuda.FusedWarpProj`
runs it with its backward. Inputs and outputs are channels-last, as in the
JAX package. ``TRAIN.FREEZE_BACKBONE`` keeps the backbone in eval mode and
cuts the gradient at its output.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..config import Config
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..geometry import bev_sample_coords_with_depth, ground_grid
from ..ops.grouped_cuda import KERNELS
from ..ops.warp_cuda import FusedWarpProj, fused_warp_proj_cuda, warp_tiles
from .encoders.encoder import ViewEncoder
from .heads import BEVDetectorHead

POS_CH = 2


def positional_encoding(
    bev_h: int, bev_w: int, bounds: Tuple[float, float, float, float], device=None
) -> torch.Tensor:
    """[H, W, 2] sin/cos encoding of normalised BEV x/y.

    The linspace spans the bounds inclusively (cell corners, not the
    centres of :func:`ground_grid`), as the JAX package does.
    """
    x_min, x_max, y_min, y_max = bounds
    xs = torch.linspace(x_min, x_max, bev_w, device=device)
    ys = torch.linspace(y_min, y_max, bev_h, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    x_norm = (xx - x_min) / (x_max - x_min)
    y_norm = (yy - y_min) / (y_max - y_min)
    return torch.stack(
        [torch.sin(2.0 * math.pi * x_norm), torch.cos(2.0 * math.pi * y_norm)], dim=-1
    )


class BEVNet(nn.Module):
    """Construct with :meth:`from_config`; ``forward(images, K, Rt)``."""

    def __init__(
        self,
        views: int,
        bev_size: Tuple[int, int],
        bev_bounds: Tuple[float, float, float, float],
        backbone: str = "efficientnet_b0",
        feat_dim: int = 1280,
        out_index: int = 2,
        bev_proj_ch: int = 128,
        default_box_wh: Tuple[float, float] = (0.6, 0.6),
        head_mid1: int = 512,
        head_mid2: int = 128,
        freeze_backbone: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.views, self.bev_size, self.bev_bounds = views, bev_size, bev_bounds
        self.freeze_backbone = freeze_backbone
        self.dtype = dtype
        self.encoder = ViewEncoder(
            backbone, feat_dim=feat_dim, out_index=out_index, dtype=dtype, fold_proj=True
        )
        self.view_proj = nn.Parameter(torch.empty(views, feat_dim, bev_proj_ch))
        self.view_proj_bias = nn.Parameter(torch.zeros(bev_proj_ch))
        self.detector = BEVDetectorHead(
            bev_proj_ch + POS_CH, bev_bounds, bev_size, default_box_wh,
            head_mid1, head_mid2, dtype,
        )
        # the kernels the model runs; a check may swap in warp_tiles_ref
        # and grouped_cuda.PLAIN, their plain versions
        self.warp = warp_tiles
        self.grouped = KERNELS

    @classmethod
    def from_config(cls, cfg: Config) -> "BEVNet":
        m = cfg.model
        if m.fusion != "concat" or m.warp_impl != "pallas":
            raise NotImplementedError(
                f"FUSION={m.fusion!r} WARP_IMPL={m.warp_impl!r}: the port runs concat "
                "fusion through the warp kernel (WARP_IMPL pallas) only; the other "
                "fusions are ROADMAP Queue 1, 'Fusions'"
            )
        if not m.static_cameras:
            raise NotImplementedError(
                "STATIC_CAMERAS false is ROADMAP Queue 1, 'Per-frame cameras'"
            )
        return cls(
            views=cfg.data.views,
            bev_size=m.bev_size,
            bev_bounds=m.bev_bounds,
            backbone=m.backbone,
            feat_dim=m.feat_dim,
            out_index=m.out_index,
            bev_proj_ch=m.bev_proj_ch,
            default_box_wh=cfg.loss.default_box_wh,
            head_mid1=m.head_mid1,
            head_mid2=m.head_mid2,
            freeze_backbone=cfg.train.freeze_backbone,
            dtype=torch.bfloat16 if cfg.runtime.use_amp else torch.float32,
        )

    def train(self, mode: bool = True) -> "BEVNet":
        """A frozen backbone stays in eval mode: its BatchNorm uses and
        keeps its running statistics."""
        super().train(mode)
        if self.freeze_backbone:
            self.encoder.backbone.train(False)
        return self

    def forward(self, images: torch.Tensor, K: torch.Tensor, Rt: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [B, V, H, W, 3] uint8 or float; K [B, V, 3, 3]; Rt
        [B, V, 4, 4] world->camera (frame 0's calibration serves the batch).
        Returns the head outputs [B, Hb, Wb, *] and 'bev_feat', float32."""
        B, V, H, W, _ = images.shape
        if V != self.views:
            raise ValueError(f"model built for {self.views} views, got {V}")
        Hb, Wb = self.bev_size
        dev = images.device
        if images.dtype == torch.uint8:
            mean = torch.as_tensor(IMAGENET_MEAN, device=dev) * 255.0
            scale = 1.0 / (torch.as_tensor(IMAGENET_STD, device=dev) * 255.0)
            images = (images.float() - mean) * scale

        feats, enc_pk, enc_pb = self.encoder(images)
        if self.freeze_backbone:
            feats = feats.detach()
        _, _, Hf, Wf, _ = feats.shape
        grid = ground_grid(Hb, Wb, self.bev_bounds, device=dev)
        coords, _ = bev_sample_coords_with_depth(K[0], Rt[0], (H, W), (Hf, Wf), grid)

        # fold the encoder proj into the view projection: warp C_raw + 1
        # channels (the ones channel carries the encoder proj bias)
        composite = torch.einsum("cf,vfo->vco", enc_pk.float(), self.view_proj)
        pre_bias = torch.einsum("f,vfo->vo", enc_pb.float(), self.view_proj)
        kernel = torch.cat([composite, pre_bias[:, None, :]], dim=1)
        ones = torch.ones(feats.shape[:-1] + (1,), dtype=feats.dtype, device=dev)
        feats = torch.cat([feats, ones], dim=-1)
        if torch.is_grad_enabled():
            bev_main = FusedWarpProj.apply(
                feats, coords, kernel, self.view_proj_bias, self.dtype, self.warp, self.grouped
            )
        else:
            bev_main = fused_warp_proj_cuda(
                feats, coords, kernel, self.view_proj_bias, self.dtype, warp=self.warp
            )

        pos = positional_encoding(Hb, Wb, self.bev_bounds, device=dev)
        pos = pos[None].expand(B, Hb, Wb, POS_CH).to(bev_main.dtype)
        bev_feat = torch.cat([bev_main, pos], dim=-1)
        out = self.detector(bev_feat)
        out["bev_feat"] = bev_feat.float()
        return out

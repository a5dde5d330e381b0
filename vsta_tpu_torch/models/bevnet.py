"""BEVNet: encoder -> cross-view fusion onto the BEV grid -> positional
encoding -> CenterNet head.

The port carries the fusions of the JAX package, each with static cameras
(``STATIC_CAMERAS: true``: frame 0's calibration serves the batch) and with
per-frame cameras (every frame warps under its own ``K``, ``Rt``):

* ``FUSION: concat`` with ``WARP_IMPL: pallas`` (the flagship). The
  encoder's 1x1 projection is folded into the per-view projection (a ones
  channel carries its bias), and
  :func:`~vsta_tpu_torch.ops.warp_cuda.fused_warp_proj_cuda` runs the warp
  kernel (``warp_tiles`` for static cameras, ``warp_views_sum`` for
  per-frame ones); with autograd on,
  :class:`~vsta_tpu_torch.ops.warp_cuda.FusedWarpProj` runs it with its
  backward.
* ``FUSION: concat`` with ``WARP_IMPL: fused``: the same folded projection
  through the differentiable
  :func:`~vsta_tpu_torch.ops.warp_cuda.fused_warp_proj` (the grouped
  sampler) in serving and training, as the JAX package runs it off the TPU
  kernel path.
* ``FUSION: deform_attn``. A warped-sum query
  (:func:`~vsta_tpu_torch.ops.warp_cuda.fused_warp_proj` through the
  grouped sampler, in serving and training) is refined by
  :class:`~vsta_tpu_torch.models.fusion.DeformableFusion` on a query grid
  strided by ``ATTN_STRIDE``, whose residual is upsampled bilinearly in
  f32 (:func:`~vsta_tpu_torch.ops.resize.resize_bilinear`) and added.
* The unfused fusions, on the per-view BEV maps of
  :func:`~vsta_tpu_torch.ops.grouped_cuda.warp_views` (the encoder's
  projection applied): ``concat`` with ``WARP_IMPL: gather`` (the per-view
  projection as one einsum), ``sum`` / ``mean`` / ``max``
  (:func:`~vsta_tpu_torch.models.fusion.simple_fusion`) and ``attn``
  (:class:`~vsta_tpu_torch.models.fusion.AttentionFusion`), the last four
  followed by the 1x1 ``bev_proj``.
* MVDet (``HEAD: mvdet``, Hou et al., arXiv:2007.07247): the encoder
  without its projection (a ResNet whose last stages may be dilated), every
  view's map resized bilinearly to ``FEAT_SIZE`` (``F.interpolate``,
  half-pixel, as MVDet's upsample), warped by
  :func:`~vsta_tpu_torch.ops.grouped_cuda.warp_views`, the views' BEV maps
  concatenated in camera order, then
  :class:`~vsta_tpu_torch.models.heads.MVDetHead` (which adds its own
  coordinate channels) in place of the positional encoding and the
  CenterNet head. ``FUSION`` is concat and ``WARP_IMPL`` gather there. It
  serves; training it raises ``NotImplementedError``.

Inputs and outputs are channels-last, as in the JAX package. The
forward marks its stages on the device (:func:`~vsta_tpu_torch.utils.tracing.mark`):
``encoder`` (the normalization and the encoder), ``fusion`` (the
resize, the geometry, the warp or fusion and the positional channels or
the views' concatenation), ``head``.
``TRAIN.FREEZE_BACKBONE`` keeps the backbone in eval mode and cuts the
gradient at the encoder's output.

On a sharded :class:`~vsta_tpu_torch.parallel.mesh.Mesh` (``mesh=``) each
rank takes its slice of the batch and of the views, and partitions the
model as JAX's compiled mesh program does: the images (and the
calibrations) are gathered over 'view', so every rank runs the encoder on
all the views of its frames; concat under the fused warps, and the
deformable fusion's warped query, warp this rank's views and sum them
over 'view' (:func:`~vsta_tpu_torch.parallel.warp_shard.warp_proj_sharded`:
the one sum split over 'view'); every other reduction over the views
(the unfused fusions, the deformable fusion's softmax over (view, point)
and its value maps) runs on every view on every rank; train-mode
BatchNorm takes its statistics over 'data' (a data group's view ranks
hold the same images); static cameras take the global frame 0's
calibration.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..config import Config
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..geometry import bev_sample_coords_with_depth, ground_grid
from ..ops.grouped_cuda import KERNELS, warp_views
from ..ops.quant import apply_quant_head
from ..ops.resize import resize_bilinear
from ..ops.warp_cuda import fused_warp_proj, warp_proj, warp_tiles
from ..ops.warp_views_cuda import warp_views_sum
from ..parallel.collectives import gather
from ..parallel.mesh import ACTIVE, get_active_mesh
from ..parallel.warp_shard import warp_proj_sharded
from ..utils import tracing
from .encoders.encoder import ViewEncoder
from .encoders.norm import BatchNorm
from .fusion import AttentionFusion, DeformableFusion, Dense, simple_fusion
from .heads import BEVDetectorHead, MVDetHead

POS_CH = 2
RESIZE_ELEMENTS = 2**31 - 1  # CUDA's channels-last bilinear resize writes fewer elements a call
FUSIONS = ("concat", "deform_attn", "sum", "mean", "max", "attn")
WARP_IMPLS = ("pallas", "fused", "gather")


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
    """Construct with :meth:`from_config`; ``forward(images, K, Rt)``.
    ``mesh``: the mesh the model runs under (None: one device)."""

    def __init__(
        self,
        views: int,
        bev_size: Tuple[int, int],
        bev_bounds: Tuple[float, float, float, float],
        backbone: str = "efficientnet_b0",
        feat_dim: int = 1280,
        out_index: Union[int, Tuple[int, ...]] = 2,
        bev_proj_ch: int = 128,
        default_box_wh: Tuple[float, float] = (0.6, 0.6),
        head_mid1: int = 512,
        head_mid2: int = 128,
        freeze_backbone: bool = False,
        dtype: torch.dtype = torch.float32,
        fusion: str = "concat",
        attn_heads: int = 4,
        attn_points: int = 4,
        attn_stride: int = 4,
        warp_impl: str = "pallas",
        static_cameras: bool = True,
        norm: str = "batch",
        dilation: Tuple[bool, bool, bool] = (False, False, False),
        feat_size: Tuple[int, int] = (0, 0),
        head: str = "centernet",
        mesh=None,
    ):
        super().__init__()
        if fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}: one of {FUSIONS}")
        if warp_impl not in WARP_IMPLS:
            raise ValueError(f"unknown warp_impl {warp_impl!r}: one of {WARP_IMPLS}")
        self.views, self.bev_size, self.bev_bounds = views, bev_size, bev_bounds
        self.mesh = mesh
        # the collectives run only on a mesh of more than one rank; a 1x1
        # mesh is the single-device model
        self.sharded = mesh is not None and mesh.size > 1
        self.local_views = mesh.local_views(views) if self.sharded else views
        self.freeze_backbone = freeze_backbone
        self.dtype = dtype
        self.fusion, self.attn_stride = fusion, max(1, attn_stride)
        self.warp_impl, self.static_cameras = warp_impl, static_cameras
        self.head = head
        # the size MVDet's maps are resized to before the warp (None: none)
        self.feat_size = tuple(feat_size) if any(feat_size) else None
        # concat under the fused warps folds the encoder's projection into
        # the view projection; every other fusion works on the projected maps
        self.fold_proj = head != "mvdet" and fusion == "concat" and warp_impl in ("fused", "pallas")
        self.encoder = ViewEncoder(
            backbone, feat_dim=feat_dim, out_index=out_index, dtype=dtype, fold_proj=self.fold_proj, norm=norm,
            proj=head != "mvdet", dilation=dilation,
        )
        if head == "mvdet":
            self.detector = MVDetHead(
                views * feat_dim + POS_CH, bev_bounds, bev_size, default_box_wh, head_mid1, head_mid2, dtype
            )
        elif fusion == "concat":
            self.view_proj = nn.Parameter(torch.empty(views, feat_dim, bev_proj_ch))
            self.view_proj_bias = nn.Parameter(torch.zeros(bev_proj_ch))
        elif fusion == "deform_attn":
            self.query_proj = nn.Parameter(torch.empty(views, feat_dim, bev_proj_ch))
            self.query_proj_bias = nn.Parameter(torch.zeros(bev_proj_ch))
            self.deform_fusion = DeformableFusion(
                views, feat_dim, bev_proj_ch + POS_CH, attn_heads, attn_points, bev_proj_ch, dtype
            )
        else:
            if fusion == "attn":
                self.attn_fusion = AttentionFusion(feat_dim, dtype=dtype)
            self.bev_proj = Dense(feat_dim, bev_proj_ch)  # the 1x1 convolution
        if head != "mvdet":
            self.detector = BEVDetectorHead(
                bev_proj_ch + POS_CH, bev_bounds, bev_size, default_box_wh,
                head_mid1, head_mid2, dtype,
            )
        # the kernels the model runs (concat/pallas: a warp kernel, warp
        # for static cameras and views_sum for per-frame ones, and the
        # grouped sampler in its backward; every other path: the grouped
        # sampler alone); a check may swap in warp_tiles_ref,
        # warp_views_sum_ref and grouped_cuda.PLAIN, their plain versions
        self.warp = warp_tiles
        self.views_sum = warp_views_sum
        self.grouped = KERNELS
        # the uint8 path's normalization, as buffers: built once, moved with
        # the model, so a request copies nothing from the host
        mean = torch.as_tensor(IMAGENET_MEAN) * 255.0
        self.register_buffer("img_mean", mean, persistent=False)
        self.register_buffer("img_scale", 1.0 / (torch.as_tensor(IMAGENET_STD) * 255.0), persistent=False)
        if self.sharded:  # train-mode statistics over 'data'
            for mod in self.encoder.modules():
                if isinstance(mod, BatchNorm):
                    mod.mesh = mesh

    @classmethod
    def from_config(cls, cfg: Config, mesh=None) -> "BEVNet":
        """``mesh``: the mesh to run under (``parallel.make_mesh``), None
        for one device, or ``parallel.ACTIVE`` for the registered one."""
        if mesh is ACTIVE:
            mesh = get_active_mesh()
        m = cfg.model
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
            fusion=m.fusion,
            attn_heads=m.attn_heads,
            attn_points=m.attn_points,
            attn_stride=m.attn_stride,
            warp_impl=m.warp_impl,
            static_cameras=m.static_cameras,
            norm=m.norm,
            dilation=m.dilation,
            feat_size=m.feat_size,
            head=m.head,
            mesh=mesh,
        )

    def train(self, mode: bool = True) -> "BEVNet":
        """A frozen backbone stays in eval mode: its BatchNorm uses and
        keeps its running statistics."""
        super().train(mode)
        if self.freeze_backbone:
            self.encoder.backbone.train(False)
        return self

    def forward(
        self, images: torch.Tensor, K: torch.Tensor, Rt: torch.Tensor, return_per_view: bool = False,
        quant_head: Optional[Dict] = None, quant_encoder: Optional[Dict] = None,
    ) -> Dict[str, torch.Tensor]:
        """images [B, V, H, W, 3] uint8 or float; K [B, V, 3, 3]; Rt
        [B, V, 4, 4] world->camera (with static cameras frame 0's calibration
        serves the batch; on a sharded mesh, this rank's frames and views).
        On a sharded mesh the images, K and Rt are gathered over 'view'
        first. Returns the head outputs [B, Hb, Wb, *] and 'bev_feat', float32
        (MVDet: the views' maps side by side, in the compute dtype);
        with ``return_per_view`` the unfused fusions and MVDet add every view's BEV map,
        'bev_per_view' [B, V, Hb, Wb, C], as the JAX package does.
        ``quant_head`` / ``quant_encoder``: int8 serving trees
        (:mod:`~vsta_tpu_torch.ops.quant`, :mod:`~vsta_tpu_torch.ops.quant_resnet`)
        on the model's device; that stage then runs in int8 in place of its
        float parameters (serving only)."""
        B, V, H, W, _ = images.shape
        if V != self.local_views:
            raise ValueError(f"model built for {self.local_views} views a rank, got {V}")
        if self.sharded:  # every view of this rank's frames, as JAX's program gathers them
            images, K, Rt = (gather(t, self.mesh, "view", 1) for t in (images, K, Rt))
        Hb, Wb = self.bev_size
        dev = images.device
        tracing.mark("encoder", images)
        if images.dtype == torch.uint8:
            images = (images.float() - self.img_mean) * self.img_scale

        if self.head == "mvdet" and (quant_head is not None or quant_encoder is not None):
            raise ValueError("HEAD mvdet serves in its float dtype: no int8 head or encoder")
        if quant_encoder is not None:
            from ..ops.quant_resnet import apply_quant_encoder  # it imports the trunk's specs from models/

            if quant_encoder["fold_proj"] != self.fold_proj:
                raise ValueError(
                    "quant_encoder was calibrated for a different fold_proj contract than this model configuration"
                )
            enc_out = apply_quant_encoder(quant_encoder, images)
            if self.fold_proj:
                enc_out = (enc_out[0].to(self.dtype), enc_out[1], enc_out[2])
            else:
                enc_out = enc_out.to(self.dtype)
        else:
            enc_out = self.encoder(images)
        feats, enc_pk, enc_pb = enc_out if self.fold_proj else (enc_out, None, None)
        if self.freeze_backbone:
            feats = feats.detach()
        tracing.mark("fusion", feats)
        if self.feat_size is not None:
            feats = self.resize_views(feats)
        _, _, Hf, Wf, _ = feats.shape
        grid = ground_grid(Hb, Wb, self.bev_bounds, device=dev)
        if self.static_cameras:  # [V, Hb, Wb, ...]: one calibration for the batch
            K0, Rt0 = K[0], Rt[0]
            if self.sharded:  # the global frame 0's, from the first data rank
                K0, Rt0 = gather(K[:1], self.mesh, "data", 0)[0], gather(Rt[:1], self.mesh, "data", 0)[0]
            coords, depth_w = bev_sample_coords_with_depth(K0, Rt0, (H, W), (Hf, Wf), grid)
        else:  # [B, V, Hb, Wb, ...]
            coords, depth_w = bev_sample_coords_with_depth(K, Rt, (H, W), (Hf, Wf), grid)
        if self.head == "mvdet":
            return self._mvdet(feats, coords, return_per_view)
        pos = positional_encoding(Hb, Wb, self.bev_bounds, device=dev)
        pos = pos[None].expand(B, Hb, Wb, POS_CH)

        per_view = None
        if self.fusion == "deform_attn":
            bev_main = self._deform(feats, coords, depth_w, pos)
        elif self.fold_proj:
            bev_main = self._concat(feats, enc_pk, enc_pb, coords)
        else:
            per_view = self.per_view(feats, coords)
            bev_main = self.fuse_views(per_view)
        bev_feat = torch.cat([bev_main, pos.to(bev_main.dtype)], dim=-1)
        tracing.mark("head", bev_feat)
        if quant_head is not None:
            out = apply_quant_head(quant_head, bev_feat.float())
        else:
            out = self.detector(bev_feat)
        out["bev_feat"] = bev_feat.float()
        if return_per_view and per_view is not None:
            out["bev_per_view"] = per_view
        return out

    def resize_views(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [B, V, Hf, Wf, C] -> [B, V, *FEAT_SIZE, C]: MVDet's
        upsample, ``F.interpolate``'s bilinear with half-pixel centres, in
        the maps' dtype and channels-last memory. CUDA's channels-last
        kernel takes an output of fewer than :data:`RESIZE_ELEMENTS`, so the images
        are resized in as few equal runs as keep under that, each written
        in place into its slice of the one output. An ``out=`` call records
        no gradient, and MVDet serves only: a gradient wanted here raises
        ``NotImplementedError``, as training it does."""
        if torch.is_grad_enabled() and feats.requires_grad:
            raise NotImplementedError(
                "MODEL.HEAD mvdet serves only (under torch.no_grad): its resize records no gradient"
            )
        B, V, Hf, Wf, C = feats.shape
        H, W = self.feat_size
        x = feats.reshape(B * V, Hf, Wf, C).permute(0, 3, 1, 2)
        most = max(1, (RESIZE_ELEMENTS - 1) // (C * H * W))  # images a run may hold
        step = -(-(B * V) // -(-(B * V) // most))  # equal runs, as few as hold them
        y = torch.empty((B * V, H, W, C), dtype=x.dtype, device=x.device)
        for a in range(0, B * V, step):
            torch.ops.aten.upsample_bilinear2d.out(
                x[a:a + step], [H, W], False, None, None, out=y[a:a + step].permute(0, 3, 1, 2)
            )
        return y.reshape(B, V, H, W, C)

    def _mvdet(self, feats, coords, return_per_view: bool) -> Dict[str, torch.Tensor]:
        """The views' warps side by side, then MVDet's classifier."""
        per_view = self.per_view(feats, coords)
        B, V, Hb, Wb, C = per_view.shape
        bev_feat = per_view.permute(0, 2, 3, 1, 4).reshape(B, Hb, Wb, V * C)
        tracing.mark("head", bev_feat)
        out = self.detector(bev_feat)
        out["bev_feat"] = bev_feat
        if return_per_view:
            out["bev_per_view"] = per_view
        return out

    def _deform(self, feats, coords, depth_w, pos) -> torch.Tensor:
        """The warped-sum query plus the deformable fusion's residual."""
        query = self.warped_query(feats, coords)
        q_in = torch.cat([query, pos.to(query.dtype)], dim=-1)
        return query + self.attention_residual(feats, coords, depth_w, q_in)

    def warped_query(self, feats: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """feats [B, V, Hf, Wf, C], coords [V, Hb, Wb, 2] or
        [B, V, Hb, Wb, 2] -> the views' warped, projected sum [B, Hb, Wb, C_out], through the grouped
        sampler in serving and training alike."""
        if self.sharded:
            return warp_proj_sharded(
                feats, coords, self.query_proj, self.query_proj_bias, self.mesh, impl="fused",
                compute_dtype=self.dtype, grouped=self.grouped,
            )
        return fused_warp_proj(
            feats, coords, self.query_proj, self.query_proj_bias, self.dtype, grouped=self.grouped
        )

    def attention_residual(self, feats, coords, depth_w, q_in) -> torch.Tensor:
        """The deformable fusion on the query grid strided by
        ``attn_stride``, upsampled bilinearly in f32 to the BEV grid;
        q_in [B, Hb, Wb, C_out + 2] -> [B, Hb, Wb, C_out] in its dtype.
        Shared coordinates and depths are expanded over the batch; per-frame
        ones are taken as they come."""
        B = feats.shape[0]
        Hb, Wb = self.bev_size
        coords_b, depth_b = coords, depth_w
        if coords.ndim == 4:
            coords_b = coords[None].expand(B, *coords.shape)
            depth_b = depth_w[None].expand(B, *depth_w.shape)
        s = self.attn_stride
        q = q_in
        if s > 1:
            coords_b, depth_b, q = coords_b[:, :, ::s, ::s], depth_b[:, :, ::s, ::s], q_in[:, ::s, ::s]
        res = self.deform_fusion(feats, coords_b, q, depth_b, grouped=self.grouped)
        if s > 1:
            res = resize_bilinear(res.float().permute(0, 3, 1, 2), (Hb, Wb)).permute(0, 2, 3, 1).to(q_in.dtype)
        return res

    def _concat(self, feats, enc_pk, enc_pb, coords) -> torch.Tensor:
        """The warp + concat fusion + projection with the encoder's
        projection folded in (WARP_IMPL pallas: through a warp kernel;
        fused: through the grouped sampler)."""
        dev = feats.device
        # fold the encoder proj into the view projection: warp C_raw + 1
        # channels (the ones channel carries the encoder proj bias)
        composite = torch.einsum("cf,vfo->vco", enc_pk.float(), self.view_proj)
        pre_bias = torch.einsum("f,vfo->vo", enc_pb.float(), self.view_proj)
        kernel = torch.cat([composite, pre_bias[:, None, :]], dim=1)
        ones = torch.ones(feats.shape[:-1] + (1,), dtype=feats.dtype, device=dev)
        feats = torch.cat([feats, ones], dim=-1)
        if self.sharded:
            return warp_proj_sharded(
                feats, coords, kernel, self.view_proj_bias, self.mesh, impl=self.warp_impl,
                compute_dtype=self.dtype, warp=self.warp, grouped=self.grouped, views_sum=self.views_sum,
            )
        return warp_proj(
            feats, coords, kernel, self.view_proj_bias, self.dtype, impl=self.warp_impl, warp=self.warp,
            grouped=self.grouped, views_sum=self.views_sum,
        )

    def per_view(self, feats: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """feats [B, V, Hf, Wf, C] -> every view's BEV map
        [B, V, Hb, Wb, C]; shared coordinates are expanded over the batch."""
        if coords.ndim == 4:
            coords = coords[None].expand(feats.shape[0], *coords.shape)
        return warp_views(feats, coords, grouped=self.grouped)

    def fuse_views(self, per_view: torch.Tensor) -> torch.Tensor:
        """The unfused fusions on the per-view BEV maps
        [B, V, Hb, Wb, C] -> [B, Hb, Wb, C_out] in the compute dtype."""
        if self.fusion == "concat":  # the [V, C, C_out] parameters of the fused path
            out = torch.einsum("bvhwc,vco->bhwo", per_view.to(self.dtype), self.view_proj.to(self.dtype))
            return out + self.view_proj_bias.to(self.dtype)
        if self.fusion == "attn":
            coverage = per_view.abs().amax(dim=-1)
            fused = self.attn_fusion(per_view, coverage)
        else:
            fused = simple_fusion(per_view, self.fusion)
        return self.bev_proj(fused.to(self.dtype))

"""The BEV detection heads.

:class:`BEVDetectorHead`, CenterNet-style: a 3-conv stem (mid1 -> mid2 ->
mid2, middle conv dilation 2, each GroupNorm(32, eps 1e-5) + ReLU) and
three 3x3 output convs: a 1-channel heatmap, 2-channel offset and
2-channel size. :class:`MVDetHead`: MVDet's map classifier, an occupancy
map alone. Input and outputs are channels-last, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gn_act_cuda

HEATMAP_BIAS = -2.19
GN_GROUPS, GN_EPS = 32, 1e-5


class BEVDetectorHead(nn.Module):
    def __init__(
        self,
        in_ch: int,
        bev_bounds: Tuple[float, float, float, float],
        bev_size: Tuple[int, int],
        default_box_wh: Tuple[float, float] = (0.6, 0.6),
        mid1: int = 512,
        mid2: int = 128,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.bev_bounds, self.bev_size, self.default_box_wh = bev_bounds, bev_size, default_box_wh
        self.stem0 = nn.Conv2d(in_ch, mid1, 3, padding=1, bias=False)
        self.gn0 = nn.GroupNorm(GN_GROUPS, mid1, eps=GN_EPS)
        self.stem1 = nn.Conv2d(mid1, mid2, 3, padding=2, dilation=2, bias=False)
        self.gn1 = nn.GroupNorm(GN_GROUPS, mid2, eps=GN_EPS)
        self.stem2 = nn.Conv2d(mid2, mid2, 3, padding=1, bias=False)
        self.gn2 = nn.GroupNorm(GN_GROUPS, mid2, eps=GN_EPS)
        self.heatmap_head = nn.Conv2d(mid2, 1, 3, padding=1)
        self.offset_head = nn.Conv2d(mid2, 2, 3, padding=1)
        self.size_head = nn.Conv2d(mid2, 2, 3, padding=1)

    def size_bias(self) -> torch.Tensor:
        """log of the default footprint in cells: the size head's init bias."""
        x_min, x_max, y_min, y_max = self.bev_bounds
        res_x = (x_max - x_min) / float(self.bev_size[1])
        res_y = (y_max - y_min) / float(self.bev_size[0])
        w = max(self.default_box_wh[0] / max(res_x, 1e-6), 1e-3)
        h = max(self.default_box_wh[1] / max(res_y, 1e-6), 1e-3)
        return torch.tensor([math.log(w), math.log(h)], dtype=torch.float32)

    @torch.no_grad()
    def init_centernet_(self) -> None:
        """CenterNet init constants: heatmap bias -2.19, offset head 0,
        size bias log(default footprint in cells)."""
        self.heatmap_head.bias.fill_(HEATMAP_BIAS)
        self.offset_head.weight.zero_()
        self.offset_head.bias.zero_()
        self.size_head.bias.copy_(self.size_bias())

    def _conv(self, x, c: nn.Conv2d, dtype) -> torch.Tensor:
        b = None if c.bias is None else c.bias.to(dtype)
        return F.conv2d(x.to(dtype), c.weight.to(dtype), b, 1, c.padding, c.dilation)

    @staticmethod
    def fused(x: torch.Tensor, gn: nn.GroupNorm) -> bool:
        """Whether a GroupNorm and its ReLU take the one-pass kernel for x:
        the kernel takes x (:func:`~vsta_tpu_torch.ops.gn_act_cuda.takes`:
        bfloat16, channels-last, as the convolutions give a map of the
        channels-last input) and no gradient is wanted (grad mode off, or
        neither x nor the affine parameters require one)."""
        wants_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, gn.weight, gn.bias))
        return not wants_grad and gn_act_cuda.takes(x, gn.weight, gn.bias, gn.num_groups)

    def _gn_relu(self, x, gn: nn.GroupNorm) -> torch.Tensor:
        """GroupNorm in float32, cast to x's dtype, then the ReLU: one
        kernel (``ops/gn_act_cuda.py``) for a CUDA map that :meth:`fused`
        admits, the plain version for anything else."""
        args = (x, gn.weight, gn.bias, gn.num_groups, gn.eps, "relu")
        if x.is_cuda and self.fused(x, gn):
            return gn_act_cuda.gn_act(*args)
        return gn_act_cuda.gn_act_ref(*args)

    def forward(self, bev_feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """bev_feat [B, H, W, C] -> heads dict (channels-last, float32)."""
        d = self.dtype
        x = bev_feat.permute(0, 3, 1, 2)
        y = self._gn_relu(self._conv(x, self.stem0, d), self.gn0)
        y = self._gn_relu(self._conv(y, self.stem1, d), self.gn1)
        shared = self._gn_relu(self._conv(y, self.stem2, d), self.gn2)
        # the output convs keep Flax's default float32 (no dtype= in the
        # JAX head), so the bf16 stem output is promoted here
        f32 = torch.float32
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        hm = nhwc(self._conv(shared, self.heatmap_head, f32))
        off = nhwc(self._conv(shared, self.offset_head, f32))
        size = nhwc(self._conv(shared, self.size_head, f32))
        return {
            "heatmap_logits": hm,
            "heatmap": torch.sigmoid(hm),
            "offset_raw": off,
            "offset": torch.sigmoid(off),
            "size_raw": size,
            "size": torch.exp(size),
        }


def coord_map(bev_h: int, bev_w: int, device=None) -> torch.Tensor:
    """[1, 2, H, W] float32: MVDet's coordinate channels (its
    ``create_coord_map``), x then y, each linear from -1 to 1 across its
    axis, the ends included."""
    xs = (torch.arange(bev_w, dtype=torch.float64, device=device) / max(bev_w - 1, 1) * 2 - 1).float()
    ys = (torch.arange(bev_h, dtype=torch.float64, device=device) / max(bev_h - 1, 1) * 2 - 1).float()
    return torch.stack([xs[None, :].expand(bev_h, bev_w), ys[:, None].expand(bev_h, bev_w)])[None]


class MVDetHead(nn.Module):
    """MVDet's map classifier (Hou et al., arXiv:2007.07247;
    ``PerspTransDetector.map_classifier`` of hou-yz/MVDet) over the views'
    BEV maps side by side and two coordinate channels (:func:`coord_map`):
    a 3x3 convolution to ``mid1`` channels with bias and ReLU, a 3x3 of
    dilation 2 to ``mid2`` with bias and ReLU, and a 3x3 of dilation 4 to
    one channel, the occupancy logits.

    The coordinate channels are constant, so their share of the first
    convolution, with its bias, is computed once a call as a per-cell bias
    map (the convolution of the two channels alone, zero-padded as the
    whole one is, in float32), and the convolution itself reads the views'
    channels only: ``in_ch - 2`` of them, 3,584 for seven views of 512, a
    multiple of 8. Its weight keeps MVDet's ``in_ch`` inputs, the
    coordinates last.

    Where this departs from MVDet: the output convolution has one bias
    (MVDet's has none), which places the threshold on the sigmoid of the
    logits as training would; it runs in float32, as the CenterNet head's
    outputs do. MVDet regresses no offset or size, so ``offset`` is the
    cell's centre (0.5) and ``size`` the default footprint in cells,
    everywhere. The stem runs in the module's compute dtype.
    """

    def __init__(
        self,
        in_ch: int,
        bev_bounds: Tuple[float, float, float, float],
        bev_size: Tuple[int, int],
        default_box_wh: Tuple[float, float] = (0.6, 0.6),
        mid1: int = 512,
        mid2: int = 512,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.bev_bounds, self.bev_size, self.default_box_wh = bev_bounds, bev_size, default_box_wh
        self.stem0 = nn.Conv2d(in_ch, mid1, 3, padding=1)
        self.stem1 = nn.Conv2d(mid1, mid2, 3, padding=2, dilation=2)
        self.heatmap_head = nn.Conv2d(mid2, 1, 3, padding=4, dilation=4)

    def footprint(self) -> Tuple[float, float]:
        """The default footprint (w, h) in cells: every cell's ``size``."""
        x_min, x_max, y_min, y_max = self.bev_bounds
        return (self.default_box_wh[0] * self.bev_size[1] / (x_max - x_min),
                self.default_box_wh[1] * self.bev_size[0] / (y_max - y_min))

    @torch.no_grad()
    def init_centernet_(self) -> None:
        """The CenterNet head's heatmap bias, -2.19: a fresh model's
        scores start where the other head's do."""
        self.heatmap_head.bias.fill_(HEATMAP_BIAS)

    def coord_bias(self, bev_h: int, bev_w: int, device) -> torch.Tensor:
        """[1, mid1, H, W] float32: the first convolution over the
        coordinate channels alone, plus its bias."""
        w = self.stem0.weight[:, -2:].float()
        return F.conv2d(coord_map(bev_h, bev_w, device), w, self.stem0.bias.float(), 1, 1)

    def _conv(self, x, c: nn.Conv2d, dtype) -> torch.Tensor:
        b = None if c.bias is None else c.bias.to(dtype)
        return F.conv2d(x.to(dtype), c.weight.to(dtype), b, 1, c.padding, c.dilation)

    def forward(self, bev_feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """bev_feat [B, H, W, in_ch - 2] (the views' maps side by side, in
        camera order) -> 'heatmap_logits', 'heatmap', 'offset', 'size'
        [B, H, W, *], channels-last, float32."""
        d = self.dtype
        x = bev_feat.permute(0, 3, 1, 2)
        B, n, Hb, Wb = x.shape
        if n != self.stem0.in_channels - 2:
            raise ValueError(f"MVDetHead built for {self.stem0.in_channels - 2} map channels, got {n}")
        y = F.conv2d(x.to(d), self.stem0.weight[:, :n].to(d), None, 1, 1)
        y = F.relu(y + self.coord_bias(Hb, Wb, x.device).to(d))
        y = F.relu(self._conv(y, self.stem1, d))
        hm = self._conv(y, self.heatmap_head, torch.float32).permute(0, 2, 3, 1)
        fw, fh = self.footprint()
        return {
            "heatmap_logits": hm,
            "heatmap": torch.sigmoid(hm),
            "offset": hm.new_full((B, Hb, Wb, 2), 0.5),
            "size": torch.stack([hm.new_full((B, Hb, Wb), fw), hm.new_full((B, Hb, Wb), fh)], dim=-1),
        }

"""CenterNet-style BEV detection head.

A 3-conv stem (mid1 -> mid2 -> mid2, middle conv dilation 2, each
GroupNorm(32, eps 1e-5) + ReLU) and three 3x3 output convs: a 1-channel
heatmap, 2-channel offset and 2-channel size. Input and outputs are
channels-last, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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

    def _gn(self, x, gn: nn.GroupNorm) -> torch.Tensor:
        return F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias, gn.eps).to(x.dtype)

    def forward(self, bev_feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """bev_feat [B, H, W, C] -> heads dict (channels-last, float32)."""
        d = self.dtype
        x = bev_feat.permute(0, 3, 1, 2)
        y = F.relu(self._gn(self._conv(x, self.stem0, d), self.gn0))
        y = F.relu(self._gn(self._conv(y, self.stem1, d), self.gn1))
        shared = F.relu(self._gn(self._conv(y, self.stem2, d), self.gn2))
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

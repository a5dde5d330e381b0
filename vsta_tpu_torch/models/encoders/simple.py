"""The minimal convolutional backbone (stride 4), the twin of
``vsta_tpu/models/encoders/simple.py``: two stride-2 3x3 convolutions with
symmetric padding (1, 1), each followed by ReLU, 16 then ``out_channels``
(= ``MODEL.FEAT_DIM``) channels. Its one level is returned five times so
that any ``OUT_INDEX`` resolves. Parameters are float32; the convolutions
run in the module's compute dtype.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn


class SimpleConvFeatures(nn.Module):
    def __init__(self, out_channels: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv2d(3, 16, 3, 2, 1)
        self.conv1 = nn.Conv2d(16, out_channels, 3, 2, 1)

    def forward(self, x: torch.Tensor, levels: int = 5) -> List[torch.Tensor]:
        """x [N, 3, H, W] -> ``levels`` copies of the stride-4 map (NCHW)."""
        y = x.to(self.dtype)
        for c in (self.conv0, self.conv1):
            y = F.relu(F.conv2d(y, c.weight.to(y.dtype), c.bias.to(y.dtype), 2, 1))
        return [y] * levels

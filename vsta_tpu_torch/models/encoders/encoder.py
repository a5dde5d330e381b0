"""Per-view encoder: one shared backbone over all B*V images + 1x1 proj.

images [B, V, H, W, 3] (NHWC, as the JAX package) -> [B, V, Hf, Wf, F].
The backbone is EfficientNet-B0 or ``simple`` (two stride-2 convolutions
of ``FEAT_DIM`` channels, the reference's fallback); the ResNets raise.
``norm`` is MODEL.NORM: both take ``'batch'`` only, and any other value
raises ``ValueError`` as the JAX package does. With
``fold_proj`` the 1x1 projection is not applied: the encoder returns
the raw pyramid map with the projection's kernel [C_raw, F] and bias [F],
for the caller to fold into the next linear op. Internally the maps are
NCHW tensors in channels-last memory, so the NHWC views are free.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from .efficientnet import EfficientNetFeatures, conv
from .simple import SimpleConvFeatures

# pyramid channels of EfficientNet-B0 (timm feature_info order)
B0_CHANNELS = (16, 24, 40, 112, 320)


class ViewEncoder(nn.Module):
    def __init__(
        self,
        backbone: str = "efficientnet_b0",
        feat_dim: int = 1280,
        out_index: int = 2,
        dtype: torch.dtype = torch.float32,
        fold_proj: bool = False,
        norm: str = "batch",
    ):
        super().__init__()
        if backbone not in ("efficientnet_b0", "simple"):
            raise NotImplementedError(
                f"backbone {backbone!r}: the port has efficientnet_b0 and simple; the "
                "others are ROADMAP Queue 1 item 2, 'Other backbones'"
            )
        if norm != "batch":  # as the reference's build_backbone: only ResNets take another norm
            raise ValueError(
                f"MODEL.NORM={norm!r} is only supported for resnet backbones "
                f"(got backbone={backbone!r})"
            )
        if not isinstance(out_index, int):
            raise NotImplementedError(
                "multi-scale OUT_INDEX tuples are ROADMAP Queue 1 item 2, 'Multi-scale out_index'"
            )
        self.out_index = out_index
        self.fold_proj = fold_proj
        if backbone == "simple":  # sized by FEAT_DIM, as the reference's fallback stack
            self.backbone = SimpleConvFeatures(feat_dim, dtype)
            raw_channels = feat_dim
        else:
            self.backbone = EfficientNetFeatures(dtype)
            raw_channels = B0_CHANNELS[out_index]
        self.proj = nn.Conv2d(raw_channels, feat_dim, 1)

    def forward(
        self, images: torch.Tensor
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        B, V, H, W, C = images.shape
        x = images.reshape(B * V, H, W, C).permute(0, 3, 1, 2)
        feat = self.backbone(x, self.out_index + 1)[self.out_index]
        if self.fold_proj:
            kernel = self.proj.weight[:, :, 0, 0].t()
            nhwc = feat.permute(0, 2, 3, 1)
            return nhwc.reshape((B, V) + nhwc.shape[1:]), kernel, self.proj.bias
        nhwc = conv(feat, self.proj).permute(0, 2, 3, 1)
        return nhwc.reshape((B, V) + nhwc.shape[1:])

"""Per-view encoder: one shared backbone over all B*V images + 1x1 proj.

images [B, V, H, W, 3] (NHWC, as the JAX package) -> [B, V, Hf, Wf, F].
:func:`build_backbone` takes every name the JAX package does: the ResNets
(18/34/50/101), EfficientNet-B0 and ``simple`` (two stride-2 convolutions
of ``FEAT_DIM`` channels, the reference's fallback). ``norm`` is
MODEL.NORM: ``'group'`` is for the ResNets only, and on any other backbone
it raises ``ValueError`` as the JAX package does.

``out_index`` picks one pyramid level, or a tuple of levels: then the
coarser maps are resized bilinearly to the finest selected one
(:func:`~vsta_tpu_torch.ops.resize.resize_bilinear`, as
``jax.image.resize``) and the channels concatenated before the 1x1
projection. With ``fold_proj`` the projection is not applied: the encoder
returns the raw map with the projection's kernel [C_raw, F] and bias [F],
for the caller to fold into the next linear op. With ``proj`` False there
is no projection (MVDet's encoder): the selected level is the output, and
``feat_dim`` must be its channels. ``dilation`` (the ResNets only) is
:class:`~vsta_tpu_torch.models.encoders.resnet.ResNetFeatures`'. Internally
the maps are NCHW tensors in channels-last memory, so the NHWC views are
free.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from ...ops.resize import resize_bilinear
from .efficientnet import EfficientNetFeatures, conv
from .resnet import RESNET_SPECS, ResNetFeatures, resnet_channels
from .simple import SimpleConvFeatures

# pyramid channels of EfficientNet-B0 (timm feature_info order)
B0_CHANNELS = (16, 24, 40, 112, 320)


def build_backbone(
    name: str, dtype: torch.dtype = torch.float32, feat_dim: int = 32, norm: str = "batch",
    dilation: Tuple[bool, bool, bool] = (False, False, False),
) -> nn.Module:
    if name in RESNET_SPECS:
        return ResNetFeatures(name, dtype, norm, dilation)
    if any(dilation):
        raise ValueError(f"dilation is for the resnet backbones, not {name!r}")
    if norm != "batch":
        raise ValueError(
            f"MODEL.NORM={norm!r} is only supported for resnet backbones "
            f"(got backbone={name!r})"
        )
    if name.startswith("efficientnet"):
        return EfficientNetFeatures(dtype)
    # the reference's fallback stack is sized by FEAT_DIM directly
    return SimpleConvFeatures(feat_dim, dtype)


def pyramid_channels(name: str, feat_dim: int) -> Tuple[int, ...]:
    """Channels of the five levels of :func:`build_backbone`'s pyramid."""
    if name in RESNET_SPECS:
        return resnet_channels(name)
    return B0_CHANNELS if name.startswith("efficientnet") else (feat_dim,) * 5


class ViewEncoder(nn.Module):
    def __init__(
        self,
        backbone: str = "efficientnet_b0",
        feat_dim: int = 1280,
        out_index: Union[int, Sequence[int]] = 2,
        dtype: torch.dtype = torch.float32,
        fold_proj: bool = False,
        norm: str = "batch",
        proj: bool = True,
        dilation: Tuple[bool, bool, bool] = (False, False, False),
    ):
        super().__init__()
        self.levels = tuple(out_index) if isinstance(out_index, (tuple, list)) else (out_index,)
        self.fold_proj = fold_proj
        self.backbone = build_backbone(backbone, dtype, feat_dim, norm, dilation)
        channels = sum(pyramid_channels(backbone, feat_dim)[i] for i in self.levels)
        if proj:
            self.proj = nn.Conv2d(channels, feat_dim, 1)
        elif fold_proj or channels != feat_dim:
            raise ValueError(f"an encoder without its projection returns the trunk's {channels} channels "
                             f"as they are: FEAT_DIM must be {channels}, got {feat_dim}, and nothing to fold")
        else:
            self.proj = None

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, 3, H, W] -> the selected level, or the selected levels at
        the finest one's size, channels concatenated (NCHW)."""
        pyramid = self.backbone(x, max(self.levels) + 1)
        feats = [pyramid[i] for i in self.levels]
        if len(feats) == 1:
            return feats[0]
        size = (max(f.shape[2] for f in feats), max(f.shape[3] for f in feats))
        return torch.cat([resize_bilinear(f, size) for f in feats], dim=1)

    def forward(
        self, images: torch.Tensor
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        B, V, H, W, C = images.shape
        x = images.reshape(B * V, H, W, C).permute(0, 3, 1, 2)
        feat = self.features(x)
        if self.fold_proj:
            kernel = self.proj.weight[:, :, 0, 0].t()
            nhwc = feat.permute(0, 2, 3, 1)
            return nhwc.reshape((B, V) + nhwc.shape[1:]), kernel, self.proj.bias
        if self.proj is not None:
            feat = conv(feat, self.proj)
        nhwc = feat.permute(0, 2, 3, 1)
        return nhwc.reshape((B, V) + nhwc.shape[1:])

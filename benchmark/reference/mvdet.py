"""Plain PyTorch reference of MVDet (Hou, Zheng and Gould, "Multiview
Detection with Feature Perspective Transformation", ECCV 2020,
arXiv:2007.07247; ``PerspTransDetector`` of github.com/hou-yz/MVDet with
``arch='resnet18'``).

Per frame set of V views:

1. The trunk: ResNet-18 built with ``replace_stride_with_dilation=[False,
   True, True]`` and cut before its average pool. The stride schedule is 2
   (the 7x7 stem), 2 (the max-pool), 1 (layer1), 2 (layer2), then 1 and 1
   (layer3 and layer4, dilated): stride 8, 512 channels. As torchvision's
   ``_make_layer`` builds it, the first block of a dilated stage keeps the
   dilation before it and the later ones take the new one, so layer3's
   blocks are dilated 1 then 2 and layer4's 2 then 4; both 3x3s of a basic
   block take the block's dilation, padded by it; the residual projection
   is a 1x1 of stride 1 and a BatchNorm. No projection follows: the 512
   channels go on as they are. It is ``resnet.py``'s trunk with that
   schedule (``MODEL.DILATION``), its weights under the same names.
2. Each view's map resized to ``FEAT_SIZE`` by ``F.interpolate``, bilinear,
   ``align_corners`` False (MVDet's upsample to a quarter of 1080 x 1920).
3. Each view's resized map warped onto the ground grid: bilinear, zero
   outside the image, at the cells' centres (``model.project_cells``).
4. The views' warps side by side in camera order, then two coordinate
   channels, x then y, each linear from -1 to 1 across its axis:
   V * 512 + 2 channels.
5. The map classifier: a 3x3 convolution to ``HEAD_MID1`` with bias and
   ReLU, a 3x3 of dilation 2 to ``HEAD_MID2`` with bias and ReLU, a 3x3 of
   dilation 4 to one channel with one bias (MVDet's has none: the bias sets
   the threshold, as ``harness/inputs.calibrate`` does for every head).

The heatmap is the sigmoid of that map; MVDet regresses no offset or size,
so the offset is the cell's centre (0.5) and the size the default
footprint (``LOSS.DEFAULT_BOX_WH``) in cells, everywhere. The views are
resized and warped one at a time, as MVDet loops over its cameras, so that
a block of frame sets holds one view's resized map at a time. Float32, TF32
off; it imports nothing of the program. There is no training reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import resnet
from .model import bilinear, normalise, project_cells, tf32_off  # noqa: F401 (the contract: model.py's, unchanged)
from .precision import exact

UNDILATED = (False, False, False)


def dilated_blocks(variant: str, dilate=UNDILATED):
    """``resnet.blocks`` under torchvision's ``replace_stride_with_dilation``
    for stages 2 to 4: (prefix, stage, convs as (in, out, kernel, stride,
    dilation), projected) of every block, in order."""
    out, rate, first, dilated = [], 1, 1, False
    for p, stage, convs, projected in resnet.blocks(variant):
        if p.endswith(".0."):  # a stage's first block
            first, dilated = rate, stage > 0 and bool(dilate[stage - 1])
            if dilated:
                rate *= 2
        d = first if p.endswith(".0.") else rate
        out.append((p, stage, [(i, o, k, 1 if dilated else s, d if k == 3 else 1) for i, o, k, s in convs],
                    projected))
    return out


def param_specs(m: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight: the trunk's entries of
    ``resnet.param_specs`` (the stem and every block, every stage), then
    the map classifier's, under the program's names."""
    specs = [s for s in resnet.param_specs(m) if s[0].startswith("encoder.backbone.")]
    mid1, mid2 = m["HEAD_MID1"], m["HEAD_MID2"]
    cin = m["VIEWS"] * m["FEAT_DIM"] + 2
    for name, cout, kin in (("stem0", mid1, cin), ("stem1", mid2, mid1)):
        specs += [(f"detector.{name}.weight", (cout, kin, 3, 3), "conv"), (f"detector.{name}.bias", (cout,), "bias")]
    return specs + [("detector.heatmap_head.weight", (1, mid2, 3, 3), "heatmap_w"),
                    ("detector.heatmap_head.bias", (1,), "heatmap_head")]


def coord_map(Hb: int, Wb: int, device) -> torch.Tensor:
    """[Hb, Wb, 2]: MVDet's ``create_coord_map``, x then y, each
    ``arange(n) / (n - 1) * 2 - 1`` in float64, then float32."""
    xs = (torch.arange(Wb, dtype=torch.float64, device=device) / max(Wb - 1, 1) * 2 - 1).float()
    ys = (torch.arange(Hb, dtype=torch.float64, device=device) / max(Hb - 1, 1) * 2 - 1).float()
    return torch.stack([xs[None, :].expand(Hb, Wb), ys[:, None].expand(Hb, Wb)], dim=-1)


class Trunk(resnet.Trunk):
    """The ResNet up to pyramid level ``level`` under ``dilate``, with no
    projection after it. ``train``: BatchNorm from the batch."""

    def __init__(self, w, variant: str, level: int, dilate=UNDILATED, q=exact, train: bool = False, stats=None):
        super().__init__(w, variant, level, q, train, stats)
        self.dilate = dilate

    def conv(self, x, name, stride=1, bias=None, dilation=1):
        wt = self.w[name]
        b = None if bias is None else self.w[bias]
        return F.conv2d(self.q(x), self.q(wt), b, stride, dilation * (wt.shape[-1] // 2), dilation)

    def block(self, x, p, convs, projected):
        n_main = len(convs) - projected
        y = x
        for k in range(n_main):
            y = self.bn(self.conv(y, f"{p}convs.{k}.weight", convs[k][3], dilation=convs[k][4]), f"{p}norms.{k}.")
            if k < n_main - 1:
                y = F.relu(y)
        if projected:
            x = self.bn(self.conv(x, f"{p}convs.{n_main}.weight", convs[n_main][3]), f"{p}norms.{n_main}.")
        return F.relu(y + x)

    def __call__(self, x):
        """x [N, 3, H, W] normalised -> the level [N, C, h, w]."""
        y = F.relu(self.bn(self.conv(x, "encoder.backbone.stem_conv.weight", 2), "encoder.backbone.stem_bn."))
        if self.level > 0:
            y = F.max_pool2d(y, 3, 2, 1)
            for p, stage, convs, projected in dilated_blocks(self.variant, self.dilate):
                if stage == self.level:
                    break
                y = self.block(y, p, convs, projected)
        return y


class Reference(resnet.Reference):
    """MVDet on ``MODEL.BACKBONE`` (a ResNet) under ``MODEL.DILATION``."""

    def __init__(self, cfg: Dict, weights, q=exact):
        super().__init__(cfg, weights, q)
        m = cfg["MODEL"]
        self.dilate = tuple(m.get("DILATION", UNDILATED))
        self.feat_size = tuple(m["FEAT_SIZE"])
        self.box_wh = tuple(cfg["LOSS"]["DEFAULT_BOX_WH"])

    def feature_hw(self) -> Tuple[int, int]:
        """The size of the maps the warp samples: ``FEAT_SIZE``."""
        return self.feat_size

    def trunk(self, train: bool = False, stats=None) -> Trunk:
        return Trunk(self.w, self.variant, self.level, self.dilate, self.q, train, stats)

    def warp_views(self, feats, K, Rt) -> torch.Tensor:
        """feats [B, V, h, w, C] -> every view's map resized and warped,
        side by side in camera order: [B, Hb, Wb, V * C]."""
        B, V, _, _, C = feats.shape
        Hb, Wb = self.bev_hw
        fh, fw = self.feature_hw()
        coords, _ = project_cells(K, Rt, self.img_hw, (fh, fw), Hb, Wb, self.bounds)
        out = []
        for v in range(V):
            up = F.interpolate(feats[:, v].permute(0, 3, 1, 2), size=(fh, fw), mode="bilinear", align_corners=False)
            s = bilinear(self.q(up.permute(0, 2, 3, 1)), coords[:, v].reshape(B, Hb * Wb, 2))
            out.append(s.reshape(B, Hb, Wb, C))
        return torch.cat(out, dim=-1)

    def head(self, bev: torch.Tensor) -> Dict[str, torch.Tensor]:
        """bev [B, Hb, Wb, V * C + 2] -> the logits and maps, channels-last."""
        w, q = self.w, self.q
        x = bev.permute(0, 3, 1, 2)
        for name, dil in (("stem0", 1), ("stem1", 2)):
            x = F.relu(F.conv2d(q(x), q(w[f"detector.{name}.weight"]), w[f"detector.{name}.bias"], 1, dil, dil))
        y = F.conv2d(q(x), q(w["detector.heatmap_head.weight"]), w["detector.heatmap_head.bias"], 1, 4, 4)
        logits = y.permute(0, 2, 3, 1)
        B, Hb, Wb, _ = logits.shape
        x_min, x_max, y_min, y_max = self.bounds
        cells = torch.tensor([self.box_wh[0] * Wb / (x_max - x_min), self.box_wh[1] * Hb / (y_max - y_min)],
                             device=logits.device)
        return {"heatmap_logits": logits, "heatmap": torch.sigmoid(logits),
                "offset": torch.full((B, Hb, Wb, 2), 0.5, device=logits.device),
                "size": cells.expand(B, Hb, Wb, 2)}

    def forward(self, images, K, Rt, train: bool = False) -> Dict[str, torch.Tensor]:
        """images [B, V, H, W, 3] uint8, K [B, V, 3, 3], Rt [B, V, 4, 4]."""
        if train:
            raise NotImplementedError("MVDet's loss is not in the reference: it serves only")
        bev = self.warp_views(self.encode(images), K, Rt)
        Hb, Wb = self.bev_hw
        pos = coord_map(Hb, Wb, bev.device).expand(bev.shape[0], Hb, Wb, 2)
        return self.head(torch.cat([bev, pos], dim=-1))

    __call__ = forward

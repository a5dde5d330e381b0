"""The model's operations a frame set, counted once at set-up from the
benchmark's own reference at the cell's shapes: convolutions and products
by ``torch.utils.flop_counter.FlopCounterMode`` on ``meta`` tensors, plus
2 operations a live tap and channel for the bilinear samplers, which that
counter does not see. Training counts the forward and the backward. So
the count reads the same work whatever implementation the program runs.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from .kernels import plain_taps


def _meta_weights(reference, cfg: Dict, grad: bool) -> Dict[str, torch.Tensor]:
    m = dict(cfg["MODEL"], VIEWS=cfg["DATA"]["VIEWS"])
    out = {}
    for name, shape, kind in reference.param_specs(m):
        dtype = torch.int64 if kind == "count" else torch.float32
        t = torch.empty(shape, dtype=dtype, device="meta")
        out[name] = t.requires_grad_(grad and kind in ("conv", "head", "heatmap_w", "dense", "dense_views", "sampling"))
    return out


def sampler_flops(reference, cfg: Dict, K: torch.Tensor, Rt: torch.Tensor) -> float:
    """2 operations a live tap and channel of the bilinear samplers, a frame
    set, at the ring rig's coordinates (K [V, 3, 3], Rt [V, 4, 4]). The
    deformable sampler's taps depend on the data: it counts four a
    sampling point (an upper bound, some 0.06 % of a frame set's count)."""
    d, m = cfg["DATA"], cfg["MODEL"]
    ref = reference.Reference(cfg, {})
    h, w = ref.feature_hw()
    Hb, Wb = ref.bev_hw
    coords, _ = reference.project_cells(torch.as_tensor(K), torch.as_tensor(Rt), ref.img_hw, (h, w), Hb, Wb,
                                        ref.bounds)
    _, live = plain_taps(coords.reshape(d["VIEWS"], Hb * Wb, 2), (h, w))
    if m["FUSION"] == "concat":
        return 2.0 * int(live.sum()) * m["BEV_PROJ_CH"]
    s, M, P = m["ATTN_STRIDE"], m["ATTN_HEADS"], m["ATTN_POINTS"]
    samples = d["VIEWS"] * M * math.ceil(Hb / s) * math.ceil(Wb / s) * P
    return 2.0 * int(live.sum()) * m["FEAT_DIM"] + 2.0 * samples * 4 * (m["BEV_PROJ_CH"] // M)


def model_flops(reference, cfg: Dict, K, Rt, train: bool = False) -> float:
    """Operations of one frame set of the configuration's ``reference``
    module: the forward and the decode's maps, or with ``train`` the forward
    and the backward."""
    d = cfg["DATA"]
    V, (H, W) = d["VIEWS"], d["IMG_SIZE"][-2:]
    w = _meta_weights(reference, cfg, train)
    ref = reference.Reference(cfg, w)
    images = torch.empty((1, V, H, W, 3), dtype=torch.uint8, device="meta")
    Km = torch.empty((1, V, 3, 3), device="meta")
    Rtm = torch.empty((1, V, 4, 4), device="meta")
    with FlopCounterMode(display=False) as fc:
        with torch.set_grad_enabled(train):
            out = ref.forward(images, Km, Rtm, train=train)
            if train:
                total = sum(v.float().sum() for k, v in out.items() if k.endswith("_logits"))
                total.backward()
    taps = sampler_flops(reference, cfg, K, Rt)
    return float(fc.get_total_flops()) + taps * (3 if train else 1)

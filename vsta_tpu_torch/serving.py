"""Serving: forward + decode with the weights loaded once.

``serve = build_serving_fn(cfg, state_dict)`` then
``serve(images, K, Rt) -> {'boxes', 'scores', 'valid', 'heatmap'}`` with
the JAX package's shapes and channels-last layout (``export.py``'s
``build_serving_fn``). It runs on the CUDA device unless the caller asks
for ``device="cpu"``; without a CUDA device it raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from .config import Config
from .models.bevnet import BEVNet
from .ops.decode import decode_detections
from .ops.quant import tree_to
from .utils import tracing


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def build_serving_fn(
    cfg: Config, state_dict: Mapping[str, torch.Tensor], *, quant_head: Optional[Dict] = None,
    quant_encoder: Optional[Dict] = None, device: str | torch.device = "cuda",
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Forward + decode for ``cfg`` with ``state_dict``'s weights.

    The returned ``serve(images, K, Rt)`` takes arrays or tensors
    (images [B, V, H, W, 3] uint8 or float, K [B, V, 3, 3], Rt
    [B, V, 4, 4]), moves them to the device and returns device tensors.
    ``serve.model`` is the :class:`BEVNet` it runs. ``quant_head`` /
    ``quant_encoder``: int8 trees from ``export.calibrate_quant_head`` /
    ``calibrate_quant_encoder``, moved to the device; that stage then runs
    in int8. The device trace of a call names its stages
    (:mod:`~vsta_tpu_torch.utils.tracing`): the model's ``encoder``,
    ``fusion`` and ``head``, then ``decode`` and ``end``.
    """
    dev = resolve_device(device)
    model = BEVNet.from_config(cfg)
    model.load_state_dict(state_dict)
    model.to(dev).eval()
    e, m = cfg.eval, cfg.model
    qh = None if quant_head is None else tree_to(quant_head, dev)
    qe = None if quant_encoder is None else tree_to(quant_encoder, dev)

    @torch.no_grad()
    def serve(images, K, Rt) -> Dict[str, torch.Tensor]:
        images = torch.as_tensor(images, device=dev)
        K = torch.as_tensor(K, device=dev, dtype=torch.float32)
        Rt = torch.as_tensor(Rt, device=dev, dtype=torch.float32)
        out = model(images, K, Rt, quant_head=qh, quant_encoder=qe)
        tracing.mark("decode", out["heatmap"])
        det = decode_detections(
            out["heatmap"], out["offset"], out["size"],
            bounds=m.bev_bounds, conf_thresh=e.conf_thresh,
            nms_dist_m=e.nms_dist_m, max_dets=e.max_dets,
        )
        tracing.mark("end", det["boxes"])
        return {
            "boxes": det["boxes"],
            "scores": det["scores"],
            "valid": det["valid"],
            "heatmap": out["heatmap"],
        }

    serve.model = model
    return serve

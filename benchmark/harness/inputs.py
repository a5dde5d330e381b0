"""What a run feeds the program and the reference, all made from ``--seed``.

* Weights: one draw of normal numbers on the device (a ``torch.Generator``
  on the card) for every parameter the reference lists, each slice scaled
  by its kind, in float32 as the program loads them.
* Cameras: Wildtrack's ring rig (every view on a ring around the origin,
  looking at it), the same for every frame (static cameras).
* Frames: uint8 frame sets at ``IMG_SIZE``, standing for what the reader's
  cache holds after decode and resize: a coarse random scene with pixel
  grain, made on the device and copied to host memory once.
* Boxes: about twelve people a frame inside the BEV bounds (training).

The dataset is indexable and returns the sample dicts the port's reader
returns, so the port's ``Prefetcher`` feeds from it as from a reader.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List

import numpy as np
import torch

# The heatmap's output convolution: weights of zero mean over each input
# channel's taps (a channel's mean level adds nothing) and a scale that
# spreads the logits; its bias is then set from the reference's logits on
# the seed's first frame set (``calibrate_heatmap``), so that a frame has
# some tens of peaks above the threshold, as a scene has people, whatever
# the seed.
HEATMAP_GAIN = 8.0
HEATMAP_BIAS = -3.4
CELLS_ABOVE = 1e-3


def model_dict(cfg: Dict) -> Dict:
    m = dict(cfg["MODEL"])
    m["VIEWS"] = cfg["DATA"]["VIEWS"]
    return m


def make_weights(reference, cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Random weights under the detector's parameter names, as the
    configuration's ``reference`` module lists them, on ``device``."""
    specs = reference.param_specs(model_dict(cfg))
    total = sum(math.prod(s) for _, s, _ in specs)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    m = cfg["MODEL"]
    x_min, x_max, y_min, y_max = m["BEV_BOUNDS"]
    Hb, Wb = m["BEV_SIZE"][-2:]
    wh = cfg["LOSS"]["DEFAULT_BOX_WH"]
    size_bias = torch.tensor([math.log(wh[0] / ((x_max - x_min) / Wb)), math.log(wh[1] / ((y_max - y_min) / Hb))],
                             device=device)
    out, at = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if kind in ("conv", "head"):
            t = z / math.sqrt(math.prod(shape[1:]))
        elif kind == "heatmap_w":  # zero-mean over each input channel's taps
            t = (z - z.mean(dim=(2, 3), keepdim=True)) * (HEATMAP_GAIN / math.sqrt(math.prod(shape[1:])))
        elif kind in ("dense_views", "dense", "sampling"):  # the sampling heads too: offsets depend on the query
            t = z / math.sqrt(shape[1])
        elif kind == "norm_w":
            t = 1.0 + 0.1 * z
        elif kind in ("norm_b", "bias", "offset_head", "bn_mean"):
            t = 0.1 * z
        elif kind == "bn_var":
            t = torch.exp(0.1 * z)
        elif kind == "heatmap_head":
            t = torch.full(shape, HEATMAP_BIAS, device=device)
        elif kind == "size_head":
            t = size_bias + 0.1 * z
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        else:
            raise ValueError(f"no rule for weights of kind {kind!r}")
        out[name] = t.contiguous()
    return out


@torch.no_grad()
def calibrate(reference, cfg: Dict, weights: Dict[str, torch.Tensor], frame_set: Dict[str, np.ndarray],
              device) -> None:
    """Make the random weights behave as trained ones do, in place, from
    the configuration's ``reference`` module on the seed's first frame set:
    every BatchNorm's running statistics become that frame set's (so each
    normalises, and the features carry the frames' content), then the
    heatmap's bias is shifted so that ``CELLS_ABOVE`` of the cells lie above
    the confidence threshold."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        args = [torch.as_tensor(frame_set[k][None], device=device) for k in ("images", "K", "Rt")]
        ref = reference.Reference(cfg, weights)
        for p, (mean, var) in ref.batch_stats(args[0][0]).items():
            weights[p + "running_mean"].copy_(mean)
            weights[p + "running_var"].copy_(var)
        logits = ref(*args)["heatmap_logits"].flatten().float()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    conf = cfg["EVAL"]["CONF_THRESH"]
    top = torch.quantile(logits.cpu(), 1.0 - CELLS_ABOVE)
    weights["detector.heatmap_head.bias"] += math.log(conf / (1 - conf)) - float(top)


def ring_camera(view: int, n_views: int, img_hw, radius: float = 20.0, height: float = 6.0):
    """K [3, 3] and world->camera Rt [4, 4] (float64) of a camera on a ring
    of ``radius`` metres at ``height``, looking at the origin."""
    ang = 2.0 * math.pi * view / max(1, n_views)
    pos = np.array([radius * math.cos(ang), radius * math.sin(ang), height])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    H, W = img_hw
    f = 0.47 * W
    K = np.array([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]])
    Rt = np.eye(4)
    Rt[:3, :3], Rt[:3, 3] = R, -R @ pos
    return K, Rt


def ring_rig(cfg: Dict):
    """K [V, 3, 3] and Rt [V, 4, 4] float32 of the ring rig."""
    V, img_hw = cfg["DATA"]["VIEWS"], tuple(cfg["DATA"]["IMG_SIZE"][-2:])
    Ks, Rts = zip(*(ring_camera(v, V, img_hw) for v in range(V)))
    return np.stack(Ks).astype(np.float32), np.stack(Rts).astype(np.float32)


def frames(n: int, V: int, H: int, W: int, seed: int, device, coarse: int = 16, grain: float = 32.0) -> np.ndarray:
    """n frame sets of uint8 [V, H, W, 3]: a coarse random scene (one value
    a ``coarse`` x ``coarse`` patch, smoothed bilinearly) with pixel grain
    on top, made on the device in bulk, so that every frame set's content,
    and with it the model's answer, is its own."""
    g = torch.Generator(device=device).manual_seed(seed)
    low = torch.rand((n * V, 3, -(-H // coarse) + 1, -(-W // coarse) + 1), generator=g, device=device) * 255.0
    img = torch.nn.functional.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    img = img + (torch.rand((n * V, 3, H, W), generator=g, device=device) - 0.5) * 2 * grain
    img = img.clamp(0, 255).round().to(torch.uint8)
    return img.permute(0, 2, 3, 1).reshape(n, V, H, W, 3).cpu().numpy()


class FrameSets:
    """``n`` frame sets from ``seed``, indexable as the port's reader is:
    ``ds[i]`` is {'images' [V, H, W, 3] uint8, 'K', 'Rt', 'boxes_world'
    [MAX_OBJECTS, 4], 'num_boxes', 'frame_idx'}."""

    def __init__(self, cfg: Dict, n: int, seed: int, device, people: int = 12):
        d = cfg["DATA"]
        V, (H, W) = d["VIEWS"], d["IMG_SIZE"][-2:]
        self.images = frames(n, V, H, W, seed + 1, device)
        self.K, self.Rt = ring_rig(cfg)
        rng = np.random.default_rng(seed + 2)
        x_min, x_max, y_min, y_max = cfg["MODEL"]["BEV_BOUNDS"]
        max_obj = cfg["LOSS"]["MAX_OBJECTS"]
        self.boxes = np.zeros((n, max_obj, 4), np.float32)
        k = min(people, max_obj)
        self.boxes[:, :k, 0] = rng.uniform(x_min + 0.5, x_max - 0.5, (n, k))
        self.boxes[:, :k, 1] = rng.uniform(y_min + 0.5, y_max - 0.5, (n, k))
        self.boxes[:, :k, 2:] = rng.uniform(0.4, 0.8, (n, k, 2))
        self.num_boxes = np.full((n,), k, np.int32)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {"images": self.images[i], "K": self.K, "Rt": self.Rt, "boxes_world": self.boxes[i],
                "num_boxes": self.num_boxes[i], "frame_idx": np.int64(i)}

    def pinned(self, B: int) -> List[Dict[str, torch.Tensor]]:
        """The frame sets as ``len(self) // B`` requests of ``B`` frame sets
        in pinned host memory (request j holds frame sets j * B .. j * B +
        B - 1), as a deployment stages the frames it serves."""
        out = []
        for j in range(len(self) // B):
            b = self.batch(list(range(j * B, (j + 1) * B)))
            out.append({k: torch.from_numpy(np.ascontiguousarray(b[k])).pin_memory() for k in ("images", "K", "Rt")})
        return out

    def batch(self, idx: List[int]) -> Dict[str, np.ndarray]:
        """The frame sets ``idx`` stacked, as the reference takes them."""
        return {"images": self.images[idx], "K": np.stack([self.K] * len(idx)),
                "Rt": np.stack([self.Rt] * len(idx)), "boxes_world": self.boxes[idx],
                "num_boxes": self.num_boxes[idx]}


def order(n_items: int, seed: int) -> Iterator[int]:
    """Dataset indices without end: seeded permutations of
    ``range(n_items)`` one after another, so that every seed serves the
    same items as often."""
    rng = np.random.default_rng(seed + 3)
    while True:
        yield from rng.permutation(n_items).tolist()

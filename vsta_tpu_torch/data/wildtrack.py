"""Wildtrack dataset reader (host side, numpy, static-shape samples): the
port's own copy of ``vsta_tpu/data/wildtrack.py``.

* discovers ``Image_subsets/C1..CV``; the frame list follows camera 1;
* calibration from ``Calibration``/``Calibrations``/``calibration``,
  intrinsics rescaled to the working image size;
* annotations from ``annotations_positions``/``Annotations``/
  ``annotations`` in two JSON layouts: {'annotations': [{'world_pos':
  [x, y]}]}, or the official list of persons whose per-view boxes are
  projected to the ground at the foot point (u = (xmin + xmax) / 2,
  v = ymax) with the original-resolution K and averaged over views
  (``DATA.USE_POSITION_ID`` decodes the official positionID instead);
* targets padded to ``LOSS.MAX_OBJECTS``.

Samples stay numpy; the copy to the device belongs to the pipeline
(``data/pipeline.Prefetcher``). ``decoders`` holds the names of the
decoders that ran (``"native"``, ``"pil"``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
from PIL import Image

from ..config import Config
from .calibration import (
    load_wildtrack_calibrations,
    pixel_to_world_np,
    rescale_intrinsics,
)
from .transforms import decode_u8, jitter_u8, transform_u8

# Official Wildtrack positionID grid: 2.5 cm cells, 480 x 1440, origin
# (-3.0, -9.0) m (the MVDet convention). Decoded when
# DATA.USE_POSITION_ID is set; the reference instead projects per-view
# foot points (wildtrack_loader.py:311-363).
_POS_GRID_W = 480
_POS_ORIGIN = (-3.0, -9.0)
_POS_STEP = 0.025


def position_id_to_world(pid: int) -> Tuple[float, float]:
    x = _POS_ORIGIN[0] + _POS_STEP * (pid % _POS_GRID_W)
    y = _POS_ORIGIN[1] + _POS_STEP * (pid // _POS_GRID_W)
    return x, y


class WildtrackDataset:
    """Multi-view frame dataset; __getitem__ returns numpy dicts."""

    def __init__(
        self,
        cfg: Config,
        train: bool = False,
        cache_from: Optional["WildtrackDataset"] = None,
    ):
        self.cfg = cfg
        self.train = train
        self.data_root = Path(cfg.data.data_root).resolve()
        self.views = cfg.data.views
        self.img_hw = cfg.data.img_size
        self.max_objects = cfg.loss.max_objects
        self.default_box_wh = cfg.loss.default_box_wh

        img_root = self.data_root / "Image_subsets"
        if not img_root.exists():
            raise FileNotFoundError(f"image root not found: {img_root}")
        self.cam_dirs = []
        for i in range(1, self.views + 1):
            d = img_root / f"C{i}"
            if not d.exists():
                raise FileNotFoundError(f"camera folder not found: {d}")
            self.cam_dirs.append(d)
        self.frame_files = sorted(p.name for p in self.cam_dirs[0].iterdir() if p.is_file())
        if not self.frame_files:
            raise FileNotFoundError("no image files found")

        calib_dir = next(
            (
                self.data_root / n
                for n in ("Calibration", "Calibrations", "calibration")
                if (self.data_root / n).exists()
            ),
            None,
        )
        if calib_dir is None:
            raise FileNotFoundError(
                "calibration dir not found (tried Calibration/Calibrations/calibration)"
            )
        Ks_orig, Rts = load_wildtrack_calibrations(calib_dir, self.views)

        # Native sensor resolution from the first frame (Wildtrack: 1920x1080).
        with Image.open(self.cam_dirs[0] / self.frame_files[0]) as im:
            self.orig_hw = (im.height, im.width)

        self.Ks_orig = [np.asarray(K, np.float64) for K in Ks_orig]
        self.Ks = np.stack(
            [rescale_intrinsics(K, self.orig_hw, self.img_hw) for K in Ks_orig]
        ).astype(np.float32)
        self.Rts = np.stack(Rts).astype(np.float32)

        ann_dir = next(
            (
                self.data_root / n
                for n in ("annotations_positions", "Annotations", "annotations")
                if (self.data_root / n).exists()
            ),
            None,
        )
        self.annotations_dir = ann_dir
        # per-frame world centers [N, 2] and their person identities
        # [N] int32 (Wildtrack personID when present, else the person's
        # index within the frame) - the identities feed MOT scoring of
        # tracked output (reference Phase-3 criterion, README.md:65-71)
        self.centers_per_frame: List[np.ndarray] = []
        self.ids_per_frame: List[np.ndarray] = []
        for f in self.frame_files:
            centers, ids = self._parse_frame_annotations(f)
            self.centers_per_frame.append(centers)
            self.ids_per_frame.append(ids)

        # Jitter RNG is derived PER __getitem__ CALL from
        # (seed, epoch, frame): __getitem__ runs concurrently on the
        # Prefetcher's thread pool and np.random.Generator is not
        # thread-safe - per-call derivation is both race-free and
        # reproducible regardless of thread schedule.
        self._seed = int(cfg.train.seed)
        self._epoch = 0
        # decoded uint8 cache (DATA.CACHE_IMAGES): ~1.1 GB for the full
        # 400-frame x 7-view Wildtrack at 270x480 - decode once, then
        # every epoch only jitters + normalizes.
        self._cache: Dict[Tuple[int, int], np.ndarray] = {}
        self.decoders: Set[str] = set()
        self._cache_enabled = bool(getattr(cfg.data, "cache_images", True))
        # Train and eval instances read the same files at the same size:
        # share one decoded cache (dict and set mutation are GIL-atomic) instead of
        # holding two full copies of the dataset in RAM.
        if (
            cache_from is not None
            and cache_from.data_root == self.data_root
            and cache_from.img_hw == self.img_hw
        ):
            self._cache = cache_from._cache
            self.decoders = cache_from.decoders

    def _load_u8(self, view: int, idx: int) -> np.ndarray:
        key = (view, idx)
        if self._cache_enabled:
            hit = self._cache.get(key)
            if hit is not None:
                return hit
        arr, decoder = decode_u8(str(self.cam_dirs[view] / self.frame_files[idx]), self.img_hw)
        self.decoders.add(decoder)
        if self._cache_enabled:
            self._cache[key] = arr
        return arr

    def __len__(self) -> int:
        return len(self.frame_files)

    def _parse_frame_annotations(
        self, fname: str
    ) -> Tuple[np.ndarray, np.ndarray]:
        """World-coordinate pedestrian centers [N, 2] + identities [N]
        for one frame."""
        centers: List[List[float]] = []
        ids: List[int] = []
        if self.annotations_dir is not None:
            jp = self.annotations_dir / (Path(fname).stem + ".json")
            if jp.exists():
                try:
                    with open(jp, "r") as f:
                        data = json.load(f)
                    if isinstance(data, dict) and "annotations" in data:
                        for i, ann in enumerate(data["annotations"]):
                            wp = ann.get("world_pos")
                            if wp and len(wp) >= 2:
                                centers.append([float(wp[0]), float(wp[1])])
                                ids.append(int(ann.get("personID", i)))
                    elif isinstance(data, list):
                        for i, person in enumerate(data):
                            pid = int(person.get("personID", i))
                            if self.cfg.data.use_position_id and "positionID" in person:
                                x, y = position_id_to_world(int(person["positionID"]))
                                centers.append([x, y])
                                ids.append(pid)
                                continue
                            pts = []
                            for view in person.get("views", []):
                                vnum = int(view.get("viewNum", -1))
                                if vnum < 0 or vnum >= len(self.Ks_orig):
                                    continue
                                xmin, xmax = view.get("xmin"), view.get("xmax")
                                ymin, ymax = view.get("ymin"), view.get("ymax")
                                if None in (xmin, xmax, ymin, ymax):
                                    continue
                                if xmin < 0 and xmax < 0:  # official "not visible" = -1
                                    continue
                                u = 0.5 * (float(xmin) + float(xmax))
                                v = float(ymax)
                                wp = pixel_to_world_np(
                                    u, v, self.Ks_orig[vnum], self.Rts[vnum]
                                )
                                if wp is not None:
                                    pts.append(wp)
                            if pts:
                                centers.append(
                                    [
                                        sum(p[0] for p in pts) / len(pts),
                                        sum(p[1] for p in pts) / len(pts),
                                    ]
                                )
                                ids.append(pid)
                except Exception as e:  # tolerant like the reference
                    print(f"[WildtrackDataset] failed to parse {jp}: {e}")
        return (
            np.asarray(centers, np.float32) if centers else np.zeros((0, 2), np.float32),
            np.asarray(ids, np.int32) if ids else np.zeros((0,), np.int32),
        )

    def targets_for(self, idx: int) -> Tuple[np.ndarray, int]:
        """Padded world boxes [MAX_OBJECTS, 4] + count (centers + default WH)."""
        centers = self.centers_per_frame[idx]
        n = min(len(centers), self.max_objects)
        boxes = np.zeros((self.max_objects, 4), np.float32)
        if n > 0:
            boxes[:n, :2] = centers[:n]
            boxes[:n, 2] = self.default_box_wh[0]
            boxes[:n, 3] = self.default_box_wh[1]
        return boxes, n

    def set_epoch(self, epoch: int) -> None:
        """Advance the jitter stream (called by the Prefetcher per epoch)."""
        self._epoch = int(epoch)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        # DATA.DEVICE_NORMALIZE: emit uint8 (the model normalises on the
        # device) - 4x less host->device transfer and no host float pass
        tf = jitter_u8 if self.cfg.data.device_normalize else transform_u8
        rng = np.random.default_rng((self._seed, self._epoch, int(idx)))
        imgs = np.stack(
            [
                tf(self._load_u8(v, idx), rng=rng, train=self.train)
                for v in range(self.views)
            ]
        )  # [V, H, W, 3] uint8 or float32
        boxes, n = self.targets_for(idx)
        return {
            "images": imgs,
            "K": self.Ks,
            "Rt": self.Rts,
            "boxes_world": boxes,
            "num_boxes": np.int32(n),
            "frame_idx": np.int32(idx),
        }


def collate(samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack per-frame samples into a batch of arrays (ref collate_fn,
    wildtrack_loader.py:389-401, but fully tensorized)."""
    return {
        "images": np.stack([s["images"] for s in samples]),
        "K": np.stack([s["K"] for s in samples]),
        "Rt": np.stack([s["Rt"] for s in samples]),
        "boxes_world": np.stack([s["boxes_world"] for s in samples]),
        "num_boxes": np.stack([s["num_boxes"] for s in samples]),
        "frame_idx": np.stack([s["frame_idx"] for s in samples]),
    }

"""Synthetic calibration and a synthetic Wildtrack-format dataset: the
port's own copy of ``vsta_tpu/data/synthetic.py``.

:func:`generate_synthetic_wildtrack` writes the on-disk layout the reader
expects: ``Image_subsets/C{i}/*.png``, OpenCV-style calibration XMLs
(rvec/tvec extrinsics, translations in millimetres) and
``annotations_positions/*.json`` in either annotation layout. It is the
dataset of the tests and of the chip run; nothing is downloaded.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import List, Tuple

import numpy as np
from PIL import Image, ImageDraw


def make_ring_camera(
    view: int,
    n_views: int = 7,
    radius: float = 20.0,
    height: float = 6.0,
    img_hw: Tuple[int, int] = (1080, 1920),
) -> Tuple[np.ndarray, np.ndarray]:
    """Plausible calibration: camera on a ring, looking at the origin.

    Returns (K [3,3], Rt [4,4]) float64, world->camera, K scaled to img_hw.
    """
    ang = 2.0 * math.pi * view / max(1, n_views)
    cam_pos = np.array([radius * math.cos(ang), radius * math.sin(ang), height])
    fwd = -cam_pos / np.linalg.norm(cam_pos)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    t = -R @ cam_pos
    H_img, W_img = img_hw
    f = 0.47 * W_img
    K = np.array([[f, 0.0, W_img / 2.0], [0.0, f, H_img / 2.0], [0.0, 0.0, 1.0]])
    Rt = np.eye(4)
    Rt[:3, :3] = R
    Rt[:3, 3] = t
    return K, Rt


def _rvec_from_R(R: np.ndarray) -> np.ndarray:
    """Inverse Rodrigues (rotation matrix -> rotation vector)."""
    cos_t = max(-1.0, min(1.0, (np.trace(R) - 1.0) / 2.0))
    theta = math.acos(cos_t)
    if theta < 1e-10:
        return np.zeros(3)
    axis = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2.0 * math.sin(theta))
    )
    return axis * theta


def _write_opencv_xml(path: Path, tag_rows: List[Tuple[str, np.ndarray]]):
    lines = ['<?xml version="1.0"?>', "<opencv_storage>"]
    for tag, mat in tag_rows:
        mat = np.asarray(mat)
        rows, cols = (mat.shape + (1,))[:2] if mat.ndim >= 2 else (mat.size, 1)
        flat = " ".join(f"{v:.10g}" for v in mat.reshape(-1))
        lines += [
            f'<{tag} type_id="opencv-matrix">',
            f"  <rows>{rows}</rows>",
            f"  <cols>{cols}</cols>",
            "  <dt>d</dt>",
            f"  <data>{flat}</data>",
            f"</{tag}>",
        ]
    lines.append("</opencv_storage>")
    path.write_text("\n".join(lines))


def generate_synthetic_wildtrack(
    root: Path,
    *,
    n_frames: int = 8,
    n_views: int = 7,
    n_people: int = 12,
    img_hw: Tuple[int, int] = (1080, 1920),
    world_pos_format: bool = False,
    seed: int = 0,
    area: Tuple[float, float] = (10.0, 5.0),
) -> Path:
    """Create a synthetic Wildtrack tree under `root` and return it.

    People walk smoothly inside |x| < area[0], |y| < area[1]; each view
    renders them as bright vertical bars (head 1.8 m) on a gray floor so
    a detector can actually learn from the data.
    """
    root = Path(root)
    rng = np.random.default_rng(seed)
    cam_names = ["CVLab1", "CVLab2", "CVLab3", "CVLab4", "IDIAP1", "IDIAP2", "IDIAP3"]
    cam_names = (cam_names * ((n_views + 6) // 7))[:n_views]

    intr_dir = root / "Calibration" / "intrinsic_original"
    extr_dir = root / "Calibration" / "extrinsic"
    ann_dir = root / "annotations_positions"
    intr_dir.mkdir(parents=True, exist_ok=True)
    extr_dir.mkdir(parents=True, exist_ok=True)
    ann_dir.mkdir(parents=True, exist_ok=True)

    cams = []
    for v in range(n_views):
        K, Rt = make_ring_camera(v, n_views, img_hw=img_hw)
        cams.append((K, Rt))
        _write_opencv_xml(intr_dir / f"intr_{cam_names[v]}.xml", [("camera_matrix", K)])
        rvec = _rvec_from_R(Rt[:3, :3])
        tvec_mm = Rt[:3, 3] * 1000.0  # millimeters: exercises mm->m autoscale
        _write_opencv_xml(
            extr_dir / f"extr_{cam_names[v]}.xml",
            [("rvec", rvec.reshape(3, 1)), ("tvec", tvec_mm.reshape(3, 1))],
        )
        (root / "Image_subsets" / f"C{v + 1}").mkdir(parents=True, exist_ok=True)

    # Smooth random walks for the crowd.
    pos = rng.uniform([-area[0], -area[1]], [area[0], area[1]], size=(n_people, 2))
    vel = rng.normal(0, 0.4, size=(n_people, 2))

    H_img, W_img = img_hw
    for f_idx in range(n_frames):
        pos = np.clip(pos + vel, [-area[0], -area[1]], [area[0], area[1]])
        vel = 0.9 * vel + rng.normal(0, 0.1, size=vel.shape)
        fname = f"{f_idx:08d}"

        # annotations
        if world_pos_format:
            ann = {
                "annotations": [
                    {"world_pos": [float(x), float(y)]} for x, y in pos
                ]
            }
        else:
            persons = []
            for pid, (x, y) in enumerate(pos):
                views = []
                for v, (K, Rt) in enumerate(cams):
                    foot = Rt @ np.array([x, y, 0.0, 1.0])
                    head = Rt @ np.array([x, y, 1.8, 1.0])
                    if foot[2] <= 0.5:
                        continue
                    uf = K @ (foot[:3] / foot[2])
                    uh = K @ (head[:3] / head[2])
                    half_w = 0.25 * K[0, 0] / foot[2]
                    xmin, xmax = uf[0] - half_w, uf[0] + half_w
                    ymin, ymax = min(uh[1], uf[1]), max(uh[1], uf[1])
                    if xmax < 0 or xmin > W_img or ymax < 0 or ymin > H_img:
                        continue
                    views.append(
                        {
                            "viewNum": v,
                            "xmin": int(xmin),
                            "xmax": int(xmax),
                            "ymin": int(ymin),
                            "ymax": int(ymax),
                        }
                    )
                persons.append({"personID": pid, "views": views})
            ann = persons
        (ann_dir / f"{fname}.json").write_text(json.dumps(ann))

        # images
        for v, (K, Rt) in enumerate(cams):
            img = Image.new("RGB", (W_img, H_img), (96, 96, 96))
            draw = ImageDraw.Draw(img)
            for x, y in pos:
                foot = Rt @ np.array([x, y, 0.0, 1.0])
                head = Rt @ np.array([x, y, 1.8, 1.0])
                if foot[2] <= 0.5:
                    continue
                uf = K @ (foot[:3] / foot[2])
                uh = K @ (head[:3] / head[2])
                half_w = max(2.0, 0.25 * K[0, 0] / foot[2])
                x0, x1 = uf[0] - half_w, uf[0] + half_w
                y0, y1 = min(uh[1], uf[1]), max(uh[1], uf[1])
                if x1 < 0 or x0 > W_img or y1 < 0 or y0 > H_img:
                    continue
                draw.rectangle(
                    [max(0, x0), max(0, y0), min(W_img - 1, x1), min(H_img - 1, y1)],
                    fill=(230, 200, 60),
                )
            img.save(root / "Image_subsets" / f"C{v + 1}" / f"{fname}.png")

    return root

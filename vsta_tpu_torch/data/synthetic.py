"""Synthetic calibration for tests and on-device runs without a dataset."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


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

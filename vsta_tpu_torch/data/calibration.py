"""Wildtrack calibration parsing (host side, numpy float64): the port's
own copy of ``vsta_tpu/data/calibration.py``.

Tolerant OpenCV-XML parsing: several tag names per matrix, nested
<data> nodes or raw text, rvec/tvec extrinsics through Rodrigues,
CVLab/IDIAP camera names, the intrinsic_original/intrinsic_zero/extrinsic
folders, K = diag(1000, 1000, 1) / Rt = I where a file does not parse,
and translations in millimetres (||t|| > 100) converted to metres.
:func:`rescale_intrinsics` scales K to the resized image.
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

K_TAGS = ["K", "intrinsic", "intrinsics", "camera_matrix", "IntrinsicMatrix", "MatrixK", "A"]
R_TAGS = ["R", "rotation", "RotationMatrix", "rotation_matrix"]
T_TAGS = ["T", "translation", "TranslationVector", "t"]
RT_TAGS = ["RT", "ExtrinsicMatrix", "Pose", "MatrixRT"]
RVEC_TAGS = ["rvec", "Rodrigues", "rotation_vector"]
TVEC_TAGS = ["tvec", "t", "translation_vector"]

DEFAULT_CAMERA_NAMES = ["CVLab1", "CVLab2", "CVLab3", "CVLab4", "IDIAP1", "IDIAP2", "IDIAP3"]


def parse_float_list(text: Optional[str]) -> List[float]:
    """Floats from free-form text (comma/space/semicolon/line separated)."""
    if text is None:
        return []
    cleaned = re.sub(r"[\,;\n\t]+", " ", text)
    vals: List[float] = []
    for p in cleaned.strip().split(" "):
        if not p:
            continue
        try:
            vals.append(float(p))
        except ValueError:
            continue
    return vals


def try_get_matrix(
    root: ET.Element, tag_names: Sequence[str], shape: Tuple[int, int]
) -> Optional[np.ndarray]:
    """Find a rows*cols matrix under any candidate tag (nested <data>, raw
    text, or OpenCV nested-element style)."""
    rows, cols = shape
    need = rows * cols
    for name in tag_names:
        for elem in root.findall(f".//{name}"):
            data_elem = elem.find("data")
            if data_elem is not None and data_elem.text is not None:
                vals = parse_float_list(data_elem.text)
                if len(vals) >= need:
                    return np.array(vals[:need], np.float64).reshape(rows, cols)
            if elem.text is not None:
                vals = parse_float_list(elem.text)
                if len(vals) >= need:
                    return np.array(vals[:need], np.float64).reshape(rows, cols)
            text_all = " ".join(e.text or "" for e in elem.iter())
            vals = parse_float_list(text_all)
            if len(vals) >= need:
                return np.array(vals[:need], np.float64).reshape(rows, cols)
    return None


def rodrigues_np(rvec: np.ndarray) -> np.ndarray:
    rv = np.asarray(rvec, np.float64).reshape(-1)
    theta = float(np.linalg.norm(rv))
    if theta < 1e-12:
        return np.eye(3)
    k = rv / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float64)
    return np.eye(3) + math.sin(theta) * K + (1.0 - math.cos(theta)) * (K @ K)


def _default_K() -> np.ndarray:
    K = np.eye(3)
    K[0, 0] = K[1, 1] = 1000.0
    return K


def _parse_extrinsic(root: ET.Element) -> Optional[np.ndarray]:
    """Parse a 3x4 [R|t] from an extrinsic XML, trying RT, R+T, rvec+tvec."""
    Rt34 = try_get_matrix(root, RT_TAGS, (3, 4))
    if Rt34 is not None:
        return Rt34
    R = try_get_matrix(root, R_TAGS, (3, 3))
    t = try_get_matrix(root, T_TAGS, (3, 1))
    if R is not None and t is not None:
        return np.concatenate([R, t], axis=1)
    rvec = try_get_matrix(root, RVEC_TAGS, (3, 1))
    if rvec is None:
        rvec = try_get_matrix(root, RVEC_TAGS, (1, 3))
    tvec = try_get_matrix(root, TVEC_TAGS, (3, 1))
    if tvec is None:
        tvec = try_get_matrix(root, TVEC_TAGS, (1, 3))
    if rvec is not None and tvec is not None:
        return np.concatenate([rodrigues_np(rvec), tvec.reshape(3, 1)], axis=1)
    return None


def load_camera_xml(xml_path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """Single-file K (3x3) + Rt (4x4) loader with flexible tags."""
    root = ET.parse(str(xml_path)).getroot()
    K = try_get_matrix(root, K_TAGS, (3, 3))
    if K is None:
        K = _default_K()
    Rt34 = _parse_extrinsic(root)
    Rt = np.eye(4)
    if Rt34 is not None:
        Rt[:3, :4] = Rt34
    return K, Rt


def _camera_names(intr_dir: Path, extr_dir: Path, views: int) -> List[str]:
    if views == 7:
        return list(DEFAULT_CAMERA_NAMES)
    candidates = [p.stem for p in list(intr_dir.rglob("*.xml")) + list(extr_dir.rglob("*.xml"))]
    names = set()
    for s in candidates:
        m = re.search(r"(CVLab\d+|IDIAP\d+)", s, flags=re.IGNORECASE)
        if m:
            names.add(m.group(1))
    cam_names = sorted(n for n in names if n.lower().startswith("cvlab")) + sorted(
        n for n in names if n.lower().startswith("idiap")
    )
    if len(cam_names) < views:
        cam_names += [f"Cam{i}" for i in range(len(cam_names) + 1, views + 1)]
    return cam_names[:views]


def load_wildtrack_calibrations(
    calib_root: Path, views: int, *, verbose: bool = False
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per-camera (K, Rt) in Wildtrack layout (ref wildtrack_loader.py:154-247).

    Rt translation auto-converts mm->m when ||t|| > 100.
    """
    calib_root = Path(calib_root)
    if (calib_root / "intrinsic_original").exists():
        intr_dir = calib_root / "intrinsic_original"
    elif (calib_root / "intrinsic_zero").exists():
        intr_dir = calib_root / "intrinsic_zero"
    else:
        intr_dir = calib_root
    extr_dir = calib_root / "extrinsic" if (calib_root / "extrinsic").exists() else calib_root

    Ks: List[np.ndarray] = []
    Rts: List[np.ndarray] = []
    for name in _camera_names(intr_dir, extr_dir, views):
        intr_match = next(
            (p for p in intr_dir.rglob("*.xml") if re.search(name, p.stem, re.IGNORECASE)), None
        )
        extr_match = next(
            (p for p in extr_dir.rglob("*.xml") if re.search(name, p.stem, re.IGNORECASE)), None
        )

        if intr_match is None:
            K = _default_K()
        else:
            K = try_get_matrix(ET.parse(str(intr_match)).getroot(), K_TAGS, (3, 3))
            if K is None:
                K = _default_K()

        Rt = np.eye(4)
        if extr_match is not None:
            Rt34 = _parse_extrinsic(ET.parse(str(extr_match)).getroot())
            if Rt34 is not None:
                Rt[:3, :4] = Rt34
                t_norm = float(np.linalg.norm(Rt[:3, 3]))
                if t_norm > 100.0:  # assume millimeters
                    Rt[:3, 3] /= 1000.0
        if verbose:
            R = Rt[:3, :3]
            ang = math.acos(max(-1.0, min(1.0, (np.trace(R) - 1.0) / 2.0)))
            print(f"[calib] {name}: angle={ang:.3f} rad t_norm={np.linalg.norm(Rt[:3,3]):.3f}")
        Ks.append(K)
        Rts.append(Rt)
    return Ks, Rts


def rescale_intrinsics(
    K: np.ndarray, orig_hw: Tuple[int, int], new_hw: Tuple[int, int]
) -> np.ndarray:
    """Scale K for an image resize from orig (H, W) to new (H, W)."""
    K = np.array(K, np.float64, copy=True)
    sy = new_hw[0] / float(orig_hw[0])
    sx = new_hw[1] / float(orig_hw[1])
    K[0, :] *= sx
    K[1, :] *= sy
    return K


def compute_homography_np(K: np.ndarray, Rt: np.ndarray) -> np.ndarray:
    """H_w2i = K[:3,:3] @ [r1 r2 t] (float64 host twin of geometry.homography)."""
    K3 = np.asarray(K, np.float64)[:3, :3]
    R = np.asarray(Rt, np.float64)[:3, :3]
    t = np.asarray(Rt, np.float64)[:3, 3:4]
    return K3 @ np.concatenate([R[:, 0:1], R[:, 1:2], t], axis=1)


def pixel_to_world_np(
    u: float, v: float, K: np.ndarray, Rt: np.ndarray
) -> Optional[Tuple[float, float]]:
    """Image pixel -> ground-plane world xy; None at/near the horizon
    (ref wildtrack_loader.py:35-44)."""
    H = compute_homography_np(K, Rt)
    det = np.linalg.det(H)
    Hi = np.linalg.pinv(H) if (not np.isfinite(det) or abs(det) < 1e-10) else np.linalg.inv(H)
    xyw = Hi @ np.array([u, v, 1.0], np.float64)
    w = float(xyw[2])
    if not np.isfinite(w) or abs(w) < 1e-8:
        return None
    return float(xyw[0] / w), float(xyw[1] / w)

"""The host image codec (C++: libjpeg/libpng decode, PIL-compatible
triangle resize, fused normalise), bound with ctypes.

``imgcodec.cpp`` compiles with ``g++ ... -ljpeg -lpng -lz`` at first use
into ``build/native/`` beside the package (listed in ``.gitignore``); the
library's file name carries a hash of the source, so an edited source is
rebuilt. Where it cannot build or load, :func:`available` is False and
the callers in ``data/transforms.py`` decode with PIL instead: this is
host decode, not the device.

Off switch: ``VSTA_TORCH_NO_NATIVE=1`` in the environment, read at every
call, makes :func:`available` False and every decode take PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "imgcodec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
OFF_SWITCH = "VSTA_TORCH_NO_NATIVE"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libimgcodec-{digest}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", str(SRC), "-o", str(tmp), "-ljpeg", "-lpng", "-lz"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"[vsta_tpu_torch.native] g++ did not run ({e}); decoding with PIL")
        return False
    if r.returncode != 0:
        print(f"[vsta_tpu_torch.native] build failed; decoding with PIL:\n{r.stderr[:2000]}")
        return False
    os.replace(tmp, lib)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if os.environ.get(OFF_SWITCH):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib_path = library_path()
        if not lib_path.exists() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            print(f"[vsta_tpu_torch.native] load failed ({e}); decoding with PIL")
            return None
        lib.vsta_decode_resize_u8.restype = ctypes.c_int
        lib.vsta_decode_resize_u8.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.vsta_image_size.restype = ctypes.c_int
        lib.vsta_image_size.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.vsta_decode_resize_norm.restype = ctypes.c_int
        lib.vsta_decode_resize_norm.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the codec is built, loadable and not switched off."""
    return _load() is not None


def decode_resize_u8(path: str, out_hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """Decode PNG/JPEG + PIL-style triangle resize -> uint8 [H, W, 3];
    None when the codec is unavailable or cannot decode the file."""
    lib = _load()
    if lib is None:
        return None
    H, W = out_hw
    out = np.empty((H, W, 3), np.uint8)
    rc = lib.vsta_decode_resize_u8(path.encode(), H, W, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out if rc == 0 else None


def decode_resize_norm(
    path: str, out_hw: Tuple[int, int], mean: np.ndarray, std: np.ndarray
) -> Optional[np.ndarray]:
    """Decode + resize + fused (x/255 - mean)/std -> float32 [H, W, 3]."""
    lib = _load()
    if lib is None:
        return None
    H, W = out_hw
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    out = np.empty((H, W, 3), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.vsta_decode_resize_norm(
        path.encode(), H, W, m.ctypes.data_as(f32p), s.ctypes.data_as(f32p), out.ctypes.data_as(f32p)
    )
    return out if rc == 0 else None



def image_size(path: str) -> Optional[Tuple[int, int]]:
    """(H, W) of a PNG/JPEG file; None when the codec is unavailable or
    cannot decode it."""
    lib = _load()
    if lib is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.vsta_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w))
    return (h.value, w.value) if rc == 0 else None

"""Host-side image transforms (PIL + numpy): the port's own copy of
``vsta_tpu/data/transforms.py``.

Resize -> train-only colour jitter (p = 0.5, PIL ``ImageEnhance`` in a
random order, hue through HSV) -> ImageNet normalisation. Decode and
resize go through the C++ codec of :mod:`vsta_tpu_torch.native` where it
is built, through PIL otherwise; :func:`decode_u8` says which decoded a
file. With the same ``np.random.Generator`` state the jitter gives the
same uint8 images as the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance

from .. import native

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def color_jitter(
    img: Image.Image,
    rng: np.random.Generator,
    brightness: float = 0.2,
    contrast: float = 0.2,
    saturation: float = 0.2,
    hue: float = 0.05,
) -> Image.Image:
    """torchvision-style ColorJitter: each factor uniform in [1-x, 1+x],
    hue shift uniform in [-hue, +hue] (fraction of the hue circle),
    applied in random order."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        g = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(g))
    if saturation > 0:
        h = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(h))
    if hue > 0:
        dh = rng.uniform(-hue, hue)

        def _hue(im: Image.Image) -> Image.Image:
            hsv = np.array(im.convert("HSV"), dtype=np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(round(dh * 255))) % 256
            return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")

        ops.append(_hue)
    order = rng.permutation(len(ops))
    for i in order:
        img = ops[i](img)
    return img


def load_and_transform(
    path: str,
    img_hw: Tuple[int, int],
    rng: Optional[np.random.Generator] = None,
    train: bool = False,
    jitter_p: float = 0.5,
) -> np.ndarray:
    """Decode -> resize -> (train-only jitter) -> normalise: float32
    [H, W, 3], channels-last. The codec's fused normalise serves eval."""
    if train:
        u8 = native.decode_resize_u8(path, img_hw)
        if u8 is not None:
            img = Image.fromarray(u8, "RGB")
            if rng is not None and rng.uniform() < jitter_p:
                img = color_jitter(img, rng)
            arr = np.asarray(img, np.float32) / 255.0
            return (arr - IMAGENET_MEAN) / IMAGENET_STD
    else:
        out = native.decode_resize_norm(path, img_hw, IMAGENET_MEAN, IMAGENET_STD)
        if out is not None:
            return out
    img = Image.open(path).convert("RGB")
    return transform_pil(img, img_hw, rng=rng, train=train, jitter_p=jitter_p)


def transform_pil(
    img: Image.Image,
    img_hw: Tuple[int, int],
    rng: Optional[np.random.Generator] = None,
    train: bool = False,
    jitter_p: float = 0.5,
) -> np.ndarray:
    H, W = img_hw
    if img.size != (W, H):
        img = img.resize((W, H), Image.BILINEAR)
    if train and rng is not None and rng.uniform() < jitter_p:
        img = color_jitter(img, rng)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def decode_u8(path: str, img_hw: Tuple[int, int]) -> Tuple[np.ndarray, str]:
    """Decode + resize only: (uint8 [H, W, 3], the decoder that ran,
    ``"native"`` or ``"pil"``)."""
    out = native.decode_resize_u8(path, img_hw)
    if out is not None:
        return out, "native"
    img = Image.open(path).convert("RGB")
    H, W = img_hw
    if img.size != (W, H):
        img = img.resize((W, H), Image.BILINEAR)
    return np.asarray(img, np.uint8), "pil"


def decode_resize_u8(path: str, img_hw: Tuple[int, int]) -> np.ndarray:
    """Decode + resize only (no jitter, no normalise): uint8 [H, W, 3];
    the stage that DATA.CACHE_IMAGES keeps."""
    return decode_u8(path, img_hw)[0]


def transform_u8(
    arr: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    train: bool = False,
    jitter_p: float = 0.5,
) -> np.ndarray:
    """(train-only jitter) + normalise a decoded uint8 [H, W, 3] image."""
    arr = jitter_u8(arr, rng=rng, train=train, jitter_p=jitter_p)
    out = arr.astype(np.float32) / 255.0
    return (out - IMAGENET_MEAN) / IMAGENET_STD


def jitter_u8(
    arr: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    train: bool = False,
    jitter_p: float = 0.5,
) -> np.ndarray:
    """Train-only colour jitter on a decoded uint8 image; stays uint8 (with
    DATA.DEVICE_NORMALIZE the model normalises on the device)."""
    if train and rng is not None and rng.uniform() < jitter_p:
        img = color_jitter(Image.fromarray(arr, "RGB"), rng)
        arr = np.asarray(img, np.uint8)
    return arr

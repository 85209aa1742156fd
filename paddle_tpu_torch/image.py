"""paddle.v2.image parity — image preprocessing for vision readers
(reference: python/paddle/v2/image.py).

The reference wraps OpenCV; this environment has no cv2, so decoding uses
Pillow when importable and every geometric transform is plain numpy (HWC
uint8/float arrays in, same out).  Function names, argument shapes, and the
CHW/flip/crop semantics match the reference so v1-era vision pipelines port
unchanged."""

from __future__ import annotations

import io
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "load_image",
    "load_image_bytes",
    "resize_short",
    "to_chw",
    "center_crop",
    "random_crop",
    "left_right_flip",
    "simple_transform",
    "load_and_transform",
]


def _require_pil():
    try:
        from PIL import Image  # type: ignore

        return Image
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "image decoding needs Pillow (the reference used cv2); "
            "geometric transforms work on numpy arrays without it"
        ) from e


def load_image_bytes(bytes_: bytes, is_color: bool = True) -> np.ndarray:
    """Decode an encoded image buffer to HWC uint8 (or HW when gray)."""
    Image = _require_pil()
    img = Image.open(io.BytesIO(bytes_))
    img = img.convert("RGB" if is_color else "L")
    return np.asarray(img)


def load_image(file: str, is_color: bool = True) -> np.ndarray:
    with open(file, "rb") as f:
        return load_image_bytes(f.read(), is_color)


def _resize(im: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize in numpy (no cv2/PIL dependency for arrays)."""
    src_h, src_w = im.shape[:2]
    if (src_h, src_w) == (h, w):
        return im
    ys = np.linspace(0, src_h - 1, h)
    xs = np.linspace(0, src_w - 1, w)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, src_h - 1)
    x1 = np.minimum(x0 + 1, src_w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    if im.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    arr = im.astype(np.float64)
    top = arr[y0][:, x0] * (1 - wx) + arr[y0][:, x1] * wx
    bot = arr[y1][:, x0] * (1 - wx) + arr[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(im.dtype, np.integer):
        return np.rint(out).astype(im.dtype)  # round, don't truncate
    return out.astype(im.dtype)


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """Scale so the SHORT edge becomes `size`, keeping aspect ratio
    (reference image.py:143)."""
    h, w = im.shape[:2]
    if h > w:
        return _resize(im, int(round(h * size / w)), size)
    return _resize(im, size, int(round(w * size / h)))


def to_chw(im: np.ndarray, order: Sequence[int] = (2, 0, 1)) -> np.ndarray:
    """HWC -> CHW (reference image.py:169)."""
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im: np.ndarray, size: int, is_color: bool = True) -> np.ndarray:
    h, w = im.shape[:2]
    if size > h or size > w:
        raise ValueError(f"crop size {size} exceeds image {h}x{w}")
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    return im[h_start : h_start + size, w_start : w_start + size]


def random_crop(
    im: np.ndarray, size: int, is_color: bool = True, rng: Optional[np.random.RandomState] = None
) -> np.ndarray:
    rng = rng or np.random
    h, w = im.shape[:2]
    h_start = int(rng.randint(0, h - size + 1))
    w_start = int(rng.randint(0, w - size + 1))
    return im[h_start : h_start + size, w_start : w_start + size]


def left_right_flip(im: np.ndarray) -> np.ndarray:
    """Mirror horizontally (reference image.py:246)."""
    return im[:, ::-1]


def simple_transform(
    im: np.ndarray,
    resize_size: int,
    crop_size: int,
    is_train: bool,
    is_color: bool = True,
    mean: Optional[np.ndarray] = None,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """resize_short + (random|center) crop + train-time random flip + CHW +
    optional mean subtraction — the reference's standard pipeline
    (image.py:265)."""
    im = resize_short(im, resize_size)
    if is_train:
        rng = rng or np.random
        im = random_crop(im, crop_size, is_color, rng=rng)
        if rng.randint(2) == 0:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size, is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]  # per-channel
        im -= mean
    return im


def load_and_transform(
    filename: str,
    resize_size: int,
    crop_size: int,
    is_train: bool,
    is_color: bool = True,
    mean: Optional[np.ndarray] = None,
) -> np.ndarray:
    return simple_transform(
        load_image(filename, is_color), resize_size, crop_size, is_train,
        is_color, mean,
    )

"""Host-side image reading and preprocessing in numpy, the counterpart of
``tdnet/data/image.py``.

:func:`read_image_bgr` decodes PNG with ``data/png.py`` (zlib and numpy;
the reference decodes with PIL) and reads ``.npy`` arrays; other formats,
JPEG among them, raise.

The GPU machine has neither cv2 nor PIL, so :func:`resize_image` is a numpy
bilinear resize that mirrors cv2's ``INTER_LINEAR`` (the reference's
``cv2.resize(img, None, fx=scale, fy=scale)``): output size
``round(side * scale)``, half-pixel centres ``src = (dst + 0.5) / scale -
0.5``, edges clamped, float32 weights, the horizontal pass first.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from tdnet_torch.data import png

__all__ = [
    "CAFFE_MEAN_BGR",
    "read_image_bgr",
    "write_image_bgr",
    "image_size",
    "preprocess_image",
    "compute_resize_scale",
    "resize_image",
]

# caffe-mode BGR means (reference utils/image.py preprocess_image)
CAFFE_MEAN_BGR = np.array([103.939, 116.779, 123.68], dtype=np.float32)


def read_image_bgr(path) -> np.ndarray:
    """An image file -> (H, W, 3) float32 BGR: PNG (decoded as PIL's
    ``convert("RGB")``, then the channels flipped) or a ``.npy`` array that
    is already (H, W, 3) BGR."""
    path = os.fspath(path)
    if path.endswith(".npy"):
        image = np.load(path, allow_pickle=False)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"{path}: a .npy image must be (H, W, 3) BGR, "
                             f"got {image.shape}")
        return np.asarray(image, np.float32)
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(png.SIGNATURE):
        raise ValueError(f"{path}: unsupported image format; the port reads {png.READS}")
    return png.decode_png(data)[:, :, ::-1].astype(np.float32)


def write_image_bgr(path, image_bgr: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 BGR image as PNG."""
    with open(path, "wb") as f:
        f.write(png.encode_png(np.ascontiguousarray(image_bgr[:, :, ::-1])))


def image_size(path):
    """(width, height) of a PNG (from its header) or a ``.npy`` image."""
    path = os.fspath(path)
    if path.endswith(".npy"):
        h, w = np.load(path, mmap_mode="r", allow_pickle=False).shape[:2]
        return w, h
    with open(path, "rb") as f:
        return png.png_size(f.read(24))


def preprocess_image(x: np.ndarray, mode: str = "caffe") -> np.ndarray:
    """Normalize a BGR image to float32: 'caffe' subtracts the BGR means,
    'tf' maps [0, 255] to [-1, 1]."""
    x = np.asarray(x, np.float32)
    if mode == "caffe":
        return x - CAFFE_MEAN_BGR
    if mode == "tf":
        return (x / np.float32(127.5)) - np.float32(1.0)
    raise ValueError(f"unknown preprocessing mode {mode!r}")


def compute_resize_scale(image_shape: Tuple[int, ...], min_side: int = 800,
                         max_side: int = 1333) -> float:
    """Aspect-preserving scale: min side -> min_side, capped so the max side
    stays within max_side."""
    rows, cols = image_shape[:2]
    scale = min_side / min(rows, cols)
    largest_side = max(rows, cols)
    if largest_side * scale > max_side:
        scale = max_side / largest_side
    return scale


def _linear_taps(n_src: int, n_dst: int, scale: float):
    """Source indices (lo, hi) and float32 weight of hi for each output
    position along one axis (cv2 resize.cpp, INTER_LINEAR)."""
    pos = ((np.arange(n_dst, dtype=np.float64) + 0.5) * (1.0 / scale)
           - 0.5).astype(np.float32)
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo.astype(np.float32)
    below = lo < 0
    lo[below], frac[below] = 0, 0.0
    above = lo >= n_src - 1
    lo[above], frac[above] = n_src - 1, 0.0
    hi = np.minimum(lo + 1, n_src - 1)
    return lo, hi, frac.astype(np.float32)


def resize_image(img: np.ndarray, min_side: int = 800, max_side: int = 1333):
    """Resize an (H, W, C) image so its min side is min_side (capped by
    max_side). Returns (float32 image, scale); a scale of 1.0 returns the
    input unchanged."""
    scale = compute_resize_scale(img.shape, min_side=min_side, max_side=max_side)
    if scale == 1.0:
        return img, 1.0
    h, w = img.shape[:2]
    out_h, out_w = int(np.rint(h * scale)), int(np.rint(w * scale))
    src = np.asarray(img, np.float32)
    x_lo, x_hi, fx = _linear_taps(w, out_w, scale)
    y_lo, y_hi, fy = _linear_taps(h, out_h, scale)
    one = np.float32(1.0)
    fx = fx.reshape((1, out_w) + (1,) * (src.ndim - 2))
    fy = fy.reshape((out_h, 1) + (1,) * (src.ndim - 2))
    rows = src[:, x_lo] * (one - fx) + src[:, x_hi] * fx  # horizontal pass
    out = rows[y_lo] * (one - fy) + rows[y_hi] * fy
    return out.astype(np.float32, copy=False), scale

"""Host-side image reading and preprocessing in numpy, the counterpart of
``tdnet/data/image.py``.

:func:`read_image_bgr` decodes PNG with ``data/png.py`` (zlib and numpy;
the reference decodes with PIL) and reads ``.npy`` arrays; other formats,
JPEG among them, raise.

The GPU machine has neither cv2 nor PIL, so :func:`resize_image` is a numpy
bilinear resize that reproduces cv2's ``INTER_LINEAR`` (the reference's
``cv2.resize(img, None, fx=scale, fy=scale)``) bit for bit: output size
``round(side * scale)``, half-pixel centres ``src = (dst + 0.5) / scale -
0.5``, the horizontal pass first. cv2 takes two routes, and so does this
module: uint8 pages go through cv2's own 11-bit fixed-point path, float32
pages through IPP's (source positions in float64, each pass one fused
multiply-add ``a + (b - a) * t`` in float32).
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


def _source_positions(n_dst: int, scale: float) -> np.ndarray:
    """Source coordinate of each output position along one axis, float64."""
    return (np.arange(n_dst, dtype=np.float64) + 0.5) * (1.0 / scale) - 0.5


def _fixed_taps(n_src: int, n_dst: int, scale: float, clamp: bool):
    """cv2's uint8 INTER_LINEAR taps along one axis: int32 source indices
    (lo, hi) and 11-bit weights (c0, c1), each weight rounded on its own
    from the float32 position. With ``clamp`` (the x axis) a position
    outside [0, n_src - 1] takes the edge pixel whole; without it (the y
    axis) only the indices are clipped and the weights stay as computed."""
    pos = _source_positions(n_dst, scale).astype(np.float32)
    lo = np.floor(pos)
    frac = pos - lo
    lo = lo.astype(np.int32)
    if clamp:
        below = lo < 0
        lo[below], frac[below] = 0, 0.0
        above = lo >= n_src - 1
        lo[above], frac[above] = n_src - 1, 0.0
    one = np.float32(2048.0)
    c0 = np.rint((np.float32(1.0) - frac) * one).astype(np.int32)
    c1 = np.rint(frac * one).astype(np.int32)
    return (np.clip(lo, 0, n_src - 1), np.clip(lo + 1, 0, n_src - 1), c0, c1)


def _float_taps(n_src: int, n_dst: int, scale: float):
    """IPP's float INTER_LINEAR taps along one axis: source indices (lo, hi)
    and the float32 weight t of hi, from float64 positions. Before the
    first pixel t is 0 on pixel 0; past the last, IPP blends pixels n-2 and
    n-1 with t = 1 (which rounds b - a + a, so it is not always b)."""
    pos = _source_positions(n_dst, scale)
    lo = np.floor(pos)
    t = pos - lo
    lo = lo.astype(np.intp)
    below = lo < 0
    lo[below], t[below] = 0, 0.0
    above = lo >= n_src - 1
    lo[above], t[above] = max(n_src - 2, 0), (1.0 if n_src > 1 else 0.0)
    return lo, np.minimum(lo + 1, n_src - 1), t.astype(np.float32)


def _lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """float32 fma(b - a, t, a): the product of two float32 values is exact
    in float64, so one rounding of the float64 sum to float32 gives it."""
    d = np.subtract(b, a).astype(np.float64)
    d *= t
    d += a
    return d.astype(np.float32)


_CHUNK_ROWS = 16  # output rows a step: the step's arrays stay in the cache


def _row_chunks(y0: np.ndarray, y1: np.ndarray, out_h: int):
    """(first, end) output rows of each step and (lo, hi) the source rows
    its vertical pass reads."""
    for r0 in range(0, out_h, _CHUNK_ROWS):
        r1 = min(out_h, r0 + _CHUNK_ROWS)
        yield r0, r1, int(y0[r0:r1].min()), int(y1[r0:r1].max()) + 1


def _columns(px: np.ndarray, cols: np.ndarray, dtype, tail) -> np.ndarray:
    """Gather whole pixels (one void element each) of rows px at cols, back
    as (rows, len(cols)) + tail of dtype."""
    g = np.ascontiguousarray(px[:, cols])
    return g.view(dtype).reshape(g.shape + tail)


def _resize(img: np.ndarray, out_h: int, out_w: int, scale: float):
    h, w = img.shape[:2]
    tail = img.shape[2:]
    src = np.ascontiguousarray(img)
    item = src.dtype.itemsize * int(np.prod(tail, dtype=np.int64))
    px = src.reshape(h, w, -1).view(np.dtype((np.void, item))).reshape(h, w)
    ones = (1,) * len(tail)
    if src.dtype == np.uint8:
        x0, x1, a0, a1 = _fixed_taps(w, out_w, scale, clamp=True)
        y0, y1, b0, b1 = _fixed_taps(h, out_h, scale, clamp=False)
        a0, a1 = a0.reshape((1, out_w) + ones), a1.reshape((1, out_w) + ones)
        b0, b1 = b0.reshape((out_h, 1) + ones), b1.reshape((out_h, 1) + ones)
        out = np.empty((out_h, out_w) + tail, np.uint8)
        for r0, r1, lo, hi in _row_chunks(y0, y1, out_h):
            rows = px[lo:hi]
            # horizontal pass: 22-bit sums, kept at 18 bits for the vertical
            hor = (_columns(rows, x0, np.uint8, tail).astype(np.int32) * a0
                   + _columns(rows, x1, np.uint8, tail).astype(np.int32) * a1) >> 4
            v = (((hor[y0[r0:r1] - lo] * b0[r0:r1]) >> 16)
                 + ((hor[y1[r0:r1] - lo] * b1[r0:r1]) >> 16) + 2) >> 2
            out[r0:r1] = v
        return out
    x0, x1, tx = _float_taps(w, out_w, scale)
    y0, y1, ty = _float_taps(h, out_h, scale)
    tx = tx.astype(np.float64).reshape((1, out_w) + ones)
    ty = ty.astype(np.float64).reshape((out_h, 1) + ones)
    out = np.empty((out_h, out_w) + tail, np.float32)
    for r0, r1, lo, hi in _row_chunks(y0, y1, out_h):
        rows = px[lo:hi]
        hor = _lerp(_columns(rows, x0, src.dtype, tail).astype(np.float32),
                    _columns(rows, x1, src.dtype, tail).astype(np.float32), tx)
        out[r0:r1] = _lerp(hor[y0[r0:r1] - lo], hor[y1[r0:r1] - lo], ty[r0:r1])
    return out


def resize_image(img: np.ndarray, min_side: int = 800, max_side: int = 1333):
    """Resize an (H, W, C) image so its min side is min_side (capped by
    max_side). Returns (image, scale): a uint8 image for uint8 input, else
    float32, equal to the reference's cv2 resize bit for bit; a scale of 1.0
    returns the input unchanged. Each step resizes 16 output rows from the
    source rows they read, gathering whole pixels."""
    scale = compute_resize_scale(img.shape, min_side=min_side, max_side=max_side)
    if scale == 1.0:
        return img, 1.0
    h, w = img.shape[:2]
    out_h, out_w = int(np.rint(h * scale)), int(np.rint(w * scale))
    return _resize(img, out_h, out_w, scale), scale

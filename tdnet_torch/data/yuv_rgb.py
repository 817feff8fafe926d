"""8-bit YUV -> RGB as the references' libavif runs it (1.3.0 under PIL 12.1,
1.4.2 under cv2 5.0; both hand the conversion to libyuv).

libavif takes the matrix and range from the ``colr`` ``nclx`` box where
the file has one, else from the AV1 sequence header, and passes libyuv's
constants of that matrix: BT.601 (matrix 5, 6 and the unspecified 2),
BT.709 (1) and BT.2020 NCL (9), limited or full range. With its default
``AVIF_CHROMA_UPSAMPLING_AUTOMATIC`` libyuv upsamples chroma with its
bilinear filter (``ScaleRowUp2_Linear`` / ``_Bilinear``: weights 3:1 and
9:3:3:1, the first and last rows and columns from one source row or
column), 4:2:2 horizontally only; 4:4:4 needs none. 4:0:0 has rules of its
own (:func:`_gray`). Each pixel is then libyuv's ``YuvPixel``: ``y1 = (y * 0x0101 * yg)
>> 16``, ``b = clamp((y1 + yb + (u - 128) * ub) >> 6)``, ``g = clamp((y1 +
yb - (u - 128) * ug - (v - 128) * vg) >> 6)``, ``r = clamp((y1 + yb + (v -
128) * vr) >> 6)``. The constants are libyuv's ``kYuv*Constants`` as the
cv2 build holds them (the same on both routes: held equal to PIL and cv2
on the golden pages and the tests' fixtures).

The identity matrix (0) of full-range 4:4:4 is libavif's own copy (G = Y,
B = U, R = V); the chroma-derived matrix (12) takes the matrix of its
primaries; libavif refuses the matrices 3, 10, 11, 13, 14 and past 15 (and
YCgCo, 8, in limited range), gray too; the other matrices, and the
identity elsewhere, are refused by name.
"""

from __future__ import annotations

import numpy as np

__all__ = ["to_rgb", "unpremultiply", "matrix_and_range", "CONSTANTS"]

# libyuv kYuv*Constants: (ub, ug, vg, vr, yg, yb)
CONSTANTS = {
    ("bt601", False): (128, 25, 52, 102, 18997, -1160),   # kYuvI601Constants
    ("bt601", True): (113, 22, 46, 90, 16320, 32),        # kYuvJPEGConstants
    ("bt709", False): (128, 14, 34, 115, 18997, -1160),   # kYuvH709Constants
    ("bt709", True): (119, 12, 30, 101, 16320, 32),       # kYuvF709Constants
    ("bt2020", False): (128, 12, 42, 107, 19003, -1160),  # kYuv2020Constants
    ("bt2020", True): (120, 11, 37, 94, 16320, 32),       # kYuvV2020Constants
}
_MATRIX = {1: "bt709", 2: "bt601", 5: "bt601", 6: "bt601", 9: "bt2020"}


def matrix_and_range(frame, colr):
    """(matrix coefficients, full range) as libavif takes them."""
    if colr is not None and len(colr) >= 11 and colr[:4] == b"nclx":
        mc = int.from_bytes(colr[8:10], "big")
        return mc, bool(colr[10] & 0x80)
    return frame.matrix, frame.full_range


def primaries(frame, colr) -> int:
    if colr is not None and len(colr) >= 11 and colr[:4] == b"nclx":
        return int.from_bytes(colr[4:6], "big")
    return frame.color_primaries


def _up_linear(c: np.ndarray, n: int) -> np.ndarray:
    """libyuv ScaleRowUp2_Linear_Any along the last axis: (..., m) -> n."""
    c = c.astype(np.int64)
    out = np.empty(c.shape[:-1] + (n,), np.int64)
    out[..., 0] = c[..., 0]
    half = ((n - 1) & ~1) // 2
    x = np.arange(half)
    out[..., 1 + 2 * x] = (3 * c[..., x] + c[..., x + 1] + 2) >> 2
    out[..., 2 + 2 * x] = (c[..., x] + 3 * c[..., x + 1] + 2) >> 2
    out[..., n - 1] = c[..., (n - 1) // 2]
    return out


def _up_420(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libyuv's bilinear 4:2:0 upsampling of one chroma plane to (h, w):
    row 0 (and the last row of an even height) from one chroma row, each
    pair of rows between from two with 9:3:3:1 weights."""
    c = c.astype(np.int64)
    out = np.empty((h, w), np.int64)
    out[0] = _up_linear(c[0], w)
    pairs = (h - 1) // 2
    if pairs:
        sa, sb = c[:pairs], c[1:pairs + 1]
        da = np.empty((pairs, w), np.int64)
        db = np.empty((pairs, w), np.int64)
        da[:, 0] = (3 * sa[:, 0] + sb[:, 0] + 2) >> 2
        db[:, 0] = (sa[:, 0] + 3 * sb[:, 0] + 2) >> 2
        half = ((w - 1) & ~1) // 2
        x = np.arange(half)
        a0, a1, b0, b1 = sa[:, x], sa[:, x + 1], sb[:, x], sb[:, x + 1]
        da[:, 1 + 2 * x] = (9 * a0 + 3 * a1 + 3 * b0 + b1 + 8) >> 4
        da[:, 2 + 2 * x] = (3 * a0 + 9 * a1 + b0 + 3 * b1 + 8) >> 4
        db[:, 1 + 2 * x] = (3 * a0 + a1 + 9 * b0 + 3 * b1 + 8) >> 4
        db[:, 2 + 2 * x] = (a0 + 3 * a1 + 3 * b0 + 9 * b1 + 8) >> 4
        m = (w - 1) // 2
        da[:, w - 1] = (3 * sa[:, m] + sb[:, m] + 2) >> 2
        db[:, w - 1] = (sa[:, m] + 3 * sb[:, m] + 2) >> 2
        out[1:1 + 2 * pairs:2] = da
        out[2:2 + 2 * pairs:2] = db
    if not h & 1:
        out[h - 1] = _up_linear(c[pairs], w)
    return out


def _chroma(frame):
    h, w = frame.planes[0].shape
    u, v = frame.planes[1], frame.planes[2]
    if frame.ss_x and frame.ss_y:
        return _up_420(u, h, w), _up_420(v, h, w)
    if frame.ss_x:
        return _up_linear(u, w), _up_linear(v, w)
    return u.astype(np.int64), v.astype(np.int64)


def _gray(frame, full: bool, yuv) -> np.ndarray:
    """4:0:0 as libavif 1.3.0 and 1.4.2 convert it: full-range Y kept;
    limited range widened in float, ``(y - 16) * 255 / 219`` rounded (never
    a tie), for an RGB image, and through libyuv's ``I400ToARGBMatrix``
    (``yuv``: the matrix's constants, where libyuv has them) for the RGBA
    image of a file with alpha."""
    y = frame.planes[0]
    if full:
        gray = y
    elif yuv is not None:
        gray = np.clip((((y.astype(np.int64) * 0x0101 * yuv[4]) >> 16) + yuv[5]) >> 6, 0, 255)
    else:
        gray = np.clip(np.floor((y.astype(np.float64) - 16) * 255 / 219 + 0.5), 0, 255)
    return np.repeat(gray.astype(np.uint8)[:, :, None], 3, 2)


def to_rgb(frame, colr, alpha: bool = False) -> np.ndarray:
    """A decoded frame (``av1.DecodedFrame``) -> (H, W, 3) uint8 RGB as
    libavif converts it; ``alpha``: the file has an alpha item (libavif
    then converts to RGBA)."""
    mc, full = matrix_and_range(frame, colr)
    if mc in (3, 10, 11, 13, 14) or mc > 15 or (mc == 8 and not full):
        raise ValueError(f"AVIF matrix coefficients {mc}{'' if full else ' in limited range'}: "
                         "libavif converts no such YUV")
    if mc == 12:  # chroma-derived NCL: libavif takes the primaries' matrix
        mc = {1: 1, 5: 6, 6: 6, 9: 9}.get(primaries(frame, colr), 12)
    if frame.mono:
        name = _MATRIX.get(mc)
        return _gray(frame, full, CONSTANTS[(name, full)] if alpha and name else None)
    if mc == 0:
        if frame.ss_x or frame.ss_y or not full:
            raise ValueError("AVIF identity matrix on subsampled or limited-range YUV: not read")
        y, u, v = frame.planes
        return np.stack([v, y, u], -1).astype(np.uint8)
    name = _MATRIX.get(mc)
    if name is None:
        raise ValueError(f"AVIF matrix coefficients {mc}: not read")
    ub, ug, vg, vr, yg, yb = CONSTANTS[(name, full)]
    y = frame.planes[0].astype(np.int64)
    u, v = _chroma(frame)
    y1 = ((y * 0x0101 * yg) >> 16) + yb
    u = u - 128
    v = v - 128
    b = np.clip((y1 + u * ub) >> 6, 0, 255)
    g = np.clip((y1 - u * ug - v * vg) >> 6, 0, 255)
    r = np.clip((y1 + v * vr) >> 6, 0, 255)
    return np.stack([r, g, b], -1).astype(np.uint8)


def unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """libavif's ``avifRGBImageUnpremultiplyAlpha`` of 8-bit RGBA, the same
    in 1.3.0 and 1.4.2 (found over all 2^16 value and alpha pairs): alpha
    255 keeps the value and 0 gives 0; between, libyuv's
    ``ARGBUnattenuate`` multiplies ``v * 0x0101`` by the 16-bit reciprocal
    ``0x10000 // a`` (0xffff for a = 1) and keeps the high half, which its
    signed pack turns to 0 from 32768 and clamps to 255 below."""
    a = alpha.astype(np.int64)[:, :, None]
    inv = np.where(a == 1, 0xFFFF, (0x10000 // np.maximum(a, 1)) & 0xFFFF)
    t = (rgb.astype(np.int64) * 0x0101 * inv) >> 16
    out = np.where(t >= 32768, 0, np.minimum(t, 255))
    out = np.where(a == 255, rgb, np.where(a == 0, 0, out))
    return out.astype(np.uint8)

"""SPIDER 2-D image decoding, equal byte for byte to PIL's
``Image.open(path).convert("RGB")`` (``SpiderImagePlugin``), the
reference's file route. cv2 does not read SPIDER, so the ``cv2`` route
refuses it.

SPIDER has no magic number, so PIL offers it every file that its earlier
plugins pass on. It reads 27 floats, big-endian first, else little-endian
(a file under 108 bytes passes on), and takes a header whose fields 1, 2,
5, 12, 13, 22 and 23 are whole numbers, whose form (5) is 1, 3, -11, -12,
-21 or -22 and whose header length (22) is the records (13) times the
record length (23) and not 0; a form other than 1 passes on. A single
image (stack 0, number 0) lies after the header; a stack's first image
(stack above 0, number 0) after a second header; an image of a stack (stack
0, number above 0) fails, as does a stack or number field that is not a
finite number; other stack values pass on. The pixels are 32-bit floats in
the header's byte order, which ``convert("RGB")`` takes to 8 bits by way
of ``L``: clipped to 0..255, truncated, NaN 0.
"""

from __future__ import annotations

import math
import struct
from typing import Optional, Tuple

import numpy as np

from tdnet_torch.data import plugins

__all__ = ["READS", "ROUTES", "is_spider", "decode_spider", "spider_size"]

READS = "SPIDER (a 2-D image, or a stack's first)"
ROUTES = ("pil", "cv2")


def _integral(f: float) -> bool:
    return not (math.isnan(f) or math.isinf(f)) and int(f) == f


def _header_length(h) -> int:
    """SpiderImagePlugin's ``isSpiderHeader`` on h (1-based): the header's
    length, or 0."""
    if not all(_integral(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _open(data: bytes) -> Optional[tuple]:
    """(width, height, byte order, offset) of the image PIL opens, None
    where PIL passes the file on; ValueError where it fails."""
    if len(data) < 108:
        return None
    for end in "><":
        h = (99.0,) + struct.unpack(end + "27f", data[:108])
        length = _header_length(h)
        if length:
            break
    else:
        return None
    if int(h[5]) != 1:
        return None
    if not all(math.isfinite(h[i]) for i in (24, 27)):
        raise ValueError("SPIDER stack field that is not a finite number: PIL fails on it")
    stack, number = int(h[24]), int(h[27])
    if stack == 0 and number == 0:
        offset = length
    elif stack > 0 and number == 0:
        if not math.isfinite(h[26]):
            raise ValueError("SPIDER stack count that is not a finite number: PIL fails on it")
        offset = 2 * length
    elif stack == 0 and number > 0:
        raise ValueError("SPIDER image inside a stack: PIL fails on it (no stack offset)")
    else:
        return None  # inconsistent stack header values
    width, height = int(h[12]), int(h[2])
    if width <= 0 or height <= 0:
        return None
    return width, height, end, offset


def is_spider(data: bytes) -> bool:
    """PIL's SPIDER plugin takes it (opens it, or fails in it)."""
    try:
        return _open(bytes(data)) is not None
    except ValueError:
        return True


def _opened(data: bytes) -> tuple:
    opened = _open(data)
    if opened is None:
        raise ValueError(f"not a SPIDER file PIL opens; this reader takes {READS}")
    plugins.check_bomb(opened[0], opened[1], "SPIDER")
    return opened


def spider_size(data: bytes) -> Tuple[int, int]:
    """(width, height), as PIL's ``.size``."""
    return _opened(bytes(data))[:2]


def float_to_l(v: np.ndarray) -> np.ndarray:
    """PIL's ``F`` to ``L``: clipped to 0..255 and truncated, NaN 0."""
    return np.where(np.isnan(v), 0, np.clip(v, 0, 255)).astype(np.uint8)


def decode_spider(data: bytes, route: str = "pil") -> np.ndarray:
    """SPIDER bytes -> (H, W, 3) uint8 RGB, equal to PIL's
    ``convert("RGB")``; the ``cv2`` route raises (OpenCV does not read
    SPIDER)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("SPIDER: OpenCV cannot read it (cv2.imdecode returns None)")
    data = bytes(data)
    width, height, end, offset = _opened(data)
    n = width * height
    if offset < 0 or len(data) < offset + 4 * n:
        raise ValueError("SPIDER pixels end early: PIL fails on it (image file is truncated)")
    v = np.frombuffer(data, end + "f4", n, offset).reshape(height, width)
    return np.repeat(float_to_l(v)[:, :, None], 3, axis=2)

"""Radiance HDR (RGBE) decoding in Python and numpy, equal byte for byte to
``cv2.imdecode(buf, cv2.IMREAD_COLOR)``, the reference's decoder for serve
bodies (``route="cv2"``). PIL cannot identify the format, so the file
route (``route="pil"``) refuses it, as ``read_image_bgr``'s reference does.

OpenCV reads the file with Greg Ward's and Bruce Walter's ``rgbe.c``
(each rule probed against cv2 5.0):

- The body must start ``#?RGBE`` or ``#?RADIANCE``. The header is read a
  line at a time as ``fgets`` into 128 bytes reads it (at most 127 bytes,
  up to and with a line feed). A line that is exactly
  ``FORMAT=32-bit_rle_rgbe`` and its line feed must come before the first
  blank line (a line feed alone), which ends the header; a carriage
  return before a line feed makes the line another one. The line after
  the header must read as ``sscanf("-Y %d +X %d")`` (its text ends at a
  NUL): rows top to bottom, columns left to right, the only orientation
  read. A size of 0 or less, or past cv2's limits (2**20 a side, 2**30
  pixels), refuses.
- Scanlines: a width under 8 or past 32767 reads flat 4-byte R, G, B, E
  pixels. Otherwise each scanline starts 2, 2, then its width in 16 bits
  (a top bit set, or other bytes, make that pixel and every one after it
  flat); its four channels follow one after another, each in runs (a
  count past 128: count - 128 copies of the next byte) and literal spans
  (a count of 1 to 128, then that many bytes). A count of 0, a run past
  the channel's end, a scanline of another width or data that ends early
  refuses.
- A pixel is ``m * 2**(e - 136)`` for each mantissa m (0 where e is 0),
  a float32 that ``convertTo(CV_8U, 255)`` multiplies by 255 (exactly) and
  rounds half to even into 0..255; at 2**31 and past, cvRound overflows
  and the sample is 0. cv2's BGR output is the file's R, G, B, as this
  module returns it.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

__all__ = ["SIGNATURES", "READS", "ROUTES", "decode_hdr", "is_hdr"]

SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
READS = "Radiance HDR (RGBE, flat or run-length scanlines) by the cv2 route"
ROUTES = ("pil", "cv2")
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_SIZE = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")
_CV2_MAX_SIDE, _CV2_MAX_PIXELS = 1 << 20, 1 << 30


def is_hdr(data: bytes) -> bool:
    return data.startswith(SIGNATURES)


def _fgets(data: bytes, pos: int) -> Tuple[bytes, int]:
    """``fgets(buf, 128, fp)``: the line and the position after it."""
    if pos >= len(data):
        raise ValueError("Radiance HDR header ends early")
    end = data.find(b"\n", pos, pos + 127)
    stop = end + 1 if end >= 0 else min(pos + 127, len(data))
    return data[pos:stop], stop


def _header(data: bytes) -> Tuple[int, int, int]:
    """``RGBE_ReadHeader`` -> (width, height, offset of the pixels)."""
    if not is_hdr(data):
        raise ValueError(f"not a Radiance HDR file; this reader takes {READS}")
    line, pos = _fgets(data, 0)
    while line != _FORMAT:
        if line == b"\n":
            raise ValueError("Radiance HDR header without FORMAT=32-bit_rle_rgbe before its "
                             "blank line")
        line, pos = _fgets(data, pos)
    while line != b"\n":
        line, pos = _fgets(data, pos)
    line, pos = _fgets(data, pos)
    m = _SIZE.match(line.split(b"\0", 1)[0])
    if m is None:
        raise ValueError("Radiance HDR size line is not '-Y <rows> +X <columns>' (the only "
                         "orientation cv2 reads)")
    height, width = int(m.group(1)), int(m.group(2))
    if (width <= 0 or height <= 0 or max(width, height) > _CV2_MAX_SIDE
            or width * height > _CV2_MAX_PIXELS):
        raise ValueError(f"Radiance HDR of {width}x{height}: cv2 refuses that size")
    return width, height, pos


def _flat(data: bytes, pos: int, n: int) -> np.ndarray:
    if pos + 4 * n > len(data):
        raise ValueError("Radiance HDR pixels end early")
    return np.frombuffer(data, np.uint8, 4 * n, pos).reshape(n, 4)


def _pixels(data: bytes, pos: int, width: int, height: int) -> np.ndarray:
    """``RGBE_ReadPixels_RLE`` -> (height * width, 4) R, G, B, E bytes."""
    if width < 8 or width > 0x7FFF:
        return _flat(data, pos, width * height)
    out = np.empty((height, 4, width), np.uint8)
    for row in range(height):
        head = data[pos:pos + 4]
        if len(head) < 4:
            raise ValueError("Radiance HDR pixels end early")
        if head[0] != 2 or head[1] != 2 or head[2] & 0x80:  # flat from this pixel on
            rows = out.transpose(0, 2, 1).reshape(height * width, 4)[:row * width]
            return np.concatenate([rows, _flat(data, pos, (height - row) * width)])
        if (head[2] << 8 | head[3]) != width:
            raise ValueError("Radiance HDR scanline of the wrong width")
        pos += 4
        for channel in range(4):
            line, x = out[row, channel], 0
            while x < width:
                if pos + 2 > len(data):
                    raise ValueError("Radiance HDR pixels end early")
                count, value = data[pos], data[pos + 1]
                pos += 2
                if count > 128:
                    count -= 128
                    if count > width - x:
                        raise ValueError("Radiance HDR run past its scanline")
                    line[x:x + count] = value
                else:
                    if count == 0 or count > width - x:
                        raise ValueError("Radiance HDR scanline data of a bad count")
                    if pos + count - 1 > len(data):
                        raise ValueError("Radiance HDR pixels end early")
                    line[x] = value
                    line[x + 1:x + count] = np.frombuffer(data, np.uint8, count - 1, pos)
                    pos += count - 1
                x += count
    return out.transpose(0, 2, 1).reshape(height * width, 4)


def decode_hdr(data: bytes, route: str = "cv2") -> np.ndarray:
    """Radiance HDR bytes -> (H, W, 3) uint8 RGB as ``cv2.imdecode(...,
    IMREAD_COLOR)`` gives it, channels flipped (``route="cv2"``); the
    ``"pil"`` route raises, as PIL cannot identify the file."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    data = bytes(data)
    if route == "pil":
        raise ValueError("Radiance HDR: PIL cannot identify it, so the pil route does not "
                         "read it")
    width, height, pos = _header(data)
    px = _pixels(data, pos, width, height).astype(np.int64)
    # m * 2**(e - 136) * 255, exact in float64 as in float32
    value = px[:, :3] * 255 * np.exp2(px[:, 3:] - 136.0)
    value = np.where(px[:, 3:] == 0, 0.0, value)
    rounded = np.where(value < 2.0 ** 31, np.rint(np.minimum(value, 2.0 ** 31)), 0.0)
    return np.minimum(rounded, 255).astype(np.uint8).reshape(height, width, 3)

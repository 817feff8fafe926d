"""Sun raster decoding in Python and numpy, equal byte for byte to the two
decoders the reference reads pages with: PIL's ``Image.open(path).
convert("RGB")`` for files (``route="pil"``, ``SunImagePlugin`` and its
``sun_rle`` decoder) and ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` for serve
bodies (``route="cv2"``, OpenCV's ``grfmt_sunras.cpp``).

Reads the 32-byte big-endian header, an RGB colormap (its red, green and
blue planes one after another) and the pixels: 1, 4, 8, 24 or 32 bits, rows
padded to 16 bits, the standard types (0 old, 1 standard; 4 and 5, TIFF
and IFF conversions) and the byte-encoded (2) and RGB (3) ones. The routes
part where their decoders do:

- cv2 reads types 0 and 1 only (its header check tests the wrong field
  for types 2 and 3), at 1, 8, 24 and 32 bits, a colormap only at 8 bits
  or fewer and of at most 2^depth entries; everything else raises on its
  route.
- 1 bit: PIL takes a set bit for black, cv2 for white (or the colormap's
  second entry); PIL refuses a colormap at 1 bit.
- 32 bits: cv2 reads each pixel as pad, blue, green, red; PIL as blue,
  green, red, pad (red, green, blue, pad in type 3).
- Byte-encoded (PIL only): runs ``0x80 n v`` of n + 1 bytes v, ``0x80 0``
  a literal 0x80, every other byte itself; PIL decodes rows of whole
  bytes, not padded to 16 bits, and lets a run cross into the next row.
- 4 bits (PIL only): gray samples scaled by 17, or colormap indices.
- PIL refuses a colormap at 1, 24 and 32 bits, and a page 1 pixel wide
  whose length field is 1 or 4: its GIMP brush plugin, tried first, takes
  that header for a brush's (``.size`` then reports the brush's size) and
  fails to load it.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

__all__ = ["SIGNATURE", "READS", "ROUTES", "decode_sunras", "sunras_size"]

SIGNATURE = b"\x59\xa6\x6a\x95"
READS = "Sun raster (1, 4, 8, 24 and 32 bits; standard, byte-encoded and RGB types)"
ROUTES = ("pil", "cv2")

_TYPES = {0: "old", 1: "standard", 2: "byte-encoded", 3: "RGB", 4: "TIFF", 5: "IFF"}


def _header(data: bytes):
    if data[:4] != SIGNATURE:
        raise ValueError(f"not a Sun raster file; this reader takes {READS}")
    if len(data) < 32:
        raise ValueError("truncated Sun raster header")
    _, width, height, depth, _, kind, map_type, map_length = struct.unpack(">8I", data[:32])
    return width, height, depth, kind, map_type, map_length


def _gimp_brush(data: bytes) -> bool:
    """PIL's ``GbrImagePlugin`` claims the header: a second word of 1 (a
    version-1 brush) with nonzero third and fourth words and a fifth of 1
    or 4 (its colour depth)."""
    _, version, width, height, depth = struct.unpack(">5I", data[:20])
    return version == 1 and width > 0 and height > 0 and depth in (1, 4)


def _rle(data: bytes, row_bytes: int, rows: int) -> np.ndarray:
    """PIL's ``SunRleDecode``: (rows, row_bytes) bytes from the encoded
    stream; a run may cross rows; a stream that ends early raises."""
    out = bytearray()
    need, pos, n = row_bytes * rows, 0, len(data)
    while len(out) < need:
        if pos >= n:
            raise ValueError("Sun raster byte-encoded data ends early: image file is truncated")
        b = data[pos]
        if b != 0x80:
            out.append(b)
            pos += 1
        elif pos + 1 < n and data[pos + 1] == 0:
            out.append(0x80)
            pos += 2
        elif pos + 2 < n:
            out += bytes([data[pos + 2]]) * (data[pos + 1] + 1)
            pos += 3
        else:
            raise ValueError("Sun raster byte-encoded data ends early: image file is truncated")
    return np.frombuffer(bytes(out[:need]), np.uint8).reshape(rows, row_bytes)


def _bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """Rows of packed 1- or 4-bit samples -> (rows, width) values."""
    if depth == 1:
        return np.unpackbits(rows, axis=1)[:, :width]
    return np.stack([rows >> 4, rows & 15], axis=2).reshape(rows.shape[0], -1)[:, :width]


def _pil(data: bytes) -> np.ndarray:
    width, height, depth, kind, map_type, map_length = _header(data)
    if _gimp_brush(data):
        raise ValueError("Sun raster 1 pixel wide with a length field of 1 or 4: PIL opens it "
                         "as a GIMP brush and fails to load it (not enough image data)")
    if width <= 0 or height <= 0:
        raise ValueError(f"bad Sun raster size {width}x{height}")
    if depth not in (1, 4, 8, 24, 32):
        raise ValueError(f"Sun raster at {depth} bits: PIL reads 1, 4, 8, 24 and 32")
    if kind not in _TYPES:
        raise ValueError(f"Sun raster type {kind}: PIL reads types 0 to 5")
    palette = None
    if map_length:
        if map_length > 1024 or map_type != 1:
            raise ValueError(f"Sun raster colormap of type {map_type}, {map_length} bytes: PIL "
                             "reads an RGB one of at most 1024 bytes")
        if depth not in (4, 8):
            raise ValueError(f"{depth}-bit Sun raster with a colormap: PIL has no mode for "
                             "it (unrecognized image mode)")
        raw = np.frombuffer(data, np.uint8, min(map_length, len(data) - 32), 32)
        n = map_length // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = raw[:3 * n].reshape(3, n).T
    offset = 32 + map_length
    row_bytes = (width * depth + 7) // 8
    if kind == 2:
        rows = _rle(data[offset:], row_bytes, height)
    else:
        stride = (width * depth + 15) // 16 * 2
        if offset + stride * height > len(data):
            raise ValueError("Sun raster data ends early: image file is truncated")
        rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    if depth == 1:
        return np.repeat(((1 - _bits(rows, width, 1)) * 255).astype(np.uint8)[:, :, None], 3,
                         axis=2)
    if depth in (4, 8):
        values = _bits(rows, width, 4) if depth == 4 else rows[:, :width]
        if palette is not None:
            return palette[values]
        gray = values * 17 if depth == 4 else values
        return np.repeat(gray.astype(np.uint8)[:, :, None], 3, axis=2)
    px = rows[:, :width * depth // 8].reshape(height, width, depth // 8)[:, :, :3]
    return np.ascontiguousarray(px if kind == 3 else px[:, :, ::-1])


def _cv2(data: bytes) -> np.ndarray:
    width, height, depth, kind, map_type, map_length = _header(data)
    entries = (1 << depth) * 3 if 0 < depth <= 8 else 0
    if not (width > 0 and height > 0 and depth in (1, 8, 24, 32)):
        raise ValueError(f"Sun raster {width}x{height} at {depth} bits: OpenCV reads 1, 8, 24 "
                         "and 32 bits")
    if kind not in (0, 1):
        raise ValueError(f"Sun raster type {kind} ({_TYPES.get(kind, 'unknown')}): OpenCV "
                         "reads types 0 and 1 only")
    if not ((map_type == 0 and map_length == 0)
            or (map_type == 1 and 0 < map_length <= entries and depth <= 8)):
        raise ValueError(f"Sun raster colormap of type {map_type}, {map_length} bytes at "
                         f"{depth} bits: OpenCV refuses it")
    if 32 + map_length > len(data):
        raise ValueError("Sun raster colormap runs past the end of the file")
    if map_length:
        n = map_length // 3
        raw = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n).T
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = raw
    elif depth <= 8:  # FillGrayPalette: 1 bit black and white
        ramp = np.arange(256) * 255 // ((1 << depth) - 1)
        palette = np.repeat(np.minimum(ramp, 255).astype(np.uint8)[:, None], 3, axis=1)
    offset = 32 + map_length
    stride = ((width * depth + 7) // 8 + 1) & -2
    if offset + stride * height > len(data):
        raise ValueError("Sun raster data ends early: OpenCV fails on it")
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    if depth <= 8:
        return palette[_bits(rows, width, 1) if depth == 1 else rows[:, :width]]
    px = rows[:, :width * depth // 8].reshape(height, width, depth // 8)
    return np.ascontiguousarray(px[:, :, :0:-1] if depth == 32 else px[:, :, ::-1])


def decode_sunras(data: bytes, route: str = "pil") -> np.ndarray:
    """Sun raster bytes -> (H, W, 3) uint8 RGB, equal to PIL's
    ``convert("RGB")`` (``route="pil"``) or to ``cv2.imdecode(...,
    IMREAD_COLOR)`` with its channels flipped (``route="cv2"``)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    data = bytes(data)
    return _pil(data) if route == "pil" else _cv2(data)


def sunras_size(data: bytes) -> Tuple[int, int]:
    """(width, height) from the header, as PIL's ``.size`` (of a GIMP brush
    where PIL takes the header for one: the height and the depth)."""
    data = bytes(data)
    width, height, depth = _header(data)[:3]
    return (height, depth) if _gimp_brush(data) else (width, height)

"""BMP decoding with numpy, equal byte for byte to the reference's two
decoders: PIL's ``convert("RGB")`` for files (``route="pil"``) and
``cv2.imdecode(..., IMREAD_COLOR)`` for serve bodies (``route="cv2"``).

Reads BI_RGB at 1, 4 and 8 bits (palette), 16 (5-5-5), 24 and 32 bits, and
BI_BITFIELDS at 16 bits (5-6-5 or 5-5-5) and 32 bits (8-8-8 in the usual
places), with any of the header versions (OS/2 core, 40, 52, 56, 108, 124
bytes), bottom-up or top-down rows padded to 4 bytes. Alpha is dropped.
The routes differ only at 16 bits: PIL scales a 5-bit sample by ``v * 255
// 31`` (6-bit: ``// 63``), cv2 shifts it left. RLE compression raises.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

__all__ = ["SIGNATURE", "READS", "ROUTES", "decode_bmp", "bmp_size"]

SIGNATURE = b"BM"
READS = ("BMP (BI_RGB at 1, 4, 8, 16, 24 and 32 bits; BI_BITFIELDS at 16 and "
         "32 bits)")
ROUTES = ("pil", "cv2")

_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3
_MASKS_16 = {(0xF800, 0x07E0, 0x001F): (11, 5, 0, 5, 6, 5),
             (0x7C00, 0x03E0, 0x001F): (10, 5, 0, 5, 5, 5)}
_MASKS_32 = (0xFF0000, 0x00FF00, 0x0000FF)


def _header(data: bytes):
    """(width, height, top-down, bits, compression, colours used, header
    size, pixel offset) of a BMP."""
    if not data.startswith(SIGNATURE) or len(data) < 26:
        raise ValueError(f"not a BMP file; this reader takes {READS}")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    if size == 12:
        width, height, _, bits = struct.unpack("<hhHH", data[18:26])
        compression, colors = _BI_RGB, 0
    elif size in (40, 52, 56, 64, 108, 124) and len(data) >= 14 + 40:
        width, height, _, bits, compression, _, _, _, colors = struct.unpack(
            "<iiHHIIiiI", data[18:50])
    else:
        raise ValueError(f"BMP header of {size} bytes is not read")
    top_down = height < 0
    return width, abs(height), top_down, bits, compression, colors, size, offset


def bmp_size(data: bytes) -> Tuple[int, int]:
    """(width, height) from the header."""
    width, height = _header(data)[:2]
    return width, height


def _rows(data: bytes, offset: int, width: int, height: int, bits: int,
          top_down: bool) -> np.ndarray:
    stride = ((width * bits + 31) >> 5) * 4
    end = offset + stride * height
    if len(data) < end:
        raise ValueError("truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    return rows if top_down else rows[::-1]


def decode_bmp(data: bytes, route: str = "pil") -> np.ndarray:
    """BMP bytes -> (H, W, 3) uint8 RGB by the rule of ``route``."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    width, height, top_down, bits, compression, colors, size, offset = _header(data)
    if width <= 0 or height == 0:
        raise ValueError(f"bad BMP size {width}x{height}")
    if compression in (_BI_RLE8, _BI_RLE4):
        raise ValueError("RLE-compressed BMP is not read")
    if compression not in (_BI_RGB, _BI_BITFIELDS):
        raise ValueError(f"BMP compression {compression} is not read")
    if compression == _BI_BITFIELDS and bits not in (16, 32):
        raise ValueError(f"BI_BITFIELDS BMP at {bits} bits is not read")
    rows = _rows(data, offset, width, height, bits, top_down)
    if bits in (1, 4, 8):
        entry = 3 if size == 12 else 4
        n = colors or (1 << bits)
        start = 14 + size
        table = np.frombuffer(data[start:start + n * entry], np.uint8)
        if table.size != n * entry:
            raise ValueError("truncated BMP palette")
        palette = np.zeros((1 << bits, 3), np.uint8)
        palette[:min(n, 1 << bits)] = table.reshape(n, entry)[:1 << bits, 2::-1]
        if bits == 8:
            index = rows[:, :width]
        else:
            index = np.unpackbits(rows, axis=1)
            if bits == 4:
                index = (index.reshape(height, -1, 4) * np.uint8([8, 4, 2, 1])).sum(
                    axis=2, dtype=np.uint8)
            index = index[:, :width]
        return palette[index]
    if bits == 24:
        return np.ascontiguousarray(rows[:, :3 * width].reshape(height, width, 3)[:, :, ::-1])
    if bits == 32:
        if compression == _BI_BITFIELDS:
            masks = struct.unpack("<III", data[54:66])
            if masks != _MASKS_32:
                raise ValueError(f"BMP bitfields {tuple(map(hex, masks))} are not read")
        px = rows[:, :4 * width].reshape(height, width, 4)
        return np.ascontiguousarray(px[:, :, 2::-1])
    if bits == 16:
        masks = (0x7C00, 0x03E0, 0x001F)
        if compression == _BI_BITFIELDS:
            masks = struct.unpack("<III", data[54:66])
        if masks not in _MASKS_16:
            raise ValueError(f"BMP bitfields {tuple(map(hex, masks))} are not read")
        rs, gs, bs, rn, gn, bn = _MASKS_16[masks]
        px = rows[:, :2 * width].copy().view("<u2").astype(np.int32)
        out = np.empty((height, width, 3), np.uint8)
        for ch, (shift, nbits) in enumerate(((rs, rn), (gs, gn), (bs, bn))):
            v = (px >> shift) & ((1 << nbits) - 1)
            out[:, :, ch] = v * 255 // ((1 << nbits) - 1) if route == "pil" else v << (8 - nbits)
        return out
    raise ValueError(f"BMP at {bits} bits is not read")

"""Adobe Photoshop (PSD) decoding, equal byte for byte to PIL's
``Image.open(path).convert("RGB")`` (``PsdImagePlugin``), the reference's
file route. cv2 does not read PSD, so the ``cv2`` route refuses it.

``Image.open`` shows a PSD's merged image, the one after the layer
section, not a layer. PIL takes a 26-byte header that starts ``8BPS`` with
version 1, whose colour mode and depth it knows (:data:`MODES`: bitmap,
gray, indexed, RGB, CMYK, multichannel, duotone and Lab at 8 bits, bitmap
at 1; else it passes the file on) and that has the channels its mode
needs (else it fails); RGB with exactly 4 channels is RGBA. It steps over
the colour-mode data (a palette where it is 768 bytes, R, G then B), the
image resources (each walked: a short one passes the file on) and the
layer section, then reads the compression: 0 is each channel's raw rows
one after the other, 1 is PackBits with a 16-bit byte count for every
row of every channel (which it walks, so they must be there) and each
channel's runs read from its first row's bytes on, whatever the counts
say (PIL's ``packbits`` decoder: a run that passes a row's end is cut
there). Any other compression has no image to load, and fails. The
channels are bands of PIL's mode: bitmap bits set white, CMYK stored
inverted, Lab's a and b offset by 128 (PIL's ``LAB`` to RGB conversion,
``cielab.py``).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from tdnet_torch.data import cielab, jpeg, plugins

__all__ = ["READS", "ROUTES", "MODES", "is_psd", "decode_psd", "psd_size"]

READS = "PSD (the merged image: raw or PackBits, bitmap, gray, indexed, RGB(A), CMYK, Lab)"
ROUTES = ("pil", "cv2")

MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
         (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
         (9, 8): ("LAB", 3)}


class _Pass(Exception):
    pass


def _u32(data: bytes, pos: int) -> int:
    if len(data) < pos + 4:
        raise _Pass  # struct.error
    return struct.unpack_from(">I", data, pos)[0]


def _u16(data: bytes, pos: int) -> int:
    if len(data) < pos + 2:
        raise _Pass
    return struct.unpack_from(">H", data, pos)[0]


def _open(data: bytes):
    """(mode, channels, width, height, palette, compression, offset)."""
    if not data.startswith(b"8BPS") or len(data) < 26 or _u16(data, 4) != 1:
        raise _Pass
    bits, present, kind = _u16(data, 22), _u16(data, 12), _u16(data, 24)
    if (kind, bits) not in MODES:
        raise _Pass  # KeyError
    mode, channels = MODES[(kind, bits)]
    if channels > present:
        raise ValueError(f"PSD of {present} channels in mode {mode}: PIL fails on it (not "
                         "enough channels)")
    if mode == "RGB" and present == 4:
        mode, channels = "RGBA", 4
    height, width = _u32(data, 14), _u32(data, 18)
    size = _u32(data, 26)
    palette = data[30:30 + size] if mode == "P" and size == 768 else None
    pos = min(len(data), 30 + size)
    size = _u32(data, pos)
    pos += 4
    end = pos + size
    while size and pos < end:  # the image resources, each walked
        pos = min(len(data), pos + 4)
        _u16(data, pos)
        pos += 2
        if pos >= len(data):
            raise _Pass  # IndexError
        name = data[pos + 1:pos + 1 + data[pos]]
        pos = min(len(data), pos + 1 + len(name))
        if not len(name) & 1:
            pos = min(len(data), pos + 1)
        n = _u32(data, pos)
        block = data[pos + 4:pos + 4 + n]
        pos = min(len(data), pos + 4 + len(block))
        if len(block) & 1:
            pos = min(len(data), pos + 1)
    size = _u32(data, pos)
    pos += 4
    if size:
        _u32(data, pos)
        pos += size
    compression = _u16(data, pos)
    pos += 2
    if compression == 1:
        counts = data[pos:pos + 2 * channels * height]
        if len(counts) < 2 * channels * height:
            raise _Pass  # struct.error walking the row counts
        pos += 2 * channels * height
    if width == 0 or height == 0:
        raise _Pass
    return mode, channels, width, height, palette, compression, pos


def _opened(data: bytes):
    try:
        return _open(bytes(data))
    except _Pass:
        return None


def is_psd(data: bytes) -> bool:
    """PIL's PSD plugin takes it (opens it, or fails in it)."""
    try:
        return _opened(data) is not None
    except ValueError:
        return True


def _head(data: bytes):
    opened = _opened(data)
    if opened is None:
        raise ValueError(f"not a PSD file PIL opens; this reader takes {READS}")
    plugins.check_bomb(opened[2], opened[3], "PSD")
    return opened


def psd_size(data: bytes) -> Tuple[int, int]:
    """(width, height), as PIL's ``.size``."""
    return _head(data)[2:4]


def _packbits(data: bytes, pos: int, rows: int, row: int) -> np.ndarray:
    """PIL's ``packbits`` decoder from ``pos``: (rows, row) bytes."""
    out = np.empty((rows, row), np.uint8)
    end = len(data)
    for y in range(rows):
        line, x = bytearray(), 0
        while x < row:
            if pos >= end:
                raise ValueError("PSD PackBits data ends early: PIL fails on it (image file "
                                 "is truncated)")
            b = data[pos]
            if b == 0x80:
                pos += 1
                continue
            if b & 0x80:
                if pos + 2 > end:
                    raise ValueError("PSD PackBits data ends early: PIL fails on it (image "
                                     "file is truncated)")
                n = min(257 - b, row - x)
                line += data[pos + 1:pos + 2] * n
                pos += 2
            else:
                if pos + b + 2 > end:
                    raise ValueError("PSD PackBits data ends early: PIL fails on it (image "
                                     "file is truncated)")
                n = min(b + 1, row - x)
                line += data[pos + 1:pos + 1 + n]
                pos += b + 2
            x += n
        out[y] = np.frombuffer(bytes(line), np.uint8)
    return out, pos


def decode_psd(data: bytes, route: str = "pil") -> np.ndarray:
    """PSD bytes -> (H, W, 3) uint8 RGB of the merged image, equal to PIL's
    ``convert("RGB")``; the ``cv2`` route raises (OpenCV does not read
    PSD)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("PSD: OpenCV cannot read it (cv2.imdecode returns None)")
    data = bytes(data)
    mode, channels, width, height, palette, compression, pos = _head(data)
    if compression not in (0, 1):
        raise ValueError(f"PSD compression {compression}: PIL fails on it (cannot load this "
                         "image)")
    row = (width + 7) // 8 if mode == "1" else width
    counts = np.frombuffer(data, ">u2", channels * height, pos - 2 * channels * height) \
        if compression == 1 else None
    bands = []
    for c in range(channels):
        if compression == 0:
            at = pos + c * width * height
            if len(data) < at + row * height:
                raise ValueError("PSD pixels end early: PIL fails on it (image file is "
                                 "truncated)")
            bands.append(np.frombuffer(data, np.uint8, row * height, at).reshape(height, row))
        else:
            at = pos + int(counts[:c * height].sum(dtype=np.int64))
            bands.append(_packbits(data, at, height, row)[0])
    if mode == "1":
        bits = np.unpackbits(bands[0], axis=1)[:, :width] * np.uint8(255)
        return np.repeat(bits[:, :, None], 3, axis=2)
    if mode == "L":
        return np.repeat(bands[0][:, :, None], 3, axis=2)
    if mode == "P":
        lut = np.zeros((256, 3), np.uint8)
        if palette is not None:
            lut = np.frombuffer(palette, np.uint8).reshape(3, 256).T
        return lut[bands[0]]
    px = np.stack(bands, axis=2)
    if mode == "CMYK":  # PIL's C;I bands: stored inverted, as Adobe's JPEGs
        return jpeg._cmyk_rgb(px, "pil")
    if mode == "LAB":
        return cielab.lcms_rgb(px)
    return np.ascontiguousarray(px[:, :, :3])

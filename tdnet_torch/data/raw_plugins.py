"""The small formats that PIL reads as raw samples, each equal byte for
byte to PIL's ``Image.open(path).convert("RGB")`` and ``.size`` (the
reference's file route); cv2 reads none of them, so the ``cv2`` route
refuses each, by name. Each is a (name, opens, open) triple of
:data:`FORMATS`: ``opens(data)`` tells whether PIL's plugin takes the file
(a file it passes on is False; one it fails on is True and ``open``
raises), ``open(data)`` gives the size and a function that decodes.

- GBR (GIMP brush, ``GbrImagePlugin``): a big-endian header of at least
  20 bytes, version 1 or 2 (``GIMP`` and a spacing after the 20 bytes),
  depth 1 (``L``) or 4 (``RGBA``), the pixels at the header's length.
- FTEX (``FtexImagePlugin``): one format, at the offset given, its size
  first: BC1 (through ``bcn.py``) or raw RGB.
- PIXAR (``PixarImagePlugin``): 512 header bytes of which PIL reads the
  size and the mode; only mode (14, 2), RGB, at byte 1024.
- McIDAS area files (``McIdasImagePlugin``): 64 big-endian words; 1, 2 or
  4 bytes a pixel (``L``, ``I;16B``, ``I;32B``) in rows ``stride`` apart
  from ``offset``, PIL's memory map for the first two (its rows may
  overlap) and its raw decoder for the last.
- IMT (``ImtImagePlugin``): a text header that PIL reads line by line
  (``data/plugins.py`` models where it passes), gray pixels after a form
  feed.
- XV thumbnails (``XVThumbImagePlugin``): ``P7 332``, comment lines, the
  size, then 8-bit pixels through the 3-3-2 palette.

Wider samples go to 8 bits as ``convert("RGB")`` takes them: 16- and
32-bit integers clipped to 0..255.
"""

from __future__ import annotations

import re
import struct
from typing import Callable, Optional, Tuple

import numpy as np

from tdnet_torch.data import bcn, plugins

__all__ = ["READS", "ROUTES", "FORMATS", "opens", "decode", "size"]

READS = ("GBR, FTEX (BC1 or RGB), PIXAR (RGB), McIDAS (8, 16 and 32 bits), IMT and XV "
         "thumbnails")
ROUTES = ("pil", "cv2")


class _Pass(Exception):
    """The plugin passes the file on (SyntaxError, struct.error, ...)."""


def _gray(v: np.ndarray) -> np.ndarray:
    return np.repeat(np.clip(v, 0, 255).astype(np.uint8)[:, :, None], 3, axis=2)


def _need(data: bytes, end: int, what: str) -> None:
    if end > len(data):
        raise ValueError(f"{what} pixels end early: PIL fails on it (image file is truncated)")


def _u32be(data: bytes, at: int) -> int:
    if len(data) < at + 4:
        raise _Pass
    return struct.unpack_from(">I", data, at)[0]


# --- GBR

def _gbr(data: bytes):
    if len(data) < 8:
        raise _Pass
    header, version = _u32be(data, 0), _u32be(data, 4)
    if header < 20 or version not in (1, 2):
        raise _Pass
    width, height, depth = (_u32be(data, at) for at in (8, 12, 16))
    if width == 0 or height == 0 or depth not in (1, 4):
        raise _Pass
    if version == 2:
        if data[20:24] != b"GIMP":
            raise _Pass
        _u32be(data, 24)
    # a version-2 header under 28 bytes reads its comment to the end
    start = header if version == 1 or header >= 28 else len(data)
    plugins.check_bomb(width, height, "GBR")

    def decode():
        n = width * height * depth
        _need(data, start + n, "GBR")
        px = np.frombuffer(data, np.uint8, n, start).reshape(height, width, depth)
        return np.ascontiguousarray(px[:, :, :3]) if depth == 4 else _gray(px[:, :, 0])
    return (width, height), decode


# --- FTEX

def _ftex(data: bytes):
    if not data.startswith(b"FTEX") or len(data) < 24:
        raise _Pass
    width, height, _, count = struct.unpack_from("<4i", data, 8)
    if count != 1:
        raise ValueError(f"FTEX of {count} formats: PIL fails on it (AssertionError)")
    if len(data) < 32:
        raise _Pass
    fmt, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise ValueError("FTEX data offset before the file: PIL fails on it")
    if len(data) < where + 4:
        raise _Pass
    (size,) = struct.unpack_from("<i", data, where)
    body = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"FTEX format {fmt}: PIL fails on it (Invalid texture compression "
                         "format)")
    if width <= 0 or height <= 0:
        raise _Pass
    plugins.check_bomb(width, height, "FTEX")

    def decode():
        if fmt == 1:
            _need(body, 3 * width * height, "FTEX")
            return np.frombuffer(body, np.uint8, 3 * width * height).reshape(height, width, 3)
        across, down = -(-width // 4), -(-height // 4)
        _need(body, 8 * across * down, "FTEX")
        blocks = np.frombuffer(body, np.uint8, 8 * across * down).reshape(-1, 8)
        px = bcn.decode_bc1(blocks)[:, :, :3].reshape(down, across, 4, 4, 3)
        px = px.transpose(0, 2, 1, 3, 4).reshape(4 * down, 4 * across, 3)
        return np.ascontiguousarray(px[:height, :width])
    return (width, height), decode


# --- PIXAR

def _pixar(data: bytes):
    if not data.startswith(b"\x80\xe8\0\0") or len(data) < 428:
        raise _Pass
    height, width = struct.unpack_from("<HH", data, 416)
    if struct.unpack_from("<HH", data, 424) != (14, 2) or width == 0 or height == 0:
        raise _Pass
    plugins.check_bomb(width, height, "PIXAR")

    def decode():
        _need(data, 1024 + 3 * width * height, "PIXAR")
        return np.frombuffer(data, np.uint8, 3 * width * height, 1024).reshape(height, width, 3)
    return (width, height), decode


# --- McIDAS

def _mcidas(data: bytes):
    if not data.startswith(b"\0\0\0\0\0\0\0\4") or len(data) < 256:
        raise _Pass
    w = (0,) + struct.unpack_from(">64i", data)
    depth = w[11]
    if depth not in (1, 2, 4):
        raise _Pass
    width, height = w[10], w[9]
    if width <= 0 or height <= 0:
        raise _Pass
    offset, stride = w[34] + w[15], w[15] + w[10] * w[11] * w[14]
    plugins.check_bomb(width, height, "McIDAS")

    def decode():
        row = width * depth
        if offset < 0:
            raise ValueError("McIDAS data offset before the file: PIL fails on it")
        mapped = depth != 4 and offset + height * stride <= len(data)
        step = stride
        if mapped and stride <= 0:
            step = row
            if offset + height * step > len(data):
                raise ValueError("McIDAS pixels end early: PIL fails on it (buffer is not "
                                 "large enough)")
        elif not mapped and stride == 0:
            step = row  # the raw decoder's rows, packed
        elif not mapped and stride < row:
            raise ValueError("McIDAS rows shorter than their pixels: PIL fails on it (raw "
                             "decoder configuration)")
        _need(data, offset + (height - 1) * step + row, "McIDAS")
        at = offset + step * np.arange(height)[:, None] + np.arange(row)[None, :]
        px = np.frombuffer(data, np.uint8)[at]
        v = px.view(">u2" if depth == 2 else ">i4" if depth == 4 else np.uint8)
        return _gray(v.reshape(height, width))
    return (width, height), decode


# --- IMT

_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")  # ImtImagePlugin.field


def _imt(data: bytes):
    """ImtImagePlugin's header loop: the offset after its form feed, or
    None where it ends without one."""
    buffer = data[:100]
    if b"\n" not in buffer:
        raise _Pass
    pos, width, height, gray, offset = 100, 0, 0, False, None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s, pos = data[pos:pos + 1], pos + 1
        if not s:
            break
        if s == b"\x0c":
            offset = min(pos, len(data)) - len(buffer)
            break
        if b"\n" not in buffer:
            buffer, pos = buffer + data[pos:pos + 100], pos + 100
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                width = int(v)
            elif k == b"height":
                height = int(v)
        except ValueError:
            raise ValueError("IMT size that is not a number: PIL fails on it") from None
        if k == b"pixel" and v == b"n8":
            gray = True
    if not gray or width <= 0 or height <= 0:
        raise _Pass
    plugins.check_bomb(width, height, "IMT")

    def decode():
        if offset is None:
            raise ValueError("IMT header without a form feed: PIL fails on it (cannot load "
                             "this image)")
        _need(data, offset + width * height, "IMT")
        return _gray(np.frombuffer(data, np.uint8, width * height, offset).reshape(height,
                                                                                   width))
    return (width, height), decode


# --- XV thumbnails

_XV_PALETTE = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                        for r in range(8) for g in range(8) for b in range(4)], np.uint8)


def _xv(data: bytes):
    if not data.startswith(b"P7 332"):
        raise _Pass
    pos = data.find(b"\n", 6)
    pos = len(data) if pos < 0 else pos + 1
    while True:
        if pos >= len(data):
            raise _Pass  # Unexpected EOF
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        line, pos = data[pos:end], end
        if line[0] != 35:
            break
    fields = line.strip().split(maxsplit=2)[:2]
    if len(fields) < 2:
        raise ValueError("XV thumbnail without its size: PIL fails on it")
    try:
        width, height = int(fields[0]), int(fields[1])
    except ValueError:
        raise ValueError("XV thumbnail size that is not a number: PIL fails on it") from None
    if width <= 0 or height <= 0:
        raise _Pass
    plugins.check_bomb(width, height, "XV thumbnail")

    def decode():
        _need(data, pos + width * height, "XV thumbnail")
        return _XV_PALETTE[np.frombuffer(data, np.uint8, width * height, pos).reshape(
            height, width)]
    return (width, height), decode


FORMATS = {"GBR": _gbr, "FTEX": _ftex, "PIXAR": _pixar, "MCIDAS": _mcidas, "IMT": _imt,
           "XVTHUMB": _xv}


def _open(name: str, data: bytes) -> Optional[Tuple[Tuple[int, int], Callable]]:
    try:
        return FORMATS[name](bytes(data))
    except _Pass:
        return None


def opens(name: str) -> Callable[[bytes], bool]:
    """Whether PIL's ``name`` plugin takes a file (opens it or fails in
    it)."""
    def takes(data: bytes) -> bool:
        try:
            return _open(name, data) is not None
        except ValueError:
            return True
    return takes


def _opened(name: str, data: bytes):
    opened = _open(name, data)
    if opened is None:
        raise ValueError(f"not a {name} file PIL opens; this reader takes {READS}")
    return opened


def size(name: str) -> Callable[[bytes], Tuple[int, int]]:
    """``name``'s (width, height), as PIL's ``.size``."""
    return lambda data: _opened(name, data)[0]


def decode(name: str) -> Callable[..., np.ndarray]:
    """``name``'s decoder: bytes -> (H, W, 3) uint8 RGB, equal to PIL's
    ``convert("RGB")``; the ``cv2`` route raises (OpenCV reads none of
    these formats)."""
    def decode_format(data: bytes, route: str = "pil") -> np.ndarray:
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        if route == "cv2":
            raise ValueError(f"{name}: OpenCV cannot read it (cv2.imdecode returns None)")
        return _opened(name, data)[1]()
    return decode_format

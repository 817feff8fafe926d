"""PCX (ZSoft Paintbrush) decoding in Python and numpy, equal byte for byte
to PIL's ``Image.open(path).convert("RGB")`` (``PcxImagePlugin`` and its
``pcx`` decoder), the reference's file route. cv2 does not read PCX, so
the ``cv2`` route refuses it.

PIL takes a file whose first byte is 10 and second (the version) 0, 2, 3
or 5 (:data:`SIGNATURES`), and passes on one whose window (``xmax`` below
``xmin`` or ``ymax`` below ``ymin``) is empty. It reads 1 bit in 1 plane
(black and white), 1 bit in 2 or 4 planes (indices into the header's 16
colours), and, in version 5 only, 8 bits in 1 plane (indices into the 256
colours after a 0x0C byte in the file's last 769 bytes, or gray where
there are none or they are the gray ramp) or in 3 (RGB); every other
layout fails on opening. Its rules, each kept:

- Every file is run-length decoded, whatever its encoding byte: a byte of
  0xC0 or more repeats the next ``byte & 0x3F`` times (0 times too); a run
  may not cross the end of a line (PIL: buffer overrun).
- A line is ``planes * stride`` bytes, ``stride`` the bytes of a plane's
  row, rounded up to an even count where the header's own differs from it.
- 1-bit planes are read ``stride`` bytes apart. 8-bit planes are read
  ``width`` bytes apart, after PIL's decoder has moved plane ``i`` from
  ``i * stride`` to ``i * width`` only where the line's length is not a
  multiple of the width: a padded RGB line whose length is reads its
  planes shifted.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from tdnet_torch.data import plugins

__all__ = ["READS", "ROUTES", "is_pcx", "decode_pcx", "pcx_size", "DCX_READS", "is_dcx",
           "decode_dcx", "dcx_size"]

READS = "PCX (1 bit in 1, 2 or 4 planes; 8 bits in 1 or 3 planes)"
ROUTES = ("pil", "cv2")
DCX_READS = "DCX (its first PCX page)"
DCX_MAGIC = 987654321


def accepts(data: bytes) -> bool:
    """PIL's ``PcxImagePlugin._accept``."""
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def _window(data: bytes):
    x0, y0, x1, y1 = struct.unpack("<4H", data[4:12])
    return x0, y0, x1 + 1, y1 + 1


def is_pcx(data: bytes) -> bool:
    """PIL's PCX plugin opens it: a whole 68-byte header with a window that
    is not empty (else PIL goes on to its other readers)."""
    if not accepts(data) or len(data) < 68:
        return False
    x0, y0, x1, y1 = _window(data)
    return x1 > x0 and y1 > y0


def pcx_size(data: bytes) -> Tuple[int, int]:
    """(width, height) of the window, as PIL's ``.size``."""
    data = bytes(data)
    if not is_pcx(data):
        raise ValueError(f"not a PCX file PIL opens; this reader takes {READS}")
    x0, y0, x1, y1 = _window(data)
    plugins.check_bomb(x1 - x0, y1 - y0, "PCX")
    return x1 - x0, y1 - y0


def _lines(data: bytes, line: int, rows: int) -> np.ndarray:
    """PIL's ``PcxDecode`` from byte 128: (rows, line) bytes."""
    out = bytearray()
    need, pos, end, x = line * rows, 128, len(data), 0
    while len(out) < need:
        if pos >= end:
            raise ValueError("PCX data ends early: image file is truncated")
        b = data[pos]
        if b >= 0xC0:
            if pos + 1 >= end:
                raise ValueError("PCX data ends early: image file is truncated")
            n = b & 0x3F
            if x + n > line:
                raise ValueError("PCX run crosses the end of a line: PIL fails on it (buffer "
                                 "overrun)")
            out += data[pos + 1:pos + 2] * n
            pos += 2
        else:
            n = 1
            out.append(b)
            pos += 1
        x = (x + n) % line
    return np.frombuffer(bytes(out), np.uint8).reshape(rows, line)


def _planes_apart(lines: np.ndarray, width: int) -> np.ndarray:
    """PIL's decoder's move of 8-bit planes to ``width`` bytes apart, done
    only where the line's length is not a multiple of the width."""
    n = lines.shape[1]
    if n % width and n > width:
        lines = lines.copy()
        bands = n // width
        step = n // bands
        for i in range(1, bands):
            lines[:, i * width:(i + 1) * width] = lines[:, i * step:i * step + width]
    return lines


def decode_pcx(data: bytes, route: str = "pil") -> np.ndarray:
    """PCX bytes -> (H, W, 3) uint8 RGB, equal to PIL's ``convert("RGB")``;
    the ``cv2`` route raises (OpenCV does not read PCX)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    data = bytes(data)
    if route == "cv2":
        raise ValueError("PCX: OpenCV cannot read it (cv2.imdecode returns None)")
    width, height = pcx_size(data)
    version, bits, planes = data[1], data[3], data[65]
    (given,) = struct.unpack("<H", data[66:68])
    if not ((bits == 1 and planes in (1, 2, 4)) or (version == 5 and bits == 8
                                                     and planes in (1, 3))):
        raise ValueError(f"PCX version {version} at {bits} bits in {planes} planes: PIL "
                         "reads 1 bit in 1, 2 or 4 planes and 8 bits in 1 or 3 (version 5): "
                         "unknown PCX mode")
    stride = (width * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    lines = _lines(data, planes * stride, height)
    if bits == 1:
        px = np.unpackbits(lines, axis=1)
        index = sum(px[:, k * stride * 8:k * stride * 8 + width].astype(np.uint8) << k
                    for k in range(planes))
        if planes == 1:
            return np.repeat((index * np.uint8(255))[:, :, None], 3, axis=2)
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(data, np.uint8, 48, 16).reshape(16, 3)
        return palette[index]
    lines = _planes_apart(lines, width)
    if planes == 3:
        return np.ascontiguousarray(lines[:, :3 * width].reshape(height, 3, width)
                                    .transpose(0, 2, 1))
    index = lines[:, :width]
    tail = data[-769:]
    if len(tail) == 769 and tail[0] == 12:
        palette = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
        return palette[index]
    return np.repeat(index[:, :, None], 3, axis=2)


# --- DCX: a directory of PCX pages, of which PIL reads the first


def _dcx_page(data: bytes):
    """The first page's offset, or None where PIL's DCX plugin passes the
    file on: a directory (up to 1024 offsets, ended by a 0) that ends
    early, no pages, or a first page that PIL's PCX plugin passes on (its
    palette is read from the end of the whole file, its pixels after its
    own header)."""
    if len(data) < 4 or struct.unpack_from("<I", data)[0] != DCX_MAGIC:
        return None
    for i in range(1024):
        if len(data) < 8 + 4 * i:
            return None  # struct.error
        (offset,) = struct.unpack_from("<I", data, 4 + 4 * i)
        if not offset:
            break
        if i == 0:
            first = offset
    else:
        i = 1024
    if i == 0 or not is_pcx(data[first:]):
        return None  # no pages (EOFError), or PCX passes the page on
    return first


def is_dcx(data: bytes) -> bool:
    """PIL's DCX plugin opens it."""
    return _dcx_page(bytes(data)) is not None


def _dcx(data: bytes) -> bytes:
    data = bytes(data)
    first = _dcx_page(data)
    if first is None:
        raise ValueError(f"not a DCX file PIL opens; this reader takes {DCX_READS}")
    return data[first:]


def dcx_size(data: bytes) -> Tuple[int, int]:
    """(width, height) of the first page, as PIL's ``.size``."""
    return pcx_size(_dcx(data))


def decode_dcx(data: bytes, route: str = "pil") -> np.ndarray:
    """DCX bytes -> (H, W, 3) uint8 RGB of the first page, equal to PIL's
    ``convert("RGB")``; the ``cv2`` route raises (OpenCV does not read
    DCX)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("DCX: OpenCV cannot read it (cv2.imdecode returns None)")
    return decode_pcx(_dcx(data), route="pil")

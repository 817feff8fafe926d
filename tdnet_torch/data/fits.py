"""FITS decoding, equal byte for byte to PIL's
``Image.open(path).convert("RGB")`` (``FitsImagePlugin``), the
reference's file route. cv2 does not read FITS, so the ``cv2`` route
refuses it.

PIL reads 80-byte cards: the first must be ``SIMPLE`` with the value
``T`` (else it passes the file on). Each header unit runs to its ``END``
card, after which the file skips to a multiple of 2880 bytes; the cards of
all units go into one table, the later over the earlier. At each ``END``
before an image is found PIL looks for one: ``NAXIS`` 0 means none yet
(the next unit may have one); 1 axis is a 1-pixel-wide column; else
``NAXIS1`` by ``NAXIS2``. ``BITPIX`` 8, 16, 32, -32 or -64 gives ``L``,
``I;16``, ``I`` or ``F`` (another gives no mode, and PIL passes the file
on). A missing card passes the file on, a value that is not an integer
fails, as do a file that ends inside the headers and headers with no
image. The image lies at the card after the unit's header, rows from the
bottom, and PIL reads its samples little-endian (FITS writes them
big-endian): 16 bits as ``I;16``, 32 as ``I``, floats as 4 bytes whatever
``BITPIX`` says. A unit ``XTENSION = 'BINTABLE'`` with ``ZIMAGE = T``
and ``ZCMPTYPE = 'GZIP_1  '`` is PIL's ``fits_gzip`` route: the ``Z``
cards give the image, the gzip stream follows the table's
``NAXIS1 * NAXIS2 * BITPIX / 8`` bytes and runs to the end of the file,
and each pixel is the last ``ZBITPIX / 8`` bytes (at most 4) of a 4-byte
word, read in the same little-endian modes (floats: nothing, which fails).
``convert("RGB")`` takes the samples to 8 bits: integers clipped to
0..255, floats clipped and truncated, NaN 0.
"""

from __future__ import annotations

import gzip
import math
import zlib
from typing import Tuple

import numpy as np

from tdnet_torch.data import plugins
from tdnet_torch.data.spider import float_to_l

__all__ = ["READS", "ROUTES", "is_fits", "decode_fits", "fits_size"]

READS = "FITS (8, 16 and 32-bit integers, 32-bit floats; gzip tiles)"
ROUTES = ("pil", "cv2")

_MODES = {8: ("L", "u1"), 16: ("I;16", "<u2"), 32: ("I", "<i4"), -32: ("F", "<f4"),
          -64: ("F", "<f4")}


class _Pass(Exception):
    pass


def _int(headers, key: bytes) -> int:
    if key not in headers:
        raise _Pass  # KeyError
    try:
        return int(headers[key])
    except ValueError:
        raise ValueError(f"FITS card {key.decode()} that is not an integer: PIL fails on "
                         "it") from None


def _size(headers, prefix: bytes):
    naxis = _int(headers, prefix + b"NAXIS")
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _int(headers, prefix + b"NAXIS1")
    return _int(headers, prefix + b"NAXIS1"), _int(headers, prefix + b"NAXIS2")


def _parse(headers):
    """``_parse_headers``: (gzip, offset, size, bits) or None."""
    prefix, gz, offset = b"", False, 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and _value(headers, b"ZCMPTYPE") == b"'GZIP_1  '"):
        table = _size(headers, b"") or (0, 0)
        offset = table[0] * table[1] * (_int(headers, b"BITPIX") // 8)
        prefix, gz = b"Z", True
    size = _size(headers, prefix)
    if not size:
        return None
    return gz, offset, size, _int(headers, prefix + b"BITPIX")


def _value(headers, key):
    if key not in headers:
        raise _Pass
    return headers[key]


def _open(data: bytes):
    """(gzip, offset of the data, (width, height), bits)."""
    headers, in_progress, found, pos = {}, False, None, 0
    while True:
        card, pos = data[pos:pos + 80], min(len(data), pos + 80)
        if not card:
            raise ValueError("FITS file that ends inside its headers: PIL fails on it "
                             "(Truncated FITS file)")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if found is None:
                found = _parse(headers)
            in_progress = False
            continue
        if found is not None:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise _Pass
        headers[keyword] = value
    if found is None:
        raise ValueError("FITS headers with no image: PIL fails on it (No image data)")
    gz, offset, size, bits = found
    if bits not in _MODES or size[0] <= 0 or size[1] <= 0:
        raise _Pass  # no mode, or an empty size: not identified
    return gz, offset + pos - 80, size, bits


def _opened(data: bytes):
    try:
        return _open(bytes(data))
    except _Pass:
        return None


def is_fits(data: bytes) -> bool:
    """PIL's FITS plugin takes it (opens it, or fails in it)."""
    if not data.startswith(b"SIMPLE"):
        return False
    try:
        return _opened(data) is not None
    except ValueError:
        return True


def _head(data: bytes):
    opened = _opened(data) if bytes(data[:6]) == b"SIMPLE" else None
    if opened is None:
        raise ValueError(f"not a FITS file PIL opens; this reader takes {READS}")
    plugins.check_bomb(*opened[2], "FITS")
    return opened


def fits_size(data: bytes) -> Tuple[int, int]:
    """(width, height), as PIL's ``.size``."""
    return _head(data)[2]


def _to_rgb(v: np.ndarray) -> np.ndarray:
    if v.dtype.kind == "f":
        gray = float_to_l(v)
    else:
        gray = np.clip(v, 0, 255).astype(np.uint8)
    return np.repeat(gray[::-1, :, None], 3, axis=2)


def decode_fits(data: bytes, route: str = "pil") -> np.ndarray:
    """FITS bytes -> (H, W, 3) uint8 RGB, equal to PIL's
    ``convert("RGB")``; the ``cv2`` route raises (OpenCV does not read
    FITS)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("FITS: OpenCV cannot read it (cv2.imdecode returns None)")
    data = bytes(data)
    gz, offset, (width, height), bits = _head(data)
    n = width * height
    dtype = np.dtype(_MODES[bits][1])
    if gz:
        try:
            value = gzip.decompress(data[offset:])
        except (OSError, EOFError, zlib.error) as e:
            raise ValueError(f"FITS gzip data PIL cannot inflate ({e})") from None
        nb = min(bits // 8, 4)
        words = np.frombuffer(value[:len(value) // 4 * 4], np.uint8).reshape(-1, 4)[:n]
        raw = words[:, 4 - nb:].tobytes() if nb > 0 else b""
        if len(raw) < n * dtype.itemsize:
            raise ValueError("FITS gzip data too short for its image: PIL fails on it (not "
                             "enough image data)")
        return _to_rgb(np.frombuffer(raw, dtype, n).reshape(height, width))
    if offset < 0 or len(data) < offset + n * dtype.itemsize:
        raise ValueError("FITS pixels end early: PIL fails on it (image file is truncated)")
    return _to_rgb(np.frombuffer(data, dtype, n, offset).reshape(height, width))

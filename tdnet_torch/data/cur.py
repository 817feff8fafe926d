"""Windows cursor (CUR) decoding, equal byte for byte to PIL's
``Image.open(path).convert("RGB")`` (``CurImagePlugin``), the reference's
file route. cv2 does not read CUR, so the ``cv2`` route refuses it.

PIL reads the directory (``\\0\\0\\2\\0``, a count, 16-byte entries) and
keeps the first entry unless a later one is larger in both its width and
its height bytes (a 0 is not 256 here). At that entry's offset it reads a
bitmap without a file header as its BMP plugin does
(``bmp.bitmap_as_bmp``), and halves the bitmap's height: the XOR image,
without the AND mask, which PIL neither reads nor checks. An empty
directory, an entry or a bitmap header that ends early, or a height that
halves to 0 passes the file on to PIL's other plugins.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from tdnet_torch.data import bmp

__all__ = ["SIGNATURE", "READS", "ROUTES", "is_cur", "decode_cur", "cur_size"]

SIGNATURE = b"\0\0\2\0"
READS = "CUR (the largest cursor's bitmap)"
ROUTES = ("pil", "cv2")


def _offset(data: bytes) -> Optional[int]:
    """The chosen entry's bitmap offset, or None where PIL passes on."""
    if not data.startswith(SIGNATURE) or len(data) < 6:
        return None
    m, pos = b"", 6
    for _ in range(struct.unpack_from("<H", data, 4)[0]):
        s, pos = data[pos:pos + 16], pos + 16
        if not m:
            m = s
        elif len(s) < 1 or (s[0] > m[0] and (len(s) < 2 or len(m) < 2)):
            return None  # IndexError
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if len(m) < 16:
        return None  # TypeError (no entries) or struct.error
    return struct.unpack_from("<I", m, 12)[0]


def _bitmap(data: bytes):
    at = _offset(data)
    return None if at is None else bmp.bitmap_as_bmp(data, at, halve=True)


def is_cur(data: bytes) -> bool:
    """PIL's CUR plugin takes it (opens it, or fails in it)."""
    try:
        return _bitmap(bytes(data)) is not None
    except ValueError:
        return True


def _made(data: bytes):
    made = _bitmap(bytes(data))
    if made is None:
        raise ValueError(f"not a CUR file PIL opens; this reader takes {READS}")
    return made


def cur_size(data: bytes) -> Tuple[int, int]:
    """(width, height) of the chosen bitmap's XOR image, as PIL's ``.size``."""
    return _made(data)[1]


def decode_cur(data: bytes, route: str = "pil") -> np.ndarray:
    """CUR bytes -> (H, W, 3) uint8 RGB of the cursor PIL loads, equal to
    PIL's ``convert("RGB")``; the ``cv2`` route raises (OpenCV does not
    read CUR)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("CUR: OpenCV cannot read it (cv2.imdecode returns None)")
    return bmp.decode_bmp(_made(data)[0], route="pil")

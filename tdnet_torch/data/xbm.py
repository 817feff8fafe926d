"""X11 bitmap (XBM) decoding, equal byte for byte to PIL's
``Image.open(path).convert("RGB")`` (``XbmImagePlugin`` and its ``xbm``
decoder), the reference's file route. cv2 does not read XBM, so the
``cv2`` route refuses it.

PIL takes a file whose first 16 bytes, less leading white space, start
``#define``, and whose first 512 bytes match its header pattern (the
``_width`` and ``_height`` defines, an optional hot spot, then anything up
to ``_bits[]``); else, or where the size is empty, it passes the file on.
Its decoder then reads each byte of the image as the two characters after
the next ``x`` in the file (a character that is not a hex digit counts
0), rows of ``ceil(width / 8)`` bytes, the bits least significant first,
a set bit white. A file that ends before the last byte's three characters
fails.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from tdnet_torch.data import plugins

__all__ = ["READS", "ROUTES", "is_xbm", "decode_xbm", "xbm_size"]

READS = "XBM"
ROUTES = ("pil", "cv2")

# XbmImagePlugin.xbm_head
_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _i
    _HEX[bytes([_c]).upper()[0]] = _i


def _header(data: bytes):
    if not data[:16].lstrip().startswith(b"#define"):
        return None
    m = _HEAD.match(data[:512])
    if m is None or int(m.group("width")) == 0 or int(m.group("height")) == 0:
        return None
    return int(m.group("width")), int(m.group("height")), m.end()


def is_xbm(data: bytes) -> bool:
    """PIL's XBM plugin opens it."""
    return _header(bytes(data)) is not None


def xbm_size(data: bytes) -> Tuple[int, int]:
    """(width, height), as PIL's ``.size``."""
    head = _header(bytes(data))
    if head is None:
        raise ValueError(f"not an XBM file PIL opens; this reader takes {READS}")
    plugins.check_bomb(head[0], head[1], "XBM")
    return head[:2]


def decode_xbm(data: bytes, route: str = "pil") -> np.ndarray:
    """XBM bytes -> (H, W, 3) uint8 RGB, equal to PIL's ``convert("RGB")``;
    the ``cv2`` route raises (OpenCV does not read XBM)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("XBM: OpenCV cannot read it (cv2.imdecode returns None)")
    data = bytes(data)
    width, height = xbm_size(data)
    start = _header(data)[2]
    stride = (width + 7) // 8
    need = stride * height
    body = np.frombuffer(data, np.uint8, len(data) - start, start)
    xs = np.flatnonzero(body == ord("x"))
    # each byte takes the two characters after its x, and the next search
    # starts after them
    picked, nxt = [], -1
    for x in xs.tolist():
        if x >= nxt:
            picked.append(x)
            nxt = x + 3
            if len(picked) == need:
                break
    if len(picked) < need or picked[-1] + 3 > len(body):
        raise ValueError("XBM data ends before its last byte: PIL fails on it (image file is "
                         "truncated)")
    at = np.asarray(picked)
    values = (_HEX[body[at + 1]] << 4) + _HEX[body[at + 2]]
    rows = values.astype(np.uint8).reshape(height, stride)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :width] * np.uint8(255)
    return np.repeat(bits[:, :, None], 3, axis=2)

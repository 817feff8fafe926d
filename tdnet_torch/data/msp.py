"""Windows Paint (MSP) decoding, equal byte for byte to PIL's
``Image.open(path).convert("RGB")`` (``MspImagePlugin``), the reference's
file route. cv2 does not read MSP, so the ``cv2`` route refuses it.

PIL takes a 32-byte header that starts ``DanM`` (version 1) or ``LinS``
(version 2) and whose sixteen little-endian words XOR to 0 (else, or where
the header ends early, it passes the file on), the width and height at
bytes 4 and 6. Version 1 is raw 1-bit rows after the header, a set bit
white. Version 2 has a row map (one 16-bit byte count a row) and PIL's
``MspDecoder``: a row of count 0 is white; else its bytes are runs, a 0
then a count and a byte repeated, or a count and that many bytes copied
(fewer where the row ends). The decoded bytes of all rows form one stream
that PIL reads as 1-bit rows, each ``ceil(width / 8)`` bytes, whatever the
runs' lengths; a short row map or row, a repeat cut at the row's end, or
a stream too short for the image fails.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from tdnet_torch.data import plugins

__all__ = ["READS", "ROUTES", "is_msp", "decode_msp", "msp_size"]

READS = "MSP (versions 1 and 2)"
ROUTES = ("pil", "cv2")


def is_msp(data: bytes) -> bool:
    """PIL's MSP plugin opens it: a whole header with a good checksum and a
    size that is not empty."""
    if data[:4] not in (b"DanM", b"LinS") or len(data) < 32:
        return False
    check = 0
    for w in struct.unpack_from("<16H", data):
        check ^= w
    return check == 0 and all(struct.unpack_from("<HH", data, 4))


def msp_size(data: bytes) -> Tuple[int, int]:
    """(width, height), as PIL's ``.size``."""
    data = bytes(data)
    if not is_msp(data):
        raise ValueError(f"not an MSP file PIL opens; this reader takes {READS}")
    width, height = struct.unpack_from("<HH", data, 4)
    plugins.check_bomb(width, height, "MSP")
    return width, height


def _stream(data: bytes, height: int, stride: int) -> bytes:
    """``MspDecoder``: the decoded bytes of every row, one stream."""
    blank = b"\xff" * stride
    if len(data) < 32 + 2 * height:
        raise ValueError("MSP row map ends early: PIL fails on it (Truncated MSP file in row "
                         "map)")
    rowmap = struct.unpack_from(f"<{height}H", data, 32)
    out, pos = bytearray(), 32 + 2 * height
    for y, n in enumerate(rowmap):
        if n == 0:
            out += blank
            continue
        row, pos = data[pos:pos + n], pos + n
        if len(row) != n:
            raise ValueError(f"MSP row {y} ends early: PIL fails on it (Truncated MSP file)")
        i = 0
        while i < n:
            kind, i = row[i], i + 1
            if kind == 0:
                if i + 2 > n:
                    raise ValueError(f"MSP row {y} ends inside a run: PIL fails on it "
                                     "(Corrupted MSP file)")
                out += row[i + 1:i + 2] * row[i]
                i += 2
            else:
                out += row[i:i + kind]
                i += kind
    return bytes(out)


def decode_msp(data: bytes, route: str = "pil") -> np.ndarray:
    """MSP bytes -> (H, W, 3) uint8 RGB, equal to PIL's ``convert("RGB")``;
    the ``cv2`` route raises (OpenCV does not read MSP)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("MSP: OpenCV cannot read it (cv2.imdecode returns None)")
    data = bytes(data)
    width, height = msp_size(data)
    stride = (width + 7) // 8
    stream = data[32:] if data.startswith(b"DanM") else _stream(data, height, stride)
    if len(stream) < stride * height:
        raise ValueError("MSP pixel data ends early: PIL fails on it (image file is "
                         "truncated / not enough image data)")
    rows = np.frombuffer(stream, np.uint8, stride * height).reshape(height, stride)
    bits = np.unpackbits(rows, axis=1)[:, :width] * np.uint8(255)
    return np.repeat(bits[:, :, None], 3, axis=2)

"""Blizzard texture (BLP) decoding, equal byte for byte to PIL's
``Image.open(path).convert("RGB")`` (``BlpImagePlugin``), the reference's
file route. cv2 does not read BLP, so the ``cv2`` route refuses it.

PIL opens a ``BLP1`` or ``BLP2`` header whole (else it passes the file on)
as RGBA where it has alpha, else RGB, and its decoder reads 16 mip offsets
and 16 lengths after the header (20 bytes for BLP2, 28 for BLP1); every
read that comes up short fails. What it decodes, as one stream of bytes
that fills the image row after row (``width`` pixels of 3 or 4 bytes,
whatever the stream's own rows):

- BLP1, compression 0: a JPEG made of the shared header (its length, then
  its bytes, after the offsets) and the first mip, ``data/jpeg.py``'s
  decode with red and blue swapped (PIL's setting of a CMYK JPEG's
  colour space asks libjpeg for what it gives anyway).
- BLP1 compression 1 with encoding 4 or 5, and BLP2 compression 1 with
  encoding 1: a 256-entry BGRA palette after the offsets, then the first
  mip's bytes as indices: RGB, or RGBA with alpha.
- BLP2, compression 1, encoding 2: the first mip as rows of 4x4 blocks
  through PIL's own Python DXT decoders (not its ``bcn`` decoder): DXT1
  (alpha encoding 0; RGB or, with alpha, RGBA), DXT3 (1) and DXT5 (7),
  both RGBA. 5-6-5 colours are shifted, not widened; DXT3 and DXT5 always
  take four colours; the stream's rows are 4-pixel multiples wide.

Every other compression, encoding or alpha encoding fails.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from tdnet_torch.data import jpeg, plugins

__all__ = ["READS", "ROUTES", "is_blp", "decode_blp", "blp_size"]

READS = "BLP (BLP1 JPEG or palette; BLP2 palette or DXT1/3/5)"
ROUTES = ("pil", "cv2")


def _header(data: bytes):
    """(version, compression, encoding, alpha, alpha encoding, width,
    height, offset) or None where PIL passes the file on."""
    magic = data[:4]
    if magic not in (b"BLP1", b"BLP2"):
        return None
    if magic == b"BLP1":
        if len(data) < 24:
            return None
        compression, alpha, width, height, encoding = struct.unpack_from("<iIIIi", data, 4)
        alpha_encoding, offset = 0, 28
    else:
        if len(data) < 20:
            return None
        (compression,) = struct.unpack_from("<i", data, 4)
        encoding, alpha, alpha_encoding = struct.unpack_from("<bbb", data, 8)
        width, height = struct.unpack_from("<II", data, 12)
        offset = 20
    if width == 0 or height == 0:
        return None
    return magic, compression, encoding, alpha != 0, alpha_encoding, width, height, offset


def is_blp(data: bytes) -> bool:
    """PIL's BLP plugin opens it."""
    return _header(bytes(data)) is not None


def _opened(data: bytes):
    head = _header(data)
    if head is None:
        raise ValueError(f"not a BLP file PIL opens; this reader takes {READS}")
    plugins.check_bomb(head[5], head[6], "BLP")
    return head


def blp_size(data: bytes) -> Tuple[int, int]:
    """(width, height), as PIL's ``.size``."""
    return _opened(bytes(data))[5:7]


def _read(data: bytes, pos: int, n: int) -> bytes:
    """``ImageFile._safe_read``: n bytes, which must all be there."""
    if n <= 0:
        return b""
    if pos + n > len(data):
        raise ValueError("BLP data ends early: PIL fails on it (Truncated File Read)")
    return data[pos:pos + n]


def _indexed(data: bytes, pos: int, start: int, length: int, alpha: bool) -> bytes:
    """The palette at pos, then ``length`` index bytes at start -> RGB(A)."""
    palette = np.frombuffer(_read(data, pos, 1024), np.uint8).reshape(256, 4)
    rgba = palette[:, [2, 1, 0, 3]] if alpha else palette[:, [2, 1, 0]]
    return rgba[np.frombuffer(_read(data, start, length), np.uint8)].tobytes()


def _colours(block: np.ndarray, four: bool):
    """PIL's ``unpack_565`` endpoints and their two middle colours: (N, 4,
    3) int, and (N,) whether the 3-colour form's black is transparent."""
    c0 = block[:, 0].astype(np.int32) | block[:, 1].astype(np.int32) << 8
    c1 = block[:, 2].astype(np.int32) | block[:, 3].astype(np.int32) << 8

    def rgb(c):
        return np.stack([((c >> 11) & 31) << 3, ((c >> 5) & 63) << 2, (c & 31) << 3], axis=1)
    a, b = rgb(c0), rgb(c1)
    thirds = (c0 > c1) | four
    mid0 = np.where(thirds[:, None], (2 * a + b) // 3, (a + b) // 2)
    mid1 = np.where(thirds[:, None], (2 * b + a) // 3, 0)
    return np.stack([a, b, mid0, mid1], axis=1), ~thirds


def _indices(block: np.ndarray) -> np.ndarray:
    code = (block[:, 0].astype(np.uint32) | block[:, 1].astype(np.uint32) << 8
            | block[:, 2].astype(np.uint32) << 16 | block[:, 3].astype(np.uint32) << 24)
    return (code[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3


def _dxt(blocks: np.ndarray, kind: int, alpha: bool) -> np.ndarray:
    """(N, 16, 3 or 4) pixels of PIL's ``decode_dxt1/3/5``."""
    n = len(blocks)
    colour = blocks if kind == 0 else blocks[:, 8:]
    table, transparent = _colours(colour, kind != 0)
    idx = _indices(colour[:, 4:8]).astype(np.intp)
    rgb = table[np.arange(n)[:, None], idx]
    if kind == 0:
        if not alpha:
            return rgb
        a = np.where((idx == 3) & transparent[:, None], 0, 255)
    elif kind == 1:
        nib = blocks[:, np.arange(16) // 2] >> (4 * (np.arange(16) % 2))
        a = (nib & 15).astype(np.int32) * 17
    else:
        a0, a1 = blocks[:, 0].astype(np.int32)[:, None], blocks[:, 1].astype(np.int32)[:, None]
        bits = sum(blocks[:, 2 + i].astype(np.uint64) << np.uint64(8 * i) for i in range(6))
        c = ((bits[:, None] >> (3 * np.arange(16, dtype=np.uint64))) & np.uint64(7)).astype(
            np.int32)
        eight = ((8 - c) * a0 + (c - 1) * a1) // 7
        six = np.where(c == 6, 0, np.where(c == 7, 255, ((6 - c) * a0 + (c - 1) * a1) // 5))
        a = np.where(c == 0, a0, np.where(c == 1, a1, np.where(a0 > a1, eight, six)))
    return np.concatenate([rgb, a[:, :, None]], axis=2)


def _stream(data: bytes, head) -> bytes:
    magic, compression, encoding, alpha, alpha_encoding, width, height, pos = head
    offsets = struct.unpack("<16I", _read(data, pos, 64))
    lengths = struct.unpack("<16I", _read(data, pos + 64, 64))
    pos += 128
    if magic == b"BLP1":
        if compression == 0:
            (size,) = struct.unpack("<I", _read(data, pos, 4))
            shared = _read(data, pos + 4, size)
            pos += 4 + size
            pos += len(_read(data, pos, offsets[0] - pos))
            stream = shared + _read(data, pos, lengths[0])
            plugins.check_bomb(*jpeg.jpeg_size(stream), "BLP JPEG")
            rgb = jpeg.decode_jpeg(stream, route="pil")
            return rgb[:, :, ::-1].tobytes()
        if compression == 1 and encoding in (4, 5):
            return _indexed(data, pos, pos + 1024, lengths[0], alpha)
        raise ValueError(f"BLP1 compression {compression} encoding {encoding}: PIL fails on it")
    if compression != 1:
        raise ValueError(f"BLP2 compression {compression}: PIL fails on it")
    if encoding == 1:
        return _indexed(data, pos, offsets[0], lengths[0], alpha)
    _read(data, pos, 1024)
    if encoding != 2:
        raise ValueError(f"BLP2 encoding {encoding}: PIL fails on it")
    if alpha_encoding not in (0, 1, 7):
        raise ValueError(f"BLP2 alpha encoding {alpha_encoding}: PIL fails on it")
    size = 8 if alpha_encoding == 0 else 16
    across, down = -(-width // 4), -(-height // 4)
    raw = _read(data, offsets[0], across * down * size)
    px = _dxt(np.frombuffer(raw, np.uint8).reshape(-1, size), alpha_encoding, alpha)
    px = px.reshape(down, across, 4, 4, -1).transpose(0, 2, 1, 3, 4)
    return px.astype(np.uint8).tobytes()


def decode_blp(data: bytes, route: str = "pil") -> np.ndarray:
    """BLP bytes -> (H, W, 3) uint8 RGB, equal to PIL's ``convert("RGB")``;
    the ``cv2`` route raises (OpenCV does not read BLP)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("BLP: OpenCV cannot read it (cv2.imdecode returns None)")
    data = bytes(data)
    head = _opened(data)
    width, height = head[5:7]
    channels = 3 if head[1] == 0 and head[0] == b"BLP1" else (4 if head[3] else 3)
    stream = _stream(data, head)
    need = width * height * channels
    if len(stream) < need:
        raise ValueError("BLP pixels too few for its size: PIL fails on it (not enough "
                         "image data)")
    px = np.frombuffer(stream, np.uint8, need).reshape(height, width, channels)
    return np.ascontiguousarray(px[:, :, :3])

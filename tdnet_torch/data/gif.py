"""GIF decoding in Python and numpy, equal byte for byte to the two
decoders the reference reads pages with: PIL's ``Image.open(path).
convert("RGB")`` for files (``route="pil"``, ``GifImagePlugin``) and
``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` for serve bodies (``route="cv2"``,
OpenCV's ``grfmt_gif.cpp``). Both read the first frame only.

Reads GIF87a and GIF89a: the logical screen, global and local colour
tables, extensions (the graphic control extension's transparent index;
others skipped), the first image's variable-width LZW data (2 to 12 bits,
clear and end codes, a full table kept until the next clear) and its
interlaced row order. The routes paint the first frame on the screen by
their own rules:

- PIL grows the screen to hold a frame that reaches past it (``.size``,
  :func:`gif_size`, is the grown one), fills what the frame leaves with
  index 0, or with the transparent index where there is one, and draws
  every pixel of the frame, transparent ones too. Indices past the
  colour table come out black. A local table that is the identity gray
  ramp gives way to the global table; where that is the identity too, or
  there is none, the page is gray, the index its value.
- cv2 refuses a frame that reaches past the screen and a background
  index past the global table, fills the screen with the global table's
  background colour (black without a global table) and leaves the
  frame's transparent pixels at it. A local table is laid over the
  global one (the global entries past its end stay in use); an index past
  both raises. Without any table it reads the index as gray, but 1 as
  white.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["SIGNATURES", "READS", "ROUTES", "decode_gif", "gif_size"]

SIGNATURES = (b"GIF87a", b"GIF89a")
READS = "GIF (GIF87a and GIF89a, the first frame)"
ROUTES = ("pil", "cv2")


class _Frame:
    """The screen, the tables and the first image of a GIF."""

    def __init__(self, data: bytes):
        if data[:6] not in SIGNATURES:
            raise ValueError(f"not a GIF file; this reader takes {READS}")
        if len(data) < 13:
            raise ValueError("truncated GIF header")
        self.width, self.height, flags, self.background = struct.unpack("<HHBB", data[6:12])
        pos = 13
        self.global_table = None
        if flags & 0x80:
            n = 2 << (flags & 7)
            self.global_table = _table(data, pos, n)
            pos += 3 * n
        self.transparent: Optional[int] = None
        while True:
            if pos >= len(data) or data[pos] == 0x3B:
                raise ValueError("GIF without an image")
            kind = data[pos]
            pos += 1
            if kind == 0x21:  # extension: its label, then sub-blocks
                label = data[pos:pos + 1]
                first, pos = _sub_blocks(data, pos + 1, first_only=True)
                if label == b"\xf9" and first and first[0] & 1:
                    if len(first) < 4:
                        raise ValueError("GIF graphic control extension too short")
                    self.transparent = first[3]
                continue
            if kind != 0x2C:
                raise ValueError(f"GIF block 0x{kind:02x} is not read")
            if pos + 10 > len(data):
                raise ValueError("truncated GIF image descriptor")
            self.x, self.y, self.w, self.h, lflags = struct.unpack("<HHHHB", data[pos:pos + 9])
            pos += 9
            self.local_table = None
            if lflags & 0x80:
                n = 2 << (lflags & 7)
                self.local_table = _table(data, pos, n)
                pos += 3 * n
            self.interlaced = bool(lflags & 0x40)
            if pos >= len(data):
                raise ValueError("truncated GIF image: no LZW code size")
            self.min_code = data[pos]
            self.lzw, _ = _sub_blocks(data, pos + 1)
            return

    def indices(self) -> np.ndarray:
        """The frame's (h, w) colour indices in display order."""
        if not 2 <= self.min_code <= 8:
            raise ValueError(f"GIF LZW minimum code size {self.min_code} is not read (2 to 8)")
        if self.w == 0 or self.h == 0:
            raise ValueError(f"GIF image of size {self.w}x{self.h}")
        n = self.w * self.h
        out = _lzw(self.lzw, self.min_code, n)
        if len(out) < n:
            raise ValueError(f"GIF image data ends after {len(out)} of its {n} pixels")
        idx = np.frombuffer(out, np.uint8, n).reshape(self.h, self.w)
        if self.interlaced:
            order = np.concatenate([np.arange(0, self.h, 8), np.arange(4, self.h, 8),
                                    np.arange(2, self.h, 4), np.arange(1, self.h, 2)])
            rows = np.empty_like(idx)
            rows[order] = idx
            idx = rows
        return idx


def _table(data: bytes, pos: int, n: int) -> np.ndarray:
    if pos + 3 * n > len(data):
        raise ValueError("truncated GIF colour table")
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)


def _sub_blocks(data: bytes, pos: int, first_only: bool = False):
    """Data sub-blocks from ``pos`` to their zero terminator -> (their bytes
    joined, or the first one alone, and the position after them)."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError("truncated GIF: its data sub-blocks run past the end")
        n = data[pos]
        if n == 0:
            pos += 1
            break
        if pos + 1 + n > len(data):
            raise ValueError("truncated GIF: its data sub-blocks run past the end")
        parts.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n
    if first_only:
        return (parts[0] if parts else None), pos
    return b"".join(parts), pos


def _lzw(raw: bytes, min_code: int, n: int) -> bytes:
    """GIF LZW: codes LSB first from min_code + 1 bits, growing a bit when
    the next free code reaches the width's limit (at most 12), a clear code
    resets the table, the end code (or n pixels) stops; a full table is
    kept until the next clear."""
    clear, end = 1 << min_code, (1 << min_code) + 1
    b = np.frombuffer(raw + bytes(4), np.uint8).astype(np.int64)
    windows = (b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)).tolist()
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    out, total = [], 0
    pos, width, stop = 0, min_code + 1, 8 * len(raw)
    prev = None
    while pos + width <= stop and total < n:
        code = (windows[pos >> 3] >> (pos & 7)) & ((1 << width) - 1)
        pos += width
        if code == clear:
            table = list(base)
            width, prev = min_code + 1, None
            continue
        if code == end:
            break
        if code < len(table) and (prev is not None or code < clear):
            entry = table[code]
            if prev is not None and len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt GIF LZW data")
        out.append(entry)
        total += len(entry)
        prev = entry
        if len(table) == 1 << width and width < 12:
            width += 1
    return b"".join(out)


def _identity(table: np.ndarray) -> bool:
    """PIL's ``_is_palette_needed`` negated: every entry i is (i, i, i)."""
    return bool((table == np.arange(len(table))[:, None]).all())


def _pil(frame: _Frame) -> np.ndarray:
    idx = frame.indices()
    width, height = _size_of(frame)
    canvas = np.full((height, width), frame.transparent or 0, np.uint8)
    canvas[frame.y:frame.y + frame.h, frame.x:frame.x + frame.w] = idx
    # a local table that is the identity gives way to the global one, and
    # an identity global table to none: PIL then reads the page as gray
    table = frame.local_table
    if table is None or _identity(table):
        table = frame.global_table
    if table is None or _identity(table):
        return np.repeat(canvas[:, :, None], 3, axis=2)
    palette = np.zeros((256, 3), np.uint8)
    palette[:len(table)] = table
    return palette[canvas]


def _cv2(frame: _Frame) -> np.ndarray:
    if frame.x + frame.w > frame.width or frame.y + frame.h > frame.height:
        raise ValueError("GIF frame reaches past its screen: OpenCV refuses it")
    g, local = frame.global_table, frame.local_table
    if g is not None and frame.background >= len(g):
        raise ValueError(f"GIF background index {frame.background} past its global table of "
                         f"{len(g)}: OpenCV refuses it")
    idx = frame.indices()
    if g is None and local is None:  # OpenCV's default: the gray ramp, 1 white
        palette, valid = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1), 256
        palette[1] = 255
    else:
        palette = np.zeros((256, 3), np.uint8)
        valid = 0
        for t in (g, local):
            if t is not None:
                palette[:len(t)] = t
                valid = max(valid, len(t))
    keep = np.ones(idx.shape, bool) if frame.transparent is None else idx != frame.transparent
    if (idx[keep] >= valid).any():
        raise ValueError(f"GIF index past its colour table of {valid}: OpenCV refuses it")
    out = np.zeros((frame.height, frame.width, 3), np.uint8)
    if g is not None:
        out[:] = g[frame.background]
    region = out[frame.y:frame.y + frame.h, frame.x:frame.x + frame.w]
    region[keep] = palette[idx[keep]]
    return out


def _size_of(frame: _Frame) -> Tuple[int, int]:
    """PIL's size: the screen, grown to hold the first frame."""
    return max(frame.width, frame.x + frame.w), max(frame.height, frame.y + frame.h)


def decode_gif(data: bytes, route: str = "pil") -> np.ndarray:
    """GIF bytes -> (H, W, 3) uint8 RGB of the first frame, equal to PIL's
    ``convert("RGB")`` (``route="pil"``) or to ``cv2.imdecode(...,
    IMREAD_COLOR)`` with its channels flipped (``route="cv2"``)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    frame = _Frame(bytes(data))
    return _pil(frame) if route == "pil" else _cv2(frame)


def gif_size(data: bytes) -> Tuple[int, int]:
    """(width, height) as PIL's ``.size``: the logical screen, grown to hold
    a first frame that reaches past it."""
    return _size_of(_Frame(bytes(data)))

"""Autodesk FLI/FLC animation decoding (the first frame), equal byte for
byte to PIL's ``Image.open(path).convert("RGB")`` (``FliImagePlugin`` and
its ``fli`` decoder), the reference's file route. cv2 does not read FLI,
so the ``cv2`` route refuses it.

PIL takes a 128-byte header with the magic 0xAF11 (FLI) or 0xAF12 (FLC)
at byte 4, flags 0 or 3 at byte 14 and its reserved runs of zeros, at
least one frame and a size that is not empty (else it passes the file
on). The palette starts as the gray ramp; PIL reads the first colour
chunk of the first frame chunk (0xF1FA) after the header, or after a
prefix chunk (0xF100) that it steps over: packets of a skip and a count
(0 is 256) of RGB triples, 6-bit (``COLOR_64``, shifted left by 2) or
8-bit (``COLOR_256``). A packet that runs past entry 255, or a triple cut
short, passes the file on.

The image is decoded from the chunk at byte 128, which must be a whole
frame chunk (0xF1FA; a prefix chunk there fails), onto a black page, its
subchunks in turn: colour (ignored here), ``BLACK`` (13), ``BRUN`` (15:
each row a count byte, then runs, a negative count copying ``-count``
bytes and a positive one repeating the next byte), ``COPY`` (16: raw
rows), ``LC`` (12: a first row, a row count, and each row's packets of a
skip and a run or copy that may not pass the row's end), ``SS2`` (7:
16-bit word packets with line skips and a last byte) and ``PSTAMP`` (18,
ignored). An unknown subchunk, one of size 0, one that runs past the data
or a row left unfinished fails.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from tdnet_torch.data import plugins

__all__ = ["READS", "ROUTES", "is_fli", "decode_fli", "fli_size"]

READS = "FLI/FLC (the first frame)"
ROUTES = ("pil", "cv2")


class _Pass(Exception):
    pass


def _u16(data: bytes, at: int) -> int:
    if len(data) < at + 2:
        raise _Pass  # struct.error
    return struct.unpack_from("<H", data, at)[0]


def _u32(data: bytes, at: int) -> int:
    if len(data) < at + 4:
        raise _Pass
    return struct.unpack_from("<I", data, at)[0]


def _palette(data: bytes, pos: int, shift: int) -> np.ndarray:
    """``FliImageFile._palette``: the gray ramp with the packets at pos
    written over it."""
    palette = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, axis=1)
    i = 0
    count = _u16(data, pos)
    pos += 2
    for _ in range(count):
        s = data[pos:pos + 2]
        if len(s) < 2:
            raise _Pass  # IndexError
        i += s[0]
        n = s[1] or 256
        s = data[pos + 2:pos + 2 + 3 * n]
        pos += 2 + len(s)
        if len(s) % 3 or i + len(s) // 3 > 256:
            raise _Pass  # IndexError: a triple cut short, or past entry 255
        palette[i:i + len(s) // 3] = np.frombuffer(s, np.uint8).reshape(-1, 3).astype(
            np.int64) << shift
        i += len(s) // 3
    return (palette & 0xFF).astype(np.uint8)


def _open(data: bytes):
    """(width, height, palette) of a file PIL opens."""
    s = data[:128]
    if not (len(s) >= 16 and _u16(s, 4) in (0xAF11, 0xAF12) and _u16(s, 14) in (0, 3)
            and s[20:22] == bytes(2) and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise _Pass
    frames, width, height = struct.unpack_from("<3H", s, 6)
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    pos = 128
    if _u16(data, pos + 4) == 0xF100:
        pos += _u32(data, pos)
    if _u16(data, pos + 4) == 0xF1FA:
        sub = pos + 16
        size = None
        for _ in range(_u16(data, pos + 6)):
            if size is not None:
                sub += size
            kind = _u16(data, sub + 4)
            if kind in (4, 11):
                palette = _palette(data, sub + 6, 2 if kind == 11 else 0)
                break
            size = _u32(data, sub)
            if not size:
                break
    if frames == 0:
        raise _Pass  # EOFError: no frame to seek to
    if len(data) <= 128:
        raise _Pass  # missing frame size
    _u32(data, 128)
    if width == 0 or height == 0:
        raise _Pass
    return width, height, palette


def _opened(data: bytes):
    try:
        return _open(data)
    except _Pass:
        return None


def is_fli(data: bytes) -> bool:
    """PIL's FLI plugin opens it."""
    return _opened(bytes(data)) is not None


def _head(data: bytes):
    opened = _opened(data)
    if opened is None:
        raise ValueError(f"not an FLI file PIL opens; this reader takes {READS}")
    plugins.check_bomb(opened[0], opened[1], "FLI")
    return opened


def fli_size(data: bytes) -> Tuple[int, int]:
    """(width, height), as PIL's ``.size``."""
    return _head(bytes(data))[:2]


def _fail(what: str):
    return ValueError(f"FLI frame {what}: PIL fails on it (broken data stream)")


def _frame(buf: bytes, w: int, h: int) -> np.ndarray:
    """``ImagingFliDecode`` on the bytes from the first frame chunk."""
    out = np.zeros((h, w), np.uint8)
    n = len(buf)
    if n < 4:
        raise _fail("size missing")
    framesize = struct.unpack_from("<I", buf)[0]
    if n + n % 2 < framesize:
        raise ValueError("FLI frame ends early: PIL fails on it (image file is truncated)")
    if n < 8 or struct.unpack_from("<H", buf, 4)[0] != 0xF1FA:
        raise _fail("chunk that is not a frame")
    chunks = struct.unpack_from("<H", buf, 6)[0]
    ptr, left = 16, n - 16
    end = n

    def need(at: int, k: int) -> None:
        if at + k > end:
            raise _fail("subchunk past the data")

    for _ in range(chunks):
        if left < 10:
            raise _fail("subchunk header past the data")
        kind = struct.unpack_from("<H", buf, ptr + 4)[0]
        d = ptr + 6
        if kind in (4, 11, 18):
            pass
        elif kind == 13:
            out[:] = 0
        elif kind == 15:
            for y in range(h):
                d += 1
                x = 0
                while x < w:
                    need(d, 2)
                    c = buf[d]
                    if c & 0x80:
                        i = 256 - c
                        if x + i > w:
                            break
                        need(d, i + 1)
                        out[y, x:x + i] = np.frombuffer(buf, np.uint8, i, d + 1)
                        d += i + 1
                    else:
                        i = c
                        if x + i > w:
                            break
                        out[y, x:x + i] = buf[d + 1]
                        d += 2
                    x += i
                if x != w:
                    raise _fail("BRUN row left unfinished")
        elif kind == 16:
            if d + w * h > ptr + left:
                raise ValueError("FLI COPY chunk ends early: PIL fails on it (image file is "
                                 "truncated)")
            out[:] = np.frombuffer(buf, np.uint8, w * h, d).reshape(h, w)
        elif kind == 12:
            need(d, 4)
            y, count = struct.unpack_from("<HH", buf, d)
            ymax = y + count
            d += 4
            while y < ymax and y < h:
                need(d, 1)
                packets, d = buf[d], d + 1
                x, p = 0, 0
                while p < packets:
                    need(d, 2)
                    x += buf[d]
                    if buf[d + 1] & 0x80:
                        i = 256 - buf[d + 1]
                        if x + i > w:
                            break
                        need(d, 3)
                        out[y, x:x + i] = buf[d + 2]
                        d += 3
                    else:
                        i = buf[d + 1]
                        if x + i > w:
                            break
                        need(d, 2 + i)
                        out[y, x:x + i] = np.frombuffer(buf, np.uint8, i, d + 2)
                        d += i + 2
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                raise _fail("LC lines left unfinished")
        elif kind == 7:
            lines = struct.unpack_from("<H", buf, d)[0]
            d += 2
            y = line = 0
            while line < lines and y < h:
                need(d, 2)
                packets = struct.unpack_from("<H", buf, d)[0]
                d += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= h:
                            raise _fail("SS2 line skip past the page")
                    else:
                        out[y, w - 1] = packets & 0xFF
                    need(d, 2)
                    packets = struct.unpack_from("<H", buf, d)[0]
                    d += 2
                x = p = 0
                while p < packets:
                    need(d, 2)
                    x += buf[d]
                    if buf[d + 1] >= 128:
                        need(d, 4)
                        i = 256 - buf[d + 1]
                        if x + 2 * i > w:
                            break
                        out[y, x:x + 2 * i] = np.tile(np.frombuffer(buf, np.uint8, 2, d + 2), i)
                        x += 2 * i
                        d += 4
                    else:
                        i = 2 * buf[d + 1]
                        if x + i > w:
                            break
                        need(d, 2 + i)
                        out[y, x:x + i] = np.frombuffer(buf, np.uint8, i, d + 2)
                        d += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                line += 1
                y += 1
            if line < lines:
                raise _fail("SS2 lines left unfinished")
        else:
            raise _fail(f"subchunk of unknown type {kind}")
        advance = struct.unpack_from("<i", buf, ptr)[0]
        if advance == 0:
            raise _fail("subchunk of size 0")
        if advance < 0 or advance > left:
            raise _fail("subchunk past the data")
        ptr += advance
        left -= advance
    return out


def decode_fli(data: bytes, route: str = "pil") -> np.ndarray:
    """FLI/FLC bytes -> (H, W, 3) uint8 RGB of the first frame, equal to
    PIL's ``convert("RGB")``; the ``cv2`` route raises (OpenCV does not
    read FLI)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("FLI: OpenCV cannot read it (cv2.imdecode returns None)")
    data = bytes(data)
    width, height, palette = _head(data)
    return palette[_frame(data[128:], width, height)]

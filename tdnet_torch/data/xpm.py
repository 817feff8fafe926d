"""X11 pixmap (XPM) decoding, equal byte for byte to PIL's
``Image.open(path).convert("RGB")`` (``XpmImagePlugin`` and its ``xpm``
decoder), the reference's file route. cv2 does not read XPM, so the
``cv2`` route refuses it.

PIL takes a file that starts ``/* XPM */`` and has a line that starts with
the values line (``"w h colours chars``; none passes the file on, an
empty number fails). Each of the next ``colours`` lines (stripped at the
right) gives a key (the ``chars`` bytes after its first) and, in the words
between it and the line's last two bytes, a ``c`` and a colour: ``None``
(transparent: the key gets no colour), or ``#`` and hex digits, of which
the low 24 bits are RGB; any other colour, or no ``c``, fails, and a ``c``
with no word after it passes the file on. The pixel lines follow, once
past an optional ``/* pixels */`` line: the text between each line's first
and last ``"`` cut into keys of ``chars`` bytes, read as one stream of
pixels whatever the width, until the image is full or the file ends. A
key with no colour fails; up to 256 colours are a palette (what PIL reads
as ``P``), more an RGB image.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from tdnet_torch.data import plugins

__all__ = ["READS", "ROUTES", "is_xpm", "decode_xpm", "xpm_size"]

READS = "XPM (# colours)"
ROUTES = ("pil", "cv2")

_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')  # XpmImagePlugin.xpm_head


class _Pass(Exception):
    pass


def _lines(data: bytes, pos: int):
    """readline() from ``pos``: (line, next position), b"" at the end."""
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def _open(data: bytes):
    """(width, height, chars per pixel, palette {key: rgb bytes}, offset of
    the pixel lines)."""
    if not data.startswith(b"/* XPM */"):
        raise _Pass
    pos = 9
    while True:
        line, pos = _lines(data, pos)
        if not line:
            raise _Pass  # broken XPM file
        m = _HEAD.match(line)
        if m:
            break
    if not all(m.group(i) for i in (1, 2, 3, 4)):
        raise ValueError("XPM values line with an empty number: PIL fails on it")
    width, height, colours, chars = (int(m.group(i)) for i in (1, 2, 3, 4))
    palette = {}
    for _ in range(colours):
        line, pos = _lines(data, pos)
        line = line.rstrip()
        key, words = line[1:chars + 1], line[chars + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                if i + 1 >= len(words):
                    raise _Pass  # IndexError
                rgb = words[i + 1]
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError:
                        raise ValueError("XPM colour that is not hex: PIL fails on it") from None
                    palette[key] = bytes([(v >> 16) & 255, (v >> 8) & 255, v & 255])
                else:
                    raise ValueError(f"XPM colour {rgb[:20]!r}: PIL reads # colours only "
                                     "(cannot read this XPM file)")
                break
        else:
            raise ValueError("XPM colour line without a c colour: PIL fails on it")
    if width <= 0 or height <= 0:
        raise _Pass
    return width, height, chars, palette, colours, pos


def _opened(data: bytes):
    try:
        return _open(bytes(data))
    except _Pass:
        return None


def is_xpm(data: bytes) -> bool:
    """PIL's XPM plugin takes it (opens it, or fails in it)."""
    try:
        return _opened(data) is not None
    except ValueError:
        return True


def _head(data: bytes):
    opened = _opened(data)
    if opened is None:
        raise ValueError(f"not an XPM file PIL opens; this reader takes {READS}")
    plugins.check_bomb(opened[0], opened[1], "XPM")
    return opened


def xpm_size(data: bytes) -> Tuple[int, int]:
    """(width, height), as PIL's ``.size``."""
    return _head(data)[:2]


def decode_xpm(data: bytes, route: str = "pil") -> np.ndarray:
    """XPM bytes -> (H, W, 3) uint8 RGB, equal to PIL's ``convert("RGB")``;
    the ``cv2`` route raises (OpenCV does not read XPM)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("XPM: OpenCV cannot read it (cv2.imdecode returns None)")
    data = bytes(data)
    width, height, chars, palette, colours, pos = _head(data)
    need = width * height
    if chars == 0:
        raise ValueError("XPM of 0 characters a pixel: PIL fails on it")
    keys, seen_header = [], False
    while len(keys) < need:
        line, pos = _lines(data, pos)
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not seen_header:
            seen_header = True
            continue
        text = b'"'.join(line.split(b'"')[1:-1])
        keys += [text[i:i + chars] for i in range(0, len(text), chars)]
    if any(k not in palette for k in keys):
        raise ValueError("XPM pixel of a key with no colour: PIL fails on it")
    if len(keys) < need:
        raise ValueError("XPM pixels end early: PIL fails on it (not enough image data)")
    if colours > 256:
        rgb = np.frombuffer(b"".join(palette[k] for k in keys[:need]), np.uint8)
        return rgb.reshape(height, width, 3).copy()
    table = {k: i for i, k in enumerate(palette)}
    lut = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(-1, 3)
    index = np.fromiter((table[k] for k in keys[:need]), np.intp, need)
    return lut[index].reshape(height, width, 3)

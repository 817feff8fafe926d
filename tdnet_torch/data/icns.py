"""Apple icon (ICNS) decoding, equal byte for byte to PIL's
``Image.open(path).convert("RGB")`` (``IcnsImagePlugin``), the reference's
file route. cv2 does not read ICNS, so the ``cv2`` route refuses it.

PIL walks the elements after the 8-byte header (a 4-byte type and a
big-endian length that counts its own 8 bytes) up to the header's file
length; an element that ends early, or a length that is not above 0,
passes the file on, and a later element of a type replaces an earlier
one. Of the sizes it knows an element for (:data:`SIZES`, each a width,
height and scale) it takes the largest (none passes the file on); its
``.size`` is that size times its scale. Loading reads every element of
that size, in :data:`SIZES`' order:

- a PNG (``data/png.py``, read from the element to the end of the file)
  or JPEG 2000 (``data/jp2.py``, the element's bytes only) image, which
  is the icon whatever its mode;
- ``it32`` (after 4 zero bytes), ``ih32``, ``il32`` and ``is32``: RGB,
  raw where the element holds exactly 3 bytes a pixel, else PIL's
  ``read_32`` runs band after band (a byte ``b`` of 0x80 or more repeats
  the next byte ``b - 125`` times, another copies the next ``b + 1``
  bytes), read on past the element's end, a run that overruns its band
  failing;
- ``t8mk``, ``h8mk``, ``l8mk`` and ``s8mk``: an alpha mask of a byte a
  pixel, which must be whole, and which ``convert("RGB")`` drops.

An element of another format fails, as do a mask with no RGB image and an
image whose size is none of the file's sizes at any scale.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

from tdnet_torch.data import jp2, plugins, png

__all__ = ["READS", "ROUTES", "SIZES", "is_icns", "decode_icns", "icns_size"]

READS = "ICNS (PNG, JPEG 2000 and RLE RGB icons)"
ROUTES = ("pil", "cv2")

SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",), (256, 256, 2): (b"ic14",),
    (256, 256, 1): (b"ic08",), (128, 128, 2): (b"ic13",),
    (128, 128, 1): (b"ic07", b"it32", b"t8mk"), (64, 64, 1): (b"icp6",),
    (32, 32, 2): (b"ic12",), (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"), (16, 16, 2): (b"ic11",),
    (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}
_RLE = (b"it32", b"ih32", b"il32", b"is32")
_MASKS = (b"t8mk", b"h8mk", b"l8mk", b"s8mk")


def _elements(data: bytes):
    """{type: (start, length)} of the elements, or None where PIL passes
    the file on."""
    if len(data) < 8 or not data.startswith(b"icns"):
        return None
    (filesize,) = struct.unpack_from(">I", data, 4)
    found, i = {}, 8
    while i < filesize:
        if len(data) < i + 8:
            return None  # struct.error
        kind, length = struct.unpack_from(">4sI", data, i)
        if length <= 0:
            return None  # invalid block header
        found[kind] = (i + 8, length - 8)
        i += length
    return found


def _best(data: bytes):
    found = _elements(data)
    if found is None:
        return None
    sizes = [s for s, kinds in SIZES.items() if any(k in found for k in kinds)]
    if not sizes:
        return None
    return found, sizes, max(sizes)


def is_icns(data: bytes) -> bool:
    """PIL's ICNS plugin opens it."""
    return _best(bytes(data)) is not None


def _opened(data: bytes):
    best = _best(data)
    if best is None:
        raise ValueError(f"not an ICNS file PIL opens; this reader takes {READS}")
    w, h, scale = best[2]
    plugins.check_bomb(w * scale, h * scale, "ICNS")
    return best


def icns_size(data: bytes) -> Tuple[int, int]:
    """(width, height) of the largest size times its scale, as PIL's
    ``.size``."""
    w, h, scale = _opened(bytes(data))[2]
    return w * scale, h * scale


def _read_32(data: bytes, start: int, length: int, side: Tuple[int, int]) -> np.ndarray:
    w, h = side
    n = w * h
    if length == 3 * n:
        if len(data) < start + length:
            raise ValueError("ICNS RGB element ends early: PIL fails on it (buffer is not "
                             "large enough)")
        return np.frombuffer(data, np.uint8, length, start).reshape(h, w, 3)
    out, pos = np.empty((3, n), np.uint8), start
    for band in range(3):
        got, left = bytearray(), n
        while left > 0:
            if pos >= len(data):
                break
            b, pos = data[pos], pos + 1
            if b & 0x80:
                count = b - 125
                got += data[pos:pos + 1] * count
                pos += 1
            else:
                count = b + 1
                got += data[pos:pos + count]
                pos += count
            left -= count
        if left != 0:
            raise ValueError(f"ICNS RLE band {band} does not end at its last pixel: PIL fails "
                             f"on it (Error reading channel [{left} left])")
        if len(got) < n:
            raise ValueError("ICNS RLE band ends early: PIL fails on it (buffer is not large "
                             "enough)")
        out[band] = np.frombuffer(bytes(got), np.uint8, n)
    return out.T.reshape(h, w, 3)


def _compressed(data: bytes, start: int, length: int) -> np.ndarray:
    sig = data[start:start + 12]
    if sig.startswith(png.SIGNATURE):
        frame = data[start:]
        plugins.check_bomb(*png.png_size(frame), "ICNS PNG element")
        return png.decode_png(frame, route="pil")
    if sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) or \
            sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
        return jp2.decode_jpeg2000(data[start:start + max(length, 0)], route="pil")
    raise ValueError("ICNS element of an unknown format: PIL fails on it (Unsupported icon "
                     "subimage format)")


def decode_icns(data: bytes, route: str = "pil") -> np.ndarray:
    """ICNS bytes -> (H, W, 3) uint8 RGB of the icon PIL loads, equal to
    PIL's ``convert("RGB")``; the ``cv2`` route raises (OpenCV does not
    read ICNS)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("ICNS: OpenCV cannot read it (cv2.imdecode returns None)")
    data = bytes(data)
    found, sizes, best = _opened(data)
    side = (best[0] * best[2], best[1] * best[2])
    channels: Dict[str, np.ndarray] = {}
    for kind in SIZES[best]:
        if kind not in found:
            continue
        start, length = found[kind]
        if kind in _MASKS:  # read, then dropped by convert("RGB")
            if len(data) < start + side[0] * side[1]:
                raise ValueError("ICNS mask ends early: PIL fails on it (buffer is not large "
                                 "enough)")
        elif kind in _RLE:
            if kind == b"it32":
                if data[start:start + 4] != bytes(4):
                    raise ValueError("ICNS it32 element without its 4 zero bytes: PIL fails "
                                     "on it")
                start, length = start + 4, length - 4
            channels["RGB"] = _read_32(data, start, length, side)
        else:
            channels["RGBA"] = _compressed(data, start, length)
    image = channels.get("RGBA")
    if image is None:
        image = channels.get("RGB")
        if image is None:
            raise ValueError("ICNS mask without an RGB icon: PIL fails on it")
    h, w = image.shape[:2]
    for sw, sh, scale in sizes:
        if (sw * scale) // w == (sh * scale) / h:
            return image
    raise ValueError(f"ICNS icon of {w}x{h}, none of the file's sizes: PIL fails on it")

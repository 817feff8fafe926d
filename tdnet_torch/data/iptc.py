"""IPTC/NAA image decoding, equal byte for byte to PIL's
``Image.open(path).convert("RGB")`` (``IptcImagePlugin``), the reference's
file route. cv2 does not read IPTC, so the ``cv2`` route refuses it.

IPTC has no magic number, so PIL offers it every file that its earlier
plugins pass on. It reads fields of ``0x1C``, a record (1-9 or 240), a
dataset and a big-endian size (past 128: the size's own byte count; 128:
none; past 132: it fails) up to a (8, 10) field or the end; a repeated
tag keeps every value. The image fields: (3, 60) its layers and whether
it has components (1 layer without: ``L``; 3 or 4 layers with: ``RGB`` or
``CMYK``, whose one stored band (3, 65) PIL places, the others black),
(3, 20) and (3, 30) the width and height, (3, 120) the compression, 1
(raw samples) or 5 (JPEG); a missing or unknown compression fails, other
missing or empty fields pass the file on, as does an unknown mode. The
image is the data of the (8, 10) fields in a row, read as a PGM of the
header's size (raw) or as a file of its own (JPEG: any format PIL reads,
of its own size, through ``data/image.py``); where no (8, 10) field
follows the header, PIL has no image to load, and fails.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from tdnet_torch.data import plugins

__all__ = ["READS", "ROUTES", "is_iptc", "decode_iptc", "iptc_size"]

READS = "IPTC/NAA (raw or JPEG data)"
ROUTES = ("pil", "cv2")
_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


class _Pass(Exception):
    pass


def _i(c: bytes) -> int:
    return int.from_bytes((b"\0\0\0\0" + c)[-4:], "big")


def _field(data: bytes, pos: int):
    """(tag or None, size, position after the header)."""
    s = data[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\0"):
        return None, 0, pos
    if len(s) < 3:
        raise _Pass  # IndexError
    if s[0] != 0x1C or s[1] not in _RECORDS:
        raise _Pass  # invalid IPTC/NAA file
    if len(s) < 4:
        raise _Pass
    size = s[3]
    if size > 132:
        raise ValueError("IPTC field length past 132: PIL fails on it (illegal field length)")
    if size == 128:
        size = 0
    elif size > 128:
        size = _i(data[pos:pos + size - 128])
        pos = min(len(data), pos + s[3] - 128)
    else:
        if len(s) < 5:
            raise _Pass  # struct.error
        size = int.from_bytes(s[3:5], "big")
    return (s[1], s[2]), size, pos


def _int(info, key) -> int:
    if key not in info:
        raise _Pass  # KeyError
    value = info[key]
    if not isinstance(value, bytes):
        raise _Pass  # TypeError: no data, or a repeated field
    return _i(value)


def _open(data: bytes):
    """(mode, band, (width, height), compression, offset of the image
    fields or None)."""
    info: Dict[tuple, object] = {}
    pos = 0
    while True:
        offset = pos
        tag, size, pos = _field(data, pos)
        if not tag or tag == (8, 10):
            break
        value = data[pos:pos + size] if size else None
        pos = min(len(data), pos + size)
        if isinstance(info.get(tag), list):
            info[tag].append(value)  # in place, as PIL does: the walk stays linear
        elif tag in info:
            info[tag] = [info[tag], value]
        else:
            info[tag] = value
    kind = info.get((3, 60), KeyError)
    if kind is KeyError or kind is None or len(kind) < 2:
        raise _Pass  # KeyError, TypeError or IndexError
    layers, component = kind[0], kind[1]
    mode, band = None, None
    if isinstance(layers, int) and layers == 1 and not component:
        mode = "L"
    else:
        if isinstance(layers, int) and layers == 3 and component:
            mode = "RGB"
        elif isinstance(layers, int) and layers == 4 and component:
            mode = "CMYK"
        if (3, 65) in info:
            value = info[(3, 65)]
            if not isinstance(value, bytes):
                raise _Pass  # TypeError
            band = value[0] - 1
        else:
            band = 0
    width, height = _int(info, (3, 20)), _int(info, (3, 30))
    if (3, 120) not in info:
        raise ValueError("IPTC image without a compression field: PIL fails on it (Unknown "
                         "IPTC image compression)")
    compression = _int(info, (3, 120))
    if compression not in (1, 5):
        raise ValueError(f"IPTC compression {compression}: PIL fails on it (Unknown IPTC image "
                         "compression)")
    if mode is None or width <= 0 or height <= 0:
        raise _Pass
    return mode, band, (width, height), compression, offset if tag == (8, 10) else None


def _opened(data: bytes):
    try:
        return _open(data)
    except _Pass:
        return None


def is_iptc(data: bytes) -> bool:
    """PIL's IPTC plugin takes it (opens it, or fails in it)."""
    try:
        return _opened(bytes(data)) is not None
    except ValueError:
        return True


def _head(data: bytes):
    opened = _opened(data)
    if opened is None:
        raise ValueError(f"not an IPTC file PIL opens; this reader takes {READS}")
    plugins.check_bomb(*opened[2], "IPTC")
    return opened


def iptc_size(data: bytes) -> Tuple[int, int]:
    """(width, height) of the header, as PIL's ``.size``."""
    return _head(bytes(data))[2]


def _image_data(data: bytes, pos: int) -> bytes:
    out = bytearray()
    while True:
        try:
            tag, size, pos = _field(data, pos)
        except _Pass:
            raise ValueError("IPTC image field PIL cannot read: PIL fails on it") from None
        if tag != (8, 10):
            return bytes(out)
        chunk = data[pos:pos + size]
        out += chunk
        pos += len(chunk)


def decode_iptc(data: bytes, route: str = "pil") -> np.ndarray:
    """IPTC bytes -> (H, W, 3) uint8 RGB, equal to PIL's
    ``convert("RGB")``; the ``cv2`` route raises (OpenCV does not read
    IPTC)."""
    from tdnet_torch.data import image, jpeg

    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("IPTC: OpenCV cannot read it (cv2.imdecode returns None)")
    data = bytes(data)
    mode, band, (width, height), compression, offset = _head(data)
    if offset is None:
        raise ValueError("IPTC header with no image fields: PIL fails on it (cannot load this "
                         "image)")
    body = _image_data(data, offset)
    if compression == 1:
        if len(body) < width * height:
            raise ValueError("IPTC raw data ends early: PIL fails on it (image file is "
                             "truncated)")
        gray = np.frombuffer(body, np.uint8, width * height).reshape(height, width)
    elif band is None:
        return image.decode_image(body, route="pil")
    else:
        found = image.pil_plugin(body)
        if not found or found[0] != "JPEG" or len(jpeg._coefficients(body)[0].comps) != 1:
            raise ValueError("IPTC band that is not a gray JPEG: the port reads a gray JPEG "
                             "band only")
        gray = jpeg.decode_jpeg(body, route="pil")[:, :, 0]
    if band is None:
        return np.repeat(gray[:, :, None], 3, axis=2)
    bands = np.zeros(gray.shape + (3 if mode == "RGB" else 4,), np.uint8)
    if not -bands.shape[2] <= band < bands.shape[2]:
        raise ValueError(f"IPTC band {band + 1} of a {mode} image: PIL fails on it")
    bands[:, :, band] = gray
    return bands if mode == "RGB" else jpeg._cmyk_rgb(255 - bands, "pil")

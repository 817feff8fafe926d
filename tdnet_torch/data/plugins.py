"""PIL's plugin order, for the file route: which reader ``Image.open``
would hand a file to.

``Image.open`` offers a file to its plugins in turn: first BMP, DIB, GIF,
JPEG, PPM and PNG, then every other in the order of ``Image.OPEN`` (AVIF,
BLP, BUFR, CUR, PCX, DCX, DDS, EPS, FITS, FLI, FTEX, GBR, GRIB, HDF5,
JPEG2000, ICNS, ICO, IM, IMT, IPTC, MCIDAS, MPEG, TIFF, MSP, PCD, PIXAR,
PSD, QOI, SGI, SPIDER, SUN, TGA, WEBP, WMF, XBM, XPM, XVTHUMB). A plugin
whose ``_accept`` takes the first 16 bytes (IM, IMT, IPTC, PCD, SPIDER and
TGA have none: they see every file) gets to ``_open`` it; a
``SyntaxError`` there passes the file on to the next plugin, and so does an
``IndexError``, ``TypeError``, ``KeyError``, ``EOFError`` or
``struct.error`` (``ImageFile`` turns each into a ``SyntaxError``), or an
image with no mode or an empty size; any other error ends ``Image.open``.

:func:`foreign` tells which of the plugins that the port does not read
would take a file before a later reader does: those that PIL opens but
cannot load (BUFR, GRIB and HDF5, which have no loader; EPS without
Ghostscript; MPEG; WMF). Their headers are modelled here, so that the
port refuses what PIL would take by such a plugin, and goes on where that
plugin passes.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

__all__ = ["PIL_MAX_PIXELS", "check_bomb", "foreign", "BUFR", "EPS", "GRIB_HDF5", "MPEG", "WMF"]

# past twice Image.MAX_IMAGE_PIXELS, Image.open raises DecompressionBombError
PIL_MAX_PIXELS = 2 * 89478485


def check_bomb(width: int, height: int, what: str) -> None:
    """Raise where ``Image.open`` refuses the size as a decompression bomb."""
    if width * height > PIL_MAX_PIXELS:
        raise ValueError(f"{what} of {width}x{height} pixels: PIL refuses it as a "
                         "decompression bomb")


def _u32le(b: bytes, at: int = 0) -> int:
    return struct.unpack_from("<I", b, at)[0]


def _u16le(b: bytes, at: int = 0) -> int:
    return struct.unpack_from("<H", b, at)[0]


# --- the headers of the plugins the port does not read


def _mpeg(d: bytes) -> bool:
    # MpegImagePlugin: a sequence header whose 12-bit width and height are
    # there (else IndexError) and not 0 (else the size passes the file on)
    return (d[:4] == b"\0\0\1\xb3" and len(d) >= 7 and (d[4] << 4 | d[5] >> 4) > 0
            and ((d[5] & 15) << 8 | d[6]) > 0)


def _wmf(d: bytes) -> bool:
    """WmfImagePlugin's ``_open``: a placeable metafile (an inch of 0
    fails; another header than the standard one, or an empty size, passes
    on) or an enhanced one (a frame of no width or height fails)."""
    if d.startswith(b"\xd7\xcd\xc6\x9a\0\0"):
        if len(d) < 16:
            return False
        inch = _u16le(d, 14)
        if inch == 0:
            return True
        x0, y0, x1, y1 = struct.unpack_from("<4h", d, 6)
        size = ((x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch)
        return d[22:26] == b"\x01\x00\t\x00" and size[0] > 0 and size[1] > 0
    if d.startswith(b"\x01\0\0\0") and d[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", d, 8)
        if f2 == f0 or f3 == f1:
            return True
        return x1 - x0 > 0 and y1 - y0 > 0
    return False


def _magic(prefix: bytes):
    return lambda d: d.startswith(prefix)


# (name, claims, PIL's failure) of the plugins that PIL offers a file to
# between the port's readers, in PIL's order; a claim that passes the file
# on is False. The failure is what PIL itself raises once it has opened it.
_NO_LOADER = "cannot find loader for this {} file"
BUFR = (("BUFR", lambda d: d[:4] in (b"BUFR", b"ZCZC"), _NO_LOADER.format("BUFR")),)
EPS = (("EPS", lambda d: d[:4] == b"%!PS" or (len(d) >= 4 and _u32le(d) == 0xC6D3D0C5),
        "Unable to locate Ghostscript on paths"),)
GRIB_HDF5 = (("GRIB", lambda d: d[:4] == b"GRIB" and len(d) > 7 and d[7] == 1,
              _NO_LOADER.format("GRIB")),
             ("HDF5", _magic(b"\x89HDF\r\n\x1a\n"), _NO_LOADER.format("HDF5")))
MPEG = (("MPEG", _mpeg, "cannot load this image"),)
WMF = (("WMF", _wmf, _NO_LOADER.format("WMF")),)


def foreign(data: bytes, group) -> Optional[Tuple[str, Optional[str]]]:
    """(name, PIL's failure) of the first plugin of ``group`` (one of the
    tuples above) that would take ``data``, or None."""
    for name, claims, failure in group:
        try:
            if claims(data):
                return name, failure
        except struct.error:
            continue
    return None

"""BMP decoding with numpy, equal byte for byte to the reference's two
decoders: PIL's ``convert("RGB")`` for files (``route="pil"``) and
``cv2.imdecode(..., IMREAD_COLOR)`` for serve bodies (``route="cv2"``).

Reads BI_RGB at 1, 4 and 8 bits (palette), 16 (5-5-5), 24 and 32 bits,
BI_BITFIELDS at 16 bits (5-6-5 or 5-5-5) and 32 bits (8-8-8 in the usual
places), and BI_RLE8 and BI_RLE4, with any of the header versions (OS/2
core, 40, 52, 56, 108, 124 bytes), bottom-up or top-down rows padded to 4
bytes. Alpha is dropped. At 16 bits PIL scales a 5-bit sample by ``v *
255 // 31`` (6-bit: ``// 63``), cv2 shifts it left.

The two routes decode RLE each by its own code, and agree on the streams
encoders write: encoded runs, absolute runs padded to a 16-bit word, end
of line, end of bitmap, and deltas, the pixels a delta or an early end of
line skips taking palette entry 0. They part on streams that break the
format's rules, and each rule is kept:

- PIL (``BmpRleDecoder``) builds one stream of indices, row after row:
  it cuts an encoded run at the row's end, lets an absolute run run on
  into the next row, reads a delta's two bytes and then takes the two
  that follow as (right, down), reads ``n // 2`` bytes for an absolute
  RLE4 run of ``n`` pixels (an odd run loses its last pixel), aligns to
  the file's 16-bit words, and fails where the stream ends before the last
  pixel.
- cv2 (``BmpDecoder::readData``) writes row by row and fails on a run
  that passes the row's end; a delta, an end of line and an end of bitmap
  fill what they skip with palette entry 0 (an end of line right after
  another, or at a row's start in RLE4, fills a whole row; in RLE8 an
  end of line right after an encoded run that filled its row is
  dropped). In RLE4 a delta moves right only and an end of bitmap ends
  the row alone. It fails where the stream ends before the last row.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from tdnet_torch.data import plugins

__all__ = ["SIGNATURE", "READS", "ROUTES", "decode_bmp", "bmp_size", "DIB_READS", "is_dib",
           "decode_dib", "dib_size", "bitmap_as_bmp"]

SIGNATURE = b"BM"
READS = ("BMP (BI_RGB at 1, 4, 8, 16, 24 and 32 bits; BI_BITFIELDS at 16 and "
         "32 bits; BI_RLE8 and BI_RLE4)")
ROUTES = ("pil", "cv2")
DIB_READS = "DIB (a BMP without its file header, as PIL reads it)"
DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)

_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3
_MASKS_16 = {(0xF800, 0x07E0, 0x001F): (11, 5, 0, 5, 6, 5),
             (0x7C00, 0x03E0, 0x001F): (10, 5, 0, 5, 5, 5)}
_MASKS_32 = (0xFF0000, 0x00FF00, 0x0000FF)


def _header(data: bytes, route: str = "pil"):
    """(width, height, top-down, bits, compression, colours used, header
    size, pixel offset) of a BMP. PIL reads an OS/2 core header's width and
    height unsigned (so never top-down)."""
    if not data.startswith(SIGNATURE) or len(data) < 26:
        raise ValueError(f"not a BMP file; this reader takes {READS}")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    if size == 12:
        width, height, _, bits = struct.unpack("<HHHH" if route == "pil" else "<hhHH",
                                               data[18:26])
        compression, colors = _BI_RGB, 0
    elif size in (40, 52, 56, 64, 108, 124) and len(data) >= 14 + 40:
        width, height, _, bits, compression, _, _, _, colors = struct.unpack(
            "<iiHHIIiiI", data[18:50])
    else:
        raise ValueError(f"BMP header of {size} bytes is not read")
    top_down = height < 0
    return width, abs(height), top_down, bits, compression, colors, size, offset


def bmp_size(data: bytes) -> Tuple[int, int]:
    """(width, height) from the header."""
    width, height = _header(data)[:2]
    return width, height


def _rows(data: bytes, offset: int, width: int, height: int, bits: int,
          top_down: bool) -> np.ndarray:
    stride = ((width * bits + 31) >> 5) * 4
    end = offset + stride * height
    if len(data) < end:
        raise ValueError("truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    return rows if top_down else rows[::-1]


def _palette(data: bytes, size: int, bits: int, colors: int) -> np.ndarray:
    """(2^bits, 3) RGB entries; those the file leaves out are black."""
    entry = 3 if size == 12 else 4
    n = colors or (1 << bits)
    start = 14 + size
    table = np.frombuffer(data[start:start + n * entry], np.uint8)
    if table.size != n * entry:
        raise ValueError("truncated BMP palette")
    palette = np.zeros((1 << bits, 3), np.uint8)
    palette[:min(n, 1 << bits)] = table.reshape(n, entry)[:1 << bits, 2::-1]
    return palette


def _rle_pil(data: bytes, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """PIL's ``BmpRleDecoder``: (height, width) palette indices, in the
    file's row order."""
    out = bytearray()
    x, total, end = 0, width * height, len(data)
    while len(out) < total:
        if pos + 2 > end:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # encoded: a run cut at the row's end
            count = max(0, min(count, width - x))
            if rle4:
                out += bytes([byte >> 4, byte & 15]) * (count >> 1) + bytes([byte >> 4])[:count & 1]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta, read at the two bytes after its own
            if pos + 2 > end:
                break
            if pos + 4 > end:
                raise ValueError("truncated RLE BMP delta")
            right, down = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + down * width)
            x = len(out) % width
        else:  # absolute: byte pixels, the RLE4 bytes counted as byte // 2
            n = byte // 2 if rle4 else byte
            got = data[pos:pos + n]
            pos += len(got)
            if rle4:
                pairs = np.frombuffer(got, np.uint8)
                out += np.stack([pairs >> 4, pairs & 15], axis=1).tobytes()
            else:
                out += got
            if len(got) < n:
                break
            x += byte
            pos += pos & 1  # PIL aligns to the file's 16-bit words
    if len(out) < total:
        raise ValueError("RLE BMP data ends before its last pixel")
    return np.frombuffer(bytes(out[:total]), np.uint8).reshape(height, width)


def _rle_cv2(data: bytes, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """OpenCV's RLE decoder: (height, width) palette indices, in the file's
    row order."""
    out = np.zeros((height, width), np.uint8)
    x = y = 0
    end = len(data)

    def fill(count: int, value: int) -> None:
        nonlocal x, y
        while True:
            n = min(count, width - x)
            out[y, x:x + n] = value
            x, count = x + n, count - n
            if x >= width:
                x, y = 0, y + 1
                if y >= height:
                    return
            if count <= 0:
                return

    line_end_flag = False
    while True:
        if pos + 2 > end:
            raise ValueError("RLE BMP data ends before its last row")
        count, code = data[pos], data[pos + 1]
        pos += 2
        if count:  # encoded
            if x + count > width:
                raise ValueError("RLE BMP run passes the end of its row")
            if rle4:
                out[y, x:x + count] = np.resize(np.uint8([code >> 4, code & 15]), count)
                x += count
                continue
            row = y
            fill(count, code)
            line_end_flag = y != row
            if y >= height:
                break
        elif code > 2:  # absolute, padded to a 16-bit word
            if x + code > width:
                raise ValueError("RLE BMP run passes the end of its row")
            n = ((((code + 1) >> 1) + 1) & ~1) if rle4 else (code + 1) & ~1
            if pos + n > end:
                raise ValueError("RLE BMP data ends before its last row")
            raw = np.frombuffer(data, np.uint8, n, pos)
            pos += n
            if rle4:
                raw = np.stack([raw >> 4, raw & 15], axis=1).reshape(-1)
            out[y, x:x + code] = raw[:code]
            x += code
            line_end_flag = False
        else:  # end of line (0), end of bitmap (1), delta (2)
            skip, down = width - x, height - y
            if rle4 or code or not line_end_flag or skip < width:
                if code == 2:
                    if pos + 2 > end:
                        raise ValueError("RLE BMP data ends before its last row")
                    skip, down = data[pos], data[pos + 1]
                    pos += 2
                if code and not rle4:  # RLE4 skips to the row's end or dx only
                    skip += down * width
                if y >= height:
                    break
                fill(skip, 0)
            line_end_flag = False
            if y >= height:
                break
    return out


def decode_bmp(data: bytes, route: str = "pil") -> np.ndarray:
    """BMP bytes -> (H, W, 3) uint8 RGB by the rule of ``route``."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    width, height, top_down, bits, compression, colors, size, offset = _header(data, route)
    if width <= 0 or height == 0:
        raise ValueError(f"bad BMP size {width}x{height}")
    if compression in (_BI_RLE8, _BI_RLE4):
        if bits != (8 if compression == _BI_RLE8 else 4):
            raise ValueError(f"BI_RLE{4 if compression == _BI_RLE4 else 8} BMP at {bits} bits")
        rle = _rle_pil if route == "pil" else _rle_cv2
        if route == "pil" and colors == 2 and data[14 + size:22 + size:4] == b"\x00\xff":
            # two entries, black and white: PIL takes the page as mode "1",
            # which its RLE decoder cannot fill
            if _palette(data, size, bits, colors)[:2].tolist() == [[0, 0, 0], [255] * 3]:
                raise ValueError("RLE BMP with a black and white palette (PIL fails on one)")
        index = rle(data, offset, width, height, compression == _BI_RLE4)
        return _palette(data, size, bits, colors)[index if top_down else index[::-1]]
    if compression not in (_BI_RGB, _BI_BITFIELDS):
        raise ValueError(f"BMP compression {compression} is not read")
    if compression == _BI_BITFIELDS and bits not in (16, 32) and (route, bits) != ("pil", 24):
        raise ValueError(f"BI_BITFIELDS BMP at {bits} bits is not read")
    rows = _rows(data, offset, width, height, bits, top_down)
    if bits in (1, 4, 8):
        palette = _palette(data, size, bits, colors)
        if bits == 8:
            index = rows[:, :width]
        else:
            index = np.unpackbits(rows, axis=1)
            if bits == 4:
                index = (index.reshape(height, -1, 4) * np.uint8([8, 4, 2, 1])).sum(
                    axis=2, dtype=np.uint8)
            index = index[:, :width]
        return palette[index]
    if bits == 24:
        if compression == _BI_BITFIELDS and struct.unpack("<III", data[54:66]) != _MASKS_32:
            raise ValueError("BMP bitfields at 24 bits other than 8-8-8 are not read")
        return np.ascontiguousarray(rows[:, :3 * width].reshape(height, width, 3)[:, :, ::-1])
    if bits == 32:
        if compression == _BI_BITFIELDS and route == "pil":
            # PIL's rawmode for each layout it takes (its MASK_MODES): where
            # the red, green and blue bytes lie in the pixel
            masks = struct.unpack("<III", data[54:66]) + (
                struct.unpack("<I", data[66:70]) if size >= 56 else (0,))
            if masks not in _BITFIELDS_PIL[32]:
                raise ValueError(f"BMP bitfields {tuple(map(hex, masks))} are not read")
            order = [(m & -m).bit_length() // 8 if m else None for m in masks[:3]]
            if masks == (0, 0, 0, 0):
                order = [2, 1, 0]
            px = rows[:, :4 * width].reshape(height, width, 4)
            return np.ascontiguousarray(px[:, :, order])
        if compression == _BI_BITFIELDS:
            masks = struct.unpack("<III", data[54:66])
            if masks != _MASKS_32:
                raise ValueError(f"BMP bitfields {tuple(map(hex, masks))} are not read")
        px = rows[:, :4 * width].reshape(height, width, 4)
        return np.ascontiguousarray(px[:, :, 2::-1])
    if bits == 16:
        masks = (0x7C00, 0x03E0, 0x001F)
        if compression == _BI_BITFIELDS:
            masks = struct.unpack("<III", data[54:66])
        if masks not in _MASKS_16:
            raise ValueError(f"BMP bitfields {tuple(map(hex, masks))} are not read")
        rs, gs, bs, rn, gn, bn = _MASKS_16[masks]
        px = rows[:, :2 * width].copy().view("<u2").astype(np.int32)
        out = np.empty((height, width, 3), np.uint8)
        for ch, (shift, nbits) in enumerate(((rs, rn), (gs, gn), (bs, bn))):
            v = (px >> shift) & ((1 << nbits) - 1)
            out[:, :, ch] = v * 255 // ((1 << nbits) - 1) if route == "pil" else v << (8 - nbits)
        return out
    raise ValueError(f"BMP at {bits} bits is not read")


# --- a bitmap without its file header (DIB, and the frames of CUR), as PIL's
# BmpImageFile._bitmap reads one

_BITFIELDS_PIL = {32: ((0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
                       (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                       (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                       (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)),
                  24: ((0xFF0000, 0xFF00, 0xFF),),
                  16: ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F))}


def bitmap_as_bmp(data: bytes, at: int = 0, halve: bool = False):
    """PIL's ``BmpImageFile._bitmap`` of the bitmap header at ``at`` (no
    file header): a BMP file of the same header, palette and pixels that
    :func:`decode_bmp` reads, and PIL's (width, height); ``halve`` halves
    the height as ``CurImagePlugin`` does. None where PIL's plugin passes
    the file on (a short read of a 40-byte header's bit masks, an empty
    size); ValueError where it ends ``Image.open`` (a short header, an
    unknown header size, depth, compression or bit masks, a palette of
    more than 65536 colours)."""
    if len(data) < at + 4:
        return None
    (size,) = struct.unpack_from("<I", data, at)
    if len(data) < at + size:
        raise ValueError("BMP header runs past the end of the file: PIL fails on it "
                         "(Truncated File Read)")
    if size == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", data, at + 4)
        compression, colors, pad, flip = _BI_RGB, 0, 3, False
    elif size in DIB_HEADERS:
        width, raw, _, bits, compression = struct.unpack_from("<IIHHI", data, at + 4)
        (colors,) = struct.unpack_from("<I", data, at + 32)
        flip = data[at + 11] == 0xFF
        height = 2 ** 32 - raw if flip else raw
        pad = 4
    else:
        raise ValueError(f"BMP header of {size} bytes: PIL fails on it (Unsupported BMP "
                         "header type)")
    pixels = at + size
    if compression == _BI_BITFIELDS and size != 12:
        if size == 40:
            if len(data) < pixels + 12:
                return None  # struct.error: PIL passes the file on
            masks = struct.unpack_from("<III", data, pixels) + (0,)
            pixels += 12
        else:
            masks = struct.unpack_from("<IIII", data, at + 40)
            masks = masks if size >= 56 else masks[:3] + (0,)
        if bits not in _BITFIELDS_PIL or (masks if bits == 32 else masks[:3]) not in \
                _BITFIELDS_PIL[bits]:
            raise ValueError("BMP bit masks PIL does not read (Unsupported BMP bitfields "
                             "layout)")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP at {bits} bits: PIL fails on it (Unsupported BMP pixel depth)")
    if compression not in (_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS):
        raise ValueError(f"BMP compression {compression}: PIL fails on it")
    if bits <= 8:
        n = colors or 1 << bits
        if n > 65536:
            raise ValueError(f"BMP palette of {n} colours: PIL fails on it")
        pixels = min(len(data), pixels + pad * n)
    if halve:
        height //= 2
    if width == 0 or height == 0:
        return None  # an empty size: PIL passes the file on
    plugins.check_bomb(width, height, "BMP")
    header = bytearray(data[at:pixels])
    if size == 12:
        header[6:8] = struct.pack("<H", height)
    else:
        header[8:12] = struct.pack("<i", -height if flip else height)
    head = b"BM" + struct.pack("<IHHI", 14 + len(data) - at, 0, 0, 14 + pixels - at)
    return head + bytes(header) + data[pixels:], (width, height)


def is_dib(data: bytes) -> bool:
    """PIL's DIB plugin takes it: a known header size in its first 4 bytes,
    and what :func:`bitmap_as_bmp` does not pass on."""
    if len(data) < 4 or struct.unpack_from("<I", data)[0] not in DIB_HEADERS:
        return False
    try:
        return bitmap_as_bmp(data) is not None
    except ValueError:
        return True


def _dib(data: bytes):
    made = bitmap_as_bmp(bytes(data))
    if made is None:
        raise ValueError(f"not a DIB file PIL opens; this reader takes {DIB_READS}")
    return made


def dib_size(data: bytes) -> Tuple[int, int]:
    """(width, height) of a DIB, as PIL's ``.size``."""
    return _dib(data)[1]


def decode_dib(data: bytes, route: str = "pil") -> np.ndarray:
    """A DIB (a BMP without its file header) -> (H, W, 3) uint8 RGB, equal
    to PIL's ``convert("RGB")``; the ``cv2`` route raises (OpenCV does not
    read a DIB)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("DIB: OpenCV cannot read it (cv2.imdecode returns None)")
    return decode_bmp(_dib(data)[0], route="pil")

"""TIFF decoding in Python and numpy, equal byte for byte to the two
decoders the reference reads pages with: PIL's ``Image.open(path).
convert("RGB")`` for files (``route="pil"``; PIL reads compressed TIFF
through libtiff) and ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` for serve
bodies (``route="cv2"``; OpenCV reads 8-bit output through libtiff's
``TIFFReadRGBA*``).

Reads the first page (both routes do) of a classic TIFF in either byte
order (``II*\\0``, ``MM\\0*``), in strips or tiles, chunky or planar
(``PlanarConfiguration`` 1 or 2), with the compressions none, PackBits,
LZW (``Predictor`` 2 too), deflate (codes 8 and 32946, through zlib),
CCITT Group 3 (one- and two-dimensional, ``T4Options`` bits 0 and 2) and
Group 4 (both with ``FillOrder`` 1 or 2) and JPEG (code 7: each strip or
tile a JPEG stream decoded by ``data/jpeg.py``, the ``JPEGTables`` tag
spliced in before it, YCbCr converted to RGB by libjpeg and every other
photometric left as the components are). Photometric min-is-white,
min-is-black, RGB, palette (a 16-bit colormap), separated CMYK, YCbCr and
CIE L*a*b* (``data/cielab.py``), at 1, 2, 4, 8 or 16 bits a sample. Outside JPEG, YCbCr is read as
libtiff's RGBA interface reads it for both routes: 8-bit data units
subsampled 1x1 to 4x4 (``tif_getimage.c``, its 4x4 misreads kept) and
``tif_color.c``'s fixed-point conversion from ``YCbCrCoefficients`` and
``ReferenceBlackWhite``. Other compressions, photometrics and layouts
raise, naming what is not read.

The routes part where their decoders do:

- 16-bit samples: PIL clips 16-bit gray to 255 (min-is-white not
  inverted) and keeps the high byte of 16-bit colour; cv2 keeps the high
  byte of gray and rounds ``v * 255 / 65535`` for colour, and fails on
  16-bit CMYK.
- Extra samples (alpha) are dropped; but cv2 premultiplies RGB by an
  unassociated alpha (``(v * a + 127) // 255``), as libtiff's RGBA
  interface does, and PIL divides an associated one out of RGB (``255 *
  v // a``).
- cv2 reads 1, 8 and 16 bits a sample (4 in a palette): 2-bit pages and
  4-bit gray raise on its route.
- A colormap whose entries are all below 256: libtiff (cv2) takes it for
  an 8-bit one, PIL keeps the high byte of each entry as for any other.
- Uncompressed YCbCr: PIL reads the bytes as ``RGBX`` unconverted, strips
  and tiles, and raises where that runs past the end of the file
  (:func:`_pil_raw`).
- Uncompressed 16-bit samples in planes: PIL reads each plane's bytes as
  8-bit samples, a byte a pixel (:func:`_pil_planar16`), and refuses gray,
  gray with alpha, associated alpha and L*a*b* so stored.
- Uncompressed tiles on the cv2 route: libtiff refuses a tile whose byte
  count, rounded up to a multiple of 1024, is not the tile's size, and
  reads a short one that passes as zero samples (:func:`_cv2_raw_tile`);
  a gray tile of 16-bit samples or with alpha, clipped at the right edge,
  is read with libtiff's skew (:func:`_cv2_gray_skew`).
- Gray with extra samples: PIL reads only 8-bit min-is-black with
  unassociated alpha (``LA``; not uncompressed in planes). cv2 reads them
  all: chunky, libtiff ignores the alpha (associated or not); in planes it
  reads them as RGB (no min-is-white inversion, 16 bits rounded to 8, an
  unassociated alpha premultiplied).
- CIE L*a*b* (photometric 8, a* and b* signed): PIL reads 3 8-bit samples
  in any layout and converts them through LittleCMS (Lab D50 -> sRGB);
  cv2 reads 3 chunky samples of 8 or 16 bits through libtiff's CIELab
  conversion, against the ``WhitePoint`` tag. They part by up to 80 on
  random samples. Both refuse other sample counts, ICC L*a*b* (9) and
  ITU L*a*b* (10); the port refuses JPEG-compressed L*a*b*, which is not
  probed.
- ``Orientation`` turns the page on both routes, and PIL's ``.size``
  (:func:`tiff_size`) reports the turned size.
"""

from __future__ import annotations

import bisect
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from tdnet_torch.data import cielab, jpeg

__all__ = ["SIGNATURES", "READS", "ROUTES", "decode_tiff", "tiff_size"]

SIGNATURES = (b"II*\x00", b"MM\x00*")
READS = ("TIFF (first page; strips or tiles, chunky or planar; none, PackBits, LZW, "
         "deflate, CCITT G3/G4 or JPEG; gray, palette, RGB, CMYK, YCbCr or CIE L*a*b* "
         "at 1 to 16 bits)")
ROUTES = ("pil", "cv2")

_COMPRESSIONS = {
    1: "none", 2: "CCITT modified Huffman RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
    5: "LZW", 6: "old-style JPEG", 7: "JPEG", 8: "deflate", 9: "JBIG (T.85)",
    10: "JBIG (T.43)", 32766: "NeXT 2-bit RLE", 32771: "CCITT RLE (word-aligned)",
    32773: "PackBits", 32809: "ThunderScan", 32895: "IT8 CT", 32896: "IT8 LW",
    32897: "IT8 HC", 32898: "IT8 BL", 32908: "Pixar film", 32909: "Pixar log",
    32946: "deflate", 32947: "Kodak DCS", 34661: "JBIG", 34676: "SGI LogL",
    34677: "SGI LogLuv", 34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA",
    50000: "Zstandard", 50001: "WebP", 50002: "JPEG XL",
}
_READ = (1, 3, 4, 5, 7, 8, 32773, 32946)
_PHOTOMETRICS = {0: "min-is-white", 1: "min-is-black", 2: "RGB", 3: "palette",
                 4: "transparency mask", 5: "separated", 6: "YCbCr", 8: "CIE L*a*b*",
                 9: "ICC L*a*b*", 10: "ITU L*a*b*", 32844: "LogL", 32845: "LogLuv",
                 32803: "CFA", 34892: "linear raw"}
_BASE = {0: 1, 1: 1, 2: 3, 3: 1, 5: 4, 6: 3, 8: 3}  # samples a pixel before extra ones

# field types -> (struct code, bytes a value)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4)}

(_WIDTH, _HEIGHT, _BITS, _COMPRESSION, _PHOTOMETRIC, _FILL_ORDER, _STRIP_OFFSETS,
 _ORIENTATION, _SAMPLES, _ROWS_PER_STRIP, _STRIP_COUNTS, _PLANAR, _T4, _T6, _PREDICTOR,
 _COLORMAP, _TILE_WIDTH, _TILE_LENGTH, _TILE_OFFSETS, _TILE_COUNTS, _INK_SET, _EXTRA,
 _SAMPLE_FORMAT, _JPEG_TABLES, _LUMA, _SUBSAMPLING, _REF_BLACK_WHITE, _WHITE_POINT) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 292, 293, 317, 320, 322,
    323, 324, 325, 332, 338, 339, 347, 529, 530, 532, 318)


def _ifd(data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """Byte order and the first IFD's fields: tag -> tuple of values (an
    ASCII or UNDEFINED field as one bytes value)."""
    if data[:4] not in SIGNATURES:
        if data[:4] in (b"II+\x00", b"MM\x00+"):
            raise ValueError("BigTIFF is not read")
        raise ValueError(f"not a TIFF file; this reader takes {READS}")
    end = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise ValueError("truncated TIFF header")
    (pos,) = struct.unpack(end + "I", data[4:8])
    if pos + 2 > len(data):
        raise ValueError("truncated TIFF: its first IFD lies past the end")
    (n,) = struct.unpack(end + "H", data[pos:pos + 2])
    if pos + 2 + 12 * n > len(data):
        raise ValueError("truncated TIFF IFD")
    fields = {}
    for i in range(n):
        tag, kind, count, raw = struct.unpack(end + "HHI4s", data[pos + 2 + 12 * i:pos + 14 + 12 * i])
        if kind not in _TYPES:
            continue  # libtiff skips fields of unknown type
        code, size = _TYPES[kind]
        nbytes = size * count
        if nbytes <= 4:
            body = raw[:nbytes]
        else:
            (at,) = struct.unpack(end + "I", raw)
            body = data[at:at + nbytes]
            if len(body) < nbytes:
                raise ValueError(f"truncated TIFF field {tag}")
        if kind in (2, 7):
            fields[tag] = (bytes(body),)
        else:
            fields[tag] = struct.unpack(f"{end}{count * len(code)}{code[0]}", body)
    return end, fields


def _one(fields, tag: int, default=None) -> int:
    values = fields.get(tag)
    if values is None:
        if default is None:
            raise ValueError(f"TIFF without its {tag} field")
        return default
    return int(values[0])


def tiff_size(data: bytes) -> Tuple[int, int]:
    """(width, height) from the first IFD, as PIL's ``.size`` reports it:
    turned where ``Orientation`` is 5 to 8."""
    _, fields = _ifd(data)
    width, height = _one(fields, _WIDTH), _one(fields, _HEIGHT)
    return (height, width) if _one(fields, _ORIENTATION, 1) in (5, 6, 7, 8) else (width, height)


# --- compressions


def _packbits(raw: bytes) -> bytes:
    out = bytearray()
    pos, n = 0, len(raw)
    while pos < n:
        h = raw[pos]
        pos += 1
        if h < 128:
            out += raw[pos:pos + h + 1]
            pos += h + 1
        elif h > 128:
            if pos < n:
                out += raw[pos:pos + 1] * (257 - h)
            pos += 1
    return bytes(out)


def _lzw(raw: bytes) -> bytes:
    """TIFF LZW: codes MSB first, 9 to 12 bits, the width growing one code
    early; 256 clears the table, 257 ends the data."""
    if raw[:2] == b"\x00\x01":
        raise ValueError("old-style (LSB first) TIFF LZW is not read")
    b = np.frombuffer(raw + bytes(4), np.uint8).astype(np.int64)
    windows = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = []
    pos, width, end = 0, 9, 8 * len(raw)
    prev = None
    while pos + width <= end:
        code = (windows[pos >> 3] >> (32 - width - (pos & 7))) & ((1 << width) - 1)
        pos += width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code < len(table):
            entry = table[code]
            if prev is not None:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt TIFF LZW data")
        out.append(entry)
        prev = entry
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return b"".join(out)


# CCITT T.4 codes: run -> code bits, white and black; terminating codes
# (0-63), make-up codes (64-1728) and the extended make-up codes that both
# colours share (1792-2560)
_WHITE = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100")
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 010011011")
_BLACK = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101")
_EXTENDED = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
             "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
             "000000011111")
# two-dimensional modes: pass, horizontal, vertical -3..3 (offset + 10)
_MODES = {"0001": 0, "001": 1, "1": 10, "011": 11, "000011": 12, "0000011": 13,
          "010": 9, "000010": 8, "0000010": 7, "0000001": -1}
_LOOK = 13  # bits of lookahead: the longest code


def _lookup(codes: Dict[str, int]):
    """A 2^13-entry table: the next 13 bits -> (code length, value), or
    (0, None) where no code starts them."""
    table = [(0, None)] * (1 << _LOOK)
    for bits, value in codes.items():
        lo = int(bits, 2) << (_LOOK - len(bits))
        for i in range(lo, lo + (1 << (_LOOK - len(bits)))):
            table[i] = (len(bits), value)
    return table


def _run_codes(terminating: str, makeup: str) -> Dict[str, int]:
    codes = {c: i for i, c in enumerate(terminating.split())}
    codes.update({c: 64 * (i + 1) for i, c in enumerate(makeup.split())})
    codes.update({c: 1792 + 64 * i for i, c in enumerate(_EXTENDED.split())})
    return codes


_RUNS = None


def _fax_tables():
    global _RUNS
    if _RUNS is None:
        _RUNS = (_lookup(_run_codes(_WHITE, _WHITE_MAKEUP)),
                 _lookup(_run_codes(_BLACK, _BLACK_MAKEUP)), _lookup(_MODES))
    return _RUNS


class _Fax:
    """CCITT T.4 / T.6 decoding of one strip or tile into rows of changing
    elements -> packed 1-bit rows (a black run is 1 bits, as libtiff writes
    them; the photometric says what 1 means)."""

    def __init__(self, raw: bytes, width: int, lsb_first: bool):
        if lsb_first:
            raw = bytes(raw).translate(_REVERSED)
        b = np.frombuffer(raw + bytes(8), np.uint8).astype(np.int64)
        self.windows = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
        self.end = 8 * len(raw)
        self.pos = 0
        self.width = width
        self.white, self.black, self.modes = _fax_tables()

    def peek(self) -> int:
        pos = self.pos
        return (self.windows[pos >> 3] >> (32 - _LOOK - (pos & 7))) & ((1 << _LOOK) - 1)

    def code(self, table, what: str) -> int:
        n, value = table[self.peek()]
        if value is None:
            raise ValueError(f"corrupt CCITT data: no {what} code at bit {self.pos}")
        self.pos += n
        return value

    def run(self, colour: int) -> int:
        table = self.black if colour else self.white
        total = 0
        while True:
            r = self.code(table, "run")
            total += r
            if r < 64:
                return total

    def eol(self) -> bool:
        """Skip fill and an end of line (11 or more zero bits, then a 1);
        False where the data ends first."""
        while self.pos < self.end:
            if self.peek() >> 2 == 0:  # 11 zero bits
                self.pos += 11
                while self.pos < self.end and not (self.peek() >> (_LOOK - 1)):
                    self.pos += 1
                self.pos += 1
                return self.pos <= self.end
            return True  # no end of line here (libtiff reads on)
        return False

    def row_1d(self):
        changes, a0, colour, w = [], 0, 0, self.width
        while a0 < w:
            a0 += self.run(colour)
            if a0 > w:
                raise ValueError("corrupt CCITT data: a run passes the row's end")
            changes.append(a0)
            colour ^= 1
        return changes

    def row_2d(self, ref):
        w = self.width
        changes, a0, colour = [], -1, 0
        ref = ref + [w] * 4
        while a0 < w:
            # b1: the first change on the reference row right of a0 to the
            # other colour (even indices turn white to black), b2 the next
            i = bisect.bisect_right(ref, a0)
            i += (i & 1) != colour
            b1, b2 = ref[i], ref[i + 1]
            mode = self.code(self.modes, "mode")
            if mode == 0:  # pass
                a0 = b2
            elif mode == 1:  # horizontal
                a0 = max(a0, 0)
                a1 = a0 + self.run(colour)
                a2 = a1 + self.run(colour ^ 1)
                if a2 > w:
                    raise ValueError("corrupt CCITT data: a run passes the row's end")
                changes += [a1, a2]
                a0 = a2
            elif mode == -1:
                raise ValueError("CCITT uncompressed mode is not read")
            else:
                a1 = b1 + mode - 10
                if a1 < 0 or a1 > w:
                    raise ValueError("corrupt CCITT data: a vertical code leaves the row")
                changes.append(a1)
                a0 = a1
                colour ^= 1
        return changes


_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _fax_rows(changes_by_row, width: int) -> bytes:
    """Rows of changing elements -> packed rows, each run of the second
    colour (black) as 1 bits."""
    toggles = np.zeros((len(changes_by_row), width + 1), np.int8)
    for r, changes in enumerate(changes_by_row):
        np.add.at(toggles[r], [c for c in changes if c < width], 1)
    bits = (np.cumsum(toggles, axis=1)[:, :width] & 1).astype(np.uint8)
    return np.packbits(bits, axis=1).tobytes()


def _fax(raw: bytes, width: int, rows: int, g4: bool, options: int, lsb_first: bool) -> bytes:
    if options & 2:
        raise ValueError("CCITT uncompressed mode is not read")
    fax = _Fax(raw, width, lsb_first)
    out, ref = [], []
    for _ in range(rows):
        if g4:
            if fax.peek() >> 1 == 1:  # EOFB: the rest is white
                break
            ref = fax.row_2d(ref)
        else:
            fax.eol()
            two_d = options & 1 and fax.pos < fax.end
            if two_d:
                tag = fax.peek() >> (_LOOK - 1)
                fax.pos += 1
                ref = fax.row_1d() if tag else fax.row_2d(ref)
            else:
                ref = fax.row_1d()
        out.append(ref)
    out += [[]] * (rows - len(out))
    return _fax_rows(out, width)


# --- layout


def _tile_bytes(cw: int, cr: int, spp: int, bits: int, sub) -> int:
    """libtiff's ``TIFFTileSize`` of an uncompressed tile (one plane's when
    planar): whole rows of packed samples, or YCbCr data units."""
    if sub != (1, 1):
        return -(-cw // sub[0]) * -(-cr // sub[1]) * (sub[0] * sub[1] + 2)
    return cr * ((cw * spp * bits + 7) // 8)


def _cv2_raw_tile(data: bytes, off: int, count: int, size: int) -> bytes:
    """An uncompressed tile as libtiff reads it for cv2: a byte count that,
    rounded up to a multiple of 1024, is not the tile's size is refused
    ("Invalid tile byte count"); a short one reads the whole tile as zero
    samples (``DumpModeDecode`` fails, the tile buffer stays cleared)."""
    if -(-count // 1024) * 1024 != size:
        raise ValueError(f"uncompressed TIFF tile of {count} bytes, {size} expected: "
                         "libtiff (cv2) refuses a count that rounded up to 1024 bytes is "
                         "not the tile's size (Invalid tile byte count)")
    if off + count > len(data):
        raise ValueError("truncated TIFF: a strip or tile lies past the end of the file")
    return data[off:off + size] if count == size else bytes(size)


def _chunk(data: bytes, fields, compression: int, index: int, offsets, counts,
                 cw: int, cr: int, spp: int, bits: int, end: str, sub=(1, 1), visible=0,
                 cv2_tile=False):
    """One strip or tile, decompressed -> (cr, cw, spp) samples; YCbCr
    subsampled by ``sub`` (h, v) comes back with its chroma replicated.
    ``cv2_tile``: an uncompressed tile read by the cv2 route's rule
    (:func:`_cv2_raw_tile`)."""
    off, count = offsets[index], counts[index]
    if cv2_tile and compression == 1:
        raw = _cv2_raw_tile(data, off, count, _tile_bytes(cw, cr, spp, bits, sub))
    else:
        raw = data[off:off + count]
    if len(raw) < count:
        raise ValueError("truncated TIFF: a strip or tile lies past the end of the file")
    fill_lsb = _one(fields, _FILL_ORDER, 1) == 2
    if compression == 7:
        return _jpeg_chunk(raw, fields, cw, cr, spp)
    if fill_lsb and compression not in (1, 3, 4, 32773):
        raise ValueError(f"TIFF FillOrder 2 with {_COMPRESSIONS[compression]} is not read")
    if fill_lsb and compression in (1, 32773):
        raw = bytes(raw).translate(_REVERSED)
    row_bytes = (cw * spp * bits + 7) // 8
    if compression == 1:
        body = raw
    elif compression == 32773:
        body = _packbits(raw)
    elif compression == 5:
        body = _lzw(raw)
    elif compression in (8, 32946):
        try:
            body = zlib.decompressobj().decompress(raw)
        except zlib.error as e:
            raise ValueError(f"corrupt TIFF deflate data: {e}") from None
    else:
        if bits != 1 or spp != 1:
            raise ValueError(f"{_COMPRESSIONS[compression]} TIFF at {bits} bits, {spp} samples")
        options = _one(fields, _T4 if compression == 3 else _T6, 0)
        body = _fax(raw, cw, cr, compression == 4, options, fill_lsb)
    if sub != (1, 1):
        if _one(fields, _PREDICTOR, 1) != 1:
            raise ValueError("TIFF Predictor with subsampled YCbCr is not read")
        return _ycbcr_blocks(body, cw, cr, *sub, visible)
    if len(body) < row_bytes * cr:
        raise ValueError("truncated TIFF strip or tile: too few bytes for its rows")
    rows = np.frombuffer(body, np.uint8, row_bytes * cr).reshape(cr, row_bytes)
    if _one(fields, _PREDICTOR, 1) == 2:
        rows = _undo_predictor(rows, cw, spp, bits, end)
    elif _one(fields, _PREDICTOR, 1) != 1:
        raise ValueError(f"TIFF Predictor {_one(fields, _PREDICTOR)} is not read")
    return _unpack(rows, cw, spp, bits, end)


def _undo_predictor(rows: np.ndarray, cw: int, spp: int, bits: int, end: str) -> np.ndarray:
    if bits == 8:
        px = rows[:, :cw * spp].reshape(rows.shape[0], cw, spp)
        return np.cumsum(px, axis=1, dtype=np.uint8).reshape(rows.shape[0], -1)
    if bits == 16:
        px = rows[:, :2 * cw * spp].copy().view(end + "u2").reshape(rows.shape[0], cw, spp)
        out = np.cumsum(px, axis=1, dtype=np.uint16).astype(end + "u2")
        return out.view(np.uint8).reshape(rows.shape[0], -1)
    raise ValueError(f"TIFF Predictor 2 at {bits} bits is not read")


def _unpack(rows: np.ndarray, cw: int, spp: int, bits: int, end: str) -> np.ndarray:
    cr = rows.shape[0]
    if bits == 8:
        return rows[:, :cw * spp].reshape(cr, cw, spp)
    if bits == 16:
        return rows[:, :2 * cw * spp].copy().view(end + "u2").astype(np.uint16).reshape(cr, cw, spp)
    px = np.unpackbits(rows, axis=1)
    if bits > 1:
        px = px[:, :px.shape[1] // bits * bits].reshape(cr, -1, bits)
        px = (px * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(axis=2, dtype=np.uint8)
    return px[:, :cw * spp].reshape(cr, cw, spp)


def _ycbcr_blocks(body: bytes, cw: int, cr: int, h: int, v: int, visible: int) -> np.ndarray:
    """Subsampled YCbCr data units (``h * v`` luma samples row by row, then
    Cb and Cr) -> (cr, cw, 3) samples, each unit's chroma on all its
    pixels, as ``tif_getimage.c``'s ``putcontig8bitYCbCr{hv}tile`` put
    the ``visible`` columns of a strip or tile: a partial unit at an edge
    is whole in the data. libtiff's own arithmetic is kept where it
    misreads: a strip is read to ``rows * (units a row * unit // v)``
    bytes, short by the remainder at 4x4 (the rest of its buffer is
    zero), and at 4x4 the units a tile hides right of the page are
    skipped as 10 bytes each, not 18."""
    across, down, unit = -(-cw // h), -(-cr // v), h * v + 2
    drawn = -(-visible // h)
    hidden = (cw - visible) // h * (10 if (h, v) == (4, 4) else unit)
    read = down * v * (across * unit // v) if visible == cw else across * down * unit
    if len(body) < read:
        raise ValueError("truncated TIFF strip or tile: too few bytes for its YCbCr blocks")
    starts = (np.arange(down)[:, None] * (drawn * unit + hidden)
              + np.arange(drawn)[None, :] * unit)
    buf = np.zeros(int(starts.max()) + unit, np.uint8)
    got = min(read, len(buf))
    buf[:got] = np.frombuffer(body, np.uint8, got)
    units = buf[starts[:, :, None] + np.arange(unit)]
    luma = units[:, :, :h * v].reshape(down, drawn, v, h).transpose(0, 2, 1, 3)
    out = np.zeros((down * v, across * h, 3), np.uint8)
    out[:, :drawn * h, 0] = luma.reshape(down * v, drawn * h)
    for i in (1, 2):
        out[:, :drawn * h, i] = np.repeat(np.repeat(units[:, :, h * v + i - 1], v, axis=0),
                                          h, axis=1)
    return out[:cr, :cw]


def _floats(fields, tag: int, n: int, default) -> list:
    """A float field of n values as libtiff stores it: a RATIONAL is
    ``(float)num / (float)den`` in float32 (0 where den is 0)."""
    values = fields.get(tag)
    if values is None:
        return [np.float32(v) for v in default]
    if len(values) == 2 * n:
        pairs = zip(values[0::2], values[1::2])
        return [np.float32(a) / np.float32(b) if b else np.float32(0) for a, b in pairs]
    if len(values) != n:
        raise ValueError(f"TIFF field {tag} of {len(values)} values, {n} expected")
    return [np.float32(v) for v in values]


def _ycbcr_tables(fields):
    """``tif_color.c`` ``TIFFYCbCrToRGBInit`` in float32 and int32, as the
    C code computes it: the tables indexed by the Y, Cb and Cr bytes (Y,
    Cr -> R, Cb -> B, Cr -> G and Cb -> G, the last two scaled by 2^16)
    from ``YCbCrCoefficients`` and ``ReferenceBlackWhite`` (their
    defaults: 0.299, 0.587, 0.114 and 0, 255, 128, 255, 128, 255)."""
    f32 = np.float32
    red, green, blue = _floats(fields, _LUMA, 3, (0.299, 0.587, 0.114))
    ref = _floats(fields, _REF_BLACK_WHITE, 6, (0, 255, 128, 255, 128, 255))
    if not abs(green) > 1e-7 or np.isnan([red, blue]).any():
        raise ValueError("TIFF YCbCrCoefficients that libtiff refuses")

    def fix(x):  # FIX(): the product in float, + 0.5 in double, truncated
        return int(float(f32(min(max(x, f32(0)), f32(2))) * f32(65536)) + 0.5)

    f1, f3 = f32(2) - f32(2) * red, f32(2) - f32(2) * blue
    d1, d2 = fix(f1), -fix(red * f1 / green)
    d3, d4 = fix(f3), -fix(blue * f3 / green)

    def code2v(c, black, white, top):  # Code2V() clamped to +-4096, truncated
        span = f32(white - black)
        step = (c - int(black)).astype(f32) * f32(top) / (span if span != 0 else f32(1))
        return np.clip(step, f32(-4096), f32(4096)).astype(np.int64)

    x = np.arange(-128, 128, dtype=np.int64)
    half = f32(128)
    cr = code2v(x, ref[4] - half, ref[5] - half, 127)
    cb = code2v(x, ref[2] - half, ref[3] - half, 127)
    luma = code2v(x + 128, ref[0], ref[1], 255)
    return luma, (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr, d4 * cb + 32768


def _ycbcr_rgb(ycc: np.ndarray, fields) -> np.ndarray:
    """YCbCr samples -> RGB by ``TIFFYCbCrtoRGB``, which libtiff's RGBA
    interface applies for both routes."""
    luma, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(fields)
    y = luma[ycc[:, :, 0]]
    cb, cr = ycc[:, :, 1], ycc[:, :, 2]
    out = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], axis=2)
    return np.clip(out, 0, 255).astype(np.uint8)


def _pil_raw(data: bytes, fields, width: int, height: int, bands: int, what: str
             ) -> np.ndarray:
    """PIL's raw decoder over the strips or tiles of an uncompressed page
    whose raw mode is a byte a sample (or ``RGBX``): 4 bytes a pixel from
    each chunky strip's or tile's offset on, the first three kept; a planar
    page's layer k read at a byte a pixel as band k of ``bands``. It fails
    ("image file is truncated") where that runs past the end of the file.
    A tile that reaches past the page's right edge is read with rows
    ``tile width * (sum of BitsPerSample) / 8`` bytes apart (divided by the
    sample count when planar), which fails where a row's bytes are more
    than that; every other strip or tile with rows packed at its width.
    ``ImageFile.load`` decodes them in the order of their offsets, one
    covering the whole page from its last offset only."""
    planar = _one(fields, _PLANAR, 1)
    if _TILE_WIDTH in fields:
        w, h = _one(fields, _TILE_WIDTH), _one(fields, _TILE_LENGTH)
        offsets = list(fields.get(_TILE_OFFSETS, ()))
    else:
        w, h = width, _one(fields, _ROWS_PER_STRIP, height)
        offsets = list(fields.get(_STRIP_OFFSETS, ()))
    if w == width and h == height and planar != 2:
        offsets = offsets[-1:]
    line = w * sum(int(b) for b in fields.get(_BITS, (8, 8, 8))) // 8
    tiles, x, y, layer = [], 0, 0, 0
    for offset in offsets:
        stride = line if x + w > width else 0
        if planar == 2:
            stride //= len(fields.get(_BITS, (8, 8, 8)))
        tiles.append((offset, x, y, min(x + w, width), min(y + h, height), layer, stride))
        x += w
        if x >= width:
            x, y = 0, y + h
            if y >= height:
                y, layer = 0, layer + 1
    tiles.sort(key=lambda t: t[0])
    out = np.zeros((height, width, bands), np.uint8)
    for offset, x0, y0, x1, y1, layer, stride in tiles:
        if planar == 2 and layer >= bands:
            continue
        px = 4 if planar != 2 else 1
        row = (x1 - x0) * px
        step = stride or row
        if step < row:
            raise ValueError(f"{what}: PIL reads a tile past the right edge with rows "
                             f"{step} bytes apart, under their {row} (decoder error)")
        n = (y1 - y0 - 1) * step + row
        if offset + n > len(data):
            raise ValueError(f"{what}: PIL reads it at {px} byte{'s' * (px > 1)} a pixel "
                             "past the end of the file (image file is truncated)")
        rows = np.lib.stride_tricks.as_strided(
            np.frombuffer(data, np.uint8, n, offset), (y1 - y0, row), (step, 1))
        rows = rows.reshape(y1 - y0, x1 - x0, px)
        if planar != 2:
            out[y0:y1, x0:x1] = rows[:, :, :3]
        else:
            out[y0:y1, x0:x1, layer] = rows[:, :, 0]
    return out


def _pil_planar16(data: bytes, fields, width: int, height: int) -> np.ndarray:
    """PIL's reading of uncompressed 16-bit samples in planes: each plane's
    raw mode is one letter of the chunky raw mode (``"RGB;16L"[k]``), so
    its bytes are read as 8-bit samples (:func:`_pil_raw`), a byte a pixel,
    and the page converts as an 8-bit one. Gray planes have no such raw
    mode, and PIL cannot identify gray with alpha at 16 bits."""
    photometric, spp = _one(fields, _PHOTOMETRIC, 1), _one(fields, _SAMPLES, 1)
    extra = int(fields.get(_EXTRA, (0,))[0]) if spp > _BASE[photometric] else 0
    if photometric not in (2, 5) or extra == 1:
        raise ValueError(f"uncompressed 16-bit {_PHOTOMETRICS.get(photometric, '')} TIFF in "
                         "planes: PIL has no raw mode for it, or cannot identify it")
    return _pil_raw(data, fields, width, height, spp, "uncompressed 16-bit TIFF in planes")


def _jpeg_chunk(raw: bytes, fields, cw: int, cr: int, spp: int) -> np.ndarray:
    tables = fields.get(_JPEG_TABLES, (b"",))[0]
    if tables[:2] == b"\xff\xd8" and tables[-2:] == b"\xff\xd9" and raw[:2] == b"\xff\xd8":
        raw = tables[:-2] + raw[2:]
    photometric = _one(fields, _PHOTOMETRIC)
    samples = jpeg._decode_samples(raw, ycc=photometric == 6)
    if samples.shape[2] != spp:
        raise ValueError(f"JPEG TIFF strip of {samples.shape[2]} components, its page {spp}")
    out = np.zeros((cr, cw, spp), np.uint8)
    h, w = min(cr, samples.shape[0]), min(cw, samples.shape[1])
    out[:h, :w] = samples[:h, :w]
    return out


def _samples(data: bytes, route: str = "pil"):
    """The page's (H, W, samples) array (uint8, or uint16 at 16 bits) and
    its fields, its uncompressed tiles read by ``route``'s rule."""
    end, fields = _ifd(data)
    width, height = _one(fields, _WIDTH), _one(fields, _HEIGHT)
    if width <= 0 or height <= 0:
        raise ValueError(f"bad TIFF size {width}x{height}")
    compression = _one(fields, _COMPRESSION, 1)
    if compression not in _READ:
        name = _COMPRESSIONS.get(compression, f"code {compression}")
        raise ValueError(f"TIFF compression {name} ({compression}) is not read; "
                         f"this reader takes {READS}")
    photometric = _one(fields, _PHOTOMETRIC, 1 if compression in (3, 4) else None)
    if photometric not in _BASE:
        name = _PHOTOMETRICS.get(photometric, f"code {photometric}")
        raise ValueError(f"TIFF photometric {name} ({photometric}) is not read")
    spp = _one(fields, _SAMPLES, 1)
    bits_all = fields.get(_BITS, (1,))
    if len(set(bits_all)) != 1:
        raise ValueError(f"TIFF samples of different sizes {bits_all} are not read")
    bits = int(bits_all[0])
    if bits not in (1, 2, 4, 8, 16):
        raise ValueError(f"TIFF at {bits} bits a sample is not read")
    if any(int(f) != 1 for f in fields.get(_SAMPLE_FORMAT, (1,))):
        raise ValueError(f"TIFF sample format {fields[_SAMPLE_FORMAT]} is not read "
                         "(unsigned integers only)")
    if spp < _BASE[photometric]:
        raise ValueError(f"TIFF {_PHOTOMETRICS[photometric]} with {spp} samples a pixel")
    if photometric in (2, 5, 6, 8) and bits < 8:
        raise ValueError(f"{_PHOTOMETRICS[photometric]} TIFF at {bits} bits is not read")
    if photometric == 5 and _one(fields, _INK_SET, 1) != 1:
        raise ValueError("separated TIFF with an ink set other than CMYK is not read")
    if compression == 7 and bits != 8:
        raise ValueError(f"JPEG TIFF at {bits} bits is not read")
    planar = _one(fields, _PLANAR, 1)
    if planar not in (1, 2) or (planar == 2 and compression == 7):
        raise ValueError(f"TIFF PlanarConfiguration {planar} is not read here")
    sub = (1, 1)
    if photometric == 6 and compression != 7:
        sub = _ycbcr_layout(fields, bits, spp, planar)
    tiled = _TILE_WIDTH in fields
    if tiled:
        cw, ch = _one(fields, _TILE_WIDTH), _one(fields, _TILE_LENGTH)
        offsets, counts = fields.get(_TILE_OFFSETS), fields.get(_TILE_COUNTS)
        across, down = -(-width // cw), -(-height // ch)
    else:
        cw, ch = width, min(_one(fields, _ROWS_PER_STRIP, 2 ** 32 - 1), height)
        offsets, counts = fields.get(_STRIP_OFFSETS), fields.get(_STRIP_COUNTS)
        across, down = 1, -(-height // ch)
    if cw <= 0 or ch <= 0:
        raise ValueError("bad TIFF strip or tile size")
    planes, chunk_spp = (spp, 1) if planar == 2 else (1, spp)
    n = across * down * planes
    if offsets is None or counts is None or len(offsets) < n or len(counts) < n:
        raise ValueError(f"TIFF with fewer strip or tile offsets and byte counts than its "
                         f"{n} strips or tiles")
    dtype = np.uint16 if bits == 16 else np.uint8
    image = np.zeros((height, width, spp), dtype)
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                y0, x0 = ty * ch, tx * cw
                rows = ch if tiled else min(ch, height - y0)
                chunk = _chunk(data, fields, compression, (p * down + ty) * across + tx,
                               offsets, counts, cw, rows, chunk_spp, bits, end, sub,
                               min(cw, width - x0), cv2_tile=tiled and route == "cv2")
                h, w = min(rows, height - y0), min(cw, width - x0)
                if (route == "cv2" and tiled and photometric in (0, 1) and w < cw
                        and planes == 1 and chunk.itemsize * chunk_spp > 1):
                    chunk = _cv2_gray_skew(chunk, w, h)
                sl = slice(p, p + 1) if planar == 2 else slice(None)
                image[y0:y0 + h, x0:x0 + w, sl] = chunk[:h, :w]
    return image, fields, bits, photometric


def _cv2_gray_skew(chunk: np.ndarray, w: int, h: int) -> np.ndarray:
    """A gray tile of 16-bit samples, or with extra samples, clipped at the
    page's right edge, as libtiff's ``put16bitbwtile``/``putagreytile``
    reads it for cv2: after each row of ``w`` pixels it skips ``cw - w``
    bytes, not pixels, so row k starts ``k * (size * spp * w + cw - w)``
    bytes into the tile (the rows below the first read the wrong
    samples)."""
    cr, cw, spp = chunk.shape
    item = chunk.dtype.newbyteorder("<")
    buf = chunk.astype(item).tobytes()
    out = chunk.copy()
    for k in range(1, h):
        start = k * (chunk.itemsize * spp * w + cw - w)
        out[k, :w] = np.frombuffer(buf, item, w * spp, start).reshape(w, spp)
    return out


def _ycbcr_layout(fields, bits: int, spp: int, planar: int):
    """The (h, v) subsampling of a YCbCr page outside JPEG, where libtiff's
    RGBA interface reads it: 8 bits, 3 samples, chunky at 1x1, 1x2, 2x1,
    2x2, 4x1, 4x2 or 4x4 (``YCbCrSubsampling``, default 2x2), planar at
    1x1 only."""
    if bits != 8 or spp != 3:
        raise ValueError(f"YCbCr TIFF of {spp} samples at {bits} bits is not read "
                         "(libtiff reads 3 at 8)")
    if _one(fields, _FILL_ORDER, 1) != 1:
        raise ValueError("YCbCr TIFF with FillOrder 2 is not read")
    sub = tuple(int(v) for v in fields.get(_SUBSAMPLING, (2, 2))[:2])
    allowed = ((1, 1),) if planar == 2 else ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2),
                                              (4, 4))
    if sub not in allowed:
        raise ValueError(f"YCbCr TIFF subsampled {sub[0]}x{sub[1]}"
                         f"{' in planes' if planar == 2 else ''} is not read (libtiff "
                         "reads 1x1, 1x2, 2x1, 2x2, 4x1, 4x2 and 4x4, planes at 1x1)")
    return sub


def _gray8(v: np.ndarray, bits: int, route: str) -> np.ndarray:
    if bits == 16:
        return np.minimum(v, 255).astype(np.uint8) if route == "pil" else (v >> 8).astype(np.uint8)
    return (v.astype(np.int32) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def _eight(v: np.ndarray, bits: int, route: str) -> np.ndarray:
    """Colour samples to 8 bits: PIL keeps the high byte of a 16-bit one,
    libtiff's RGBA interface (cv2) rounds ``v * 255 / 65535``."""
    if bits != 16:
        return v.astype(np.uint8)
    if route == "pil":
        return (v >> 8).astype(np.uint8)
    return ((v.astype(np.int64) * 255 + 32767) // 65535).astype(np.uint8)


def _lab_rgb(image: np.ndarray, fields, bits: int, route: str) -> np.ndarray:
    """CIE L*a*b*: PIL reads 3 8-bit samples (any layout) and converts them
    through LittleCMS, whose a* and b* are offset by 128: PIL's chunky
    ``LAB`` unpacker flips 0x80 of the file's signed bytes, its planar
    bands copy them as they are. cv2 reads 3 chunky 8- or 16-bit samples
    through libtiff's RGBA interface, against the ``WhitePoint`` tag."""
    spp = image.shape[2]
    if _one(fields, _COMPRESSION, 1) == 7:
        raise ValueError("JPEG-compressed CIE L*a*b* TIFF is not read")
    if route == "pil" and (spp != 3 or bits != 8):
        raise ValueError(f"CIE L*a*b* TIFF of {spp} samples at {bits} bits: PIL reads 3 at 8")
    if route == "cv2":
        if spp != 3 or bits not in (8, 16):
            raise ValueError(f"CIE L*a*b* TIFF of {spp} samples at {bits} bits: libtiff's RGBA "
                             "interface (cv2) reads 3 at 8 or 16")
        if _one(fields, _PLANAR, 1) != 1:
            raise ValueError("CIE L*a*b* TIFF in planes: libtiff's RGBA interface (cv2) "
                             "refuses it")
        white = cielab.D50_WHITE_POINT
        if _WHITE_POINT in fields:
            v = np.asarray(fields[_WHITE_POINT][:4], np.float32)
            if v.size < 4:
                raise ValueError("CIE L*a*b* TIFF with a short WhitePoint")
            white = tuple(np.float32(0) if d == 0 else n / d
                          for n, d in ((v[0], v[1]), (v[2], v[3])))
        return cielab.libtiff_rgb(image, bits, white)
    if _one(fields, _PLANAR, 1) == 1:
        image = image ^ np.array([0, 0x80, 0x80], np.uint8)
    return cielab.lcms_rgb(image)


def _rgb(image: np.ndarray, fields, bits: int, photometric: int, route: str) -> np.ndarray:
    spp = image.shape[2]
    if photometric == 8:
        return _lab_rgb(image, fields, bits, route)
    extra = int(fields.get(_EXTRA, (0,))[0]) if spp > _BASE[photometric] else 0
    if route == "cv2" and (bits == 2 or (bits == 4 and photometric != 3)):
        raise ValueError(f"{_PHOTOMETRICS[photometric]} TIFF at {bits} bits: cv2 reads "
                         "1, 8 and 16 bits (4 in a palette) only")
    if route == "pil" and photometric in (0, 1) and spp > 1:
        if not (photometric == 1 and bits == 8 and spp == 2 and extra == 2):
            raise ValueError(f"{_PHOTOMETRICS[photometric]} TIFF of {spp} samples at {bits} "
                             "bits: PIL reads gray with extra samples only as 8-bit "
                             "min-is-black with unassociated alpha (LA)")
        if _one(fields, _PLANAR, 1) == 2 and _one(fields, _COMPRESSION, 1) == 1:
            raise ValueError("uncompressed LA TIFF in planes: PIL has no raw mode for it")
    if (route == "cv2" and photometric in (0, 1) and spp > 1 and bits in (8, 16)
            and _one(fields, _PLANAR, 1) == 2):
        # libtiff's RGBA interface reads gray planes as RGB (gtTileSeparate,
        # putRGB*separate*): no min-is-white inversion, 16 bits rounded to 8,
        # unassociated alpha premultiplied
        g = _eight(image[:, :, 0], bits, route).astype(np.int32)
        if extra == 2:
            g = (g * _eight(image[:, :, 1], bits, route).astype(np.int32) + 127) // 255
        return np.repeat(g.astype(np.uint8)[:, :, None], 3, axis=2)
    if extra == 1 and (photometric != 2 or bits != 8) and not (
            route == "cv2" and photometric in (0, 1)):  # libtiff's gray ignores alpha
        raise ValueError("TIFF with associated alpha is read in 8-bit RGB only")
    if photometric in (0, 1):
        g = _gray8(image[:, :, 0], bits, route)
        if photometric == 0 and not (bits == 16 and route == "pil"):  # PIL: I;16 as it is
            g = 255 - g
        return np.repeat(g[:, :, None], 3, axis=2)
    if photometric == 3:
        if bits == 16:
            raise ValueError("16-bit palette TIFF is not read")
        cmap = np.asarray(fields.get(_COLORMAP, ()), np.int64)
        if cmap.size != 3 << bits:
            raise ValueError(f"TIFF colormap of {cmap.size} entries for {bits}-bit indices")
        cmap = cmap.reshape(3, -1).T
        if route == "pil" or (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap.astype(np.uint8)[image[:, :, 0]]
    if photometric == 5:
        if bits == 16 and route == "cv2":
            raise ValueError("16-bit CMYK TIFF: libtiff's RGBA interface (cv2) fails on one")
        x = (image[:, :, :4] >> 8 if bits == 16 else image[:, :, :4]).astype(np.int32)
        nk = 255 - x[:, :, 3:]
        t = x[:, :, :3] * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    rgb = _eight(image[:, :, :3], bits, route)
    if extra == 2 and route == "cv2":  # libtiff premultiplies unassociated alpha
        a = _eight(image[:, :, 3:4], bits, route).astype(np.int32)
        rgb = ((rgb.astype(np.int32) * a + 127) // 255).astype(np.uint8)
    elif extra == 1 and route == "pil":  # PIL's RGBa -> RGB divides it out
        a = image[:, :, 3:4].astype(np.int32)
        keep = (a == 0) | (a == 255)
        rgb = np.where(keep, rgb, np.minimum(255, 255 * rgb.astype(np.int32)
                                             // np.maximum(a, 1))).astype(np.uint8)
    return np.ascontiguousarray(rgb)


def decode_tiff(data: bytes, route: str = "pil") -> np.ndarray:
    """TIFF bytes -> (H, W, 3) uint8 RGB of the first page, equal to PIL's
    ``convert("RGB")`` (``route="pil"``) or to ``cv2.imdecode(...,
    IMREAD_COLOR)`` with its channels flipped (``route="cv2"``)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    data = bytes(data)
    _, fields = _ifd(data)
    if (route == "pil" and _one(fields, _PHOTOMETRIC, 1) == 6
            and _one(fields, _COMPRESSION, 1) == 1):
        _samples(data)  # what the port refuses, it refuses on both routes
        rgb = _pil_raw(data, fields, _one(fields, _WIDTH), _one(fields, _HEIGHT), 3,
                       "uncompressed YCbCr TIFF")
    elif (route == "pil" and _one(fields, _COMPRESSION, 1) == 1 and _one(fields, _PLANAR, 1) == 2
          and max(fields.get(_BITS, (1,))) == 16):
        image, fields, _, photometric = _samples(data)
        raw = _pil_planar16(data, fields, image.shape[1], image.shape[0])
        rgb = _rgb(raw, fields, 8, photometric, route)
    else:
        image, fields, bits, photometric = _samples(data, route)
        if photometric == 6 and _one(fields, _COMPRESSION, 1) != 7:
            rgb = _ycbcr_rgb(image, fields)
        else:
            rgb = _rgb(image, fields, bits, photometric, route)
    return jpeg._orient(rgb, _one(fields, _ORIENTATION, 1))

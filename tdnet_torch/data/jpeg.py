"""JPEG decoding in Python and numpy, equal byte for byte to the two
decoders the reference reads pages with. Both link libjpeg-turbo 3.1 and
decode with its defaults (the ISLOW inverse DCT, fancy upsampling), so
this module mirrors that library:

- files (``tdnet/data/image.py``): PIL's ``Image.open(path).convert("RGB")``,
  which ignores EXIF orientation (``route="pil"``);
- serve bodies (``tdnet/bin/serve.py``): ``cv2.imdecode(buf,
  cv2.IMREAD_COLOR)``, which turns the page by its EXIF orientation 1-8
  (``route="cv2"``).

Reads baseline and extended sequential and progressive Huffman frames
(SOF0, SOF1, SOF2) and their arithmetic-coded forms (SOF9, SOF10, with DAC
conditioning tables) at 8 bits with one, three or four components and any
sampling factors libjpeg accepts (1 to 4; each component's factors must
divide the largest), interleaved or not, 8- or 16-bit quantisation tables,
restart intervals, and the Annex K Huffman tables where a file defines
none (Motion JPEG); and lossless frames (SOF3: predictors 1 to 7, a point
transform, any sampling factors, each component upsampled by replication,
as libjpeg-turbo does without a DCT), which libjpeg-turbo 3 decodes
without colour conversion: gray, RGB or CMYK, never YCbCr (three
components without a JFIF or Adobe marker are RGB, whatever their ids).
Lossless frames of 2 to 7 bits come out of libjpeg-turbo unscaled: cv2
reads them so, PIL cannot handle the layers. Hierarchical frames, lossless
arithmetic coding (SOF11), lossy frames of other than 8 bits, lossless
ones past 8 bits and DNL raise, as does a file that ends before its EOI
marker (both reference routes fail on each).

Arithmetic decoding is ``jdarith.c``: the Qe state machine of T.81 Table
D.2, the DC and AC statistics bins with their conditioning, a Python loop
over binary decisions. PIL hands libjpeg the file's first 65536 bytes,
and libjpeg's arithmetic decoder cannot wait for more: the pil route
raises where the decoder would read past them, as PIL fails there
(cv2 reads the whole buffer). A lossless scan's differences are
Huffman-decoded and undifferenced row by row as ``jdpred.c`` does; cv2
asks libjpeg for BGR, which lossless mode does not convert gray to, so
the cv2 route refuses gray lossless files.

The entropy decoding is serial: each Huffman symbol is found from the next
16 bits through a 65536-entry table (libjpeg's ``look_nbits``/``look_sym``
widened so that the coefficient's extra bits come with its code), read
from a list of 40-bit windows, one for each byte. A progressive frame's
scans (``jdphuff.c``: DC first and refinement, AC first with its EOB runs
and AC refinement) fill one coefficient buffer for the whole frame, and
where its scans leave some of the first nine AC coefficients unrefined,
libjpeg-turbo's block smoothing (``jdcoefct.c`` ``decompress_smooth_data``)
estimates them from the DC values of the 5x5 blocks around each block.
Everything after the entropy decoding runs in numpy over all the blocks of
a component: dequantisation and the ISLOW
inverse DCT as libjpeg-turbo's x86-64 SIMD code computes them (the
``jidctint.c`` arithmetic, CONST_BITS 13 and PASS1_BITS 2, in 16-bit
lanes: products and some sums wrap, each pass saturates, and the output is
saturated to 0..255 where the C code's range-limit table would wrap; the
two differ only on coefficients no real image has), the upsampling
of ``jdsample.c`` as ``jinit_upsampler`` chooses it (fancy h2v1, h1v2 and
h2v2: its edges repeat the first and last sample, and only the
component's ``downsampled_width`` samples count; other integral ratios,
such as 4:1:1, by replication) and the YCbCr -> RGB tables of
``jdcolor.c``. The colour space is guessed as
``jdapimin.c`` does: JFIF means YCbCr, an Adobe marker's transform 0 means
RGB, component ids 'R', 'G', 'B' mean RGB; four components are CMYK, or
YCCK where an Adobe marker's transform is not 0. A single component is
repeated into three channels, as both routes do. Four components come out
of libjpeg as (inverted, Adobe-style) CMYK, and each route turns them into
RGB by its own rule: PIL reads them as ``CMYK;I`` and applies its
``convert("RGB")`` (``255 - k`` scaled by ``255 - c`` over 255, rounded),
cv2 applies ``k - ((255 - c) * k >> 8)`` to libjpeg's bytes. The two
differ by 1 on most samples.
"""

from __future__ import annotations

import functools
import re
import struct
from array import array
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["SIGNATURE", "READS", "ROUTES", "decode_jpeg", "jpeg_size",
           "exif_orientation"]

SIGNATURE = b"\xff\xd8\xff"
READS = ("baseline, extended sequential and progressive JPEG, Huffman or arithmetic, "
         "and lossless JPEG (8-bit, and 2- to 7-bit lossless by the cv2 route; gray, "
         "YCbCr, RGB, CMYK or YCCK; sampling factors up to 4)")
ROUTES = ("pil", "cv2")

# the next marker: fill bytes (0xFF) before it, its code not 0x00 (a
# stuffed data byte) and not 0xFF
# PIL's ImageFile.MAXBLOCK: the bytes of the file it hands libjpeg first
PIL_BLOCK = 65536

_MARKER = re.compile(rb"\xff+([^\x00\xff])")
# a stuffed 0xFF data byte in entropy-coded data (libjpeg drops any fill
# bytes before the 0x00)
_STUFFED = re.compile(rb"\xff+\x00")

_SOF_READ = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA)  # SOF2, 10: progressive; SOF3: lossless;
# SOF9, 10: arithmetic
_PROGRESSIVE = (0xC2, 0xCA)
_ARITHMETIC = (0xC9, 0xCA)
_SOF_UNSUPPORTED = {
    0xC5: "hierarchical JPEG (SOF5): libjpeg-turbo does not decode it",
    0xC6: "hierarchical JPEG (SOF6): libjpeg-turbo does not decode it",
    0xC7: "hierarchical JPEG (SOF7): libjpeg-turbo does not decode it",
    0xCB: "lossless arithmetic-coded JPEG (SOF11): libjpeg-turbo does not decode it",
    0xCD: "hierarchical arithmetic-coded JPEG (SOF13): libjpeg-turbo does not decode it",
    0xCE: "hierarchical arithmetic-coded JPEG (SOF14): libjpeg-turbo does not decode it",
    0xCF: "hierarchical arithmetic-coded JPEG (SOF15): libjpeg-turbo does not decode it",
}

# zigzag position -> natural (row-major) index
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.intp)


def _annex_k_ac(prefix: List[int]) -> bytes:
    """An Annex K AC symbol list: its irregular prefix, then every other
    (run, size) symbol in increasing order."""
    rest = [s for s in range(256) if (s & 15) and (s & 15) <= 10 and s not in prefix]
    return bytes(prefix + sorted(set(rest) | {0x00, 0xF0} - set(prefix)))


# Annex K tables, used where a scan names a table the file never defined
# (libjpeg-turbo's std_huff_tables): (class, id) -> (counts, symbols)
_STD_TABLES = {
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), _annex_k_ac([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
        0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
        0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
        0x82, 0x09, 0x0A, 0x16])),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _annex_k_ac([
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
        0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
        0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
        0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1])),
}

_BAD_CODE = 17  # libjpeg reads 17 bits for a code no table holds, then takes symbol 0


class _Huffman:
    """One Huffman table as 65536-entry lookups on the next 16 bits.

    DC: ``fast[i] = (bits, difference)`` where the code and its extra bits
    fit in 16; else ``(code length, None)`` and ``slow[i]`` is the size.
    AC: ``fast[i] = (bits, advance, value)``: ``advance`` is the zero run
    (16 for ZRL, 64 for EOB) and ``value`` the coefficient (0 for ZRL and
    EOB); ``(code length, run, None)`` where the extra bits do not fit,
    and ``slow[i]`` is then the size."""

    def __init__(self, counts: bytes, symbols: bytes, is_dc: bool, lossless: bool = False):
        length = np.full(65536, _BAD_CODE, np.int64)
        symbol = np.zeros(65536, np.int64)
        code, k = 0, 0
        for bits in range(1, 17):
            for _ in range(counts[bits - 1]):
                if code >= 1 << bits:
                    raise ValueError("bad Huffman table: its code space is over-subscribed")
                lo = code << (16 - bits)
                hi = (code + 1) << (16 - bits)
                length[lo:hi], symbol[lo:hi] = bits, symbols[k]
                code, k = code + 1, k + 1
            code <<= 1
        if is_dc and any(s > (16 if lossless else 15) for s in symbols):
            raise ValueError("bad Huffman table: a DC symbol above 15")
        bad = length == _BAD_CODE
        size = symbol if is_dc else symbol & 15  # a DC symbol is the size
        wide = (symbol == 16) & lossless  # lossless category 16: 32768, no extra bits
        size = np.where(wide, 0, size)
        total = length + size
        fits = (total <= 16) | bad
        idx = np.arange(65536, dtype=np.int64)
        extra = (idx >> np.maximum(16 - total, 0)) & ((1 << size) - 1)
        value = np.where(bad, 0, np.where(wide, 32768, _extend(extra, size)))
        n = np.where(bad, _BAD_CODE, np.where(fits, total, length)).tolist()
        v, f = value.tolist(), fits.tolist()
        self.slow = {i: int(size[i]) for i in np.flatnonzero(~fits).tolist()}
        if is_dc:
            self.fast = [(a, b) if c else (a, None) for a, b, c in zip(n, v, f)]
            return
        # size 0: ZRL (run 15) skips 16 zeros; any other run ends the block
        run = symbol >> 4
        advance = np.where(bad | ((size == 0) & (run != 15)), 64,
                           np.where(size == 0, 16, run)).tolist()
        self.fast = [(a, r, b) if c else (a, r, None) for a, r, b, c in zip(n, advance, v, f)]
        self._length, self._symbol = length, symbol

    @functools.cached_property
    def raw(self):
        """AC: ``raw[i] = (code length, run, size)`` of the code that the
        next 16 bits ``i`` start with, for the progressive scans, whose
        EOB runs and refinement bits the fast table does not carry."""
        s = self._symbol
        return list(zip(self._length.tolist(), (s >> 4).tolist(), (s & 15).tolist()))


def _extend(x, s):
    """libjpeg's HUFF_EXTEND: s extra bits x -> the signed value."""
    x = np.asarray(x, np.int64)
    s = np.asarray(s, np.int64)
    neg = (s > 0) & (x < (np.int64(1) << np.maximum(s - 1, 0)))
    return np.where(neg, x - (np.int64(1) << s) + 1, np.where(s > 0, x, 0))


@functools.lru_cache(maxsize=32)
def _huffman(counts: bytes, symbols: bytes, is_dc: bool, lossless: bool = False) -> _Huffman:
    """Tables are cached by content (most files of one encoder share them);
    a table is never changed once built."""
    return _Huffman(counts, symbols, is_dc, lossless)


_STRIDE = 80  # a block's slots: 64, and room for a run past the last (k <= 78)


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant: Optional[np.ndarray] = None  # latched at its first scan
        # progressive: the Al of the last scan that sent each coefficient
        # (zigzag order), -1 for one no scan has sent (libjpeg's coef_bits)
        self.coef_bits = [-1] * 64


class _Frame:
    """SOF geometry, as libjpeg's ``initial_setup`` lays it out."""

    def __init__(self, width: int, height: int, comps: List[_Component],
                 progressive: bool = False, arithmetic: bool = False, lossless: bool = False):
        self.width, self.height, self.comps = width, height, comps
        self.progressive, self.arithmetic, self.lossless = progressive, arithmetic, lossless
        self.read_end = 0  # arithmetic: the furthest file offset its decoder read
        self.precision = 8
        self.max_h = max(c.h for c in comps)
        self.max_v = max(c.v for c in comps)
        self.mcus_x = -(-width // (8 * self.max_h))
        self.mcus_y = -(-height // (8 * self.max_v))
        offset = 0
        for c in comps:
            c.width_blocks = -(-width * c.h // (8 * self.max_h))
            c.height_blocks = -(-height * c.v // (8 * self.max_v))
            c.ds_width = -(-width * c.h // self.max_h)
            c.ds_height = -(-height * c.v // self.max_v)
            c.cols, c.rows = self.mcus_x * c.h, self.mcus_y * c.v  # the padded grid
            c.offset = offset
            offset += c.rows * c.cols * _STRIDE
        # coefficients of every block, zigzag order, _STRIDE slots a block
        self.coefs = array("h", bytes(2 * offset))


class _Reader:
    """Walks the markers of a JPEG stream."""

    def __init__(self, data: bytes):
        if not data.startswith(b"\xff\xd8"):
            raise ValueError(f"not a JPEG file; this reader takes {READS}")
        self.data, self.pos = data, 2

    def next_marker(self) -> int:
        m = _MARKER.search(self.data, self.pos)
        if m is None:
            raise ValueError("truncated JPEG: the file ends before its EOI marker")
        self.pos = m.end()
        return m.group(1)[0]

    def segment(self) -> bytes:
        data, pos = self.data, self.pos
        if pos + 2 > len(data):
            raise ValueError("truncated JPEG marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        if length < 2 or pos + length > len(data):
            raise ValueError("truncated JPEG marker segment")
        self.pos = pos + length
        return data[pos + 2:pos + length]


def _header(data: bytes, stop_at_frame: bool):
    """Markers up to any frame header (``stop_at_frame``) or through the
    whole stream: yields each (marker, segment body); a scan's is
    (reader, scan header), the reader left at the scan's data."""
    reader = _Reader(data)
    while True:
        marker = reader.next_marker()
        if marker == 0xD9:
            yield marker, b""
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue  # standalone markers
        if marker == 0xDA:
            yield marker, (reader, reader.segment())
            continue
        body = reader.segment()
        yield marker, body
        if stop_at_frame and (marker in _SOF_READ or marker in _SOF_UNSUPPORTED):
            return


def _check_frame_marker(marker: int) -> None:
    if marker in _SOF_UNSUPPORTED:
        raise ValueError(_SOF_UNSUPPORTED[marker])
    if marker == 0xDC:
        raise ValueError("JPEG with a DNL marker (height 0 in its frame) is not read")


def _parse_frame(body: bytes, progressive: bool = False, arithmetic: bool = False,
                 lossless: bool = False) -> _Frame:
    if len(body) < 6:
        raise ValueError("bad JPEG frame header")
    precision, height, width, n = struct.unpack(">BHHB", body[:6])
    if precision != 8 and not (lossless and 2 <= precision < 8):
        raise ValueError(f"{precision}-bit JPEG: both references refuse it (PIL cannot handle "
                         "its layers, and cv2 reads 8-bit samples only)")
    if height == 0:
        raise ValueError("JPEG with a DNL marker (height 0 in its frame) is not read")
    if width == 0:
        raise ValueError("bad JPEG frame: width 0")
    if n not in (1, 3, 4) or len(body) < 6 + 3 * n:
        raise ValueError(f"JPEG with {n} components is not read; this reader takes 1, 3 or 4")
    comps = []
    for i in range(n):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4):
            raise ValueError(f"bad JPEG sampling factors {h}x{v}: libjpeg takes 1 to 4")
        if tq > 3:
            raise ValueError(f"bad JPEG quantisation table id {tq}")
        comps.append(_Component(cid, h, v, tq))
    frame = _Frame(width, height, comps, progressive, arithmetic, lossless)
    frame.precision = precision
    if lossless:  # each component's own samples (jdinput.c's width_in_blocks)
        for c in comps:
            c.samples = np.zeros((-(-height * c.v // frame.max_v), -(-width * c.h // frame.max_h)),
                                 np.uint8)
    for c in comps:
        if frame.max_h % c.h or frame.max_v % c.v:
            raise ValueError(f"JPEG sampling factors {c.h}x{c.v} against {frame.max_h}x"
                             f"{frame.max_v} are not read: libjpeg upsamples only by "
                             "whole ratios")
    return frame


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(width, height) from the frame header of any JPEG process, as PIL's
    ``.size`` (EXIF orientation is not applied; PIL opens 8-bit frames
    only)."""
    for marker, body in _header(data, stop_at_frame=True):
        if (marker in _SOF_READ or marker in _SOF_UNSUPPORTED) and len(body) >= 5:
            precision, height, width = struct.unpack(">BHH", body[:5])
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG: PIL cannot handle its layers")
            return width, height
        if marker in (0xD9, 0xDA):
            break
    raise ValueError("JPEG without a frame header")


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (tag 0x0112 of IFD0) of the first APP1 Exif
    segment before the first scan, as OpenCV reads it; 1 where there is
    none or it is out of range."""
    for marker, body in _header(data, stop_at_frame=False):
        if marker in (0xD9, 0xDA):
            break
        if marker == 0xE1 and body.startswith(b"Exif\x00\x00"):
            return _tiff_orientation(body[6:])
    return 1


# OpenCV's ExifReader parses these IFD0 tags before it looks for the
# orientation; a value they point past the data at ends the parse
_EXIF_STRINGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298)
_EXIF_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3, 0x0214: 6}
_EXIF_SHORTS = (0x0112, 0x0128, 0x0213)


def _tiff_orientation(tiff: bytes) -> int:
    """OpenCV's ``ExifReader`` on a TIFF header and IFD0: little-endian only
    after ``II`` (anything else reads big-endian), the mark 42, then each
    entry in turn, a read past the data ending the parse; the first entry
    with tag 0x0112 gives the 16 bits at its value field, whatever its
    type. 1 where there is none or it is out of 1-8."""
    end = "<" if tiff[:2] == b"II" else ">"
    n = len(tiff)

    def u16(o):
        if o + 1 >= n:
            raise IndexError
        return struct.unpack_from(end + "H", tiff, o)[0]

    def u32(o):
        if o + 3 >= n:
            raise IndexError
        return struct.unpack_from(end + "I", tiff, o)[0]

    orientation = None
    try:
        if u16(2) != 0x2A:
            return 1
        ifd = u32(4)
        for i in range(u16(ifd)):
            entry = ifd + 2 + 12 * i
            tag = u16(entry)
            if tag in _EXIF_STRINGS:
                size = u32(entry + 4)
                at = u32(entry + 8) if size > 4 else 8
                if at + size > n:
                    raise IndexError
            elif tag in _EXIF_RATIONALS:
                at = u32(entry + 8)
                for k in range(2 * _EXIF_RATIONALS[tag]):
                    u32(at + 4 * k)
            elif tag in _EXIF_SHORTS:
                value = u16(entry + 8)
                if tag == 0x0112 and orientation is None:
                    orientation = value
    except IndexError:
        pass
    return orientation if orientation is not None and 1 <= orientation <= 8 else 1


def _quant_tables(body: bytes, tables: Dict[int, np.ndarray]) -> None:
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        size = 128 if pq else 64
        if tq > 3 or pq > 1 or pos + 1 + size > len(body):
            raise ValueError("bad JPEG quantisation table")
        raw = np.frombuffer(body[pos + 1:pos + 1 + size], ">u2" if pq else np.uint8)
        table = np.empty(64, np.int64)
        table[_NATURAL] = raw
        tables[tq] = table
        pos += 1 + size


def _huffman_tables(body: bytes, tables: Dict[Tuple[int, int], _Huffman]) -> None:
    pos = 0
    while pos < len(body):
        tc, th = body[pos] >> 4, body[pos] & 15
        counts = body[pos + 1:pos + 17]
        n = sum(counts)
        symbols = body[pos + 17:pos + 17 + n]
        if tc > 1 or th > 3 or len(counts) != 16 or len(symbols) != n or n > 256:
            raise ValueError("bad JPEG Huffman table")
        if tc == 0 and max(symbols, default=0) == 16:
            tables[(tc, th)] = None  # category 16: a lossless table only
        else:
            tables[(tc, th)] = _huffman(bytes(counts), bytes(symbols), tc == 0)
        tables[("raw", tc, th)] = (bytes(counts), bytes(symbols))
        pos += 17 + n


def _windows(data: bytes) -> List[int]:
    """40-bit big-endian windows, one starting at each byte of ``data``
    but the last four."""
    b = np.frombuffer(data, np.uint8).astype(np.int64)
    n = len(data) - 4
    w = (b[:n] << 32) | (b[1:n + 1] << 24) | (b[2:n + 2] << 16) | (b[3:n + 3] << 8) | b[4:n + 4]
    return w.tolist()


# zero bytes after each interval's data: libjpeg feeds zero bits to an MCU
# that runs past the end of its data. An MCU that reads past this gap is
# decoded again with _LONG_GAP, which one MCU cannot cross (10 blocks of 64
# symbols of at most 31 bits).
_GAP = 64
_LONG_GAP = 2560


def _decode_interval(W: List[int], pos: int, end: int, blocks, coefs) -> int:
    """Entropy-decode one restart interval (or a scan without restarts)
    whose bits are ``[pos, end)`` of the windows ``W``; returns the bit
    position it stopped at.

    ``blocks`` lists (slot, DC table, AC table, component, ends an MCU) in
    decoding order. Where the data runs out, the MCU in progress reads zero
    bits and the rest of the interval stays zero, as in libjpeg."""
    mask = 0xFFFFFFFF
    preds = [0, 0, 0, 0]
    for base, dc, ac, ci, last in blocks:
        x = (W[pos >> 3] >> (8 - (pos & 7))) & mask
        n, v = dc.fast[x >> 16]
        if v is None:
            s = dc.slow[x >> 16]
            e = (x >> (32 - n - s)) & ((1 << s) - 1)
            v = e if e >> (s - 1) else e - (1 << s) + 1
            n += s
        pos += n
        p = preds[ci] + v
        preds[ci] = p
        coefs[base] = ((p + 32768) & 0xFFFF) - 32768  # JCOEF is 16 bits
        k = 1
        fast, slow = ac.fast, ac.slow
        while k < 64:
            x = (W[pos >> 3] >> (8 - (pos & 7))) & mask
            n, r, v = fast[x >> 16]
            if v is None:
                s = slow[x >> 16]
                e = (x >> (32 - n - s)) & ((1 << s) - 1)
                v = e if e >> (s - 1) else e - (1 << s) + 1
                n += s
            pos += n
            k += r
            if v:
                coefs[base + k] = v
                k += 1
        if pos > end and last:
            break
    return pos


def _decode_segments(segments: List[bytes], intervals, coefs) -> None:
    """Decode each interval from its un-stuffed segment. The segments share
    one window list, each followed by _GAP zero bytes; an interval that
    reads past its gap is zeroed and decoded again from its own data and
    _LONG_GAP zeros."""
    pad = bytes(_GAP)
    W = _windows(pad.join(segments) + pad + bytes(4))
    start = 0
    for segment, blocks in zip(segments, intervals):
        end = start + 8 * len(segment)
        try:
            stop = _decode_interval(W, start, end, blocks, coefs)
        except IndexError:
            stop = None
        if stop is None or stop > end + 8 * _GAP:
            view = np.frombuffer(coefs, np.int16)
            for block in blocks:
                view[block[0]:block[0] + _STRIDE] = 0
            _decode_interval(_windows(segment + bytes(_LONG_GAP + 4)), 0, 8 * len(segment),
                             blocks, coefs)
        start = end + 8 * _GAP


def _scan_header(body: bytes, frame: _Frame, huff, quant, tables_needed=(0, 1)):
    """The components of a scan (their quantisation tables latched at the
    first scan that names them), each one's (DC, AC) Huffman tables (None
    where the scan does not need that class) and (Ss, Se, Ah, Al)."""
    if len(body) < 1 or len(body) < 1 + 2 * body[0] + 3:
        raise ValueError("bad JPEG scan header")
    ns = body[0]
    by_id = {c.id: c for c in frame.comps}
    comps, tables = [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"JPEG scan names component {cid}, which the frame lacks")
        c = by_id[cid]
        pair = []
        for key in ((0, t >> 4), (1, t & 15)):
            if key[0] not in tables_needed:
                pair.append(None)
                continue
            if key in huff and huff[key] is None:
                raise ValueError("bad Huffman table: a DC symbol above 15")
            if key not in huff:
                if key not in _STD_TABLES:
                    raise ValueError(f"JPEG scan uses Huffman table {key}, which is undefined")
                huff[key] = _huffman(*_STD_TABLES[key], key[0] == 0)
            pair.append(huff[key])
        if c.quant is None:
            if c.tq not in quant:
                raise ValueError(f"JPEG component {cid} uses quantisation table {c.tq}, "
                                 "which is undefined")
            c.quant = quant[c.tq].copy()
        comps.append(c)
        tables.append(tuple(pair))
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    return comps, tables, (ss, se, a >> 4, a & 15)


def _scan_order(frame: _Frame, comps: List[_Component]):
    """Blocks of a scan in decoding order: their slots in the coefficient
    buffer, the blocks an MCU and each block's index into ``comps``. A
    scan of one component codes its real blocks only; an interleaved scan
    codes whole MCUs, dummy blocks included."""
    if len(comps) == 1:
        c = comps[0]
        by, bx = np.divmod(np.arange(c.height_blocks * c.width_blocks), c.width_blocks)
        return (c.offset + (by * c.cols + bx) * _STRIDE).tolist(), 1, [0]
    my, mx = np.divmod(np.arange(frame.mcus_y * frame.mcus_x), frame.mcus_x)
    parts, index = [], []
    for i, c in enumerate(comps):
        for dy in range(c.v):
            for dx in range(c.h):
                parts.append(c.offset + ((my * c.v + dy) * c.cols + mx * c.h + dx) * _STRIDE)
                index.append(i)
    if len(parts) > 10:
        raise ValueError("bad JPEG scan: more than 10 blocks an MCU")
    return np.stack(parts, axis=1).reshape(-1).tolist(), len(parts), index


def _scan_segments(reader: _Reader, spans: Optional[list] = None) -> List[bytes]:
    """A scan's entropy-coded data, un-stuffed: intervals split at RSTn, up
    to the next other marker (the reader is left at it). ``spans`` gets
    each interval's (file offset of its data, of the marker after it, of
    the marker's end)."""
    data = reader.data
    start = reader.pos
    segments = []
    while True:
        m = _MARKER.search(data, start)
        if m is None:
            raise ValueError("truncated JPEG: the file ends before its EOI marker")
        segments.append(_STUFFED.sub(b"\xff", data[start:m.start()]))
        if spans is not None:
            spans.append((start, m.start(), m.end()))
        start = m.end()
        if not 0xD0 <= m.group(1)[0] <= 0xD7:
            reader.pos = m.start()
            return segments


def _scan(reader: _Reader, body: bytes, frame: _Frame, huff, quant, restart: int) -> None:
    comps, tables, band = _scan_header(body, frame, huff, quant)
    if band != (0, 63, 0, 0):
        raise ValueError("a sequential JPEG scan must cover coefficients 0..63")
    # blocks in decoding order: (slot, DC table, AC table, index, ends an MCU)
    slots, per_mcu, index = _scan_order(frame, comps)
    kinds = [(*tables[i], i) for i in index]
    blocks = [(slot, *kinds[j % per_mcu], j % per_mcu == per_mcu - 1)
              for j, slot in enumerate(slots)]
    segments = _scan_segments(reader)
    step = (restart * per_mcu) if restart else len(blocks)
    intervals = [blocks[lo:lo + step] for lo in range(0, len(blocks), step)]
    # an interval without data (a restart marker missing) stays zero
    _decode_segments(segments[:len(intervals)], intervals, frame.coefs)


# --- progressive scans (jdphuff.c). Each decoder takes the windows, the
# interval's bit range [pos, end) and its blocks' slots; an MCU that runs
# past the data reads zero bits, and the interval's later MCUs are left as
# they are (libjpeg's insufficient_data). _PGAP zero bytes follow each
# interval: more than one MCU of any progressive scan can read.
_PGAP = 320
_MASK32 = 0xFFFFFFFF


def _dc_first(W, pos, end, slots, per_mcu, tables, index, al, coefs) -> None:
    preds = [0, 0, 0, 0]
    for j in range(0, len(slots), per_mcu):
        for t in range(per_mcu):
            dc = tables[t]
            x = (W[pos >> 3] >> (8 - (pos & 7))) & _MASK32
            n, v = dc.fast[x >> 16]
            if v is None:
                s = dc.slow[x >> 16]
                e = (x >> (32 - n - s)) & ((1 << s) - 1)
                v = e if e >> (s - 1) else e - (1 << s) + 1
                n += s
            pos += n
            ci = index[t]
            p = preds[ci] + v
            preds[ci] = p
            coefs[slots[j + t]] = (((p << al) + 32768) & 0xFFFF) - 32768
        if pos > end:
            return


def _dc_refine(W, pos, end, slots, al, coefs) -> None:
    p1 = 1 << al
    for slot in slots:
        if pos >= end:  # zero bits from here on change nothing
            return
        if (W[pos >> 3] >> (39 - (pos & 7))) & 1:
            coefs[slot] |= p1
        pos += 1


def _ac_first(W, pos, end, slots, table, ss, se, al, coefs) -> None:
    raw = table.raw
    eobrun, i, n = 0, 0, len(slots)
    while i < n:
        if eobrun:  # blocks of an EOB run keep their zeros
            skip = min(eobrun, n - i)
            eobrun -= skip
            i += skip
            continue
        base = slots[i]
        k = ss
        while k <= se:
            x = (W[pos >> 3] >> (8 - (pos & 7))) & _MASK32
            ln, r, s = raw[x >> 16]
            if s:
                e = (x >> (32 - ln - s)) & ((1 << s) - 1)
                pos += ln + s
                k += r
                v = e if e >> (s - 1) else e - (1 << s) + 1
                coefs[base + (k if k < 64 else 63)] = (((v << al) + 32768) & 0xFFFF) - 32768
                k += 1
            elif r == 15:  # ZRL
                pos += ln
                k += 16
            else:  # EOBr: this block and 2^r + r bits - 1 more end here
                eobrun = (1 << r) + ((x >> (32 - ln - r)) & ((1 << r) - 1)) - 1
                pos += ln + r
                break
        i += 1
        if pos > end:
            return


def _ac_refine(W, pos, end, slots, table, ss, se, al, coefs) -> None:
    raw = table.raw
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    for base in slots:
        k = ss
        if not eobrun:
            while k <= se:
                x = (W[pos >> 3] >> (8 - (pos & 7))) & _MASK32
                ln, r, s = raw[x >> 16]
                pos += ln
                if s:  # a newly nonzero coefficient: its sign bit
                    s = p1 if (x >> (31 - ln)) & 1 else m1
                    pos += 1
                elif r != 15:
                    eobrun = (1 << r) + ((x >> (32 - ln - r)) & ((1 << r) - 1))
                    pos += r
                    break
                # pass over nonzero coefficients (a correction bit each) and
                # r zero ones; the next zero one takes the new value
                while True:
                    v = coefs[base + k]
                    if v:
                        if (W[pos >> 3] >> (39 - (pos & 7))) & 1 and not v & p1:
                            coefs[base + k] = (((v + (p1 if v >= 0 else m1)) + 32768)
                                               & 0xFFFF) - 32768
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                    if k > se:
                        break
                if s:
                    coefs[base + (k if k < 64 else 63)] = s
                k += 1
        if eobrun:  # the rest of the band: correction bits only
            while k <= se:
                v = coefs[base + k]
                if v:
                    if (W[pos >> 3] >> (39 - (pos & 7))) & 1 and not v & p1:
                        coefs[base + k] = (((v + (p1 if v >= 0 else m1)) + 32768)
                                           & 0xFFFF) - 32768
                    pos += 1
                k += 1
            eobrun -= 1
        if pos > end:
            return


def _progressive_band(body: bytes):
    """A progressive scan's (Ss, Se, Ah, Al), checked as ``jdphuff.c`` and
    ``jdarith.c`` check them."""
    if len(body) < 1 or len(body) < 1 + 2 * body[0] + 3:
        raise ValueError("bad JPEG scan header")
    ns = body[0]
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if (se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1)) \
            or (ah and al != ah - 1) or al > 13:
        raise ValueError(f"bad progressive JPEG scan: Ss {ss}, Se {se}, Ah {ah}, Al {al} "
                         f"over {ns} components")
    return ss, se, ah, al


def _progressive_scan(reader: _Reader, body: bytes, frame: _Frame, huff, quant,
                      restart: int) -> None:
    """One scan of a progressive frame (``jdphuff.c``), which refines the
    frame's coefficient buffer in place."""
    ss, se, ah, al = _progressive_band(body)
    dc_band = ss == 0
    needed = ((0,) if ah == 0 else ()) if dc_band else (1,)
    comps, tables, _ = _scan_header(body, frame, huff, quant, needed)
    for c in comps:
        c.coef_bits[ss:se + 1] = [al] * (se + 1 - ss)
    slots, per_mcu, index = _scan_order(frame, comps)
    segments = _scan_segments(reader)
    n_mcus = len(slots) // per_mcu
    step = restart or n_mcus
    pad = bytes(_PGAP)
    W = _windows(pad.join(segments) + pad + bytes(4))
    coefs, start = frame.coefs, 0
    # an interval without data (a restart marker missing) is left as it is
    for first, segment in zip(range(0, n_mcus, step), segments):
        end = start + 8 * len(segment)
        part = slots[first * per_mcu:(first + step) * per_mcu]
        if dc_band and ah == 0:
            _dc_first(W, start, end, part, per_mcu, [tables[i][0] for i in index],
                      index, al, coefs)
        elif dc_band:
            _dc_refine(W, start, end, part, al, coefs)
        elif ah == 0:
            _ac_first(W, start, end, part, tables[0][1], ss, se, al, coefs)
        else:
            _ac_refine(W, start, end, part, tables[0][1], ss, se, al, coefs)
        start = end + 8 * _PGAP


# --- arithmetic-coded scans (jdarith.c). T.81 Table D.2 as libjpeg-turbo's
# jaricom.c holds it: state -> (Qe, next state after an LPS, after an MPS,
# whether an LPS switches the MPS); state 113 is the fixed 0.5 estimate.
_ARITAB = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
)
ARITH_QE = [q for q, _, _, _ in _ARITAB]
ARITH_NEXT_LPS = [(switch << 7) | lps for _, lps, _, switch in _ARITAB]  # the switch in bit 7
ARITH_NEXT_MPS = [mps for _, _, mps, _ in _ARITAB]
ARITH_FIXED = 113
_DC_BINS, _AC_BINS = 64, 256


class _ArithError(Exception):
    """jdarith.c's ``ct = -1``: a magnitude or spectral overflow, after
    which libjpeg decodes nothing more of the interval."""


def _arith_decoder(data: bytes):
    """``arith_decode`` over one interval's un-stuffed bytes, zero bytes past
    their end (libjpeg feeds zeros once it meets a marker): a function of a
    statistics area and a bin -> the decoded bit, the bin updated."""
    a = c = pos = 0
    ct = -16  # two bytes to read before the first decision
    n = len(data)
    qes, nls, nms = ARITH_QE, ARITH_NEXT_LPS, ARITH_NEXT_MPS

    def consumed() -> int:
        return pos

    def decode(st, i: int) -> int:
        nonlocal a, c, ct, pos
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                c <<= 8
                if pos < n:
                    c |= data[pos]
                    pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        k = sv & 0x7F
        qe = qes[k]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ nms[k]
            else:
                st[i] = (sv & 0x80) ^ nls[k]
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nls[k]
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nms[k]
        return sv >> 7

    decode.consumed = consumed  # bytes of ``data`` read so far
    return decode


def _read_end(data: bytes, span, segment: bytes, consumed: int) -> int:
    """The file offset past the last byte libjpeg's arithmetic decoder read
    of an interval that it read ``consumed`` un-stuffed bytes of: into the
    marker after the data where it read all of them (it reads the marker
    to find it), else through the stuffing of the last byte it read."""
    start, marker, marker_end = span
    if consumed >= len(segment):
        return marker_end
    extra = 0  # stuffed bytes beyond the un-stuffed ones read so far
    for m in _STUFFED.finditer(data, start, marker):
        if m.start() - start - extra >= consumed:
            break
        extra += m.end() - m.start() - 1
    return start + consumed + extra


def _arith_dc(decode, st, s0: int, lower: int, upper: int):
    """Figures F.19-F.24: one DC difference from the statistics area ``st``
    at context ``s0`` -> (difference, next context)."""
    if not decode(st, s0):
        return 0, 0
    sign = decode(st, s0 + 1)
    i = s0 + 2 + sign
    m = decode(st, i)
    if m:
        i = 20
        while decode(st, i):
            m <<= 1
            if m == 0x8000:
                raise _ArithError
            i += 1
    if m < (1 << lower) >> 1:
        context = 0
    elif m > (1 << upper) >> 1:
        context = 12 + 4 * sign
    else:
        context = 4 + 4 * sign
    v, i = m, i + 14
    while m > 1:
        m >>= 1
        if decode(st, i):
            v |= m
    v += 1
    return (-v if sign else v), context


def _arith_ac_value(decode, st, i: int, k: int, kk: int, fixed) -> int:
    """Figures F.21-F.24 for the AC coefficient at zigzag ``k`` whose bins
    start at ``i`` (``kk``: the table's conditioning bound K)."""
    sign = decode(fixed, 0)
    i += 2
    m = decode(st, i)
    if m and decode(st, i):
        m <<= 1
        i = 189 if k <= kk else 217
        while decode(st, i):
            m <<= 1
            if m == 0x8000:
                raise _ArithError
            i += 1
    v, i = m, i + 14
    while m > 1:
        m >>= 1
        if decode(st, i):
            v |= m
    v += 1
    return -v if sign else v


def _w16s(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


def _arith_sequential(decode, blocks, coefs, stats, dac) -> None:
    """``decode_mcu``: every block of one interval; ``blocks`` lists (slot,
    DC table, AC table, component)."""
    dc_stats, ac_stats, fixed = stats
    lower, upper, kks = dac
    last, context = [0, 0, 0, 0], [0, 0, 0, 0]
    for base, td, ta, ci in blocks:
        v, context[ci] = _arith_dc(decode, dc_stats[td], context[ci], lower[td], upper[td])
        last[ci] = (last[ci] + v) & 0xFFFF
        coefs[base] = _w16s(last[ci])
        st, kk, k = ac_stats[ta], kks[ta], 0
        while k < 63:
            i = 3 * k
            if decode(st, i):  # end of block
                break
            while True:
                k += 1
                if decode(st, i + 1):
                    break
                i += 3
                if k >= 63:
                    raise _ArithError
            coefs[base + k] = _w16s(_arith_ac_value(decode, st, i, k, kk, fixed))


def _arith_dc_first(decode, blocks, coefs, stats, dac, al: int) -> None:
    dc_stats = stats[0]
    lower, upper, _ = dac
    last, context = [0, 0, 0, 0], [0, 0, 0, 0]
    for base, td, _, ci in blocks:
        v, context[ci] = _arith_dc(decode, dc_stats[td], context[ci], lower[td], upper[td])
        last[ci] = (last[ci] + v) & 0xFFFF
        coefs[base] = _w16s(last[ci] << al)


def _arith_dc_refine(decode, blocks, coefs, stats, al: int) -> None:
    fixed = stats[2]
    for base, _, _, _ in blocks:
        if decode(fixed, 0):
            coefs[base] |= 1 << al


def _arith_ac_first(decode, blocks, coefs, stats, dac, ss: int, se: int, al: int) -> None:
    _, ac_stats, fixed = stats
    for base, _, ta, _ in blocks:
        st, kk, k = ac_stats[ta], dac[2][ta], ss
        while k <= se:
            i = 3 * (k - 1)
            if decode(st, i):
                break
            while not decode(st, i + 1):
                i += 3
                k += 1
                if k > se:
                    raise _ArithError
            coefs[base + k] = _w16s(_arith_ac_value(decode, st, i, k, kk, fixed) << al)
            k += 1


def _arith_ac_refine(decode, blocks, coefs, stats, ss: int, se: int, al: int) -> None:
    _, ac_stats, fixed = stats
    p1, m1 = 1 << al, -1 << al
    for base, _, ta, _ in blocks:
        st = ac_stats[ta]
        kex = se
        while kex > 0 and not coefs[base + kex]:
            kex -= 1
        k = ss
        while k <= se:
            i = 3 * (k - 1)
            if k > kex and decode(st, i):
                break
            while True:
                v = coefs[base + k]
                if v:
                    if decode(st, i + 2):
                        coefs[base + k] = _w16s(v + (m1 if v < 0 else p1))
                    break
                if decode(st, i + 1):
                    coefs[base + k] = m1 if decode(fixed, 0) else p1
                    break
                i += 3
                k += 1
                if k > se:
                    raise _ArithError
            k += 1


def _dac(body: bytes, dac) -> None:
    """``get_dac``: conditioning tables, (class, id) -> DC (L, U) or AC K."""
    lower, upper, kks = dac
    if len(body) % 2:
        raise ValueError("bad JPEG DAC segment")
    for pos in range(0, len(body), 2):
        index, value = body[pos], body[pos + 1]
        if index >= 32:
            raise ValueError(f"bad JPEG DAC table index {index}")
        if index >= 16:
            kks[index - 16] = value
        else:
            lower[index], upper[index] = value & 15, value >> 4
            if lower[index] > upper[index]:
                raise ValueError(f"bad JPEG DAC value 0x{value:02x}: L above U")


def _arith_scan(reader: _Reader, body: bytes, frame: _Frame, quant, restart: int,
                dac) -> None:
    """One arithmetic-coded scan (SOF9: the whole band of every block;
    SOF10: a progressive scan), its statistics areas fresh at the scan's
    start and at each restart."""
    if frame.progressive:
        ss, se, ah, al = _progressive_band(body)
    else:
        ss, se, ah, al = 0, 63, 0, 0
    comps, _, _ = _scan_header(body, frame, {}, quant, ())
    ns = body[0]
    selectors = [(body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15) for i in range(ns)]
    if any(t >= 16 for pair in selectors for t in pair):
        raise ValueError("bad JPEG scan: an arithmetic table selector above 15")
    if frame.progressive:
        for c in comps:
            c.coef_bits[ss:se + 1] = [al] * (se + 1 - ss)
    slots, per_mcu, index = _scan_order(frame, comps)
    blocks = [(slot, *selectors[index[j % per_mcu]], index[j % per_mcu])
              for j, slot in enumerate(slots)]
    n_mcus = len(slots) // per_mcu
    step = restart or n_mcus
    coefs = frame.coefs
    spans = []
    segments = _scan_segments(reader, spans)
    # an interval without data (a restart marker missing) is left as it is
    for first, segment, span in zip(range(0, n_mcus, step), segments, spans):
        part = blocks[first * per_mcu:(first + step) * per_mcu]
        stats = ([bytearray(_DC_BINS) for _ in range(16)],
                 [bytearray(_AC_BINS) for _ in range(16)], bytearray([ARITH_FIXED]))
        decode = _arith_decoder(segment)
        try:
            if not frame.progressive:
                _arith_sequential(decode, part, coefs, stats, dac)
            elif ss == 0 and ah == 0:
                _arith_dc_first(decode, part, coefs, stats, dac, al)
            elif ss == 0:
                _arith_dc_refine(decode, part, coefs, stats, al)
            elif ah == 0:
                _arith_ac_first(decode, part, coefs, stats, dac, ss, se, al)
            else:
                _arith_ac_refine(decode, part, coefs, stats, ss, se, al)
        except _ArithError:
            pass  # libjpeg warns and leaves the rest of the interval as it is
        frame.read_end = max(frame.read_end, _read_end(reader.data, span, segment,
                                                       decode.consumed()))


# --- lossless scans (SOF3: libjpeg-turbo 3's jdlhuff.c, jdpred.c and
# jdlossls.c). Each sample's difference from its prediction, Huffman-coded
# by magnitude category; the samples undifferenced row by row.


def _lossless_diffs(segment: bytes, tables, n: int) -> np.ndarray:
    """n differences of one interval, the tables taken in turn (one a
    component of the scan); past the data, zero bits (libjpeg feeds zeros
    to a scan that runs out)."""
    out = [0] * n
    ns = len(tables)
    for pad in (8, 4 * n + 8):
        W = _windows(segment + bytes(pad))
        pos = 0
        try:
            for j in range(n):
                dc = tables[j % ns]
                x = (W[pos >> 3] >> (8 - (pos & 7))) & 0xFFFFFFFF
                bits, v = dc.fast[x >> 16]
                if v is None:
                    s = dc.slow[x >> 16]
                    e = (x >> (32 - bits - s)) & ((1 << s) - 1)
                    v = e if e >> (s - 1) else e - (1 << s) + 1
                    bits += s
                pos += bits
                out[j] = v
            break
        except IndexError:
            continue
    return np.array(out, np.int64)


def _undifference(d: np.ndarray, predictor: int, initial: int) -> np.ndarray:
    """``jdpred.c`` over one interval of one component: (rows, width)
    differences -> samples mod 2^16. The interval's first row predicts
    from the left (its first sample from ``initial``), each later row's
    first sample from above, the rest by the scan's predictor."""
    rows, width = d.shape
    x = np.empty_like(d)
    x[0] = (initial + np.cumsum(d[0])) & 0xFFFF
    for r in range(1, rows):
        b = x[r - 1]
        first = (d[r, 0] + b[0]) & 0xFFFF
        if predictor == 1:  # Ra
            x[r] = (first + np.cumsum(np.concatenate([[0], d[r, 1:]]))) & 0xFFFF
        elif predictor == 2:  # Rb
            x[r] = (d[r] + b) & 0xFFFF
        elif predictor == 3:  # Rc
            x[r, 0] = first
            x[r, 1:] = (d[r, 1:] + b[:-1]) & 0xFFFF
        elif predictor in (4, 5):  # Ra + Rb - Rc, Ra + ((Rb - Rc) >> 1)
            step = b[1:] - b[:-1] if predictor == 4 else (b[1:] - b[:-1]) >> 1
            x[r] = (first + np.cumsum(np.concatenate([[0], d[r, 1:] + step]))) & 0xFFFF
        else:  # Rb + ((Ra - Rc) >> 1), (Ra + Rb) >> 1: each sample on the last
            row, dr, bl = [first], d[r].tolist(), b.tolist()
            ra = first
            for j in range(1, width):
                if predictor == 6:
                    ra = (dr[j] + bl[j] + ((ra - bl[j - 1]) >> 1)) & 0xFFFF
                else:
                    ra = (dr[j] + ((ra + bl[j]) >> 1)) & 0xFFFF
                row.append(ra)
            x[r] = row
    return x


def _lossless_scan(reader: _Reader, body: bytes, frame: _Frame, huff, restart: int) -> None:
    """One lossless scan: predictor Ss (1 to 7), point transform Al. An
    MCU of a scan of one component is one sample; of an interleaved scan,
    each component's h x v samples in raster order, the MCUs covering
    ``ceil(W / hmax)`` by ``ceil(H / vmax)`` blocks (what reaches past a
    component's samples is decoded and dropped). Each component's samples
    are undifferenced on its own grid (the first sample row of the scan
    and of each restart interval from the left), then shifted left by Al
    to 8 bits."""
    if len(body) < 1 or len(body) < 1 + 2 * body[0] + 3:
        raise ValueError("bad JPEG scan header")
    ns = body[0]
    predictor, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if not 1 <= predictor <= 7 or se != 0 or ah != 0 or al >= frame.precision:
        raise ValueError(f"bad lossless JPEG scan: predictor {predictor}, Se {se}, Ah {ah}, "
                         f"Al {al}")
    by_id = {c.id: c for c in frame.comps}
    comps, tables = [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"JPEG scan names component {cid}, which the frame lacks")
        raw = huff.get(("raw", 0, t >> 4))
        if raw is None:
            raise ValueError(f"JPEG scan uses Huffman table (0, {t >> 4}), which is undefined")
        comps.append(by_id[cid])
        tables.append(_huffman(*raw, True, True))
    for c in comps:
        c.quant = np.ones(64, np.int64)  # sent: no quantisation in lossless mode
    if ns == 1:
        blocks = [(1, 1)]
        mcux, mcuy = comps[0].samples.shape[1], comps[0].samples.shape[0]
    else:
        blocks = [(c.h, c.v) for c in comps]
        mcux, mcuy = -(-frame.width // frame.max_h), -(-frame.height // frame.max_v)
    if restart and restart % mcux:
        raise ValueError(f"lossless JPEG restart interval {restart} not a whole number of "
                         f"its {mcux}-MCU rows: libjpeg-turbo refuses it")
    step = restart // mcux if restart else mcuy
    unit_tables = [t for t, (h, v) in zip(tables, blocks) for _ in range(h * v)]
    per_mcu = len(unit_tables)
    segments = _scan_segments(reader)
    initial = 1 << (frame.precision - al - 1)
    for first, segment in zip(range(0, mcuy, step), segments):
        rows = min(step, mcuy - first)
        d = _lossless_diffs(segment, unit_tables, rows * mcux * per_mcu).reshape(rows, mcux,
                                                                               per_mcu)
        at = 0
        for c, (h, v) in zip(comps, blocks):
            block = d[:, :, at:at + h * v].reshape(rows, mcux, v, h)
            at += h * v
            x = _undifference(block.transpose(0, 2, 1, 3).reshape(rows * v, mcux * h),
                              predictor, initial)
            top = first * v
            part = c.samples[top:top + rows * v]
            part[:] = ((x << al) & 0xFF)[:part.shape[0], :part.shape[1]]


# jidctint.c constants (CONST_BITS 13)
_F0298, _F0390, _F0541, _F0765, _F0899, _F1175 = 2446, 3196, 4433, 6270, 7373, 9633
_F1501, _F1847, _F1961, _F2053, _F2562, _F3072 = 12299, 15137, 16069, 16819, 20995, 25172


def _w16(v):
    """Wrap to int16, as a 16-bit SIMD add, shift or product does."""
    return ((v + 32768) & 0xFFFF) - 32768


def _idct_pass(x, shift: int):
    """One pass of libjpeg-turbo's SIMD ISLOW inverse DCT
    (``jidctint-avx2.asm``, which both references run on x86-64) over the
    8 int16 inputs ``x[0..7]`` (arrays): the products and sums of
    ``jidctint.c`` regrouped as the SIMD code does (each ``pmaddwd`` a pair
    of 16-bit products), with 16-bit sums where it forms ``x0 +- x4`` and
    the odd part's ``z3``, ``z4``; each output DESCALEd by ``shift`` and
    saturated to int16. For the coefficients of any real image this equals
    the C code."""
    z2, z3 = x[2], x[6]
    tmp3 = z2 * (_F0541 + _F0765) + z3 * _F0541
    tmp2 = z2 * _F0541 + z3 * (_F0541 - _F1847)
    tmp0 = _w16(x[0] + x[4]) << 13
    tmp1 = _w16(x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z3, z4 = _w16(t0 + t2), _w16(t1 + t3)
    z3, z4 = (z3 * (_F1175 - _F1961) + z4 * _F1175,
              z3 * _F1175 + z4 * (_F1175 - _F0390))
    o0 = t0 * (_F0298 - _F0899) + t3 * -_F0899 + z3
    o3 = t0 * -_F0899 + t3 * (_F1501 - _F0899) + z4
    o1 = t1 * (_F2053 - _F2562) + t2 * -_F2562 + z4
    o2 = t1 * -_F2562 + t2 * (_F3072 - _F2562) + z3
    r = 1 << (shift - 1)
    out = [tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
           tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3]
    return [np.clip((v + r) >> shift, -32768, 32767) for v in out]


# --- block smoothing (libjpeg-turbo jdcoefct.c). The estimates, as the C
# code writes them: coefficient (zigzag 1..9, then the DC) -> its kernel on
# the 5x5 DC values DC01..DC25 (rows above to below, columns left to
# right, DC13 the block's own), with DC interpolation ("change_dc", where
# no scan has sent any of the nine) and without.
_SMOOTH_CHANGE_DC = (
    "-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11"
    " + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20"
    " - DC21 - DC22 + DC24 + DC25",
    "-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08"
    " + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21"
    " + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25",
    "DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17"
    " + 7 * DC18 + 2 * DC19 + DC23",
    "-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25",
    "2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 + DC15"
    " + 2 * DC17 - 5 * DC18 + 2 * DC19",
    "DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19",
    "DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19",
    "DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19",
    "DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19",
    "-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07"
    " + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14"
    " - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21"
    " - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25",
)
_SMOOTH_PLAIN = (
    "-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15",
    "-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23",
    "-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23",
    "DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 - DC06"
    " + 10 * DC07 - 10 * DC09",
    "-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15",
)
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)  # natural order of zigzag 1..9


def _kernel(text: str) -> Dict[int, int]:
    """``"-7 * DC11 + 50 * DC12"`` -> {10: -7, 11: 50} (0-based cells)."""
    terms = re.findall(r"([+-]?)\s*(?:(\d+) \* )?DC(\d\d)", text)
    return {int(cell) - 1: (-1 if sign == "-" else 1) * int(w or 1) for sign, w, cell in terms}


_KERNELS = ([_kernel(t) for t in _SMOOTH_CHANGE_DC], [_kernel(t) for t in _SMOOTH_PLAIN])


def _smoothing(frame: _Frame) -> bool:
    """``smoothing_ok``: a progressive frame whose scans left some of the
    first nine AC coefficients of a component unrefined (its DC sent, at
    least in part, and no zero among the quantisers the estimates use)."""
    if not frame.progressive:
        return False
    useful = False
    for c in frame.comps:
        if c.quant is None or not c.quant[[0, *_SMOOTH_POS]].all() or c.coef_bits[0] < 0:
            return False
        useful |= any(c.coef_bits[1:10])
    return useful


def _smoothed(frame: _Frame, c: _Component, coefs: np.ndarray) -> np.ndarray:
    """``decompress_smooth_data``: a copy of the component's coefficient
    slots with each estimate written where the coefficient is still zero
    and not known to full precision. The neighbours' DC values are the
    stored ones; columns are clamped to the real blocks, rows as the C code
    clamps them (it counts rows of the last iMCU row by that row's real
    block rows, so near the bottom of a short frame its window differs
    from a plain clamp)."""
    bits = c.coef_bits
    change_dc = all(b == -1 for b in bits[1:10])
    hb, wb = c.height_blocks, c.width_blocks
    out = coefs.astype(np.int64).reshape(c.rows, c.cols, _STRIDE)
    dc = out[:, :, 0].copy()
    total = frame.mcus_y
    row = np.arange(hb)
    imcu, b = row // c.v, row % c.v
    per = np.where(imcu < total - 1, c.v, hb % c.v or c.v)  # block rows of that iMCU row
    at, rows_seen = imcu * per + b, per * total
    prev = np.where(at > 0, row - 1, row)
    nxt = np.where(at < rows_seen - 1, row + 1, row)
    rows = (np.where(at > 1, row - 2, prev), prev, row, nxt,
            np.where(at < rows_seen - 2, row + 2, nxt))
    col = np.arange(wb)
    cols = [np.clip(col + d, 0, wb - 1) for d in (-2, -1, 0, 1, 2)]
    cell = {}

    def window(i):
        if i not in cell:
            cell[i] = dc[rows[i // 5][:, None], cols[i % 5][None, :]]
        return cell[i]

    q = c.quant
    real = out[:hb, :wb]
    estimates = list(enumerate(_KERNELS[0] if change_dc else _KERNELS[1], start=1))
    for k, kernel in estimates:
        al = bits[k] if k < 10 else 0
        if k < 10 and al == 0:
            continue
        num = q[0] * sum(w * window(i) for i, w in kernel.items())
        qk = int(q[_SMOOTH_POS[k - 1]] if k < 10 else q[0])
        pred = ((qk << 7) + np.abs(num)) // (qk << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = _w16(np.where(num >= 0, pred, -pred))
        zz = k if k < 10 else 0
        if k < 10:
            real[:, :, zz] = np.where(real[:, :, zz] == 0, pred, real[:, :, zz])
        else:
            real[:, :, 0] = pred
    return out.reshape(-1, _STRIDE)


def _component_plane(frame: _Frame, c: _Component, smooth: bool = False) -> np.ndarray:
    """Dequantise and inverse-DCT every block of a component -> its
    (ds_height, ds_width) uint8 samples: ``x + 128`` saturated to 0..255,
    as the SIMD code packs it. A block whose AC coefficients are all zero
    comes out flat and is computed as one value."""
    coefs = np.frombuffer(frame.coefs, np.int16)[c.offset:c.offset + c.rows * c.cols * _STRIDE]
    coefs = coefs.reshape(-1, _STRIDE)
    if smooth:
        coefs = _smoothed(frame, c, coefs)
    samples = np.empty((coefs.shape[0], 64), np.uint8)
    q = _w16(c.quant)  # the SIMD code holds the table in 16 bits
    dc = _w16(coefs[:, 0].astype(np.int64) * q[0])  # pmullw: the low 16 bits
    flat = (_w16(dc << 2) * 8192 + (1 << 17)) >> 18  # the zero-column path (psllw)
    samples[:] = (np.clip(flat, -128, 127) + 128).astype(np.uint8)[:, None]
    busy = np.flatnonzero(coefs[:, 1:].any(axis=1))
    if busy.size:
        zz = coefs[busy].astype(np.int64)
        zz[:, 63] += zz[:, 64:79].sum(axis=1)  # a run past 63 lands on 63, as in libjpeg
        block = np.empty((busy.size, 64), np.int64)
        block[:, _NATURAL] = zz[:, :64]
        block = _w16(_w16(block) * q).reshape(-1, 8, 8)
        # pass 1: columns, into the int16 workspace; a block whose columns
        # have no AC terms takes the shortcut, a 16-bit shift of each DC
        ws = np.stack(_idct_pass([block[:, k, :] for k in range(8)], 11), axis=1)
        dc_rows = ~block[:, 1:, :].any(axis=(1, 2))
        ws[dc_rows] = _w16(block[dc_rows, :1, :] << 2)
        # pass 2: rows, into samples
        out = np.stack(_idct_pass([ws[:, :, k] for k in range(8)], 18), axis=2)
        samples[busy] = (np.clip(out.reshape(-1, 64), -128, 127) + 128).astype(np.uint8)
    plane = samples.reshape(c.rows, c.cols, 8, 8).transpose(0, 2, 1, 3)
    plane = plane.reshape(c.rows * 8, c.cols * 8)
    return plane[:c.ds_height, :c.ds_width]


def _upsample(plane: np.ndarray, c: _Component, frame: _Frame) -> np.ndarray:
    """``jdsample.c`` as ``jinit_upsampler`` picks a method for the ratio of
    the largest sampling factors to the component's: fancy h2v1, h1v2 and
    h2v2 (triangle filters whose edges repeat the first and last sample;
    h2 below 3 columns replicates, as libjpeg does), any other whole ratio
    (4:1:1) by replication."""
    fh, fv = frame.max_h // c.h, frame.max_v // c.v
    wide = c.ds_width > 2
    p = plane.astype(np.int32)
    if (fh, fv) == (2, 2) and wide:
        up = np.concatenate([p[:1], p[:-1]], axis=0)
        down = np.concatenate([p[1:], p[-1:]], axis=0)
        rows = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
        rows[0::2] = 3 * p + up
        rows[1::2] = 3 * p + down
        left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
        right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
        out = np.empty((rows.shape[0], 2 * rows.shape[1]), np.int32)
        out[:, 0::2] = (3 * rows + left + 8) >> 4
        out[:, 1::2] = (3 * rows + right + 7) >> 4
        return out.astype(np.uint8)
    if (fh, fv) == (1, 2):
        up = np.concatenate([p[:1], p[:-1]], axis=0)
        down = np.concatenate([p[1:], p[-1:]], axis=0)
        out = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
        out[0::2] = (3 * p + up + 1) >> 2
        out[1::2] = (3 * p + down + 2) >> 2
        return out.astype(np.uint8)
    if (fh, fv) == (2, 1) and wide:
        left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
        out[:, 0::2] = (3 * p + left + 1) >> 2
        out[:, 1::2] = (3 * p + right + 2) >> 2
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)


def _ycc_tables():
    """``jdcolor.c`` ``build_ycc_rgb_table`` (SCALEBITS 16), with the green
    term summed for every (Cb, Cr) pair."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    g = (cb_g[:, None] + cr_g[None, :]) >> 16
    return cr_r.astype(np.int16), cb_b.astype(np.int16), g.reshape(-1).astype(np.int16)


_CR_R, _CB_B, _CBCR_G = _ycc_tables()


def _colour_space(frame: _Frame, jfif: bool, adobe: Optional[int]) -> str:
    """``jdapimin.c`` ``default_decompress_parms``' guess."""
    n = len(frame.comps)
    if n == 1:
        return "gray"
    if n == 4:
        return "cmyk" if adobe is None or adobe == 0 else "ycck"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    if frame.lossless:  # libjpeg-turbo 3 takes a lossless frame without markers for RGB
        return "rgb"
    return "rgb" if tuple(c.id for c in frame.comps) == (82, 71, 66) else "ycc"


def _ycc_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    y = y.astype(np.int16)
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = np.clip(y + _CR_R[cr], 0, 255)
    out[..., 1] = np.clip(y + _CBCR_G[(cb.astype(np.intp) << 8) | cr], 0, 255)
    out[..., 2] = np.clip(y + _CB_B[cb], 0, 255)
    return out


def _samples(frame: _Frame, planes: List[np.ndarray], space: str) -> np.ndarray:
    """libjpeg's output samples, (H, W, components): gray, RGB, or CMYK
    (YCCK through ``ycck_cmyk_convert``); ``"none"`` leaves the
    components as they are."""
    h, w = frame.height, frame.width
    planes = [p[:h, :w] for p in planes]
    if space == "ycc":
        return _ycc_rgb(*planes)
    if space == "ycck":
        rgb = _ycc_rgb(*planes[:3]).astype(np.int16)
        return np.concatenate([255 - rgb, planes[3][:, :, None]], axis=2).astype(np.uint8)
    return np.ascontiguousarray(np.stack(planes, axis=2))


def _cmyk_rgb(cmyk: np.ndarray, route: str) -> np.ndarray:
    """libjpeg's (Adobe-inverted) CMYK -> RGB by the route's rule: PIL
    unpacks ``CMYK;I`` (255 - each byte), then ``cmyk2rgb``'s ``nk -
    MULDIV255(c, nk)`` with ``nk = 255 - k``; cv2 takes ``k - ((255 - c) *
    k >> 8)`` on libjpeg's bytes."""
    x = cmyk.astype(np.int32)
    k = x[:, :, 3:]
    if route == "pil":
        t = (255 - x[:, :, :3]) * k + 128
        return np.clip(k - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    return (k - ((255 - x[:, :, :3]) * k >> 8)).astype(np.uint8)


def _orient(image: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ExifTransform``: orientation 1-8 -> the upright page."""
    if orientation >= 5:
        image = image.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        image = np.flip(image, axis=axis)
    return np.ascontiguousarray(image)


def _coefficients(data: bytes):
    """Parse a JPEG and entropy-decode its scans -> (frame, its coefficient
    buffer filled; whether it has a JFIF marker; its Adobe transform or
    None)."""
    data = bytes(data)
    quant: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], _Huffman] = {}
    dac = ([0] * 16, [1] * 16, [5] * 16)  # arithmetic conditioning: DC L, U; AC K
    frame: Optional[_Frame] = None
    restart = 0
    jfif, adobe = False, None
    for marker, body in _header(data, stop_at_frame=False):
        _check_frame_marker(marker)
        if marker == 0xD9:
            break
        if marker in _SOF_READ:
            if frame is not None:
                raise ValueError("JPEG with two frame headers")
            frame = _parse_frame(body, marker in _PROGRESSIVE, marker in _ARITHMETIC,
                                 marker == 0xC3)
        elif marker == 0xDB:
            _quant_tables(body, quant)
        elif marker == 0xC4:
            _huffman_tables(body, huff)
        elif marker == 0xCC:
            _dac(body, dac)
        elif marker == 0xDD:
            if len(body) < 2:
                raise ValueError("bad JPEG restart interval")
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            reader, header = body
            if frame.lossless:
                _lossless_scan(reader, header, frame, huff, restart)
            elif frame.arithmetic:
                _arith_scan(reader, header, frame, quant, restart, dac)
            else:
                scan = _progressive_scan if frame.progressive else _scan
                scan(reader, header, frame, huff, quant, restart)
        elif marker == 0xE0 and len(body) >= 14 and body.startswith(b"JFIF\x00"):
            jfif = True
        elif marker == 0xEE and len(body) >= 12 and body.startswith(b"Adobe"):
            adobe = body[11]
    if frame is None:
        raise ValueError("JPEG without a frame header")
    if any(c.quant is None for c in frame.comps):
        raise ValueError("JPEG whose scans leave a component out")
    return frame, jfif, adobe


def _decode(data: bytes):
    """Parse and decode a JPEG -> (frame, its upsampled component planes,
    the colour space libjpeg would guess)."""
    frame, jfif, adobe = _coefficients(data)
    if frame.lossless:
        space = _colour_space(frame, jfif, adobe)
        if space in ("ycc", "ycck"):
            raise ValueError(f"lossless {space.upper()} JPEG: libjpeg-turbo converts no colour "
                             "in lossless mode, and both routes refuse it")
        # libjpeg upsamples lossless components by replication (no fancy
        # upsampling without a DCT)
        planes = [np.repeat(np.repeat(c.samples, frame.max_v // c.v, 0), frame.max_h // c.h,
                            1)[:frame.height, :frame.width] for c in frame.comps]
        return frame, planes, space
    smooth = _smoothing(frame)
    planes = [_upsample(_component_plane(frame, c, smooth), c, frame) for c in frame.comps]
    return frame, planes, _colour_space(frame, jfif, adobe)


def _decode_samples(data: bytes, ycc: bool) -> np.ndarray:
    """A JPEG -> libjpeg's (H, W, components) samples, for a container
    that states the colour space itself (TIFF, as libtiff sets it): ``ycc``
    converts three components from YCbCr to RGB, else every component is
    left as it is."""
    frame, planes, _ = _decode(data)
    return _samples(frame, planes, "ycc" if ycc and len(planes) == 3 else "none")


def decode_jpeg(data: bytes, route: str = "pil") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, equal to PIL's
    ``convert("RGB")`` (``route="pil"``) or to ``cv2.imdecode(...,
    IMREAD_COLOR)`` with its channels flipped (``route="cv2"``, which
    applies the EXIF orientation)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    frame, planes, space = _decode(data)
    if frame.arithmetic and route == "pil" and frame.read_end > PIL_BLOCK:
        raise ValueError(f"arithmetic-coded JPEG read to byte {frame.read_end}: PIL feeds "
                         f"libjpeg {PIL_BLOCK} bytes first, and its arithmetic decoder cannot "
                         "wait for more (PIL: broken data stream)")
    if frame.lossless and frame.precision != 8 and route == "pil":
        raise ValueError(f"{frame.precision}-bit lossless JPEG: PIL cannot handle its layers "
                         "(cv2 reads the samples as they are)")
    if frame.lossless and space == "gray" and route == "cv2":
        raise ValueError("lossless gray JPEG: cv2 asks libjpeg-turbo for BGR, which it does "
                         "not convert to in lossless mode")
    image = _samples(frame, planes, space)
    if image.shape[2] == 1:
        image = np.repeat(image, 3, axis=2)
    elif image.shape[2] == 4:
        image = _cmyk_rgb(image, route)
    if route == "cv2":
        image = _orient(image, exif_orientation(data))
    return image

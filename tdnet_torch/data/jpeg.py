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
(SOF0, SOF1, SOF2) at 8 bits with one, three or four components and any
sampling factors libjpeg accepts (1 to 4; each component's factors must
divide the largest), interleaved or not, 8- or 16-bit quantisation tables,
restart intervals, and the Annex K Huffman tables where a file defines
none (Motion JPEG). Lossless, hierarchical, arithmetic-coded and 12-bit
frames and DNL raise, as does a file that ends before its EOI marker
(both reference routes fail on one).

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
READS = ("baseline, extended sequential and progressive Huffman JPEG (8-bit; "
         "gray, YCbCr, RGB, CMYK or YCCK; sampling factors up to 4)")
ROUTES = ("pil", "cv2")

# the next marker: fill bytes (0xFF) before it, its code not 0x00 (a
# stuffed data byte) and not 0xFF
_MARKER = re.compile(rb"\xff+([^\x00\xff])")
# a stuffed 0xFF data byte in entropy-coded data (libjpeg drops any fill
# bytes before the 0x00)
_STUFFED = re.compile(rb"\xff+\x00")

_SOF_READ = (0xC0, 0xC1, 0xC2)  # SOF2: progressive
_SOF_UNSUPPORTED = {
    0xC3: "lossless JPEG (SOF3) is not read",
    0xC5: "hierarchical JPEG (SOF5) is not read",
    0xC6: "hierarchical JPEG (SOF6) is not read",
    0xC7: "hierarchical JPEG (SOF7) is not read",
    0xC9: "arithmetic-coded JPEG (SOF9) is not read",
    0xCA: "arithmetic-coded JPEG (SOF10) is not read",
    0xCB: "arithmetic-coded JPEG (SOF11) is not read",
    0xCD: "arithmetic-coded JPEG (SOF13) is not read",
    0xCE: "arithmetic-coded JPEG (SOF14) is not read",
    0xCF: "arithmetic-coded JPEG (SOF15) is not read",
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

    def __init__(self, counts: bytes, symbols: bytes, is_dc: bool):
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
        if is_dc and any(s > 15 for s in symbols):
            raise ValueError("bad Huffman table: a DC symbol above 15")
        bad = length == _BAD_CODE
        size = symbol if is_dc else symbol & 15  # a DC symbol is the size
        total = length + size
        fits = (total <= 16) | bad
        idx = np.arange(65536, dtype=np.int64)
        extra = (idx >> np.maximum(16 - total, 0)) & ((1 << size) - 1)
        value = np.where(bad, 0, _extend(extra, size))
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
def _huffman(counts: bytes, symbols: bytes, is_dc: bool) -> _Huffman:
    """Tables are cached by content (most files of one encoder share them);
    a table is never changed once built."""
    return _Huffman(counts, symbols, is_dc)


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
                 progressive: bool = False):
        self.width, self.height, self.comps = width, height, comps
        self.progressive = progressive
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
    if marker == 0xCC:
        raise ValueError("arithmetic-coded JPEG (DAC) is not read")
    if marker == 0xDC:
        raise ValueError("JPEG with a DNL marker (height 0 in its frame) is not read")


def _parse_frame(body: bytes, progressive: bool = False) -> _Frame:
    if len(body) < 6:
        raise ValueError("bad JPEG frame header")
    precision, height, width, n = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"{precision}-bit JPEG is not read; this reader takes 8-bit samples")
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
    frame = _Frame(width, height, comps, progressive)
    for c in comps:
        if frame.max_h % c.h or frame.max_v % c.v:
            raise ValueError(f"JPEG sampling factors {c.h}x{c.v} against {frame.max_h}x"
                             f"{frame.max_v} are not read: libjpeg upsamples only by "
                             "whole ratios")
    return frame


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(width, height) from the frame header of any JPEG process, as PIL's
    ``.size`` (EXIF orientation is not applied)."""
    for marker, body in _header(data, stop_at_frame=True):
        if (marker in _SOF_READ or marker in _SOF_UNSUPPORTED) and len(body) >= 5:
            precision, height, width = struct.unpack(">BHH", body[:5])
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


def _tiff_orientation(tiff: bytes) -> int:
    if tiff[:2] == b"II":
        end = "<"
    elif tiff[:2] == b"MM":
        end = ">"
    else:
        return 1
    try:
        (ifd,) = struct.unpack(end + "I", tiff[4:8])
        (count,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
        for i in range(count):
            entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
            tag, kind, n = struct.unpack(end + "HHI", entry[:8])
            if tag == 0x0112 and kind == 3:  # SHORT
                (value,) = struct.unpack(end + "H", entry[8:10])
                return value if 1 <= value <= 8 else 1
    except struct.error:
        return 1
    return 1


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
        tables[(tc, th)] = _huffman(bytes(counts), bytes(symbols), tc == 0)
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


def _scan_segments(reader: _Reader) -> List[bytes]:
    """A scan's entropy-coded data, un-stuffed: intervals split at RSTn, up
    to the next other marker (the reader is left at it)."""
    data = reader.data
    start = reader.pos
    segments = []
    while True:
        m = _MARKER.search(data, start)
        if m is None:
            raise ValueError("truncated JPEG: the file ends before its EOI marker")
        segments.append(_STUFFED.sub(b"\xff", data[start:m.start()]))
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


def _progressive_scan(reader: _Reader, body: bytes, frame: _Frame, huff, quant,
                      restart: int) -> None:
    """One scan of a progressive frame (``jdphuff.c``), which refines the
    frame's coefficient buffer in place."""
    if len(body) < 1 or len(body) < 1 + 2 * body[0] + 3:
        raise ValueError("bad JPEG scan header")
    ns = body[0]
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    dc_band = ss == 0
    if (se != 0 if dc_band else (ss > se or se > 63 or ns != 1)) \
            or (ah and al != ah - 1) or al > 13:
        raise ValueError(f"bad progressive JPEG scan: Ss {ss}, Se {se}, Ah {ah}, Al {al} "
                         f"over {ns} components")
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


def _decode(data: bytes):
    """Parse and decode a JPEG -> (frame, its upsampled component planes,
    the colour space libjpeg would guess)."""
    data = bytes(data)
    quant: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], _Huffman] = {}
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
            frame = _parse_frame(body, progressive=marker == 0xC2)
        elif marker == 0xDB:
            _quant_tables(body, quant)
        elif marker == 0xC4:
            _huffman_tables(body, huff)
        elif marker == 0xDD:
            if len(body) < 2:
                raise ValueError("bad JPEG restart interval")
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            reader, header = body
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
    image = _samples(frame, planes, space)
    if image.shape[2] == 1:
        image = np.repeat(image, 3, axis=2)
    elif image.shape[2] == 4:
        image = _cmyk_rgb(image, route)
    if route == "cv2":
        image = _orient(image, exif_orientation(data))
    return image

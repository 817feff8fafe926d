"""Transcode a Huffman JPEG into an arithmetic-coded one, as ``jpegtran
-arithmetic`` would: the same quantised coefficients, entropy-coded by
T.81 Annex D as libjpeg-turbo's ``jcarith.c`` codes them (its
``arith_encode``, ``finish_pass`` and ``emit_restart``, and the statistics
bins and conditioning of each MCU coder). Arithmetic coding is lossless
over the coefficients, so PIL and cv2 decode the result to the same bytes
as the original: the tests hold that, which checks this encoder without
the port's decoder.

No encoder installed here writes arithmetic coding; this one reads the
original's coefficients with the port's parser (``tdnet_torch/data/
jpeg.py`` ``_coefficients``) and writes SOF9 (sequential: one scan of every
component) or SOF10 (progressive, by a scan script), with optional DAC
conditioning tables and a restart interval. Used by tests/test_torch_jpeg.py
and tools/make_pages.py. Run from the repo root:

    python tools/jpeg_arith.py in.jpg out.jpg [--progressive] [--restart N]
"""

import argparse
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from tdnet_torch.data import jpeg  # noqa: E402

_QE, _NL, _NM = jpeg.ARITH_QE, jpeg.ARITH_NEXT_LPS, jpeg.ARITH_NEXT_MPS

# libjpeg's jpeg_simple_progression for three components and for one:
# (components, Ss, Se, Ah, Al)
SCRIPT_COLOUR = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                 ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                 ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                 ((0,), 1, 63, 1, 0)]
SCRIPT_GRAY = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
               ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def _simple_script(n: int):
    """The script for n components: libjpeg's for one and three, for four
    the colour script's chroma scans on each of the last three."""
    if n == 1:
        return SCRIPT_GRAY
    if n == 3:
        return SCRIPT_COLOUR
    rest = tuple(range(1, n))
    return ([(tuple(range(n)), 0, 0, 0, 1), ((0,), 1, 5, 0, 2)]
            + [((c,), 1, 63, 0, 1) for c in rest]
            + [((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), (tuple(range(n)), 0, 0, 1, 0)]
            + [((c,), 1, 63, 1, 0) for c in rest] + [((0,), 1, 63, 1, 0)])


class _Coder:
    """``jcarith.c``'s encoder state and its three routines."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _flush_stack(self):
        """Output the pending zero bytes, the buffered byte and the stacked
        0xFF bytes (each stuffed), as ``arith_encode`` does when a byte
        below 0xFF arrives."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self.out += bytes(self.zc)
            self.zc = 0
            self.out.append(self.buffer)
        if self.sc:
            self.out += bytes(self.zc)
            self.zc = 0
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self):
        """A carry into the buffered byte: stacked 0xFF bytes become 0x00."""
        if self.buffer >= 0:
            self.out += bytes(self.zc)
            self.zc = 0
            self.out.append(self.buffer + 1)
            if self.buffer + 1 == 0xFF:
                self.out.append(0)
        self.zc += self.sc
        self.sc = 0

    def encode(self, st, i: int, val: int):
        sv = st[i]
        k = sv & 0x7F
        qe = _QE[k]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ _NL[k]
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ _NM[k]
        while True:  # renormalisation and output (section D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stack()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        """``finish_pass``: the value of the interval with the most trailing
        zero bits, its remaining bytes (final zero bytes left out)."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._flush_stack()
        if self.c & 0x7FFF800:
            self.out += bytes(self.zc)
            self.zc = 0
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if self.c & mask:
                    byte = (self.c >> shift) & 0xFF
                    self.out.append(byte)
                    if byte == 0xFF:
                        self.out.append(0)


def _dc_diff(coder, st, s0, v, lower, upper):
    """Figures F.4 and F.6-F.9: one DC difference -> the next context."""
    if v == 0:
        coder.encode(st, s0, 0)
        return 0
    coder.encode(st, s0, 1)
    if v > 0:
        coder.encode(st, s0 + 1, 0)
        i, context = s0 + 2, 4
    else:
        v = -v
        coder.encode(st, s0 + 1, 1)
        i, context = s0 + 3, 8
    m = 0
    v -= 1
    if v:
        coder.encode(st, i, 1)
        m, v2, i = 1, v, 20
        while v2 > 1:
            v2 >>= 1
            coder.encode(st, i, 1)
            m <<= 1
            i += 1
    coder.encode(st, i, 0)
    if m < (1 << lower) >> 1:
        context = 0
    elif m > (1 << upper) >> 1:
        context += 8
    i += 14
    while m > 1:
        m >>= 1
        coder.encode(st, i, 1 if m & v else 0)
    return context


def _ac_magnitude(coder, st, i, k, v, kk):
    """Figures F.8-F.9 for |v| >= 1 at zigzag k, bins from i + 2."""
    i += 2
    m = 0
    v -= 1
    if v:
        coder.encode(st, i, 1)
        m, v2 = 1, v >> 1
        if v2:
            coder.encode(st, i, 1)
            m <<= 1
            i = 189 if k <= kk else 217
            while v2 > 1:
                v2 >>= 1
                coder.encode(st, i, 1)
                m <<= 1
                i += 1
    coder.encode(st, i, 0)
    i += 14
    while m > 1:
        m >>= 1
        coder.encode(st, i, 1 if m & v else 0)


def _sequential(coder, blocks, coefs, stats, dac):
    """``encode_mcu``."""
    dc_stats, ac_stats, fixed = stats
    lower, upper, kks = dac
    last, context = [0] * 4, [0] * 4
    for base, td, ta, ci in blocks:
        dc = coefs[base]
        context[ci] = _dc_diff(coder, dc_stats[td], context[ci], dc - last[ci], lower[td],
                               upper[td])
        last[ci] = dc
        st, kk = ac_stats[ta], kks[ta]
        ke = 63
        while ke and not coefs[base + ke]:
            ke -= 1
        k = 0
        while k < ke:
            i = 3 * k
            coder.encode(st, i, 0)
            k += 1
            while coefs[base + k] == 0:
                coder.encode(st, i + 1, 0)
                i += 3
                k += 1
            coder.encode(st, i + 1, 1)
            v = coefs[base + k]
            coder.encode(fixed, 0, 0 if v > 0 else 1)
            _ac_magnitude(coder, st, i, k, abs(v), kk)
        if k < 63:  # no end of block after the last coefficient
            coder.encode(st, 3 * k, 1)


def _shifted(v: int, al: int) -> int:
    """An AC coefficient after the point transform: rounded toward 0."""
    return v >> al if v >= 0 else -((-v) >> al)


def _dc_first(coder, blocks, coefs, stats, dac, al):
    dc_stats = stats[0]
    lower, upper, _ = dac
    last, context = [0] * 4, [0] * 4
    for base, td, _, ci in blocks:
        m = coefs[base] >> al
        context[ci] = _dc_diff(coder, dc_stats[td], context[ci], m - last[ci], lower[td],
                               upper[td])
        last[ci] = m


def _dc_refine(coder, blocks, coefs, stats, al):
    for base, _, _, _ in blocks:
        coder.encode(stats[2], 0, (coefs[base] >> al) & 1)


def _ac_first(coder, blocks, coefs, stats, dac, ss, se, al):
    _, ac_stats, fixed = stats
    for base, _, ta, _ in blocks:
        st, kk = ac_stats[ta], dac[2][ta]
        ke = se
        while ke > 0 and not _shifted(coefs[base + ke], al):
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            coder.encode(st, i, 0)
            while True:
                v = _shifted(coefs[base + k], al)
                if v:
                    coder.encode(st, i + 1, 1)
                    coder.encode(fixed, 0, 0 if v > 0 else 1)
                    break
                coder.encode(st, i + 1, 0)
                i += 3
                k += 1
            _ac_magnitude(coder, st, i, k, abs(v), kk)
            k += 1
        if k <= se:
            coder.encode(st, 3 * (k - 1), 1)


def _ac_refine(coder, blocks, coefs, stats, ss, se, ah, al):
    _, ac_stats, fixed = stats
    for base, _, ta, _ in blocks:
        st = ac_stats[ta]
        ke = se
        while ke > 0 and not _shifted(coefs[base + ke], al):
            ke -= 1
        kex = ke
        while kex > 0 and not _shifted(coefs[base + kex], ah):
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                coder.encode(st, i, 0)
            while True:
                v = abs(_shifted(coefs[base + k], al))
                if v:
                    if v >> 1:  # nonzero at an earlier stage: its next bit
                        coder.encode(st, i + 2, v & 1)
                    else:  # newly nonzero
                        coder.encode(st, i + 1, 1)
                        coder.encode(fixed, 0, 0 if coefs[base + k] > 0 else 1)
                    break
                coder.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            coder.encode(st, 3 * (k - 1), 1)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _scan(frame, comps, ss, se, ah, al, restart, dac, coefs, progressive) -> bytes:
    """One scan: its header and arithmetic-coded data, a restart marker
    between intervals."""
    header = bytes([len(comps)])
    for c in comps:
        header += bytes([c.id, (c.tq << 4) | c.tq])  # conditioning tables: the quant id
    header += bytes([ss, se, (ah << 4) | al])
    slots, per_mcu, index = jpeg._scan_order(frame, comps)
    blocks = [(slot, comps[index[j % per_mcu]].tq, comps[index[j % per_mcu]].tq,
               index[j % per_mcu]) for j, slot in enumerate(slots)]
    n_mcus = len(slots) // per_mcu
    step = restart or n_mcus
    coder = _Coder()
    for n, first in enumerate(range(0, n_mcus, step)):
        if n:
            coder.finish()
            coder.out += bytes([0xFF, 0xD0 + (n - 1) % 8])
            coder.reset()
        part = blocks[first * per_mcu:(first + step) * per_mcu]
        stats = ([bytearray(64) for _ in range(16)], [bytearray(256) for _ in range(16)],
                 bytearray([jpeg.ARITH_FIXED]))
        if not progressive:
            _sequential(coder, part, coefs, stats, dac)
        elif ss == 0 and ah == 0:
            _dc_first(coder, part, coefs, stats, dac, al)
        elif ss == 0:
            _dc_refine(coder, part, coefs, stats, al)
        elif ah == 0:
            _ac_first(coder, part, coefs, stats, dac, ss, se, al)
        else:
            _ac_refine(coder, part, coefs, stats, ss, se, ah, al)
    coder.finish()
    return _segment(0xDA, header) + bytes(coder.out)


def transcode(data: bytes, progressive: bool = False, restart: int = 0, dac=None,
              script=None) -> bytes:
    """A Huffman JPEG -> the same coefficients arithmetic-coded: SOF9, or
    SOF10 by ``script`` (default: libjpeg's simple progression). ``dac``:
    {table: (L, U)} for DC and {16 + table: K} for AC conditioning, written
    in a DAC segment; each component codes with the tables of its
    quantisation table's id. The original's APPn and COM segments before
    its frame are kept."""
    frame, _, _ = jpeg._coefficients(data)
    coefs = [int(v) for v in frame.coefs]
    comps = frame.comps
    out = bytearray(b"\xff\xd8")
    for marker, body in jpeg._header(bytes(data), stop_at_frame=True):
        if 0xE0 <= marker <= 0xEF or marker == 0xFE:
            out += _segment(marker, body)
    for tq in sorted({c.tq for c in comps}):
        q = next(c.quant for c in comps if c.tq == tq)[jpeg._NATURAL]
        wide = int(q.max()) > 255
        out += _segment(0xDB, bytes([(wide << 4) | tq])
                        + q.astype(">u2" if wide else np.uint8).tobytes())
    sof = struct.pack(">BHHB", 8, frame.height, frame.width, len(comps))
    sof += b"".join(bytes([c.id, (c.h << 4) | c.v, c.tq]) for c in comps)
    out += _segment(0xCA if progressive else 0xC9, sof)
    tables = ([0] * 16, [1] * 16, [5] * 16)
    if dac:
        body = b""
        for index, value in sorted(dac.items()):
            if index >= 16:
                tables[2][index - 16] = value
                body += bytes([index, value])
            else:
                tables[0][index], tables[1][index] = value
                body += bytes([index, (value[1] << 4) | value[0]])
        out += _segment(0xCC, body)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    if not progressive:
        groups = [comps] if len(comps) == 1 or sum(c.h * c.v for c in comps) <= 10 \
            else [[c] for c in comps]
        for group in groups:
            out += _scan(frame, group, 0, 63, 0, 0, restart, tables, coefs, False)
    else:
        script = script or _simple_script(len(comps))
        for members, ss, se, ah, al in script:
            out += _scan(frame, [comps[i] for i in members], ss, se, ah, al, restart, tables,
                         coefs, True)
    return bytes(out + b"\xff\xd9")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src")
    parser.add_argument("dst")
    parser.add_argument("--progressive", action="store_true")
    parser.add_argument("--restart", type=int, default=0)
    args = parser.parse_args()
    with open(args.src, "rb") as f:
        data = transcode(f.read(), args.progressive, args.restart)
    with open(args.dst, "wb") as f:
        f.write(data)


if __name__ == "__main__":
    main()

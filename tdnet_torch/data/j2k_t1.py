"""JPEG 2000 tier 1 (EBCOT, ISO/IEC 15444-1 Annex C and D) in Python, as
OpenJPEG 2.5 decodes a code-block (``t1.c``, ``mqc.c``): both reference
routes (PIL and cv2) read JPEG 2000 through OpenJPEG.

:func:`decode_block` takes a code-block's coded segments and returns its
coefficients in OpenJPEG's form: each magnitude carries one bit below the
last decoded bit-plane, set as the mid-point of what is still unknown
(``oneplushalf`` on becoming significant, ``poshalf`` up or down on each
refinement), so a code-block cut short by rate layers is reconstructed
half-way, and the reversible path halves the values afterwards
(``j2k_dwt.py``).

- The MQ decoder: the 47 states of Table C.2, 19 contexts (zero coding
  0-8, sign 9-13, refinement 14-16, run 17, uniform 18) reset to their
  initial states, OpenJPEG's ``BYTEIN`` (after a 0xFF byte a byte above
  0x8F is a marker: ones are fed and the pointer stays) and the two 0xFF
  bytes it writes after each segment's data, so a decoder that runs off
  the end reads ones.
- The three passes in stripes of four rows, column by column:
  significance propagation, magnitude refinement and cleanup with its
  run mode (a full column of four whose coefficients and neighbours are
  all insignificant is coded by one run decision and, if it breaks, two
  uniform decisions for its first significant row).
- The code-block styles of COD/COC: BYPASS (raw bits for the
  significance and refinement passes from the fifth bit-plane of the
  block on), RESET (contexts reset after each pass), TERMALL (each pass
  its own segment), VSC (the row below a stripe is not seen), PTERM
  (checks only) and SEGSYM (four uniform decisions after each cleanup
  pass, read and not checked).
- The ROI max-shift (``RGN``): magnitudes at or above ``1 << roishift``
  are shifted down, after the passes.

The decoder keeps a padded (h + 2) x (w + 2) flag list: the eight
neighbours' significance (bits 0-7), the four direct neighbours' signs
(bits 8-11) and the coefficient's own state; and each stripe's busy
columns, those with a significant coefficient in their 4 x 3
neighbourhood. The first pass visits only these, the refinement pass a
sorted list of the significant coefficients, and the cleanup pass decodes
a run of idle columns by run decisions, several at a time while the run
context stays on its MPS. The MQ registers live in the passes' locals,
the decision's common case decoded inline.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["decode_block", "BYPASS", "RESET", "TERMALL", "VSC", "PTERM", "SEGSYM"]

# code-block style bits (SPcod / SPcoc)
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32

# Table C.2: Qe, next index on MPS and on LPS, and whether the LPS switches
# the sense of the MPS
_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
       0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
       0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
       0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
       0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23,
         24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44,
         45, 45, 46)
_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19,
         20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
         41, 42, 43, 46)
_SWITCH = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1) + (0,) * 32

# a context's state is 2 * index + mps; per state: Qe, mps, and the states
# after an MPS and after an LPS exchange
QE = [_QE[s >> 1] for s in range(94)]
MPS = [s & 1 for s in range(94)]
NEXT_MPS = [2 * _NMPS[s >> 1] + (s & 1) for s in range(94)]
NEXT_LPS = [2 * _NLPS[s >> 1] + ((s & 1) ^ _SWITCH[s >> 1]) for s in range(94)]
QE16 = [q << 16 for q in QE]

_UNI, _AGG = 18, 17
# initial states: uniform at index 46, run at 3, the first zero context at 4
_RESET = [0] * 19
_RESET[_UNI], _RESET[_AGG], _RESET[0] = 2 * 46, 2 * 3, 2 * 4

# flag bits: neighbour significance (as seen from the coefficient) ...
_NW, _N, _NE, _W, _E, _SW, _S, _SE = 1, 2, 4, 8, 16, 32, 64, 128
# ... the direct neighbours' signs, and the coefficient's own state
_WNEG, _ENEG, _NNEG, _SNEG = 256, 512, 1024, 2048
_SIG, _PI, _MU = 4096, 8192, 16384
_SOUTH = _SW | _S | _SE | _SNEG
_NEIGHBOURS = 0xFF


def _zc_lut(orient: int) -> List[int]:
    """Table D.1: the zero-coding context from the eight neighbours, by
    band orientation (0 LL, 1 HL, 2 LH, 3 HH)."""
    out = []
    for f in range(256):
        h = bool(f & _W) + bool(f & _E)
        v = bool(f & _N) + bool(f & _S)
        d = bool(f & _NW) + bool(f & _NE) + bool(f & _SW) + bool(f & _SE)
        if orient == 1:
            h, v = v, h
        if orient == 3:
            hv = h + v
            n = (8 if d >= 3 else 7 if d == 2 and hv >= 1 else 6 if d == 2 else
                 5 if d == 1 and hv >= 2 else 4 if d == 1 and hv == 1 else 3 if d == 1 else
                 2 if hv >= 2 else 1 if hv == 1 else 0)
        elif h == 2:
            n = 8
        elif h == 1:
            n = 7 if v else 6 if d else 5
        else:
            n = 4 if v == 2 else 3 if v == 1 else 2 if d >= 2 else 1 if d == 1 else 0
        out.append(n)
    return out


ZC = [_zc_lut(o) for o in range(4)]


def _sc_lut() -> List[Tuple[int, int]]:
    """Tables D.2 and D.3: the sign context and its XOR bit from the direct
    neighbours' significance and signs, indexed by ``flags & 0xF5A``."""
    out = [(9, 0)] * 4096
    for f in range(4096):
        if f & ~0xF5A:
            continue

        def part(sig_a, neg_a, sig_b, neg_b):
            s = (0 if not f & sig_a else -1 if f & neg_a else 1) + \
                (0 if not f & sig_b else -1 if f & neg_b else 1)
            return max(-1, min(1, s))

        h = part(_W, _WNEG, _E, _ENEG)
        v = part(_N, _NNEG, _S, _SNEG)
        if h < 0 or (h == 0 and v < 0):
            h, v, xor = -h, -v, 1
        else:
            xor = 0
        ctx = {(1, 1): 13, (1, 0): 12, (1, -1): 11, (0, 1): 10, (0, 0): 9}[(h, v)]
        out[f] = (ctx, xor)
    return out


_SC = _sc_lut()
SC_CTX = [c for c, _ in _SC]
SC_XOR = [x for _, x in _SC]


class _Shape:
    """Per code-block size: the scan order of the padded (h + 2) x (w + 2)
    positions (stripe, then column, then row) and the columns each
    position's significance makes busy."""

    def __init__(self, w: int, h: int):
        W = w + 2
        self.w, self.h, self.W = w, h, W
        size = W * (h + 2)
        self.key = [-1] * size  # scan order of each position
        self.rows = [min(4, h - y0) for y0 in range(0, h, 4)]
        for y in range(h):
            s, r = divmod(y, 4)
            for x in range(w):
                p = (y + 1) * W + x + 1
                self.key[p] = (s * w + x) * 4 + r
        self.pos = [0] * (4 * w * len(self.rows))
        for p, k in enumerate(self.key):
            if k >= 0:
                self.pos[k] = p
        # the busy columns a significant coefficient makes: its own stripe's
        # columns x - 1 to x + 1, the stripe above's from row 0 (not under
        # VSC) and the stripe below's from row 3
        self.marks = [()] * size
        self.marks_vsc = [()] * size
        n = len(self.rows)
        for y in range(h):
            s, r = divmod(y, 4)
            for x in range(w):
                p = (y + 1) * W + x + 1
                lo, hi = max(x - 1, 0), min(x + 2, w)
                ones = b"\x01" * (hi - lo)
                own = [(s * w + lo, s * w + hi, ones)]
                below = [((s + 1) * w + lo, (s + 1) * w + hi, ones)] if r == 3 and s + 1 < n \
                    else []
                above = [((s - 1) * w + lo, (s - 1) * w + hi, ones)] if r == 0 and s else []
                self.marks[p] = tuple(own + above + below)
                self.marks_vsc[p] = tuple(own + below)


_SHAPES = {}


def _shape(w: int, h: int) -> _Shape:
    if (w, h) not in _SHAPES:
        _SHAPES[(w, h)] = _Shape(w, h)
    return _SHAPES[(w, h)]


def _raw_decoder(seg: bytes):
    """OpenJPEG's raw (BYPASS) bit reader over one segment
    (``opj_mqc_raw_decode``)."""
    src = bytes(seg) + b"\xff\xff"
    c = ct = bp = 0

    def bit() -> int:
        nonlocal c, ct, bp
        if ct == 0:
            if c == 0xFF:
                if src[bp] > 0x8F:
                    c, ct = 0xFF, 8
                else:
                    c, ct, bp = src[bp], 7, bp + 1
            else:
                c, ct, bp = src[bp], 8, bp + 1
        ct -= 1
        return (c >> ct) & 1

    return bit


class _MQ:
    """OpenJPEG's MQ decoder over one segment (``opj_mqc_init_dec``: the
    data followed by two 0xFF bytes, ``BYTEIN`` stopping on them), its
    contexts' states in ``ctx``. The passes keep the A and C registers in
    locals and decode the common case inline: an MPS that needs no
    renormalisation (``(C >> 16) >= Qe`` and A still at least 0x8000 after
    ``A -= Qe``); :meth:`slow` does the rest of ``opj_mqc_decode_macro``."""

    __slots__ = ("src", "a", "c", "ct", "bp", "ctx")

    def __init__(self, seg: bytes, ctx: List[int]):
        self.src = bytes(seg) + b"\xff\xff"
        self.ctx = ctx
        self.bp = 0
        self.c = (self.src[0] << 16) if len(seg) else 0xFF << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self) -> None:
        src, bp = self.src, self.bp
        nxt = src[bp + 1]
        if src[bp] == 0xFF:
            if nxt > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += nxt << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c += nxt << 8
            self.ct = 8

    def slow(self, cx: int, s: int, qe: int, a: int, c: int):
        """The decision in context cx (state s) once A has had Qe taken
        off, when it is not the inline MPS: -> (bit, A, C)."""
        ctx = self.ctx
        if (c >> 16) < qe:
            if a < qe:
                d = s & 1
                ctx[cx] = NEXT_MPS[s]
            else:
                d = 1 - (s & 1)
                ctx[cx] = NEXT_LPS[s]
            a = qe
        else:
            c -= qe << 16
            if a >= 0x8000:
                return s & 1, a, c
            if a < qe:
                d = 1 - (s & 1)
                ctx[cx] = NEXT_LPS[s]
            else:
                d = s & 1
                ctx[cx] = NEXT_MPS[s]
        ct = self.ct
        while True:  # RENORMD
            if ct == 0:
                self.c, self.ct = c, 0
                self._bytein()
                c, ct = self.c, self.ct
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a >= 0x8000:
                self.ct = ct
                return d, a, c

    def decode(self, cx: int) -> int:
        """One decision, the registers kept in the object."""
        s = self.ctx[cx]
        qe = QE[s]
        a, c = self.a - qe, self.c
        if c >= QE16[s] and a >= 0x8000:
            self.a, self.c = a, c - QE16[s]
            return s & 1
        d, self.a, self.c = self.slow(cx, s, qe, a, c)
        return d

    def skip_mps(self, cx: int, k: int) -> int:
        """Up to k decisions in context cx while each is its MPS on the
        fast path (so the context's state stays): -> how many."""
        qe = QE[self.ctx[cx]]
        m = min(k, (self.a - 0x8000) // qe, self.c // (qe << 16))
        if m <= 0:
            return 0
        self.a -= m * qe
        self.c -= m * (qe << 16)
        return m


class _State:
    """A code-block's coefficients and flags while its passes run, and for
    each stripe which columns are busy: hold a significant coefficient in
    their 4 x 3 neighbourhood (the columns a cleanup pass leaves out of
    its run mode, and the only ones the first two passes can code)."""

    def __init__(self, shape: _Shape, orient: int, vsc: bool):
        size = shape.W * (shape.h + 2)
        self.shape = shape
        self.flags = flags = [0] * size
        self.data = data = [0] * size
        self.zc = ZC[orient]
        self.vsc = vsc
        self.rmask = (-1, -1, -1, ~_SOUTH if vsc else -1)  # VSC: row 3 sees no south
        self.sig_keys: List[int] = []  # scan keys of significant positions, sorted
        self.new_keys: List[int] = []  # those that became significant since
        w = shape.w
        self.busy = busy = bytearray(w * len(shape.rows))  # stripe s, column x: s * w + x
        for i, rows in enumerate(shape.rows):
            if rows < 4:  # no run mode in a partial stripe
                busy[i * w:(i + 1) * w] = b"\x01" * w
        marks = shape.marks_vsc if vsc else shape.marks
        key, add, W = shape.key, self.new_keys.append, shape.W

        def significant(p: int, neg: int, value: int) -> None:
            """Coefficient p becomes significant with sign ``neg``: its
            value, its neighbours' flags (``opj_t1_update_flags``) and the
            busy columns."""
            flags[p] |= _SIG
            up, down = p - W, p + W
            flags[up - 1] |= _SE
            flags[up + 1] |= _SW
            flags[down - 1] |= _NE
            flags[down + 1] |= _NW
            if neg:
                data[p] = -value
                flags[up] |= _S | _SNEG
                flags[down] |= _N | _NNEG
                flags[p - 1] |= _E | _ENEG
                flags[p + 1] |= _W | _WNEG
            else:
                data[p] = value
                flags[up] |= _S
                flags[down] |= _N
                flags[p - 1] |= _E
                flags[p + 1] |= _W
            add(key[p])
            for lo, hi, ones in marks[p]:
                busy[lo:hi] = ones

        self.significant = significant


def decode_block(segments: Sequence[Tuple[bytes, int]], w: int, h: int, numbps: int,
                 orient: int, style: int, roishift: int = 0) -> np.ndarray:
    """One code-block: ``segments`` its (data, number of passes) in order,
    ``numbps`` its magnitude bit-planes (Mb less the zero bit-planes),
    ``orient`` its band (0 LL, 1 HL, 2 LH, 3 HH) -> (h, w) int32
    coefficients in OpenJPEG's doubled form (see the module docstring)."""
    shape = _shape(w, h)
    st = _State(shape, orient, bool(style & VSC))
    bpno = roishift + numbps  # OpenJPEG's bpno_plus_one
    if bpno >= 31:
        raise ValueError(f"JPEG 2000 code-block of {bpno} bit-planes (OpenJPEG reads up to 30)")
    passtype = 2
    ctx = list(_RESET)
    for seg_data, seg_passes in segments:
        raw = bool(style & BYPASS) and passtype < 2 and bpno <= numbps - 4
        mq = _raw_decoder(seg_data) if raw else _MQ(seg_data, ctx)
        for _ in range(seg_passes):
            if bpno < 1:
                break
            if passtype == 0:
                (_sigpass_raw if raw else _sigpass)(st, mq, bpno)
            elif passtype == 1:
                (_refpass_raw if raw else _refpass)(st, mq, bpno)
            else:
                _clnpass(st, mq, bpno, style & SEGSYM)
            if style & RESET and not raw:
                ctx[:] = _RESET
            passtype += 1
            if passtype == 3:
                passtype, bpno = 0, bpno - 1
    out = np.asarray(st.data, np.int64).reshape(h + 2, w + 2)[1:-1, 1:-1]
    if roishift:
        mag = np.abs(out)
        big = mag >= (1 << roishift)
        out = np.where(big, np.sign(out) * (mag >> roishift), out)
    return out.astype(np.int32)


def _sigpass(st: _State, mq: _MQ, bpno: int) -> None:
    """Significance propagation: the busy columns in scan order, each
    coefficient not significant with a significant neighbour."""
    one = 1 << bpno
    oneplushalf = one | (one >> 1)
    shape = st.shape
    flags, zc, rmask, busy = st.flags, st.zc, st.rmask, st.busy
    significant, ctx, slow = st.significant, mq.ctx, mq.slow
    qe_of, qe16_of, sc_ctx, sc_xor = QE, QE16, SC_CTX, SC_XOR
    coded, pi = _SIG | _PI, _PI
    W, w = shape.W, shape.w
    a, c = mq.a, mq.c
    for s, rows in enumerate(shape.rows):
        top0 = (4 * s + 1) * W + 1 - s * w
        end = (s + 1) * w
        every = busy.find(0, s * w, end) < 0  # all busy: step, no search
        i = busy.find(1, s * w, end)
        while i >= 0:
            p = top0 + i
            for r in range(rows):
                f = flags[p] & rmask[r]
                if not f & coded and f & 0xFF:
                    cx = zc[f & 0xFF]
                    q = ctx[cx]
                    qe = qe_of[q]
                    a -= qe
                    if c >= qe16_of[q] and a >= 0x8000:
                        c -= qe16_of[q]
                        d = q & 1
                    else:
                        d, a, c = slow(cx, q, qe, a, c)
                    if d:
                        lu = f & 0xF5A
                        cx = sc_ctx[lu]
                        q = ctx[cx]
                        qe = qe_of[q]
                        a -= qe
                        if c >= qe16_of[q] and a >= 0x8000:
                            c -= qe16_of[q]
                            d = q & 1
                        else:
                            d, a, c = slow(cx, q, qe, a, c)
                        significant(p, d ^ sc_xor[lu], oneplushalf)
                    flags[p] |= pi
                p += W
            i = (i + 1 if i + 1 < end else -1) if every else busy.find(1, i + 1, end)
    mq.a, mq.c = a, c


def _sigpass_raw(st: _State, bit, bpno: int) -> None:
    """Significance propagation from raw bits (BYPASS)."""
    one = 1 << bpno
    oneplushalf = one | (one >> 1)
    shape = st.shape
    flags, rmask, busy = st.flags, st.rmask, st.busy
    W, w = shape.W, shape.w
    for s, rows in enumerate(shape.rows):
        top0 = (4 * s + 1) * W + 1 - s * w
        end = (s + 1) * w
        i = busy.find(1, s * w, end)
        while i >= 0:
            p = top0 + i
            for r in range(rows):
                f = flags[p] & rmask[r]
                if not f & (_SIG | _PI) and f & _NEIGHBOURS:
                    if bit():
                        st.significant(p, bit(), oneplushalf)
                    flags[p] |= _PI
                p += W
            i = busy.find(1, i + 1, end)


def _refine_order(st: _State) -> List[int]:
    if st.new_keys:
        st.new_keys.sort()
        st.sig_keys = sorted(st.sig_keys + st.new_keys)
        st.new_keys.clear()
    return st.sig_keys


def _refpass(st: _State, mq: _MQ, bpno: int) -> None:
    """Magnitude refinement of the coefficients significant before this
    bit-plane, in scan order."""
    poshalf = (1 << bpno) >> 1
    flags, data, pos, rmask = st.flags, st.data, st.shape.pos, st.rmask
    ctx, slow, qe_of, qe16_of = mq.ctx, mq.slow, QE, QE16
    pi, mu = _PI, _MU
    a, c = mq.a, mq.c
    for k in _refine_order(st):
        p = pos[k]
        f = flags[p]
        if f & pi:
            continue
        cx = 16 if f & mu else 15 if f & rmask[k & 3] & 0xFF else 14
        q = ctx[cx]
        qe = qe_of[q]
        a -= qe
        if c >= qe16_of[q] and a >= 0x8000:
            c -= qe16_of[q]
            d = q & 1
        else:
            d, a, c = slow(cx, q, qe, a, c)
        if d ^ (data[p] < 0):
            data[p] += poshalf
        else:
            data[p] -= poshalf
        flags[p] = f | mu
    mq.a, mq.c = a, c


def _refpass_raw(st: _State, bit, bpno: int) -> None:
    """Magnitude refinement from raw bits (BYPASS)."""
    poshalf = (1 << bpno) >> 1
    flags, data, pos = st.flags, st.data, st.shape.pos
    for k in _refine_order(st):
        p = pos[k]
        f = flags[p]
        if f & _PI:
            continue
        if bit() ^ (data[p] < 0):
            data[p] += poshalf
        else:
            data[p] -= poshalf
        flags[p] = f | _MU


def _clnpass(st: _State, mq: _MQ, bpno: int, segsym: int) -> None:
    """Cleanup: every position not yet coded in this bit-plane, column by
    column; a run of idle columns is decoded by run decisions, several at
    a time while the run context stays on its MPS (0)."""
    one = 1 << bpno
    oneplushalf = one | (one >> 1)
    shape = st.shape
    flags, zc, rmask, busy = st.flags, st.zc, st.rmask, st.busy
    significant, ctx, slow = st.significant, mq.ctx, mq.slow
    qe_of, qe16_of, sc_ctx, sc_xor = QE, QE16, SC_CTX, SC_XOR
    pi, not_pi, sig = _PI, ~_PI, _SIG
    W, w = shape.W, shape.w
    a, c = mq.a, mq.c
    for s, rows in enumerate(shape.rows):
        base, end = s * w, (s + 1) * w
        top0 = (4 * s + 1) * W + 1 - base
        x = base
        while x < end:
            start = 0
            if not busy[x]:
                stop = busy.find(1, x, end)
                if stop < 0:
                    stop = end
                mq.a, mq.c = a, c
                while x < stop:  # a run of idle columns
                    if not ctx[_AGG] & 1:  # its MPS is 0
                        x += mq.skip_mps(_AGG, stop - x)
                        if x >= stop:
                            break
                    if mq.decode(_AGG):
                        start = mq.decode(_UNI) << 1
                        start |= mq.decode(_UNI)
                        break
                    x += 1
                a, c = mq.a, mq.c
                if x >= stop:
                    continue
                # the run broke at row ``start`` of column x: its sign next
                p = top0 + x + start * W
                lu = flags[p] & rmask[start] & 0xF5A
                cx = SC_CTX[lu]
                q = ctx[cx]
                qe = QE[q]
                a -= qe
                if c >= QE16[q] and a >= 0x8000:
                    c -= QE16[q]
                    d = q & 1
                else:
                    d, a, c = slow(cx, q, qe, a, c)
                significant(p, d ^ SC_XOR[lu], oneplushalf)
                start += 1
            p = top0 + x + start * W
            for r in range(start, rows):
                f = flags[p]
                if f & pi:  # coded by the first pass: the flag is cleared for the next plane
                    flags[p] = f & not_pi
                elif not f & sig:
                    f &= rmask[r]
                    cx = zc[f & 0xFF]
                    q = ctx[cx]
                    qe = qe_of[q]
                    a -= qe
                    if c >= qe16_of[q] and a >= 0x8000:
                        c -= qe16_of[q]
                        d = q & 1
                    else:
                        d, a, c = slow(cx, q, qe, a, c)
                    if d:
                        lu = f & 0xF5A
                        cx = sc_ctx[lu]
                        q = ctx[cx]
                        qe = qe_of[q]
                        a -= qe
                        if c >= qe16_of[q] and a >= 0x8000:
                            c -= qe16_of[q]
                            d = q & 1
                        else:
                            d, a, c = slow(cx, q, qe, a, c)
                        significant(p, d ^ sc_xor[lu], oneplushalf)
                p += W
            x += 1
    mq.a, mq.c = a, c
    if segsym:
        for _ in range(4):
            mq.decode(_UNI)

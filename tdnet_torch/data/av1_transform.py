"""AV1 inverse transforms (specification section 7.13), vectorised in numpy
over the rows (then the columns) of one transform block: DCT of 4 to 64
points, ADST of 4, 8 and 16 points, identity of 4 to 32 and the Walsh-
Hadamard transform of lossless blocks, with the row and column shifts,
the intermediate clamps and the rectangular scaling of the 2-D process.

A 1-D transform works on a list of ``n`` int64 arrays, one a coefficient
position, each holding that position across the rows being transformed.
"""

from __future__ import annotations

import numpy as np

from tdnet_torch.data import av1_tables as T

__all__ = ["inverse_transform_2d", "ROW_SHIFT"]

# Cos128_Lookup: cos(k * pi / 128) in Q12, k = 0..64
_COS128 = [int(v) for v in T.COSPI[2]] + [0]
_SINPI = [int(v) for v in T.SINPI[2]]  # 0, sin(pi/9), sin(2pi/9), ... in Q12
ROW_SHIFT = (0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2)

DCT, ADST, IDENTITY = 0, 1, 2
# the 1-D transforms of each transform type: (vertical, horizontal)
TYPE_1D = (
    (DCT, DCT), (ADST, DCT), (DCT, ADST), (ADST, ADST), (ADST, DCT), (DCT, ADST),
    (ADST, ADST), (ADST, ADST), (ADST, ADST), (IDENTITY, IDENTITY), (DCT, IDENTITY),
    (IDENTITY, DCT), (ADST, IDENTITY), (IDENTITY, ADST), (ADST, IDENTITY),
    (IDENTITY, ADST))
FLIP_UD = frozenset((4, 6, 8, 14))  # FLIPADST_DCT, FLIPADST_FLIPADST, FLIPADST_ADST, V_FLIPADST
FLIP_LR = frozenset((5, 6, 7, 15))  # DCT_FLIPADST, FLIPADST_FLIPADST, ADST_FLIPADST, H_FLIPADST


def _cos128(angle: int) -> int:
    a = angle & 255
    if a <= 64:
        return _COS128[a]
    if a <= 128:
        return -_COS128[128 - a]
    if a <= 192:
        return -_COS128[a - 128]
    return _COS128[256 - a]


def _sin128(angle: int) -> int:
    return _cos128(angle - 64)


def _brev(n: int, x: int) -> int:
    r = 0
    for i in range(n):
        if x & (1 << i):
            r |= 1 << (n - 1 - i)
    return r


def _b(t, a, b, angle, flip):
    c, s = _cos128(angle), _sin128(angle)
    x = t[a] * c - t[b] * s
    y = t[a] * s + t[b] * c
    x = (x + 2048) >> 12
    y = (y + 2048) >> 12
    if flip:
        t[a], t[b] = y, x
    else:
        t[a], t[b] = x, y


def _h(t, a, b, flip):
    if flip:
        a, b = b, a
    x, y = t[a], t[b]
    t[a], t[b] = x + y, x - y


def _dct_program(n: int):
    """The butterfly steps of the inverse DCT of 2^n points: ('B', a, b,
    angle, flip) and ('H', a, b, flip), in order."""
    p = []
    B = lambda a, b, ang, f: p.append(("B", a, b, ang, f))  # noqa: E731
    H = lambda a, b, f: p.append(("H", a, b, f))  # noqa: E731
    if n == 6:
        for i in range(16):
            B(32 + i, 63 - i, 63 - 4 * _brev(4, i), 0)
    if n >= 5:
        for i in range(8):
            B(16 + i, 31 - i, 6 + (_brev(3, 7 - i) << 3), 0)
    if n == 6:
        for i in range(16):
            H(32 + i * 2, 33 + i * 2, i & 1)
    if n >= 4:
        for i in range(4):
            B(8 + i, 15 - i, 12 + (_brev(2, 3 - i) << 4), 0)
    if n >= 5:
        for i in range(8):
            H(16 + 2 * i, 17 + 2 * i, i & 1)
    if n == 6:
        for i in range(4):
            for j in range(2):
                B(62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * _brev(2, i) + 64 * j, 1)
    if n >= 3:
        for i in range(2):
            B(4 + i, 7 - i, 56 - 32 * i, 0)
    if n >= 4:
        for i in range(4):
            H(8 + 2 * i, 9 + 2 * i, i & 1)
    if n >= 5:
        for i in range(2):
            for j in range(2):
                B(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1)
    if n == 6:
        for i in range(8):
            for j in range(2):
                H(32 + i * 4 + j, 35 + i * 4 - j, i & 1)
    for i in range(2):
        B(2 * i, 2 * i + 1, 32 + 16 * i, 1 - i)
    if n >= 3:
        for i in range(2):
            H(4 + 2 * i, 5 + 2 * i, i)
    if n >= 4:
        for i in range(2):
            B(14 - i, 9 + i, 48 + 64 * i, 1)
    if n >= 5:
        for i in range(4):
            for j in range(2):
                H(16 + 4 * i + j, 19 + 4 * i - j, i & 1)
    if n == 6:
        for i in range(2):
            for j in range(4):
                B(61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1)
    for i in range(2):
        H(i, 3 - i, 0)
    if n >= 3:
        B(6, 5, 32, 1)
    if n >= 4:
        for i in range(2):
            for j in range(2):
                H(8 + 4 * i + j, 11 + 4 * i - j, i)
    if n >= 5:
        for i in range(4):
            B(29 - i, 18 + i, 48 + (i >> 1) * 64, 1)
    if n == 6:
        for i in range(4):
            for j in range(4):
                H(32 + 8 * i + j, 39 + 8 * i - j, i & 1)
    if n >= 3:
        for i in range(4):
            H(i, 7 - i, 0)
    if n >= 4:
        for i in range(2):
            B(13 - i, 10 + i, 32, 1)
    if n >= 5:
        for i in range(2):
            for j in range(4):
                H(16 + i * 8 + j, 23 + i * 8 - j, i)
    if n == 6:
        for i in range(8):
            B(59 - i, 36 + i, 48 if i < 4 else 112, 1)
    if n >= 4:
        for i in range(8):
            H(i, 15 - i, 0)
    if n >= 5:
        for i in range(4):
            B(27 - i, 20 + i, 32, 1)
    if n == 6:
        for i in range(8):
            H(32 + i, 47 - i, 0)
            H(48 + i, 63 - i, 1)
    if n >= 5:
        for i in range(16):
            H(i, 31 - i, 0)
    if n == 6:
        for i in range(8):
            B(55 - i, 40 + i, 32, 1)
    if n == 6:
        for i in range(32):
            H(i, 63 - i, 0)
    return p


_DCT_PROGRAMS = {n: _dct_program(n) for n in range(2, 7)}


def _run(t, program):
    for step in program:
        if step[0] == "B":
            _b(t, step[1], step[2], step[3], step[4])
        else:
            _h(t, step[1], step[2], step[3])


def _idct(t, n):
    t[:] = [t[_brev(n, i)] for i in range(1 << n)]
    _run(t, _DCT_PROGRAMS[n])


def _iadst4(t):
    s1, s2, s3, s4 = _SINPI[1], _SINPI[2], _SINPI[3], _SINPI[4]
    x0, x1, x2, x3 = t
    a0 = s1 * x0
    a1 = s2 * x0
    a2 = s3 * x1
    a3 = s4 * x2
    a4 = s1 * x2
    a5 = s2 * x3
    a6 = s4 * x3
    a7 = x0 - x2
    b7 = a7 + x3
    a0 = a0 + a3
    a1 = a1 - a4
    a3 = a2
    a2 = s3 * b7
    a0 = a0 + a5
    a1 = a1 - a6
    y0 = a0 + a3
    y1 = a1 + a3
    y2 = a2
    y3 = a0 + a1
    y3 = y3 - a3
    t[:] = [(y0 + 2048) >> 12, (y1 + 2048) >> 12, (y2 + 2048) >> 12, (y3 + 2048) >> 12]


def _adst_program(n: int):
    p = []
    B = lambda a, b, ang, f: p.append(("B", a, b, ang, f))  # noqa: E731
    H = lambda a, b, f: p.append(("H", a, b, f))  # noqa: E731
    if n == 3:
        for i in range(4):
            B(2 * i, 2 * i + 1, 60 - 16 * i, 1)
        for i in range(4):
            H(i, 4 + i, 0)
        for i in range(2):
            B(4 + 3 * i, 5 + i, 48 - 32 * i, 1)
        for i in range(2):
            for j in range(2):
                H(4 * j + i, 2 + 4 * j + i, 0)
        for i in range(2):
            B(2 + 4 * i, 3 + 4 * i, 32, 1)
    else:
        for i in range(8):
            B(2 * i, 2 * i + 1, 62 - 8 * i, 1)
        for i in range(8):
            H(i, 8 + i, 0)
        for i in range(2):
            B(8 + 2 * i, 9 + 2 * i, 56 - 32 * i, 1)
            B(13 + 2 * i, 12 + 2 * i, 8 + 32 * i, 1)
        for i in range(4):
            for j in range(2):
                H(8 * j + i, 4 + 8 * j + i, 0)
        for i in range(2):
            for j in range(2):
                B(4 + 8 * j + 3 * i, 5 + 8 * j + i, 48 - 32 * i, 1)
        for i in range(2):
            for j in range(4):
                H(4 * j + i, 2 + 4 * j + i, 0)
        for i in range(4):
            B(2 + 4 * i, 3 + 4 * i, 32, 1)
    return p


_ADST_PROGRAMS = {3: _adst_program(3), 4: _adst_program(4)}


def _adst_out_index(n: int):
    out = []
    for i in range(1 << n):
        a = (i >> 3) & 1
        b = ((i >> 2) & 1) ^ ((i >> 3) & 1)
        c = ((i >> 1) & 1) ^ ((i >> 2) & 1)
        d = (i & 1) ^ ((i >> 1) & 1)
        out.append(((d << 3) | (c << 2) | (b << 1) | a) >> (4 - n))
    return out


_ADST_OUT = {3: _adst_out_index(3), 4: _adst_out_index(4)}


def _iadst(t, n):
    if n == 2:
        _iadst4(t)
        return
    n0 = 1 << n
    t[:] = [t[(i - 1) if (i & 1) else (n0 - i - 1)] for i in range(n0)]
    _run(t, _ADST_PROGRAMS[n])
    src = list(t)
    t[:] = [-src[idx] if (i & 1) else src[idx] for i, idx in enumerate(_ADST_OUT[n])]


def _iidentity(t, n):
    if n == 2:
        t[:] = [(x * 5793 + 2048) >> 12 for x in t]
    elif n == 3:
        t[:] = [x * 2 for x in t]
    elif n == 4:
        t[:] = [(x * 11586 + 2048) >> 12 for x in t]
    else:
        t[:] = [x * 4 for x in t]


def _iwht(t, shift):
    a, c, d, b = (x >> shift for x in t)
    a = a + c
    d = d - b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a = a - b
    d = d + c
    t[:] = [a, b, c, d]


def _apply(kind, t, n, lossless, shift=0):
    if lossless:
        _iwht(t, shift)
    elif kind == DCT:
        _idct(t, n)
    elif kind == ADST:
        _iadst(t, n)
    else:
        _iidentity(t, n)


def _dc_only(dc: int, log2w: int, log2h: int, tx_size: int) -> int:
    """The one value of a DCT_DCT residual whose only coefficient is DC: in
    every inverse DCT the DC meets one rotation by cos(pi / 4) (2896 in
    Q12) and then only additions of zeros, so each output is that product
    rounded."""
    if abs(log2w - log2h) == 1:
        dc = (dc * 2896 + 2048) >> 12
    dc = max(-(1 << 15), min((1 << 15) - 1, dc))
    v = (dc * 2896 + 2048) >> 12
    shift = ROW_SHIFT[tx_size]
    if shift:
        v = (v + (1 << (shift - 1))) >> shift
    v = max(-(1 << 15), min((1 << 15) - 1, v))
    return (((v * 2896 + 2048) >> 12) + 8) >> 4


def inverse_transform_2d(coeffs: np.ndarray, tx_type: int, log2w: int, log2h: int,
                         tx_size: int, lossless: bool) -> np.ndarray:
    """The residual (h, w) int64 of the dequantised ``coeffs`` (h, w) of one
    transform block, before the flips (applied when it is added)."""
    w, h = 1 << log2w, 1 << log2h
    if tx_type == 0 and not lossless and not coeffs.flat[1:].any():
        return np.full((h, w), _dc_only(int(coeffs[0, 0]), log2w, log2h, tx_size), np.int64)
    vert, horz = TYPE_1D[tx_type]
    rows = min(h, 32)
    d = coeffs[:rows].astype(np.int64)
    if not lossless and abs(log2w - log2h) == 1:
        d = (d * 2896 + 2048) >> 12
    if not lossless:
        d = np.clip(d, -(1 << 15), (1 << 15) - 1)
    t = [d[:, j] for j in range(w)]
    _apply(horz, t, log2w, lossless, 2)
    res = np.zeros((h, w), np.int64)
    if lossless:
        res[:rows] = np.stack(t, 1)
    else:
        shift = ROW_SHIFT[tx_size]
        if shift:
            res[:rows] = (np.stack(t, 1) + (1 << (shift - 1))) >> shift
        else:
            res[:rows] = np.stack(t, 1)
        res = np.clip(res, -(1 << 15), (1 << 15) - 1)
    t = [res[i] for i in range(h)]
    _apply(vert, t, log2h, lossless, 0)
    out = np.stack(t, 0)
    if not lossless:
        out = (out + 8) >> 4
    return out

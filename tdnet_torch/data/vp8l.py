"""The WebP lossless bitstream (``VP8L``) in Python and numpy, as libwebp's
``vp8l_dec.c`` decodes it: equal byte for byte to what PIL and
``cv2.imdecode`` read from a lossless WebP (both run libwebp).

- the header: signature ``0x2f``, 14-bit width - 1 and height - 1, the
  alpha hint and a 3-bit version that must be 0;
- the transforms, each at most once, undone in the reverse of their order:
  predictor (14 modes; the top row predicts from the left, the left column
  from the top, modes 14 and 15 act as mode 0), cross-colour,
  subtract-green and colour-indexing with pixel bundling (1, 2, 4 or 8
  indices a byte; indices past the palette are transparent black);
- prefix codes: simple codes of one or two symbols, and normal codes read
  through the code-length code in its fixed order, with the repeat codes
  16, 17 and 18 and ``max_symbol``. A code of one symbol takes no bits;
  any other must be complete, or the stream is refused;
- the entropy image of meta prefix codes, the colour cache and LZ77
  lengths and distances through the 120-entry distance map.

A stream is refused (``ValueError``) where libwebp refuses it: a bad
header, an incomplete or over-full code, a distance before the first pixel
or a copy past the last, a colour-cache index without a cache, a second
transform of one kind, or bits read past the end of the data. libwebp's
bit reader loads 8 bytes at once, so a stream shorter than 8 bytes may be
read 64 bits far before it counts as truncated.

:func:`decode_vp8l` reads a ``VP8L`` chunk's payload; :func:`decode_stream`
reads an image stream without the header, as the ``ALPH`` chunk holds it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["SIGNATURE", "decode_vp8l", "decode_stream", "vp8l_info"]

SIGNATURE = 0x2F

# the order in which the code-length code's lengths are stored
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)

# distance codes 1..120 -> (dy, 8 - dx) as 0xYX: the 2-D neighbourhood
DISTANCE_MAP = (
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1A,
    0x26, 0x2A, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1B, 0x36, 0x3A,
    0x25, 0x2B, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1C, 0x35, 0x3B,
    0x46, 0x4A, 0x24, 0x2C, 0x58, 0x45, 0x4B, 0x34, 0x3C, 0x03,
    0x57, 0x59, 0x13, 0x1D, 0x56, 0x5A, 0x23, 0x2D, 0x44, 0x4C,
    0x55, 0x5B, 0x33, 0x3D, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1E,
    0x66, 0x6A, 0x22, 0x2E, 0x54, 0x5C, 0x43, 0x4D, 0x65, 0x6B,
    0x32, 0x3E, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5D, 0x11, 0x1F,
    0x64, 0x6C, 0x42, 0x4E, 0x76, 0x7A, 0x21, 0x2F, 0x75, 0x7B,
    0x31, 0x3F, 0x63, 0x6D, 0x52, 0x5E, 0x00, 0x74, 0x7C, 0x41,
    0x4F, 0x10, 0x20, 0x62, 0x6E, 0x30, 0x73, 0x7D, 0x51, 0x5F,
    0x40, 0x72, 0x7E, 0x61, 0x6F, 0x50, 0x71, 0x7F, 0x60, 0x70,
)

NUM_LITERALS, NUM_LENGTHS, NUM_DISTANCES = 256, 24, 40
PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)
_HASH_MUL = 0x1E35A7BD


class _Bits:
    """LSB-first bits of ``data``: 64-bit windows at every byte, zeros past
    the end; ``limit`` is the bit count past which libwebp calls the stream
    truncated (8 bytes at least: its reader loads that many at once)."""

    def __init__(self, data: bytes):
        n = max(len(data), 8) + 32  # windows past the limit: a read never leaves them
        b = np.frombuffer(bytes(data) + bytes(n + 8 - len(data)), np.uint8).astype(np.uint64)
        win = np.zeros(n, np.uint64)
        for k in range(8):
            win |= b[k:k + n] << np.uint64(8 * k)
        self.win: List[int] = win.tolist()
        self.pos = 0
        self.limit = 8 * max(len(data), 8)

    def read(self, n: int) -> int:
        pos = self.pos
        if pos > self.limit:
            return 0
        self.pos = pos + n
        return (self.win[pos >> 3] >> (pos & 7)) & ((1 << n) - 1)

    def check(self, what: str) -> None:
        if self.pos > self.limit:
            raise ValueError(f"truncated WebP lossless stream: {what} runs past its end")


_BITREV: dict = {}


def _bit_reversal(bits: int) -> np.ndarray:
    """For each ``bits``-bit index read LSB first, its MSB-first value."""
    if bits not in _BITREV:
        i = np.arange(1 << bits)
        r = np.zeros_like(i)
        for k in range(bits):
            r |= ((i >> k) & 1) << (bits - 1 - k)
        _BITREV[bits] = r
    return _BITREV[bits]


class _Code:
    """A canonical prefix code as one lookup table of ``1 << bits`` entries,
    each ``symbol << 4 | length``, indexed by the next ``bits`` bits."""

    __slots__ = ("table", "mask")

    def __init__(self, lengths: np.ndarray):
        syms = np.flatnonzero(lengths)
        if len(syms) == 0:
            raise ValueError("WebP lossless prefix code without symbols")
        if len(syms) == 1:  # one symbol: no bits at all
            self.table, self.mask = [int(syms[0]) << 4], 0
            return
        lens = lengths[syms].astype(np.int64)
        order = np.lexsort((syms, lens))
        syms, lens = syms[order], lens[order]
        bits = int(lens.max())
        span = np.int64(1) << (bits - lens)
        if int(span.sum()) != 1 << bits:
            raise ValueError("WebP lossless prefix code is not complete")
        entries = np.repeat((syms.astype(np.int64) << 4) | lens, span)
        self.table = entries[_bit_reversal(bits)].tolist()
        self.mask = (1 << bits) - 1

    def read(self, br: _Bits) -> int:
        pos = br.pos
        if pos > br.limit:
            return 0
        v = self.table[(br.win[pos >> 3] >> (pos & 7)) & self.mask]
        br.pos = pos + (v & 15)
        return v >> 4


def _read_code(br: _Bits, alphabet: int) -> _Code:
    lengths = np.zeros(alphabet, np.int64)
    if br.read(1):  # simple code: one or two symbols
        n = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        for s in ([first, br.read(8)] if n == 2 else [first]):
            if s < alphabet:
                lengths[s] = 1
    else:
        cl = np.zeros(19, np.int64)
        for i in range(br.read(4) + 4):
            cl[CODE_LENGTH_ORDER[i]] = br.read(3)
        br.check("a code-length code")
        code = _Code(cl)
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > alphabet:
                raise ValueError("WebP lossless code lengths: max_symbol past the alphabet")
        else:
            max_symbol = alphabet
        sym, prev = 0, 8
        while sym < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            v = code.read(br)
            if v < 16:
                lengths[sym] = v
                sym += 1
                if v:
                    prev = v
                continue
            extra, offset = ((2, 3), (3, 3), (7, 11))[v - 16]
            repeat = br.read(extra) + offset
            if sym + repeat > alphabet:
                raise ValueError("WebP lossless code lengths repeat past the alphabet")
            lengths[sym:sym + repeat] = prev if v == 16 else 0
            sym += repeat
    br.check("a prefix code")
    return _Code(lengths)


def _read_group(br: _Bits, cache_bits: int):
    green = NUM_LITERALS + NUM_LENGTHS + ((1 << cache_bits) if cache_bits else 0)
    return tuple(_read_code(br, n) for n in (green, NUM_LITERALS, NUM_LITERALS, NUM_LITERALS,
                                             NUM_DISTANCES))


def _prefix_value(br: _Bits, sym: int) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _entropy_image(br: _Bits, w: int, h: int, top_level: bool,
                   palette_alpha: bool = False) -> np.ndarray:
    """The colour cache, the prefix codes and the entropy-coded pixels of a
    ``w`` x ``h`` image -> (h, w) uint32 ARGB (transforms not undone).
    ``palette_alpha``: an alpha stream whose only transform is colour
    indexing; libwebp decodes it 8 bits a pixel when it has no colour cache
    and one symbol for red, blue and alpha, and then lets the last symbol
    read past the end."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"WebP lossless colour cache of {cache_bits} bits (1 to 11)")
    meta_bits, meta = 0, None
    if top_level and br.read(1):
        meta_bits = br.read(3) + 2
        sub = _entropy_image(br, _subsample(w, meta_bits), _subsample(h, meta_bits), False)
        meta = ((sub >> 8) & 0xFFFF).astype(np.int64)
    br.check("the prefix codes' header")
    n_groups = 1 if meta is None else int(meta.max()) + 1
    groups = [_read_group(br, cache_bits) for _ in range(n_groups)]
    eight_bit = palette_alpha and not cache_bits and all(
        g[1].mask == g[2].mask == g[3].mask == 0 for g in groups)
    return _pixels(br, w, h, groups, meta, meta_bits, cache_bits, eight_bit)


def _pixels(br: _Bits, w: int, h: int, groups, meta, meta_bits: int, cache_bits: int,
            overrun_ok: bool = False):
    total = w * h
    out: List[int] = []
    append, extend = out.append, out.extend
    win, limit = br.win, br.limit
    pos = br.pos
    cache = [0] * (1 << cache_bits) if cache_bits else None
    cache_shift = 32 - cache_bits
    cached = 0  # pixels inserted in the colour cache so far
    len_limit = NUM_LITERALS + NUM_LENGTHS
    meta_rows = None if meta is None else meta.tolist()
    mw = (1 << meta_bits) - 1 if meta is not None else 0
    x = y = 0
    g = groups[0]
    n = 0
    while n < total:
        if pos > limit:
            break
        if meta_rows is not None and ((x & mw) == 0 or n == 0):
            g = groups[meta_rows[y >> meta_bits][x >> meta_bits]]
        gc, rc, bc, ac, dc = g
        v = gc.table[(win[pos >> 3] >> (pos & 7)) & gc.mask]
        pos += v & 15
        code = v >> 4
        if code < NUM_LITERALS:
            v = rc.table[(win[pos >> 3] >> (pos & 7)) & rc.mask]
            pos += v & 15
            red = v >> 4
            v = bc.table[(win[pos >> 3] >> (pos & 7)) & bc.mask]
            pos += v & 15
            blue = v >> 4
            v = ac.table[(win[pos >> 3] >> (pos & 7)) & ac.mask]
            pos += v & 15
            append((v >> 4) << 24 | red << 16 | code << 8 | blue)
            n += 1
            x += 1
            if x == w:
                x = 0
                y += 1
        elif code < len_limit:
            br.pos = pos
            length = _prefix_value(br, code - NUM_LITERALS)
            dist_code = _prefix_value(br, dc.read(br))
            pos = br.pos
            if dist_code > 120:
                dist = dist_code - 120
            else:
                yx = DISTANCE_MAP[dist_code - 1]
                dist = max(1, (yx >> 4) * w + 8 - (yx & 15))
            if dist > n or length > total - n:
                raise ValueError(f"WebP lossless back-reference (distance {dist}, length "
                                 f"{length}) reaches outside the image")
            start = n - dist
            if dist >= length:
                extend(out[start:start + length])
            else:
                for i in range(start, start + length):
                    append(out[i])
            n += length
            x += length
            if x >= w:
                y += x // w
                x %= w
            if meta_rows is not None and n < total:
                g = groups[meta_rows[y >> meta_bits][x >> meta_bits]]
        else:  # a colour-cache index: the green alphabet has them only with a cache
            key = code - len_limit
            while cached < n:
                p = out[cached]
                cache[((p * _HASH_MUL) & 0xFFFFFFFF) >> cache_shift] = p
                cached += 1
            append(cache[key])
            n += 1
            x += 1
            if x == w:
                x = 0
                y += 1
    br.pos = pos
    if n < total or (pos > br.limit and not overrun_ok):
        raise ValueError("truncated WebP lossless stream: the pixels run past its end")
    return np.array(out, np.uint32).reshape(h, w)


def _channels(argb: np.ndarray) -> np.ndarray:
    """(..., ) uint32 ARGB -> (..., 4) uint8 in memory order B, G, R, A."""
    return np.ascontiguousarray(argb, "<u4").view(np.uint8).reshape(argb.shape + (4,))


def _argb(ch: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(ch, np.uint8).view("<u4").reshape(ch.shape[:-1])


def _tile_values(data: np.ndarray, bits: int, w: int, h: int) -> np.ndarray:
    """A sub-sampled image's values spread over its tiles -> (h, w)."""
    return data[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]


def _inverse_predictor(res: np.ndarray, data: np.ndarray, bits: int) -> np.ndarray:
    """Undo the predictor transform on (h, w) ARGB residuals. A pixel reads
    its left, top, top-right and top-left neighbours, so all pixels with
    the same x + 2y are independent: they are done together, front by
    front."""
    h, w = res.shape
    mode = ((_tile_values(data, bits, w, h) >> 8) & 15).astype(np.int64)
    mode[0, 0], mode[0, 1:], mode[1:, 0] = 0, 1, 2
    mode = mode.ravel()
    r = _channels(res).reshape(-1, 4).astype(np.int32)
    out = np.zeros((h * w, 4), np.int32)
    black = np.array([0, 0, 0, 255], np.int32)
    for t in range(w + 2 * (h - 1)):
        y0, y1 = max(0, (t - w + 2) // 2), min(h - 1, t // 2)
        ys = np.arange(y0, y1 + 1)
        f = ys * w + (t - 2 * ys)
        m = mode[f]
        L = out[np.maximum(f - 1, 0)]
        T = out[np.maximum(f - w, 0)]
        TR = out[np.maximum(f - w + 1, 0)]
        TL = out[np.maximum(f - w - 1, 0)]
        P = np.empty((16,) + L.shape, np.int32)
        P[0] = P[14] = P[15] = black
        P[1], P[2], P[3], P[4] = L, T, TR, TL
        P[5] = (((L + TR) >> 1) + T) >> 1
        P[6] = (L + TL) >> 1
        P[7] = (L + T) >> 1
        P[8] = (TL + T) >> 1
        P[9] = (T + TR) >> 1
        P[10] = (P[6] + P[9]) >> 1
        # Select: the neighbour whose gradient estimate is nearer
        pt_minus_pl = (np.abs(L - TL).sum(1) - np.abs(T - TL).sum(1))[:, None]
        P[11] = np.where(pt_minus_pl <= 0, T, L)
        P[12] = np.clip(L + T - TL, 0, 255)
        d = P[7] - TL  # (a - b) / 2 in C rounds toward zero
        P[13] = np.clip(P[7] + ((d + (d < 0)) >> 1), 0, 255)
        pred = P[m, np.arange(len(f))]
        out[f] = (r[f] + pred) & 255
    return _argb(out.astype(np.uint8).reshape(h, w, 4))


def _inverse_cross_color(img: np.ndarray, data: np.ndarray, bits: int) -> np.ndarray:
    h, w = img.shape
    m = _channels(_tile_values(data, bits, w, h)).view(np.int8).astype(np.int32)
    c = _channels(img)
    g = c[..., 1].view(np.int8).astype(np.int32)
    red = (c[..., 2].astype(np.int32) + ((m[..., 0] * g) >> 5)) & 255  # green_to_red
    red8 = red.astype(np.uint8).view(np.int8).astype(np.int32)
    blue = (c[..., 0].astype(np.int32) + ((m[..., 1] * g) >> 5)  # green_to_blue
            + ((m[..., 2] * red8) >> 5)) & 255  # red_to_blue
    out = c.copy()
    out[..., 2], out[..., 0] = red, blue
    return _argb(out)


def _inverse_subtract_green(img: np.ndarray) -> np.ndarray:
    c = _channels(img).copy()
    g = c[..., 1]
    c[..., 0] += g  # uint8: wraps mod 256
    c[..., 2] += g
    return _argb(c)


def _inverse_color_indexing(img: np.ndarray, palette: np.ndarray, bits: int,
                            w: int) -> np.ndarray:
    h = img.shape[0]
    green = (img >> 8) & 0xFF
    if bits:
        bpp = 8 >> bits
        x = np.arange(w)
        idx = (green[:, x >> bits] >> (bpp * (x & ((1 << bits) - 1)))) & ((1 << bpp) - 1)
    else:
        idx = green
    return palette[idx.astype(np.int64)].reshape(h, w)


def _read_transform(br: _Bits, w: int, seen: set, h: int):
    """One transform's type and data -> (transform, the image width after it)."""
    kind = br.read(2)
    if kind in seen:
        raise ValueError("WebP lossless stream repeats a transform")
    seen.add(kind)
    if kind in (PREDICTOR, CROSS_COLOR):
        bits = br.read(3) + 2
        data = _entropy_image(br, _subsample(w, bits), _subsample(h, bits), False)
        return (kind, bits, data, w), w
    if kind == COLOR_INDEXING:
        n = br.read(8) + 1
        bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
        deltas = _channels(_entropy_image(br, n, 1, False)[0])
        palette = np.zeros((256, 4), np.uint8)
        palette[:n] = np.cumsum(deltas, axis=0, dtype=np.uint8)  # each entry adds to the last
        return (kind, bits, _argb(palette), w), _subsample(w, bits)
    return (kind, 0, None, w), w


def _decode(br: _Bits, w: int, h: int, alpha: bool = False) -> np.ndarray:
    transforms, seen, cw = [], set(), w
    while br.read(1):
        t, cw = _read_transform(br, cw, seen, h)
        transforms.append(t)
    br.check("the transforms")
    img = _entropy_image(br, cw, h, True, alpha and [t[0] for t in transforms] == [COLOR_INDEXING])
    for kind, bits, data, tw in reversed(transforms):
        if kind == PREDICTOR:
            img = _inverse_predictor(img, data, bits)
        elif kind == CROSS_COLOR:
            img = _inverse_cross_color(img, data, bits)
        elif kind == SUBTRACT_GREEN:
            img = _inverse_subtract_green(img)
        else:
            img = _inverse_color_indexing(img, data, bits, tw)
    return img


def vp8l_info(data: bytes) -> Tuple[int, int]:
    """(width, height) from a ``VP8L`` payload's 5-byte header, as libwebp's
    ``VP8LGetInfo`` checks it (the alpha hint after them sets only PIL's
    mode, which RGB does not see)."""
    if len(data) < 5 or data[0] != SIGNATURE or data[4] >> 5:
        raise ValueError("not a WebP lossless bitstream (signature 0x2f, version 0)")
    bits = int.from_bytes(bytes(data[1:5]), "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def decode_vp8l(data: bytes) -> np.ndarray:
    """A ``VP8L`` chunk's payload -> (H, W, 4) uint8 RGBA."""
    w, h = vp8l_info(data)
    br = _Bits(data)
    br.pos = 40
    return _rgba(_decode(br, w, h))


def decode_stream(data: bytes, width: int, height: int) -> np.ndarray:
    """An image stream without the header (an ``ALPH`` chunk's lossless
    alpha) of a known size -> (H, W) uint8, the green channel."""
    img = _decode(_Bits(data), width, height, alpha=True)
    return ((img >> 8) & 0xFF).astype(np.uint8)


def _rgba(img: np.ndarray) -> np.ndarray:
    return _channels(img)[..., [2, 1, 0, 3]]

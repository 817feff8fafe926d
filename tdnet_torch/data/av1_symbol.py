"""The AV1 symbol decoder (specification section 8.2), as libaom's
``od_ec_dec`` runs it: a 15-bit range, a window of pending bits, CDFs in
libaom's inverted form (``av1_tables.py``) adapted after each symbol.

It is the decoder's hottest loop: plain Python ints and lists, no numpy.
A CDF is a list of ``n + 1`` ints for ``n`` symbols, the last the
adaptation counter; :func:`copy_cdfs` gives a tile its own copy.
"""

from __future__ import annotations

__all__ = ["SymbolDecoder", "copy_cdfs", "cdf_lists"]

_WINDOW = 62  # bits of the pending window (libaom's is the machine word)
_LOTS_OF_BITS = 0x4000
_RATE = (0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2)  # libaom's nsymbs2speed


def cdf_lists(a, n_symbols=None):
    """A numpy CDF table -> nested lists of ints, each innermost list cut
    to ``n_symbols + 1`` entries where given (the table's padding dropped)."""
    if a.ndim == 1:
        row = [int(v) for v in a]
        if n_symbols is not None:
            row = row[:n_symbols - 1] + [0, 0]
        return row
    return [cdf_lists(x, n_symbols) for x in a]


def copy_cdfs(cdfs):
    """A deep copy of nested lists of CDF lists."""
    if isinstance(cdfs, dict):
        return {k: copy_cdfs(v) for k, v in cdfs.items()}
    if cdfs and isinstance(cdfs[0], (list, dict)):
        return [copy_cdfs(c) for c in cdfs]
    return list(cdfs)


class SymbolDecoder:
    """One tile's arithmetic decoder over ``data[start:end]``."""

    __slots__ = ("data", "start", "pos", "end", "dif", "rng", "cnt", "disable_update",
                 "tell_offs")

    def __init__(self, data: bytes, start: int, end: int, disable_update: bool = False):
        if end <= start:
            raise ValueError("AV1 tile of no bytes")
        self.data = data
        self.start = start
        self.pos = start
        self.end = end
        self.tell_offs = -14  # libaom's 10 - (32 - 8): tell() is 1 once initialised
        self.dif = (1 << (_WINDOW - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self.disable_update = disable_update
        self._refill()

    def _refill(self):
        s = _WINDOW - 9 - (self.cnt + 15)
        dif, cnt, pos, end, data = self.dif, self.cnt, self.pos, self.end, self.data
        while s >= 0 and pos < end:
            dif ^= data[pos] << s
            pos += 1
            cnt += 8
            s -= 8
        if pos >= end:
            self.tell_offs += _LOTS_OF_BITS - cnt
            cnt = _LOTS_OF_BITS
        self.dif, self.cnt, self.pos = dif, cnt, pos

    def tell(self) -> int:
        """libaom's ``od_ec_dec_tell``: 1 plus the bits the symbols used."""
        return (self.pos - self.start) * 8 - self.cnt + self.tell_offs

    def exit_ok(self) -> bool:
        """The specification's ``exit_symbol``: the symbols stay within the
        tile, the bit after the last one they used is 1 and every later bit
        of the tile is 0."""
        pos = self.tell() - 1  # the trailing bit's position in the tile
        size = self.end - self.start
        if (pos + 8) >> 3 > size or pos < 0:
            return False
        byte = self.data[self.start + (pos >> 3)]
        rest = byte & ((0x100 >> (pos & 7)) - 1)
        if rest != 0x80 >> (pos & 7):
            return False
        return not any(self.data[self.start + (pos >> 3) + 1:self.end])

    def overread(self) -> bool:
        """dav1d's end-of-tile check in place of ``exit_symbol``: the
        symbols used every bit of the tile (its ``msac.cnt`` below -15)."""
        return self.tell() - 1 >= 8 * (self.end - self.start)

    def symbol(self, cdf) -> int:
        """Read one symbol with ``cdf`` (adapted in place unless updates are
        disabled)."""
        n = len(cdf) - 1
        dif = self.dif
        r = self.rng
        c = dif >> (_WINDOW - 16)
        r8 = r >> 8
        ret = -1
        v = r
        while True:
            u = v
            ret += 1
            v = ((r8 * (cdf[ret] >> 6)) >> 1) + 4 * (n - 1 - ret)
            if c >= v:
                break
        r = u - v
        dif -= v << (_WINDOW - 16)
        d = 16 - r.bit_length()
        self.cnt -= d
        self.dif = ((dif + 1) << d) - 1
        self.rng = r << d
        if self.cnt < 0:
            self._refill()
        if not self.disable_update:
            count = cdf[n]
            rate = 3 + (count > 15) + (count > 31) + _RATE[n]
            for i in range(n - 1):
                if i < ret:
                    cdf[i] += (32768 - cdf[i]) >> rate
                else:
                    cdf[i] -= cdf[i] >> rate
            if count < 32:
                cdf[n] = count + 1
        return ret

    def bool(self) -> int:
        """One equiprobable bit (``read_bool`` / libaom's ``aom_read_bit``)."""
        dif = self.dif
        r = self.rng
        v = ((r >> 8) << 7) + 4  # f = 16384: ((r >> 8) * (16384 >> 6)) >> 1
        vw = v << (_WINDOW - 16)
        if dif >= vw:
            r -= v
            dif -= vw
            bit = 0
        else:
            r = v
            bit = 1
        d = 16 - r.bit_length()
        self.cnt -= d
        self.dif = ((dif + 1) << d) - 1
        self.rng = r << d
        if self.cnt < 0:
            self._refill()
        return bit

    def literal(self, n: int) -> int:
        """``L(n)``: n bits, the most significant first."""
        x = 0
        for _ in range(n):
            x = (x << 1) | self.bool()
        return x

    def cdf2(self, icdf0: int) -> int:
        """A 2-symbol read with a fixed CDF and no adaptation (libaom's
        ``aom_read_cdf`` on a gathered partition CDF)."""
        dif = self.dif
        r = self.rng
        c = dif >> (_WINDOW - 16)
        v = (((r >> 8) * (icdf0 >> 6)) >> 1) + 4
        if c >= v:
            r -= v
            dif -= v << (_WINDOW - 16)
            ret = 0
        else:
            r = v
            ret = 1
        d = 16 - r.bit_length()
        self.cnt -= d
        self.dif = ((dif + 1) << d) - 1
        self.rng = r << d
        if self.cnt < 0:
            self._refill()
        return ret

    def ns(self, n: int) -> int:
        """``NS(n)``: a value below n with literal bits."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.literal(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.literal(1)

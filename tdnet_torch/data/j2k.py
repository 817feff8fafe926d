"""The JPEG 2000 codestream (ISO/IEC 15444-1 Annex A and B) and tier 2,
as OpenJPEG 2.5 reads them (``j2k.c``, ``t2.c``, ``pi.c``, ``tgt.c``,
``bio.c``): both reference routes read JPEG 2000 through OpenJPEG.

:func:`decode_codestream` parses the main header (SIZ, COD, COC, QCD,
QCC, RGN, POC; TLM, PLM, CRG and COM skipped), each tile-part (SOT, its
own COD, COC, QCD, QCC, RGN and POC, PLT skipped, SOD, ``Psot`` 0 for a
last tile-part running to EOC), and the packets of each tile in its
progression order (LRCP, RLCP, RPCL, PCRL, CPRL, and the POC's volumes,
each packet read once: OpenJPEG's ``include`` table), with SOP and EPH
markers, tag trees for inclusion and zero bit-planes, the pass counts,
``Lblock`` and the segments of each code-block style. Each code-block's
segments go to ``j2k_t1.decode_block``, its coefficients to their band,
and each tile-component through ``j2k_dwt`` (dequantisation, the inverse
5/3 or 9/7 transform, RCT or ICT, the DC level shift). It returns each
component's samples on its own grid, as OpenJPEG's ``opj_decode`` does,
and :func:`decode_tiles` the same tile by tile (``opj_decode_tile_data``,
which PIL's route reads).

Image and tile offsets, component subsampling, 1 to 16 bits (signed or
not) and any number of layers, resolutions and precincts are read. A
damaged codestream is read or refused by OpenJPEG's own checks: exact
marker-segment lengths, known Scod bits, unknown markers stepped over two
bytes at a time (``opj_j2k_read_unk``), tile-part indices, a missing EPH,
the end of the stream. What OpenJPEG refuses, or what the port does not
read (packed packet headers in PPM or PPT, the Part 2 component
transforms MCC, MCO and CBD, HTJ2K code-blocks), raises ``ValueError``
naming it.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from tdnet_torch.data import j2k_dwt, j2k_t1

__all__ = ["SIGNATURE", "Codestream", "parse", "decode_codestream", "decode_tiles",
           "codestream_size"]

SIGNATURE = b"\xff\x4f\xff\x51"  # SOC, SIZ

_SOT, _SOD, _EOC, _SIZ = 0xFF90, 0xFF93, 0xFFD9, 0xFF51
_COD, _COC, _RGN, _QCD, _QCC, _POC = 0xFF52, 0xFF53, 0xFF5E, 0xFF5C, 0xFF5D, 0xFF5F
_PPM, _PPT = 0xFF60, 0xFF61  # packed packet headers: refused
_MCT, _MCC, _MCO, _CBD = 0xFF74, 0xFF75, 0xFF77, 0xFF78  # Part 2: refused
# the markers OpenJPEG's header readers know, where each may stand (main
# header, tile-part header); TLM, PLM, PLT, CRG, COM, CAP and CPF are read
# and left, any other marker is skipped as ``opj_j2k_read_unk`` does
_MAIN_MARKERS = {_SOT, _COD, _COC, _RGN, _QCD, _QCC, _POC, 0xFF55, 0xFF57, _PPM, 0xFF63,
                 0xFF64, _MCT, _CBD, 0xFF50, 0xFF59, _MCC, _MCO}
_TILE_MARKERS = {_COD, _COC, _RGN, _QCD, _QCC, _POC, 0xFF58, _PPT, 0xFF64, _MCT, _MCC, _MCO}
_KNOWN = _MAIN_MARKERS | _TILE_MARKERS | {_SIZ, 0xFF91}  # and SOP, allowed nowhere
_PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
_PACKED = ("JPEG 2000 packed packet headers (PPM/PPT) are not read: neither reference's "
           "writer nor OpenJPEG's encoder makes them to hold the port to")


class _Comp:
    """Coding parameters of one tile-component (COD/COC, QCD/QCC, RGN)."""

    def __init__(self):
        self.levels = 0
        self.cbw = self.cbh = 6
        self.style = 0
        self.qmfbid = 0
        self.precincts: List[Tuple[int, int]] = []  # (PPx, PPy) per resolution
        self.qstyle = 0
        self.guard = 0
        self.steps: List[Tuple[int, int]] = []  # (expn, mant) per band
        self.roishift = 0

    def copy(self) -> "_Comp":
        c = _Comp()
        c.__dict__.update(self.__dict__)
        c.precincts = list(self.precincts)
        c.steps = list(self.steps)
        return c


class _Tile:
    """A tile's coding parameters and the data of its tile-parts."""

    def __init__(self, default):
        self.csty, self.progression, self.layers, self.mct = default[:4]
        self.comps: List[_Comp] = [c.copy() for c in default[4]]
        self.pocs: List[tuple] = []
        self.data = bytearray()
        self.parts = 0  # tile-parts read


class Codestream:
    """A parsed codestream: the image's geometry and components, and each
    tile's parameters and data."""

    def __init__(self):
        self.x1 = self.y1 = self.x0 = self.y0 = 0
        self.tw = self.th = self.tx0 = self.ty0 = 0
        self.comps: List[Tuple[int, bool, int, int]] = []  # (prec, sgnd, dx, dy)
        self.tiles: Dict[int, _Tile] = {}
        self.across = self.down = 0

    @property
    def size(self) -> Tuple[int, int]:
        return self.x1 - self.x0, self.y1 - self.y0

    def comp_box(self, c: int) -> Tuple[int, int, int, int]:
        _, _, dx, dy = self.comps[c]
        return (-(-self.x0 // dx), -(-self.y0 // dy), -(-self.x1 // dx), -(-self.y1 // dy))

    def tile_box(self, t: int) -> Tuple[int, int, int, int]:
        p, q = t % self.across, t // self.across
        return (max(self.tx0 + p * self.tw, self.x0), max(self.ty0 + q * self.th, self.y0),
                min(self.tx0 + (p + 1) * self.tw, self.x1),
                min(self.ty0 + (q + 1) * self.th, self.y1))


def codestream_size(data: bytes) -> Tuple[int, int]:
    """Xsiz - XOsiz by Ysiz - YOsiz from the SIZ segment (PIL's ``.size``
    of a raw codestream)."""
    if len(data) < 4 + 38 or not data.startswith(SIGNATURE):
        raise ValueError("truncated JPEG 2000 codestream header")
    xsiz, ysiz, xo, yo = struct.unpack_from(">IIII", data, 8)
    return xsiz - xo, ysiz - yo


def _u16(d: bytes, p: int) -> int:
    return (d[p] << 8) | d[p + 1]


def _read_siz(cs: Codestream, seg: bytes) -> None:
    if len(seg) < 36:
        raise ValueError("JPEG 2000 SIZ segment too short")
    (_, cs.x1, cs.y1, cs.x0, cs.y0, cs.tw, cs.th, cs.tx0, cs.ty0, n) = struct.unpack_from(
        ">HIIIIIIIIH", seg, 0)
    if n == 0 or n > 16384 or len(seg) != 36 + 3 * n:
        raise ValueError(f"JPEG 2000 SIZ with {n} components")
    if cs.x0 >= cs.x1 or cs.y0 >= cs.y1:
        raise ValueError(f"JPEG 2000 image of negative or zero size ({cs.x0}, {cs.y0}, "
                         f"{cs.x1}, {cs.y1})")
    if cs.tw == 0 or cs.th == 0 or cs.tx0 > cs.x0 or cs.ty0 > cs.y0 or \
            cs.tx0 + cs.tw <= cs.x0 or cs.ty0 + cs.th <= cs.y0:
        raise ValueError("JPEG 2000 SIZ with a bad tile grid")
    for i in range(n):
        ssiz, dx, dy = seg[36 + 3 * i:39 + 3 * i]
        prec = (ssiz & 0x7F) + 1
        if prec > 31:
            raise ValueError(f"JPEG 2000 component of {prec} bits")
        if dx == 0 or dy == 0:
            raise ValueError("JPEG 2000 component with a zero subsampling factor")
        cs.comps.append((prec, bool(ssiz & 0x80), dx, dy))
    cs.across = -(-(cs.x1 - cs.tx0) // cs.tw)
    cs.down = -(-(cs.y1 - cs.ty0) // cs.th)
    if cs.across * cs.down > 65535:
        raise ValueError(f"JPEG 2000 of {cs.across}x{cs.down} tiles (OpenJPEG reads up to "
                         "65535)")


def _read_spcod(comp: _Comp, seg: bytes, p: int, defined: bool) -> None:
    """SPcod/SPcoc from byte p: levels, code-block size and style, the
    wavelet, and the precinct sizes."""
    if len(seg) < p + 5:
        raise ValueError("JPEG 2000 COD/COC segment too short")
    levels, cbw, cbh, style, qmfbid = seg[p:p + 5]
    if levels > 32:
        raise ValueError(f"JPEG 2000 with {levels} decomposition levels (OpenJPEG reads up "
                         "to 32)")
    cbw, cbh = cbw + 2, cbh + 2
    if cbw > 10 or cbh > 10 or cbw + cbh > 12:
        raise ValueError(f"JPEG 2000 code-blocks of 2^{cbw} x 2^{cbh}")
    if style & 0x40:
        raise ValueError("HTJ2K (high-throughput) code-blocks are not read")
    if style & 0x80:
        raise ValueError(f"JPEG 2000 code-block style 0x{style:02x} is not read")
    if qmfbid > 1:
        raise ValueError(f"JPEG 2000 transform {qmfbid} (Part 2 kernels) is not read")
    comp.levels, comp.cbw, comp.cbh, comp.style, comp.qmfbid = levels, cbw, cbh, style, qmfbid
    if defined:
        if len(seg) < p + 5 + levels + 1:
            raise ValueError("JPEG 2000 COD/COC segment too short for its precincts")
        comp.precincts = [(b & 15, b >> 4) for b in seg[p + 5:p + 6 + levels]]
        for r, (ppx, ppy) in enumerate(comp.precincts):
            if r and (ppx == 0 or ppy == 0):
                raise ValueError("JPEG 2000 precinct of size 1 at a resolution above 0")
    else:
        comp.precincts = [(15, 15)] * (levels + 1)
    if len(seg) != p + 5 + (levels + 1 if defined else 0):
        raise ValueError("JPEG 2000 COD/COC segment of the wrong length (OpenJPEG refuses it)")


def _read_sqcd(comp: _Comp, seg: bytes, p: int) -> None:
    """Sqcd/Sqcc and the step sizes as OpenJPEG reads them: a byte each
    without quantization (style 0), one 16-bit value when derived (1), 16
    bits each for any other style; the segment must hold no more."""
    if len(seg) < p + 1:
        raise ValueError("JPEG 2000 QCD/QCC segment too short")
    sq = seg[p]
    comp.guard, comp.qstyle = sq >> 5, sq & 0x1F
    body = seg[p + 1:]
    if comp.qstyle == 0:
        comp.steps = [(b >> 3, 0) for b in body]
        return
    n = 1 if comp.qstyle == 1 else len(body) // 2
    if len(body) != 2 * n:
        raise ValueError("JPEG 2000 QCD/QCC segment of the wrong length (OpenJPEG refuses it)")
    comp.steps = [(v >> 11, v & 0x7FF) for v in (_u16(body, 2 * i) for i in range(n))]


def _next_marker(data: bytes, pos: int, end: int, allowed: set) -> int:
    """Where the next marker segment of a header starts: ``pos`` if the
    marker there is known, else OpenJPEG's ``opj_j2k_read_unk`` stepping two
    bytes at a time from the unknown marker to the next known one, which
    must be allowed where it stands."""
    marker = _u16(data, pos)
    if marker < 0xFF00:
        raise ValueError(f"JPEG 2000 header: 0x{marker:04X} where a marker should be")
    if marker not in _KNOWN:
        pos += 2
        while True:
            if pos + 2 > end:
                raise ValueError(f"JPEG 2000 unknown marker 0x{marker:04X} and no known "
                                 "marker after it (OpenJPEG: stream too short)")
            marker = _u16(data, pos)
            if marker >= 0xFF00 and marker in _KNOWN:
                break
            pos += 2
    if marker not in allowed:
        raise ValueError(f"JPEG 2000 marker 0x{marker:04X} where it may not stand")
    return pos


def _check_mct(seg: bytes) -> None:
    """OpenJPEG's ``opj_j2k_read_mct``: a Part 2 MCT array is stored and,
    with no MCC using it, changes nothing; a segment too short for its
    first record is refused."""
    if len(seg) < 2 or (_u16(seg, 0) == 0 and len(seg) <= 6):
        raise ValueError("JPEG 2000 MCT segment too short (OpenJPEG refuses it)")


def _comp_index(cs: Codestream, seg: bytes, p: int) -> Tuple[int, int]:
    if len(cs.comps) < 257:
        return seg[p], p + 1
    return _u16(seg, p), p + 2


def _apply(cs: Codestream, target, marker: int, seg: bytes, main: bool) -> None:
    """One marker segment (its body after the length) into the main
    header's defaults or a tile's parameters."""
    n = len(cs.comps)
    if marker == _COD:
        if len(seg) < 5:
            raise ValueError("JPEG 2000 COD segment too short")
        csty, prog, layers, mct = seg[0], seg[1], _u16(seg, 2), seg[4]
        if csty & ~7:
            raise ValueError(f"JPEG 2000 COD with an unknown Scod 0x{csty:02x}")
        if prog > 4:
            raise ValueError(f"JPEG 2000 progression order {prog} is unknown")
        if layers == 0:
            raise ValueError("JPEG 2000 COD with zero layers")
        if mct > 1:
            raise ValueError(f"JPEG 2000 multiple component transform {mct} (Part 2)")
        comps = target["comps"] if main else target.comps
        for c in range(n):
            _read_spcod(comps[c], seg, 5, bool(csty & 1))
        if main:
            target.update(csty=csty, progression=prog, layers=layers, mct=mct, cod=True)
        else:
            target.csty, target.progression, target.layers, target.mct = csty, prog, layers, mct
    elif marker == _COC:
        c, p = _comp_index(cs, seg, 0)
        if c >= n:
            raise ValueError(f"JPEG 2000 COC for component {c} of {n}")
        comps = target["comps"] if main else target.comps
        _read_spcod(comps[c], seg, p + 1, bool(seg[p] & 1))
    elif marker == _QCD:
        comps = target["comps"] if main else target.comps
        for c in range(n):
            _read_sqcd(comps[c], seg, 0)
        if main:
            target["qcd"] = True
    elif marker == _QCC:
        c, p = _comp_index(cs, seg, 0)
        if c >= n:
            raise ValueError(f"JPEG 2000 QCC for component {c} of {n}")
        comps = target["comps"] if main else target.comps
        _read_sqcd(comps[c], seg, p)
    elif marker == _RGN:
        c, p = _comp_index(cs, seg, 0)
        if c >= n:
            raise ValueError(f"JPEG 2000 RGN for component {c} of {n}")
        comps = target["comps"] if main else target.comps
        comps[c].roishift = seg[p + 1]  # the style byte is not read (OpenJPEG)
    elif marker == _POC:
        wide = n >= 257
        step = 9 if wide else 7
        pocs = []
        for i in range(0, len(seg) - step + 1, step):
            e = seg[i:i + step]
            if wide:
                rs, cs_, ly, re, ce, pp = e[0], _u16(e, 1), _u16(e, 3), e[5], _u16(e, 6), e[8]
            else:
                rs, cs_, ly, re, ce, pp = e[0], e[1], _u16(e, 2), e[4], e[5], e[6]
            pocs.append((rs, cs_, ly, re, min(ce, n), pp))  # an unknown order: no packets
        if main:
            target["pocs"] = pocs
        else:
            target.pocs = pocs
    else:
        raise ValueError(f"JPEG 2000 marker 0x{marker:04X} in the wrong place")


def parse(data: bytes, whole_image: bool = False) -> Codestream:
    """The main header and every tile-part of a codestream. After the last
    tile-part OpenJPEG wants EOC, or an SOT, or the end of the data; a
    stray last marker in the final two bytes ends a whole-image decode
    (``opj_decode``, ``whole_image``) but fails the tile-by-tile reader,
    and a whole-image decode reads no SOT after every tile is complete."""
    data = bytes(data)
    if not data.startswith(SIGNATURE):
        raise ValueError("not a JPEG 2000 codestream (no SOC and SIZ)")
    cs = Codestream()
    pos = 2
    main: dict = {"comps": [], "pocs": []}
    seen_siz = False
    while True:
        if pos + 4 > len(data):
            raise ValueError("JPEG 2000 codestream ends in its main header")
        pos = _next_marker(data, pos, len(data), _MAIN_MARKERS if seen_siz else {_SIZ})
        marker = _u16(data, pos)
        if marker == _SOT:
            break
        length = _u16(data, pos + 2)
        if length < 2 or pos + 2 + length > len(data):
            raise ValueError("JPEG 2000 marker segment runs past the end of the data")
        seg = data[pos + 4:pos + 2 + length]
        if marker == _SIZ:
            _read_siz(cs, seg)
            main["comps"] = [_Comp() for _ in cs.comps]
            seen_siz = True
        elif marker in (_COD, _COC, _QCD, _QCC, _RGN, _POC):
            _apply(cs, main, marker, seg, main=True)
        elif marker in (_PPM, _PPT):
            raise ValueError(_PACKED)
        elif marker == _MCT:
            _check_mct(seg)
        elif marker in (_MCC, _MCO, _CBD):
            raise ValueError(f"JPEG 2000 Part 2 marker 0x{marker:04X} is not read")
        pos += 2 + length
    if not main.get("cod") or not main.get("qcd"):
        raise ValueError("JPEG 2000 main header without " +
                         ("COD" if not main.get("cod") else "QCD"))
    default = (main["csty"], main["progression"], main["layers"], main["mct"], main["comps"])
    n_tiles = cs.across * cs.down
    complete = 0  # tiles with all the tile-parts their TNsot gives
    while True:
        if pos + 2 > len(data):  # OpenJPEG reads a marker after each tile-part
            raise ValueError("JPEG 2000 codestream ends without an EOC marker "
                             "(OpenJPEG: stream too short)")
        marker = _u16(data, pos)
        if marker == _EOC or (marker == _SOT and (
                pos + 2 == len(data) or (whole_image and complete == n_tiles))):
            break  # opj_decode stops once every tile is decoded
        if marker != _SOT:
            if pos + 2 == len(data) and whole_image:
                break  # opj_decode stops where the stream does: "does not end with EOC"
            raise ValueError(f"JPEG 2000: 0x{marker:04X} where a tile-part should start")
        if pos + 12 > len(data):
            raise ValueError("JPEG 2000 codestream ends in an SOT segment")
        lsot, t, psot, tpsot, tnsot = struct.unpack_from(">HHIBB", data, pos + 2)
        if lsot != 10:
            raise ValueError(f"JPEG 2000 SOT segment of length {lsot}")
        if t >= n_tiles:
            raise ValueError(f"JPEG 2000 tile {t} of {n_tiles}")
        start = pos
        end = len(data) if psot == 0 else start + psot
        if psot == 0:
            tail = data.rfind(b"\xff\xd9")
            end = tail if tail > start else len(data)
        if end > len(data):
            raise ValueError("JPEG 2000 tile-part runs past the end of the data")
        tile = cs.tiles.get(t)
        if tile is None:
            tile = cs.tiles[t] = _Tile(default)
            tile.pocs = list(main["pocs"])
        if tpsot != tile.parts:
            raise ValueError(f"JPEG 2000 tile-part {tpsot} of tile {t} where part {tile.parts} "
                             "should come (OpenJPEG refuses it)")
        tile.parts += 1
        pos += 12
        while True:
            if pos + 2 > end:
                raise ValueError("JPEG 2000 tile-part header runs past its tile-part")
            if _u16(data, pos) == _SOD:
                pos += 2
                break
            pos = _next_marker(data, pos, end, _TILE_MARKERS)
            marker = _u16(data, pos)
            length = _u16(data, pos + 2)
            seg = data[pos + 4:pos + 2 + length]
            if length < 2 or pos + 2 + length > end:
                raise ValueError("JPEG 2000 marker segment runs past its tile-part")
            if marker in (_COD, _COC, _QCD, _QCC, _RGN, _POC):
                _apply(cs, tile, marker, seg, main=False)
            elif marker == _PPT:
                raise ValueError(_PACKED)
            elif marker == _MCT:
                _check_mct(seg)
            elif marker in (_MCC, _MCO, _CBD):
                raise ValueError(f"JPEG 2000 Part 2 marker 0x{marker:04X} is not read")
            pos += 2 + length
        tile.data += data[pos:end]
        pos = end
        if tnsot and tile.parts == tnsot:
            complete += 1
    return cs


# --- tier 2


class _Bits:
    """OpenJPEG's packet-header bit reader (``bio.c``): after a 0xFF byte
    the next byte holds 7 bits."""

    __slots__ = ("d", "p", "end", "buf", "ct")

    def __init__(self, d: bytes, p: int, end: int):
        self.d, self.p, self.end, self.buf, self.ct = d, p, end, 0, 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.p < self.end:
                self.buf |= self.d[self.p]
                self.p += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> None:
        if (self.buf & 0xFF) == 0xFF:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.p < self.end:
                self.buf |= self.d[self.p]
                self.p += 1
        self.ct = 0


class _TagTree:
    """A tag tree over a w x h grid of leaves (``tgt.c``)."""

    def __init__(self, w: int, h: int):
        self.parent: List[int] = []
        sizes = []
        while True:
            sizes.append((w, h))
            if w * h <= 1:
                break
            w, h = -(-w // 2), -(-h // 2)
        base = 0
        for lv, (lw, lh) in enumerate(sizes):
            nxt = base + lw * lh
            pw = sizes[lv + 1][0] if lv + 1 < len(sizes) else 0
            for j in range(lh):
                for i in range(lw):
                    self.parent.append(nxt + (j // 2) * pw + i // 2 if lv + 1 < len(sizes)
                                       else -1)
            base = nxt
        n = len(self.parent)
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> bool:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return self.value[node] < threshold


class _Block:
    __slots__ = ("x0", "y0", "x1", "y1", "segs", "numbps", "lenbits", "new")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.segs: List[list] = []  # [data chunks, passes, maxpasses]
        self.numbps = 0
        self.lenbits = 3
        self.new: List[Tuple[int, int]] = []  # (segment index, length) of this packet


class _Band:
    def __init__(self, kind, x0, y0, x1, y1, numbps, step):
        self.kind, self.x0, self.y0, self.x1, self.y1 = kind, x0, y0, x1, y1
        self.numbps, self.step = numbps, step
        self.precincts: List[tuple] = []  # (cw, ch, blocks, incl tree, imsb tree)

    @property
    def empty(self) -> bool:
        return self.x1 <= self.x0 or self.y1 <= self.y0


class _Res:
    def __init__(self, x0, y0, x1, y1, ppx, ppy):
        self.x0, self.y0, self.x1, self.y1, self.ppx, self.ppy = x0, y0, x1, y1, ppx, ppy
        px0, py0 = (x0 >> ppx) << ppx, (y0 >> ppy) << ppy
        self.pw = 0 if x0 == x1 else -(-x1 >> ppx) - (x0 >> ppx)
        self.ph = 0 if y0 == y1 else -(-y1 >> ppy) - (y0 >> ppy)
        self.px0, self.py0 = px0, py0
        self.bands: List[_Band] = []


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _tile_comps(cs: Codestream, tile: _Tile, box) -> List[dict]:
    """Each tile-component's resolutions, bands, precincts and code-blocks
    (``opj_tcd_init_tile``)."""
    tx0, ty0, tx1, ty1 = box
    out = []
    for c, (prec, sgnd, dx, dy) in enumerate(cs.comps):
        comp = tile.comps[c]
        if len(comp.precincts) != comp.levels + 1:
            raise ValueError("JPEG 2000 COC/COD precincts do not match the levels")
        nb = 3 * comp.levels + 1
        if comp.qstyle == 1:
            e0, m0 = comp.steps[0]
            steps = [(e0, m0)] + [(max(e0 - (b - 1) // 3, 0), m0) for b in range(1, nb)]
        else:  # bands past the step sizes given keep OpenJPEG's zeroed ones
            steps = (comp.steps + [(0, 0)] * nb)[:nb]
        cx0, cy0 = _ceil_div(tx0, dx), _ceil_div(ty0, dy)
        cx1, cy1 = _ceil_div(tx1, dx), _ceil_div(ty1, dy)
        levels = comp.levels
        resolutions = []
        for r in range(levels + 1):
            lv = levels - r
            rx0, ry0 = _ceil_div(cx0, 1 << lv), _ceil_div(cy0, 1 << lv)
            rx1, ry1 = _ceil_div(cx1, 1 << lv), _ceil_div(cy1, 1 << lv)
            ppx, ppy = comp.precincts[r]
            res = _Res(rx0, ry0, rx1, ry1, ppx, ppy)
            if r == 0:
                kinds, cbgx, cbgy = (0,), ppx, ppy
                tlx, tly = res.px0, res.py0
            else:
                kinds, cbgx, cbgy = (1, 2, 3), ppx - 1, ppy - 1
                tlx, tly = _ceil_div(res.px0, 2), _ceil_div(res.py0, 2)
            cbw, cbh = min(comp.cbw, cbgx), min(comp.cbh, cbgy)
            for kind in kinds:
                if kind == 0:
                    bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                    band_no = 0
                else:
                    n = lv + 1
                    xo, yo = kind & 1, kind >> 1
                    bx0 = _ceil_div(cx0 - (xo << (n - 1)), 1 << n)
                    by0 = _ceil_div(cy0 - (yo << (n - 1)), 1 << n)
                    bx1 = _ceil_div(cx1 - (xo << (n - 1)), 1 << n)
                    by1 = _ceil_div(cy1 - (yo << (n - 1)), 1 << n)
                    band_no = 3 * (r - 1) + kind
                expn, mant = steps[band_no]
                band = _Band(kind, bx0, by0, bx1, by1, expn + comp.guard - 1, (expn, mant))
                for pno in range(res.pw * res.ph):
                    gx0 = tlx + (pno % res.pw) * (1 << cbgx) if res.pw else 0
                    gy0 = tly + (pno // res.pw) * (1 << cbgy) if res.pw else 0
                    px0, py0 = max(gx0, bx0), max(gy0, by0)
                    px1, py1 = min(gx0 + (1 << cbgx), bx1), min(gy0 + (1 << cbgy), by1)
                    if px1 <= px0 or py1 <= py0:
                        band.precincts.append((0, 0, [], None, None))
                        continue
                    cbx0, cby0 = (px0 >> cbw) << cbw, (py0 >> cbh) << cbh
                    cw = (_ceil_div(px1, 1 << cbw) << cbw) - cbx0 >> cbw
                    ch = (_ceil_div(py1, 1 << cbh) << cbh) - cby0 >> cbh
                    blocks = []
                    for j in range(ch):
                        for i in range(cw):
                            x0 = cbx0 + (i << cbw)
                            y0 = cby0 + (j << cbh)
                            blocks.append(_Block(max(x0, px0), max(y0, py0),
                                                 min(x0 + (1 << cbw), px1),
                                                 min(y0 + (1 << cbh), py1)))
                    band.precincts.append((cw, ch, blocks, _TagTree(cw, ch), _TagTree(cw, ch)))
                res.bands.append(band)
            resolutions.append(res)
        out.append(dict(box=(cx0, cy0, cx1, cy1), res=resolutions, comp=comp, dx=dx, dy=dy,
                        prec=prec, sgnd=sgnd))
    return out


def _packets(cs: Codestream, tile: _Tile, tcs: List[dict], box):
    """(layer, resolution, component, precinct) of each packet in the
    order of the tile's progression and POCs (``pi.c``)."""
    n = len(cs.comps)
    maxres = max(len(tc["res"]) for tc in tcs)
    maxprec = max((r.pw * r.ph for tc in tcs for r in tc["res"]), default=0)
    seen = set()
    if tile.pocs:  # (RSpoc, CSpoc, LYEpoc, REpoc, CEpoc, Ppoc)
        volumes = [(rs, c0, min(ly, tile.layers), re, c1, pp)
                   for rs, c0, ly, re, c1, pp in tile.pocs]
    else:
        volumes = [(0, 0, tile.layers, maxres, n, tile.progression)]
    for r0, c0, l1, r1, c1, prog in volumes:
        for key in _volume(cs, tcs, box, prog, 0, l1, r0, r1, c0, c1, maxprec):
            if key not in seen:
                seen.add(key)
                yield key


def _volume(cs, tcs, box, prog, l0, l1, r0, r1, c0, c1, maxprec):
    if prog >= len(_PROGRESSIONS):
        return  # OpenJPEG's iterator gives no packet for an unknown order
    name = _PROGRESSIONS[prog]
    if name == "LRCP":
        for l in range(l0, l1):
            for r in range(r0, r1):
                for c in range(c0, c1):
                    if r < len(tcs[c]["res"]):
                        res = tcs[c]["res"][r]
                        for p in range(res.pw * res.ph):
                            yield l, r, c, p
        return
    if name == "RLCP":
        for r in range(r0, r1):
            for l in range(l0, l1):
                for c in range(c0, c1):
                    if r < len(tcs[c]["res"]):
                        res = tcs[c]["res"][r]
                        for p in range(res.pw * res.ph):
                            yield l, r, c, p
        return
    tx0, ty0, tx1, ty1 = box

    def steps(comps):
        dxs, dys = [], []
        for c in comps:
            tc = tcs[c]
            nres = len(tc["res"])
            for r, res in enumerate(tc["res"]):
                dxs.append(tc["dx"] << (res.ppx + nres - 1 - r))
                dys.append(tc["dy"] << (res.ppy + nres - 1 - r))
        return min(dxs), min(dys)

    def precinct(c, r, x, y):
        tc = tcs[c]
        if r >= len(tc["res"]):
            return None
        res = tc["res"][r]
        lv = len(tc["res"]) - 1 - r
        dx, dy = tc["dx"], tc["dy"]
        trx0, try0 = _ceil_div(tx0, dx << lv), _ceil_div(ty0, dy << lv)
        trx1, try1 = _ceil_div(tx1, dx << lv), _ceil_div(ty1, dy << lv)
        rpx, rpy = res.ppx + lv, res.ppy + lv
        if not (y % (dy << rpy) == 0 or (y == ty0 and (try0 << lv) % (1 << rpy))):
            return None
        if not (x % (dx << rpx) == 0 or (x == tx0 and (trx0 << lv) % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (_ceil_div(x, dx << lv) >> res.ppx) - (trx0 >> res.ppx)
        prcj = (_ceil_div(y, dy << lv) >> res.ppy) - (try0 >> res.ppy)
        return prci + prcj * res.pw

    def positions(sx, sy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += sx - x % sx
            y += sy - y % sy

    if name == "RPCL":
        sx, sy = steps(range(len(tcs)))
        for r in range(r0, r1):
            for x, y in positions(sx, sy):
                for c in range(c0, c1):
                    p = precinct(c, r, x, y)
                    if p is not None:
                        for l in range(l0, l1):
                            yield l, r, c, p
    elif name == "PCRL":
        sx, sy = steps(range(len(tcs)))
        for x, y in positions(sx, sy):
            for c in range(c0, c1):
                for r in range(r0, r1):
                    p = precinct(c, r, x, y)
                    if p is not None:
                        for l in range(l0, l1):
                            yield l, r, c, p
    else:  # CPRL
        for c in range(c0, c1):
            sx, sy = steps([c])
            for x, y in positions(sx, sy):
                for r in range(r0, r1):
                    p = precinct(c, r, x, y)
                    if p is not None:
                        for l in range(l0, l1):
                            yield l, r, c, p


def _init_seg(block: _Block, style: int, first: bool) -> None:
    if style & j2k_t1.TERMALL:
        maxpasses = 1
    elif style & j2k_t1.BYPASS:
        if first:
            maxpasses = 10
        else:
            maxpasses = 2 if block.segs[-1][2] in (1, 10) else 1
    else:
        maxpasses = 109
    block.segs.append([[], 0, maxpasses])


def _numpasses(bits: _Bits) -> int:
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    n = bits.read(2)
    if n != 3:
        return 3 + n
    n = bits.read(5)
    if n != 31:
        return 6 + n
    return 37 + bits.read(7)


def _read_packets(cs: Codestream, tile: _Tile, tcs: List[dict], box) -> None:
    """Walk the tile's packets, gathering each code-block's segments."""
    d = bytes(tile.data)
    pos, end = 0, len(d)
    sop, eph = tile.csty & 2, tile.csty & 4
    packets = list(_packets(cs, tile, tcs, box))
    for c, tc in enumerate(tcs):
        reached = max((r for _, r, pc, _ in packets if pc == c), default=-1)
        if reached < len(tc["res"]) - 1:  # a POC volume of an unknown order left them out
            raise ValueError(f"JPEG 2000 tile whose packets stop at resolution {reached} of "
                             f"component {c}: OpenJPEG would rebuild it at that resolution "
                             "only (not read)")
    for layer, r, c, p in packets:
        if pos >= end:
            break  # OpenJPEG stops at the end of the tile's data
        comp = tcs[c]["comp"]
        res = tcs[c]["res"][r]
        if sop and pos + 6 <= end and d[pos] == 0xFF and d[pos + 1] == 0x91:
            pos += 6
        bits = _Bits(d, pos, end)
        present = bits.bit()
        blocks_new = []
        if present:
            for band in res.bands:
                if band.empty:
                    continue
                cw, ch, blocks, incl, imsb = band.precincts[p]
                for k, blk in enumerate(blocks):
                    if not blk.segs:
                        included = incl.decode(bits, k, layer + 1)
                    else:
                        included = bits.bit()
                    if not included:
                        continue
                    if not blk.segs:
                        i = 0
                        while not imsb.decode(bits, k, i):
                            i += 1
                        # more zero bit-planes than the band has leave none
                        # (OpenJPEG's unsigned count wraps; no pass decodes)
                        blk.numbps = band.numbps + 1 - i
                        blk.lenbits = 3
                    passes = _numpasses(bits)
                    while bits.bit():
                        blk.lenbits += 1
                    if not blk.segs:
                        _init_seg(blk, comp.style, True)
                    elif blk.segs[-1][1] == blk.segs[-1][2]:
                        _init_seg(blk, comp.style, False)
                    segno = len(blk.segs) - 1
                    new = []
                    pending = blk.segs[segno][1]
                    while True:
                        seg = blk.segs[segno]
                        take = min(seg[2] - pending, passes)
                        nbits = blk.lenbits + take.bit_length() - 1
                        if nbits > 32:
                            raise ValueError("JPEG 2000 code-block segment length of more "
                                             "than 32 bits")
                        new.append((segno, take, bits.read(nbits)))
                        passes -= take
                        if passes <= 0:
                            break
                        _init_seg(blk, comp.style, False)
                        segno += 1
                        pending = 0
                    blocks_new.append((blk, new))
        bits.align()
        pos = bits.p
        if eph:  # a missing SOP is passed over, a missing EPH is not
            if not (pos + 2 <= end and d[pos] == 0xFF and d[pos + 1] == 0x92):
                raise ValueError("JPEG 2000 packet header without its EPH marker "
                                 "(OpenJPEG refuses it)")
            pos += 2
        for blk, new in blocks_new:
            for segno, take, length in new:
                if pos + length > end:
                    raise ValueError("JPEG 2000 code-block data runs past the tile's data "
                                     "(OpenJPEG's strict mode refuses it)")
                seg = blk.segs[segno]
                seg[0].append(d[pos:pos + length])
                seg[1] += take
                pos += length


def _decode_tile(cs: Codestream, t: int) -> List[Tuple[tuple, np.ndarray]]:
    """One tile -> per component its box (x0, y0, x1, y1) on the
    component's grid and its samples (int32, DC-shifted and clamped)."""
    tile = cs.tiles[t]
    box = cs.tile_box(t)
    tcs = _tile_comps(cs, tile, box)
    _read_packets(cs, tile, tcs, box)
    planes = []
    for tc in tcs:
        comp = tc["comp"]
        reversible = comp.qmfbid == 1
        bands = []
        for r, res in enumerate(tc["res"]):
            per = []
            for band in res.bands:
                shape = (max(band.y1 - band.y0, 0), max(band.x1 - band.x0, 0))
                coeffs = np.zeros(shape, np.int32)
                for cw, ch, blocks, _, _ in band.precincts:
                    for blk in blocks:
                        if not blk.segs or not any(s[0] for s in blk.segs):
                            continue
                        segs = [(b"".join(chunks), passes) for chunks, passes, _ in blk.segs]
                        vals = j2k_t1.decode_block(segs, blk.x1 - blk.x0, blk.y1 - blk.y0,
                                                   blk.numbps, band.kind, comp.style,
                                                   comp.roishift)
                        coeffs[blk.y0 - band.y0:blk.y1 - band.y0,
                               blk.x0 - band.x0:blk.x1 - band.x0] = vals
                per.append(j2k_dwt.dequantize(coeffs, reversible, band.step, tc["prec"]))
            bands.append((res, per))
        planes.append(j2k_dwt.inverse_transform(bands, reversible))
    if tile.mct and len(planes) >= 3:
        if len({p.shape for p in planes[:3]}) != 1:
            raise ValueError("JPEG 2000 component transform over components of different "
                             "sizes (OpenJPEG refuses it)")
        planes[:3] = j2k_dwt.inverse_mct(planes[:3], tcs[0]["comp"].qmfbid == 1)
    out = []
    for tc, plane in zip(tcs, planes):
        out.append((tc["box"], j2k_dwt.dc_shift(plane, tc["prec"], tc["sgnd"],
                                                tc["comp"].qmfbid == 1)))
    return out


def decode_tiles(data: bytes, whole_image: bool = False):
    """The codestream and, for each tile in codestream order of its first
    part, its index and each component's (box, int32 samples)."""
    cs = parse(data, whole_image)
    return cs, [(t, _decode_tile(cs, t)) for t in cs.tiles]


def decode_codestream(data: bytes) -> Tuple[Codestream, List[np.ndarray]]:
    """The codestream and each component's samples on its own grid (int32,
    tiles never decoded left at zero), as ``opj_decode`` leaves them."""
    cs, tiles = decode_tiles(data, whole_image=True)
    comps = []
    for c in range(len(cs.comps)):
        x0, y0, x1, y1 = cs.comp_box(c)
        comps.append(np.zeros((y1 - y0, x1 - x0), np.int32))
    for _, parts in tiles:
        for c, ((bx0, by0, bx1, by1), plane) in enumerate(parts):
            x0, y0, _, _ = cs.comp_box(c)
            comps[c][by0 - y0:by1 - y0, bx0 - x0:bx1 - x0] = plane
    return cs, comps

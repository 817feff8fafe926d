"""JPEG 2000 pages: the JP2 box file and each reference route's reading of
a raw codestream or a JP2 file, equal byte for byte to PIL's
``Image.open(path).convert("RGB")`` (``route="pil"``) and to
``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` (``route="cv2"``). Both reach
OpenJPEG (PIL 12.1 bundles 2.5.4, cv2 5.0 links 2.5.3); ``j2k.py`` decodes
the codestream as it does, this module holds what each route makes of the
components.

The JP2 file: the signature box, ``ftyp`` (its brand is not checked by
either route), and ``jp2h`` with ``ihdr``, ``colr`` (the first one: an
enumerated colour space, sRGB 16, greyscale 17, sYCC 18, e-sYCC 24 or CMYK
12, or an ICC profile, which OpenJPEG reports as an unknown colour space),
``pclr``, ``cmap``, ``cdef`` and ``res `` (skipped); the codestream is the
``jp2c`` box.

- PIL (``Jpeg2KImagePlugin`` and ``Jpeg2KDecode.c``) takes its mode from
  the header: a codestream's SIZ (1 component ``L``, or ``I;16`` above 8
  bits; 2 ``LA``; 3 ``RGB``; 4 ``RGBA``; more raises), a JP2's ``ihdr``
  (the same), ``colr`` CMYK making 4 components ``CMYK``, and an 8-bit
  ``pclr`` over ``L``/``LA`` making ``P``/``PA`` with a palette built by
  ``ImagePalette.getcolor`` (repeated colours share one slot; the slots
  after the last are black). Its decoder refuses more than 4 components,
  takes the header's colour space (a ``colr`` other than the enumerated
  ones, or none, leaves it unspecified), guesses an unspecified one (1-2
  components grey, 3-4 sRGB unless component 1 or 2 is the first
  subsampled one, then sYCC), and needs an unpacker for (mode, colour
  space, components). It decodes tile by tile (``opj_decode_tile_data``:
  no palette, no channel definitions) and unpacks each sample as
  ``(offset + word) << (8 - prec)`` or ``>> (prec - 8)`` with a rounding
  half added, stored in 8 bits (a 16-bit sample of 65408 or more wraps
  to 0), a subsampled component read at ``x // dx`` in rows of ``w //
  dx``; sYCC goes through ``ImagingConvertYCbCr2RGB``. ``convert("RGB")``
  then clips ``I;16`` to 255, drops alpha, maps ``P``/``PA`` through the
  palette and converts CMYK with ``cmyk2rgb``.
- cv2 (``Jpeg2KOpjDecoder``) decodes the whole image (``opj_decode``,
  which applies ``pclr`` through ``cmap`` and reorders by ``cdef``),
  refuses more than 4 components, signed samples, precisions under 8,
  subsampled or offset components and colour spaces other than sRGB,
  grey and sYCC (an unknown or unspecified one is taken for sRGB, so a
  raw codestream of 1 or 2 components is refused); it shifts every
  sample right by the largest precision less 8 and keeps the low byte,
  takes components 2, 1, 0 for sRGB, component 0 three times for grey,
  and OpenCV's fixed-point ``COLOR_YUV2BGR`` for sYCC.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from tdnet_torch.data import j2k

__all__ = ["SIGNATURES", "READS", "ROUTES", "is_jpeg2000", "decode_jpeg2000", "jpeg2000_size"]

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
SIGNATURES = (j2k.SIGNATURE, JP2_SIGNATURE)
READS = "JPEG 2000 (J2K codestream or JP2 file; 5/3 and 9/7, any progression and layers)"
ROUTES = ("pil", "cv2")

_PIL_MAX_PIXELS = 2 * 89478485  # past twice Image.MAX_IMAGE_PIXELS, PIL refuses to open
_CV2_MAX_SIDE, _CV2_MAX_PIXELS = 1 << 20, 1 << 30  # OpenCV's CV_IO_MAX_IMAGE_* defaults

# OpenJPEG's colour spaces (OPJ_COLOR_SPACE)
UNKNOWN, UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = -1, 0, 1, 2, 3, 4, 5
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}
_NAMES = {UNKNOWN: "unknown", UNSPECIFIED: "unspecified", SRGB: "sRGB", GRAY: "greyscale",
          SYCC: "sYCC", EYCC: "e-sYCC", CMYK: "CMYK"}


def is_jpeg2000(data: bytes) -> bool:
    return data.startswith(SIGNATURES)


# --- the JP2 boxes


def _boxes(data: bytes, pos: int, end: int):
    """(type, body start, body end) of the boxes in data[pos:end]. OpenJPEG
    takes the codestream box to the end of the data, whatever its length
    says."""
    while pos + 8 <= end:
        lbox, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if lbox == 1:
            if pos + 16 > end:
                raise ValueError("JP2 box header runs past the data")
            lbox = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
        if kind == b"jp2c":
            yield kind, pos + head, end
            return
        if lbox == 0:
            lbox = end - pos
        if lbox < head or pos + lbox > end:
            raise ValueError(f"JP2 {kind!r} box of a bad length {lbox}")
        yield kind, pos + head, pos + lbox
        pos += lbox


class _Header:
    """What OpenJPEG reads of a JP2 file's header (``jp2.c``)."""

    def __init__(self):
        self.size: Optional[Tuple[int, int]] = None  # ihdr (w, h)
        self.enumcs = 0
        self.has_colr = False
        self.pclr: Optional[Tuple[np.ndarray, List[int], List[int]]] = None  # entries, sizes, signs
        self.cmap: Optional[List[Tuple[int, int, int]]] = None
        self.cdef: Optional[List[Tuple[int, int, int]]] = None
        self.codestream = b""

    @property
    def color_space(self) -> int:
        return _ENUMCS.get(self.enumcs, UNKNOWN)


def _read_jp2(data: bytes) -> _Header:
    """The JP2 boxes as OpenJPEG reads them: the header box's ``ihdr``,
    the first ``colr``, ``pclr``, ``cmap`` and ``cdef``, and the
    codestream of ``jp2c``."""
    hdr = _Header()
    seen_jp2h = False
    for kind, b0, b1 in _boxes(data, 0, len(data)):
        if kind == b"jp2h":
            seen_jp2h = True
            for sub, s0, s1 in _boxes(data, b0, b1):
                body = data[s0:s1]
                if sub == b"ihdr":
                    if hdr.size is not None:
                        continue
                    if len(body) != 14:
                        raise ValueError("JP2 ihdr box of a bad size")
                    h, w, nc = struct.unpack_from(">IIH", body)
                    if nc == 0 or nc > 16384:
                        raise ValueError(f"JP2 ihdr with {nc} components")
                    hdr.size = (w, h)
                elif sub == b"colr":
                    if len(body) < 3:
                        raise ValueError("JP2 colr box of a bad size")
                    if hdr.has_colr:
                        continue
                    if body[0] == 1:  # enumerated
                        if len(body) < 7:
                            raise ValueError("JP2 colr box of a bad size")
                        hdr.enumcs = struct.unpack_from(">I", body, 3)[0]
                        hdr.has_colr = True
                    elif body[0] == 2:  # ICC: an unknown colour space to OpenJPEG
                        hdr.has_colr = True
                elif sub == b"pclr":
                    hdr.pclr = _read_pclr(body, hdr.pclr)
                elif sub == b"cmap":
                    if hdr.pclr is None:
                        raise ValueError("JP2 cmap box before its pclr box")
                    if hdr.cmap is not None:
                        raise ValueError("JP2 header with two cmap boxes")
                    n = hdr.pclr[0].shape[1]
                    if len(body) < 4 * n:
                        raise ValueError("JP2 cmap box too short")
                    hdr.cmap = [struct.unpack_from(">HBB", body, 4 * i) for i in range(n)]
                elif sub == b"cdef":
                    if hdr.cdef is not None:
                        raise ValueError("JP2 header with two cdef boxes")
                    if len(body) < 2:
                        raise ValueError("JP2 cdef box too short")
                    n = struct.unpack_from(">H", body)[0]
                    if n == 0 or len(body) < 2 + 6 * n:
                        raise ValueError("JP2 cdef box too short")
                    hdr.cdef = [struct.unpack_from(">HHH", body, 2 + 6 * i) for i in range(n)]
        elif kind == b"jp2c":
            if not seen_jp2h:
                raise ValueError("JP2 file whose codestream comes before its header box")
            hdr.codestream = data[b0:b1]
            break
    if not seen_jp2h:
        raise ValueError("JP2 file without a jp2h box")
    if hdr.size is None:
        raise ValueError("JP2 file without an ihdr box")
    if not hdr.codestream:
        raise ValueError("JP2 file without a codestream (jp2c box)")
    return hdr


def _check_ihdr(hdr: _Header, cs: j2k.Codestream) -> None:
    """OpenJPEG refuses a JP2 whose ``ihdr`` size is not the codestream's."""
    if hdr.size != cs.size:
        raise ValueError(f"JP2 ihdr of {hdr.size[0]}x{hdr.size[1]}, its codestream "
                         f"{cs.size[0]}x{cs.size[1]} (OpenJPEG refuses it)")


def _read_pclr(body: bytes, old) -> Tuple[np.ndarray, List[int], List[int]]:
    if old is not None:
        raise ValueError("JP2 header with two pclr boxes")
    if len(body) < 3:
        raise ValueError("JP2 pclr box too short")
    n, nc = struct.unpack_from(">HB", body)
    if n == 0 or n > 1024 or nc == 0:
        raise ValueError(f"JP2 pclr box of {n} entries and {nc} columns")
    if len(body) < 3 + nc:
        raise ValueError("JP2 pclr box too short")
    sizes = [(b & 0x7F) + 1 for b in body[3:3 + nc]]
    signs = [b >> 7 for b in body[3:3 + nc]]
    entries = np.zeros((n, nc), np.int64)
    p = 3 + nc
    for j in range(n):
        for i in range(nc):
            k = min((sizes[i] + 7) >> 3, 4)
            if p + k > len(body):
                raise ValueError("JP2 pclr box too short for its entries")
            entries[j, i] = int.from_bytes(body[p:p + k], "big")
            p += k
    return entries, sizes, signs


# --- sizes


def _pil_header(data: bytes):
    """PIL's ``_parse_codestream`` / ``_parse_jp2_header``: (size, mode,
    palette colours or None)."""
    if data.startswith(j2k.SIGNATURE):
        if len(data) < 4 + 38:
            raise ValueError("truncated JPEG 2000 codestream header")
        w, h = j2k.codestream_size(data)
        csiz = struct.unpack_from(">H", data, 40)[0]
        if csiz == 1:
            mode = "I;16" if (data[42] & 0x7F) + 1 > 8 else "L"
        else:
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(csiz)
        if mode is None:
            raise ValueError(f"JPEG 2000 of {csiz} components: PIL cannot determine its mode")
        return _pil_size_checked((w, h)), mode, None
    header = None
    for kind, b0, b1 in _boxes(data, 12, len(data)):
        if kind == b"jp2h":
            header = (b0, b1)
            break
    if header is None:
        raise ValueError("JP2 file without a jp2h box (PIL's reader fails)")
    size = mode = None
    nc = 0
    palette = None
    for kind, b0, b1 in _boxes(data, *header):
        body = data[b0:b1]
        if kind == b"ihdr":
            if len(body) < 11:
                raise ValueError("JP2 ihdr box too short")
            h, w, nc, bpc = struct.unpack_from(">IIHB", body)
            size = (w, h)
            mode = ("I;16" if (bpc & 0x7F) > 8 else "L") if nc == 1 else \
                {2: "LA", 3: "RGB", 4: "RGBA"}.get(nc)
        elif kind == b"colr" and nc == 4:
            if len(body) < 7:
                raise ValueError("JP2 colr box too short")
            if body[0] == 1 and struct.unpack_from(">I", body, 3)[0] == 12:
                mode = "CMYK"
        elif kind == b"pclr" and mode in ("L", "LA"):
            ne, npc = struct.unpack_from(">HB", body)
            depths = body[3:3 + npc]
            if max(depths, default=0) <= 8:
                colors: Dict[tuple, int] = {}
                p = 3 + npc
                for _ in range(ne):
                    color = tuple(body[p:p + npc])
                    p += npc
                    if len(color) < npc:
                        raise ValueError("JP2 pclr box too short (PIL's reader fails)")
                    if npc == 4 and len(color) == 3:
                        color += (255,)
                    if color not in colors:
                        if len(colors) >= 256:
                            raise ValueError("JP2 palette of more than 256 colours "
                                             "(PIL cannot allocate them)")
                        colors[color] = len(colors)
                palette = (list(colors), npc)
                mode = "P" if mode == "L" else "PA"
    if size is None or mode is None:
        raise ValueError("malformed JP2 header (PIL cannot determine its size and mode)")
    return _pil_size_checked(size), mode, palette


def _pil_size_checked(size: Tuple[int, int]) -> Tuple[int, int]:
    if size[0] <= 0 or size[1] <= 0:
        raise ValueError(f"JPEG 2000 of {size[0]}x{size[1]}: PIL cannot open it")
    if size[0] * size[1] > _PIL_MAX_PIXELS:
        raise ValueError(f"JPEG 2000 of {size[0]}x{size[1]}: PIL refuses it as a "
                         "decompression bomb")
    return size


def jpeg2000_size(data: bytes) -> Tuple[int, int]:
    """PIL's ``.size``: Xsiz - XOsiz by Ysiz - YOsiz of a codestream, the
    ``ihdr`` width and height of a JP2 file."""
    return _pil_header(data)[0]


# --- the PIL route


def _pil_word(plane: np.ndarray, prec: int) -> np.ndarray:
    """Samples as the tile buffer holds them and PIL reads them back: 1, 2
    or 4 bytes a sample, read unsigned."""
    size = (prec + 7) >> 3
    bits = {1: 8, 2: 16}.get(size, 32)
    return plane.astype(np.int64) & ((1 << bits) - 1)


def _pil_shift(word: np.ndarray, prec: int, sgnd: bool, target: int = 8) -> np.ndarray:
    """``j2ku_shift(offset + word, target - prec)``."""
    shift = target - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
        return (offset + word) >> -shift
    return (offset + word) << shift


def _ycbcr_tables():
    i = np.arange(256) - 128
    t = lambda c: np.trunc(i * c * 64 + 0.5).astype(np.int64)  # noqa: E731 (C's (int)(v + 0.5))
    return t(1.40200), t(-0.34414), t(-0.71414), t(1.77200)


_R_CR, _G_CB, _G_CR, _B_CB = _ycbcr_tables()


def _pil_ycbcr_rgb(ycc: np.ndarray) -> np.ndarray:
    """Pillow's ``ImagingConvertYCbCr2RGB``."""
    y, cb, cr = (ycc[..., k].astype(np.int64) for k in range(3))
    r = y + (_R_CR[cr] >> 6)
    g = y + ((_G_CB[cb] + _G_CR[cr]) >> 6)
    b = y + (_B_CB[cb] >> 6)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


_UNPACKERS = {  # (mode, colour space, components) -> (unpacker, subsampling allowed)
    ("L", GRAY, 1): ("gray", False), ("P", SRGB, 1): ("gray", False),
    ("PA", SRGB, 2): ("graya", False), ("I;16", GRAY, 1): ("gray16", False),
    ("LA", GRAY, 2): ("graya", False),
    ("RGB", GRAY, 1): ("gray", False), ("RGB", GRAY, 2): ("gray", False),
    ("RGB", SRGB, 3): ("srgb", True), ("RGB", SYCC, 3): ("sycc", True),
    ("RGB", SRGB, 4): ("srgb", True), ("RGB", SYCC, 4): ("sycc", True),
    ("RGBA", GRAY, 1): ("gray", False), ("RGBA", GRAY, 2): ("graya", False),
    ("RGBA", SRGB, 3): ("srgb", True), ("RGBA", SYCC, 3): ("sycc", True),
    ("RGBA", SRGB, 4): ("srgb", True), ("RGBA", SYCC, 4): ("sycc", True),
    ("CMYK", CMYK, 4): ("cmyk", True),
}


def _pil_tile(cs: j2k.Codestream, box, parts, which: str, nout: int) -> np.ndarray:
    """One tile's pixels as PIL's unpacker writes them: (h, w, nout). The
    tile buffer holds each component's samples back to back, 1, 2 or 4
    bytes each; PIL finds component k after ``w // dx * (h // dy)`` samples
    of each one before it, whatever their real size."""
    x0, y0, x1, y1 = box
    w, h = x1 - x0, y1 - y0
    sizes = [{1: 1, 2: 2}.get((cs.comps[k][0] + 7) >> 3, 4) for k in range(len(parts))]
    buf = b"".join(_pil_word(plane, cs.comps[k][0]).astype(f"<u{sizes[k]}").tobytes()
                   for k, (_, plane) in enumerate(parts))
    out = np.zeros((h, w, nout), np.int64)
    if which in ("gray", "gray16", "graya"):
        gray = _words_at(buf, 0, sizes[0], w * h).reshape(h, w)
        out[:, :, :] = _pil_shift(gray, *cs.comps[0][:2], 16 if which == "gray16" else 8)[
            :, :, None]
        if which == "graya":
            alpha = _words_at(buf, sizes[0] * w * h, sizes[1], w * h).reshape(h, w)
            out[:, :, 3] = _pil_shift(alpha, *cs.comps[1][:2])
        return out
    offset = 0
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    for k in range(4 if which == "cmyk" else min(len(parts), 3)):
        prec, sgnd, dx, dy = cs.comps[k]
        rw = w // dx
        count = rw * (h // dy)
        idx = (ys // dy) * rw + xs // dx
        comp = _words_at(buf, offset, sizes[k], max(count, int(idx.max()) + 1))
        out[:, :, k] = _pil_shift(comp[idx], prec, sgnd)
        offset += sizes[k] * count
    return out


def _words_at(buf: bytes, start: int, size: int, count: int) -> np.ndarray:
    """``count`` little-endian words of ``size`` bytes from byte ``start``
    of the zero-padded tile buffer."""
    need = start + size * count
    if need > len(buf):
        buf = buf + bytes(need - len(buf))
    return np.frombuffer(buf, f"<u{size}", count, start).astype(np.int64)


def _pil(data: bytes) -> np.ndarray:
    (width, height), mode, palette = _pil_header(data)
    if data.startswith(j2k.SIGNATURE):
        codestream, color = data, UNSPECIFIED
    else:
        hdr = _read_jp2(data)
        codestream = hdr.codestream
        # the header's colour space (``opj_jp2_read_header``): one of the
        # enumerated ones, else unspecified (no colr, ICC, other values)
        color = _ENUMCS.get(hdr.enumcs, UNSPECIFIED)
    cs = j2k.parse(codestream)
    if not data.startswith(j2k.SIGNATURE):
        _check_ihdr(hdr, cs)
    n = len(cs.comps)
    if n > 4:
        raise ValueError(f"JPEG 2000 of {n} components: PIL's decoder refuses more than 4 "
                         "(broken data stream)")
    first_sub = next((k for k, (_, _, dx, dy) in enumerate(cs.comps) if dx != 1 or dy != 1),
                     -1)
    if color == UNSPECIFIED:
        color = GRAY if n <= 2 else SYCC if first_sub in (1, 2) else SRGB
    found = _UNPACKERS.get((mode, color, n))
    if found is None or (first_sub >= 0 and not found[1]):
        raise ValueError(f"JPEG 2000 {_NAMES[color]} image of {n} components as PIL mode "
                         f"{mode}: PIL has no unpacker for it (broken data stream)")
    which = found[0]
    nout = 1 if mode in ("L", "P", "I;16") else 4
    image = np.zeros((height, width, nout), np.int64)
    _, tiles = j2k.decode_tiles(codestream)
    for t, parts in tiles:
        x0, y0, x1, y1 = cs.tile_box(t)
        if (x0 - cs.x0) + (x1 - x0) > width or (y0 - cs.y0) + (y1 - y0) > height:
            raise ValueError("JPEG 2000 tile outside PIL's image (broken data stream)")
        px = _pil_tile(cs, (x0, y0, x1, y1), parts, which, nout)
        if which == "sycc":
            px[:, :, :3] = _pil_ycbcr_rgb(px[:, :, :3] & 0xFF)
        image[y0 - cs.y0:y1 - cs.y0, x0 - cs.x0:x1 - cs.x0] = px
    if mode == "I;16":
        return np.repeat(np.minimum(image & 0xFFFF, 255).astype(np.uint8), 3, axis=2)
    px = (image & 0xFF).astype(np.int64)
    if mode == "L":
        return np.repeat(px.astype(np.uint8), 3, axis=2)
    if mode in ("P", "PA"):
        colors, npc = palette
        lut = np.zeros((256, 3), np.int64)  # slots past the palette's colours are black
        for i, color in enumerate(colors):
            lut[i] = (tuple(color) + (0, 0, 0))[:3]
        return lut[px[:, :, 0]].astype(np.uint8)
    if mode == "CMYK":
        nk = 255 - px[:, :, 3:]
        t = px[:, :, :3] * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    return px[:, :, :3].astype(np.uint8)


# --- the cv2 route


def _yuv_bgr(ycc: np.ndarray) -> np.ndarray:
    """OpenCV's 8-bit ``COLOR_YUV2BGR`` (``YCrCb2RGB_i`` with the BT.601
    YUV coefficients, 14-bit fixed point) -> RGB."""
    y, u, v = (ycc[..., k].astype(np.int64) - (0 if k == 0 else 128) for k in range(3))

    def descale(x):
        return (x + (1 << 13)) >> 14

    b = y + descale(u * 33292)
    g = y + descale(u * -6472 + v * -9519)
    r = y + descale(v * 18678)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _apply_pclr(hdr: _Header, comps: List[np.ndarray], info: List[list]):
    """``opj_jp2_check_color`` and ``opj_jp2_apply_pclr``: the palette
    columns through ``cmap`` become the components."""
    entries, sizes, signs = hdr.pclr
    nch = entries.shape[1]
    cmap = [list(e) for e in hdr.cmap]
    used = [False] * nch
    for i, (cmp, mtyp, pcol) in enumerate(cmap):
        if cmp >= len(comps):
            raise ValueError(f"JP2 cmap names component {cmp} of {len(comps)}")
        if mtyp not in (0, 1) or pcol >= nch or (mtyp == 1 and used[pcol]) or \
                (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
            raise ValueError("JP2 cmap that OpenJPEG refuses")
        used[pcol] = True
    if any(not used[i] and cmap[i][1] != 0 for i in range(nch)):
        raise ValueError("JP2 palette column without a mapping")
    if len(comps) == 1 and not all(used):
        for i in range(nch):
            cmap[i][1], cmap[i][2] = 1, i
    top = entries.shape[0] - 1
    new, new_info = [], []
    for i, (cmp, mtyp, pcol) in enumerate(cmap):
        src = comps[cmp]
        if mtyp == 0:
            new.append(src.copy())
        else:
            new.append(entries[np.clip(src, 0, top), pcol].astype(np.int64))
        new_info.append([sizes[i], signs[i]] + info[cmp][2:])
    return new, new_info


def _apply_cdef(hdr: _Header, comps: List[np.ndarray], info: List[list]) -> None:
    """``opj_jp2_apply_cdef``: swap colour channels into their association."""
    cdef = [list(e) for e in hdr.cdef]
    n = len(comps)
    for i, (cn, typ, asoc) in enumerate(cdef):
        if cn >= n or asoc in (0, 65535):
            continue
        acn = asoc - 1
        if acn >= n:
            continue
        if cn != acn and typ == 0:
            comps[cn], comps[acn] = comps[acn], comps[cn]
            info[cn], info[acn] = info[acn], info[cn]
            for e in cdef[i + 1:]:
                if e[0] == cn:
                    e[0] = acn
                elif e[0] == acn:
                    e[0] = cn


def _check_cdef(hdr: _Header, ncomps: int) -> None:
    nr = ncomps
    if hdr.pclr is not None and hdr.cmap is not None:
        nr = hdr.pclr[0].shape[1]
    for cn, _, asoc in hdr.cdef:
        if cn >= nr or (asoc not in (0, 65535) and asoc - 1 >= nr):
            raise ValueError("JP2 cdef names a channel the image lacks (OpenJPEG refuses it)")
    for c in range(nr):
        if not any(cn == c for cn, _, _ in hdr.cdef):
            raise ValueError("JP2 cdef without a definition for every channel "
                             "(OpenJPEG refuses it)")


def _cv2(data: bytes) -> np.ndarray:
    if data.startswith(j2k.SIGNATURE):
        hdr, codestream, color = None, data, UNSPECIFIED
    else:
        hdr = _read_jp2(data)
        codestream, color = hdr.codestream, hdr.color_space
    cs = j2k.parse(codestream, whole_image=True)
    if hdr is not None:
        _check_ihdr(hdr, cs)
    n = len(cs.comps)
    w, h = cs.size
    if w > _CV2_MAX_SIDE or h > _CV2_MAX_SIDE or w * h > _CV2_MAX_PIXELS:
        raise ValueError(f"JPEG 2000 of {w}x{h}: past OpenCV's image size limits")
    if not 1 <= n <= 4:
        raise ValueError(f"JPEG 2000 of {n} components: cv2 reads 1 to 4")
    if any(sgnd for _, sgnd, _, _ in cs.comps):
        raise ValueError("JPEG 2000 with signed components: cv2 refuses them")
    max_prec = max(prec for prec, _, _, _ in cs.comps)
    if max_prec < 8:
        raise ValueError(f"JPEG 2000 of {max_prec}-bit samples: cv2 reads 8 bits and more")
    _, comps = j2k.decode_codestream(codestream)
    info = [[prec, sgnd, dx, dy] + list(cs.comp_box(k)[:2])
            for k, (prec, sgnd, dx, dy) in enumerate(cs.comps)]
    comps = [c.astype(np.int64) for c in comps]
    if hdr is not None:
        if hdr.cdef is not None:
            _check_cdef(hdr, n)
        if hdr.pclr is not None and hdr.cmap is not None:
            comps, info = _apply_pclr(hdr, comps, info)
        if hdr.cdef is not None:
            _apply_cdef(hdr, comps, info)
    if color not in (UNKNOWN, UNSPECIFIED, SRGB, GRAY, SYCC):
        raise ValueError(f"JPEG 2000 in the {_NAMES[color]} colour space: cv2 cannot convert "
                         "it to BGR")
    width, height = cs.size
    for k, c in enumerate(comps):
        _, _, dx, dy, cx0, cy0 = info[k]
        if dx != 1 or dy != 1 or cx0 != 0 or cy0 != 0 or c.shape != (height, width):
            raise ValueError("JPEG 2000 with subsampled or offset components: cv2 refuses "
                             "them (tiles are not supported)")
    shift = max(max_prec - 8, 0)
    if color == GRAY:
        g = ((comps[0] >> shift) & 0xFF).astype(np.uint8)
        return np.repeat(g[:, :, None], 3, axis=2)
    if len(comps) < 3:
        raise ValueError(f"JPEG 2000 of {len(comps)} components in the "
                         f"{_NAMES[color]} colour space: cv2 cannot make BGR of it")
    planes = np.stack([(comps[k] >> shift) & 0xFF for k in range(3)], -1).astype(np.uint8)
    if color == SYCC:
        return _yuv_bgr(planes)
    return planes


def decode_jpeg2000(data: bytes, route: str = "pil") -> np.ndarray:
    """A J2K codestream or JP2 file -> (H, W, 3) uint8 RGB by the rule of
    ``route`` (``"pil"`` or ``"cv2"``); what the route's reference refuses
    raises ``ValueError`` naming the case."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    data = bytes(data)
    return _pil(data) if route == "pil" else _cv2(data)

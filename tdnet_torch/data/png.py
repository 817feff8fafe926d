"""PNG and APNG decoding and PNG encoding with zlib and numpy, so the port
reads pages without PIL or cv2 (the GPU machine has neither).

Reads every PNG colour type (gray, RGB, palette, gray+alpha, RGBA) at every
bit depth the format allows (1, 2, 4, 8 and 16), non-interlaced or Adam7,
with all five row filters, by the rules of the decoder the reference reads
with on each route: PIL's ``Image.open(path).convert("RGB")`` for files
(``route="pil"``) and ``cv2.imdecode(buf, IMREAD_COLOR)`` for serve bodies
(``route="cv2"``). Gray is repeated, alpha dropped, palette indices looked
up (an index past the palette black) and gray below 8 bits scaled to
0..255 on both. Writes 8-bit gray, RGB
or RGBA with the Up filter on every row.

The routes part on these points (each probed against PIL 12.1 and cv2 5.0
with libpng 1.6):

- **16 bits.** PIL keeps the high byte of RGB, gray+alpha and RGBA and
  clips gray to 255. cv2 keeps the high byte of every colour type, but
  ``(v + 127) // 255``, clipped to 255, on its animation path.
- **Chunks and CRCs.** PIL walks the chunks up to the first ``IDAT`` (or
  ``fdAT``) with every CRC checked and every type four of ``[A-Za-z0-9_]``;
  the image data is the run of consecutive data chunks from there, CRCs
  unread; after it, it reads chunks up to ``IEND`` (a cut header ends the
  walk, a cut body raises) and stops at an ``fcTL`` when animated. The
  last ``IHDR`` before the data counts. cv2 checks the CRCs of ``IHDR``,
  ``PLTE`` and (off its animation path) ``IDAT`` only, refuses a second
  ``IHDR``, an unknown critical chunk or a ``PLTE`` that is not 1 to 256
  whole entries, and wants every chunk whole up to an ``IEND``; the image
  is the first run of ``IDAT`` chunks.
- **The zlib stream** is fed a chunk at a time (at most 64 KiB a read for
  PIL, 8 KiB for libpng). An error met before the rows are all out
  refuses on both routes; past them it is ignored. A stream that ends
  early leaves PIL's missing rows 0, unless it ends inside a row (then PIL
  raises "image file is truncated"); cv2 refuses it.
- **APNG.** An ``acTL`` before the image data makes the file animated.
  PIL: a second ``acTL``, or a frame count of 0 or past 2**31, leaves it a
  still image; a cut ``acTL`` or ``fcTL`` raises; ``fcTL`` and ``fdAT``
  sequence numbers must run 0, 1, 2, ... (else it refuses), and an
  ``fcTL`` before the image data must lie inside the canvas and gives the
  box the data is decoded into (at the ``fcTL``'s size; the rest 0). PIL
  returns that image (the ``IDAT`` image), never a later frame.
  cv2: an ``acTL`` must be 8 bytes and an ``fcTL`` 26 (else it refuses);
  the last ``acTL`` before the data counts; a count of 0 refuses and of 1
  reads a still image; from 2 up cv2 returns the first frame, no CRC but
  ``IHDR``'s and ``PLTE``'s checked and sequence numbers ignored. The
  first frame is the ``IDAT`` image when an ``fcTL`` comes before it
  (decoded at the ``IHDR`` size, its top-left ``fcTL`` box placed at the
  ``fcTL`` offset), else the first ``fcTL`` after it, whose ``fdAT`` (and
  ``IDAT``) chunks are decoded at the ``fcTL`` size and placed at its
  offset; either way on a black canvas, copied whatever the blend op. An
  ``fcTL`` that reaches past the canvas, or whose dispose op is past 2 or
  blend op past 1, refuses, and so does a frame ``fcTL`` of zero width or
  height; the frame ends at the next ``fcTL`` (checked the same, but for
  its size) or at ``IEND``, and a frame that ends nowhere, or whose rows
  are short, refuses. zlib errors are benign on this path: the rows out
  before one stand, and the ``IDAT`` image that is not a frame is only
  checked for bad row filters. (cv2 crashes on an ``fdAT`` of under 4
  bytes; the port refuses one.)
- **EXIF.** cv2 turns a still image by the orientation of its first
  ``eXIf`` chunk whose CRC holds and that starts ``II*\\0`` or ``MM\\0*``
  (before or after the image data; a "Raw profile type exif" text chunk
  is not read), as OpenCV's ``ExifReader`` parses it. Its animation path
  and PIL turn nothing.
- **Size limits.** PIL refuses past 2 * 89478485 pixels; cv2 past 2**30
  pixels or 2**20 a side, and libpng past 1000000 a side.

Rows whose filter is Average or Paeth depend on the reconstructed byte to
their left, so a page that uses them is reconstructed along anti-diagonals
(each step vectorised over the rows it crosses); pages with only None, Sub
and Up filters are reconstructed a row at a time.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from tdnet_torch.data.jpeg import _orient, _tiff_orientation

__all__ = ["SIGNATURE", "READS", "ROUTES", "decode_png", "encode_png", "png_size"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
READS = ("PNG and APNG (gray, RGB, palette, gray+alpha, RGBA at 1 to 16 bits, "
         "non-interlaced or Adam7) and .npy")
ROUTES = ("pil", "cv2")
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
_CID = re.compile(rb"[A-Za-z0-9_]{4}")  # PIL's chunk type check
_DATA = (b"IDAT", b"fdAT")
_READ_BLOCK = {"pil": 65536, "cv2": 8192}  # bytes of a chunk fed to zlib at once
_PIL_MAX_PIXELS = 2 * 89478485
_CV2_MAX_SIDE, _CV2_MAX_PIXELS = 1 << 20, 1 << 30
_LIBPNG_MAX_SIDE = 1000000


class _Chunk(NamedTuple):
    kind: bytes
    body: bytes          # shorter than ``length`` where the file ends inside it
    length: int
    crc_ok: Optional[bool]  # None where the CRC runs past the end


class _Header(NamedTuple):
    width: int
    height: int
    depth: int
    color: int
    interlace: int


def _walk(data: bytes) -> List[_Chunk]:
    """Every chunk header that fits in the data after the signature, its
    body and CRC as far as they go."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"not a PNG file; this reader takes {READS}")
    out, pos = [], 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        ok = None
        if len(body) == length and len(crc) == 4:
            ok = struct.unpack(">I", crc)[0] == zlib.crc32(kind + body) & 0xFFFFFFFF
        out.append(_Chunk(kind, body, length, ok))
        pos += 12 + length
    return out


def _ihdr(body: bytes, route: str) -> _Header:
    """The IHDR fields, checked as the route's reader checks them: PIL
    takes any interlace byte but 0 for Adam7 and ignores the compression
    byte."""
    if len(body) < 13:
        raise ValueError("truncated PNG IHDR chunk")
    width, height, depth, color, method, filt, interlace = struct.unpack(">IIBBBBB", body[:13])
    if route == "pil":
        interlace, method = int(interlace != 0), 0
    if color not in _CHANNELS:
        raise ValueError(f"bad PNG colour type {color}")
    if depth not in _DEPTHS[color]:
        raise ValueError(f"bad PNG bit depth {depth} for colour type {color}")
    if interlace not in (0, 1):
        raise ValueError(f"bad PNG interlace method {interlace}")
    if method:
        raise ValueError(f"unknown PNG compression method {method}")
    if filt:
        raise ValueError(f"unknown PNG filter method {filt}")
    if width == 0 or height == 0:
        raise ValueError("PNG of zero width or height")
    return _Header(width, height, depth, color, interlace)


def png_size(data: bytes) -> Tuple[int, int]:
    """(width, height) as PIL's ``.size``: the last ``IHDR`` before the
    image data, after PIL's checks of the chunks up to it (a file PIL
    cannot open raises)."""
    hdr = _pil_open(_walk(data))[0]
    return hdr.width, hdr.height


def _unfilter(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstructed (H, stride) bytes from the filtered rows."""
    h, stride = raw.shape
    if (ftype > 4).any():
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    if (ftype <= 2).all():
        out = np.empty_like(raw)
        prev = np.zeros(stride, np.uint8)
        for r in range(h):
            f, row = ftype[r], raw[r]
            if f == 1:  # Sub: a running sum of each byte lane, mod 256
                row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif f == 2:  # Up
                row = row + prev
            out[r] = row
            prev = out[r]
        return out
    # anti-diagonal wavefront over (row, pixel): a pixel depends on its left,
    # upper and upper-left neighbours, all on the two previous diagonals
    w = stride // bpp
    g = raw.reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row and column
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[r][:, None]
        pred = np.select([f == 0, f == 1, f == 2, f == 3], [0, a, b, (a + b) >> 1], paeth)
        out[r + 1, x + 1] = (g[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, stride)


def _sub_image(raw: np.ndarray, pos: int, height: int, width: int,
               depth: int, channels: int) -> np.ndarray:
    """``height`` filtered rows of one (sub-)image at ``raw[pos:]`` ->
    (height, width, channels) samples, uint8, or uint16 at 16 bits."""
    stride = (width * channels * depth + 7) // 8
    rows = raw[pos:pos + height * (stride + 1)].reshape(height, stride + 1)
    px = _unfilter(rows[:, 1:], rows[:, 0], max(1, channels * depth // 8))
    if depth < 8:
        vals = np.unpackbits(px, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (vals * weights).sum(axis=2, dtype=np.uint8)[:, :width]
    elif depth == 16:
        px = px.reshape(height, -1, 2).astype(np.uint16)
        px = (px[..., 0] << 8) | px[..., 1]
    return px.reshape(height, width, channels)


def _passes(hdr: _Header, width: int, height: int):
    """(y0, x0, dy, dx, rows, row bytes with its filter byte) of each pass
    that holds pixels."""
    channels = _CHANNELS[hdr.color]
    for y0, x0, dy, dx in (_ADAM7 if hdr.interlace else ((0, 0, 1, 1),)):
        h, w = -(-(height - y0) // dy), -(-(width - x0) // dx)
        if h > 0 and w > 0:  # an empty pass has no bytes, not even filters
            yield y0, x0, dy, dx, h, w, (w * channels * hdr.depth + 7) // 8 + 1


def _needed(hdr: _Header, width: int, height: int) -> int:
    return sum(h * n for *_, h, w, n in _passes(hdr, width, height))


def _samples(raw: bytes, hdr: _Header, width: int, height: int):
    """(height, width, channels) samples from the inflated rows, the rows
    past the end of ``raw`` left 0 -> (samples, bytes of whole rows, the
    mask of the pixels those rows wrote)."""
    channels = _CHANNELS[hdr.color]
    px = np.zeros((height, width, channels), np.uint16 if hdr.depth == 16 else np.uint8)
    written = np.zeros((height, width), bool)
    buf = np.frombuffer(raw, np.uint8)
    pos = 0
    for y0, x0, dy, dx, h, w, n in _passes(hdr, width, height):
        rows = min(h, (buf.size - pos) // n)
        if rows > 0:
            px[y0::dy, x0::dx][:rows] = _sub_image(buf, pos, rows, w, hdr.depth, channels)
            written[y0::dy, x0::dx][:rows] = True
        pos += rows * n
        if rows < h:
            break
    return px, pos, written


def _inflate(bodies, need: int, block: int):
    """PIL's and libpng's zlib feed: each chunk body in reads of at most
    ``block`` bytes, stopping once ``need`` bytes are out or the stream
    ends -> (the bytes out before any error, whether an error was met
    before the rows were out, whether the stream ended, the index of the
    last body read)."""
    z = zlib.decompressobj()
    out = bytearray()
    last = -1
    for j, body in enumerate(bodies):
        for i in range(0, len(body), block):
            if len(out) >= need or z.eof:
                return bytes(out), False, z.eof, last
            piece, last = body[i:i + block], j
            state = z.copy()
            try:
                out += z.decompress(piece)
            except zlib.error:
                for k in range(len(piece)):  # the bytes out before the error
                    try:
                        out += state.decompress(piece[k:k + 1])
                    except zlib.error:
                        break
                return bytes(out), len(out) <= need, False, last
    return bytes(out), False, z.eof, last


def _to_rgb(px: np.ndarray, hdr: _Header, palette, sixteen) -> np.ndarray:
    """Samples -> (H, W, 3) uint8 RGB, 16-bit samples cut by ``sixteen``:
    ``"high"``, ``"clip"`` (gray only; the rest keep the high byte) or
    ``"div255"``."""
    color = hdr.color
    if hdr.depth == 16:
        if sixteen == "div255":
            px = np.minimum((px.astype(np.int32) + 127) // 255, 255)
        elif sixteen == "clip" and color == 0:
            px = np.minimum(px, 255)
        else:
            px = px >> 8
        px = px.astype(np.uint8)
    elif hdr.depth < 8 and color == 0:
        px = px * np.uint8(255 // ((1 << hdr.depth) - 1))
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)  # indices past the palette are black
        full[:min(len(palette), 256)] = palette[:256]
        return full[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _palette(body: bytes):
    return np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)


# ---- the file route: PIL's PngImagePlugin ----

class _PilOpen(NamedTuple):
    header: _Header
    palette: Optional[np.ndarray]
    box: Tuple[int, int, int, int]  # (x, y, width, height) the data is decoded into
    first: int                      # index of the first data chunk
    animated: bool
    seq: Optional[int]


def _fdat_seq(c: _Chunk, seq: Optional[int]) -> int:
    if c.length < 4:
        raise ValueError("APNG contains truncated fdAT chunk")
    got = struct.unpack(">I", c.body[:4])[0] if len(c.body) >= 4 else None
    if seq is None or got != seq + 1:
        raise ValueError("APNG contains frame sequence errors")
    return got


def _fctl_pil(c: _Chunk, seq: Optional[int], size) -> Tuple[int, Tuple[int, int, int, int]]:
    if c.length < 26:
        raise ValueError("APNG contains truncated fcTL chunk")
    if len(c.body) < c.length:
        raise ValueError("truncated PNG chunk")
    got, w, h, x, y = struct.unpack(">IIIII", c.body[:20])
    if (seq is None and got != 0) or (seq is not None and got != seq + 1):
        raise ValueError("APNG contains frame sequence errors")
    if x + w > size[0] or y + h > size[1]:
        raise ValueError("APNG contains invalid frames")
    return got, (x, y, w, h)


def _pil_open(chunks: List[_Chunk]) -> _PilOpen:
    """PIL's ``_open``: the chunks before the image data, every CRC checked."""
    hdr = palette = box = seq = None
    frames = None
    for i, c in enumerate(chunks):
        if not _CID.fullmatch(c.kind):
            raise ValueError(f"broken PNG file (chunk {c.kind!r})")
        if c.kind == b"fdAT":
            seq = _fdat_seq(c, seq)
        if c.kind in _DATA:
            if hdr is None:
                raise ValueError("PNG without IHDR")
            x, y, w, h = box if box is not None else (0, 0, hdr.width, hdr.height)
            if x == 0 and w == 0:  # PIL's tile (0, y, 0, y1) is the whole image
                x, y, w, h = 0, 0, hdr.width, hdr.height
            if hdr.width * hdr.height > _PIL_MAX_PIXELS:
                raise ValueError("PNG past PIL's decompression bomb limit")
            animated = frames is not None and frames + (box is None) > 1
            return _PilOpen(hdr, palette, (x, y, w, h), i, animated, seq)
        if c.kind == b"IEND":
            break
        if len(c.body) < c.length:
            raise ValueError("truncated PNG chunk")
        if c.kind == b"IHDR":
            hdr = _ihdr(c.body, "pil")
        elif c.kind == b"PLTE":
            palette = _palette(c.body)
        elif c.kind == b"acTL":
            if c.length < 8:
                raise ValueError("APNG contains truncated acTL chunk")
            n = struct.unpack(">I", c.body[:4])[0]
            frames = None if frames is not None or n == 0 or n > 0x80000000 else n
        elif c.kind == b"fcTL":
            if hdr is None:
                raise ValueError("PNG without IHDR")
            seq, box = _fctl_pil(c, seq, (hdr.width, hdr.height))
        if c.crc_ok is not True:
            raise ValueError(f"broken PNG file (bad checksum in {c.kind!r})")
    raise ValueError("PNG without image data")


def _pil_tail(chunks: List[_Chunk], start: int, opened: _PilOpen) -> None:
    """PIL's ``load_end``: the chunks after the one the decoder ended in."""
    seq = opened.seq
    size = (opened.header.width, opened.header.height)
    for c in chunks[start:]:
        if not _CID.fullmatch(c.kind) or c.kind == b"IEND":
            return
        if c.kind == b"fcTL" and opened.animated:
            return
        if c.kind == b"fcTL":
            seq = _fctl_pil(c, seq, size)[0]
        elif c.kind == b"fdAT":
            seq = _fdat_seq(c, seq)
        elif c.kind == b"acTL" and c.length < 8:
            raise ValueError("APNG contains truncated acTL chunk")
        elif c.kind == b"IHDR":
            _ihdr(c.body, "pil")
        if len(c.body) < c.length:
            raise ValueError("truncated PNG chunk")


def _decode_pil(data: bytes) -> np.ndarray:
    chunks = _walk(data)
    opened = _pil_open(chunks)
    hdr = opened.header
    x, y, w, h = opened.box
    if w == 0 or h == 0:
        raise ValueError("tile cannot extend outside image")
    run = [opened.first]  # the data chunks read one after another
    while run[-1] + 1 < len(chunks) and chunks[run[-1] + 1].kind in _DATA:
        run.append(run[-1] + 1)
    bodies = [chunks[i].body[4:] if chunks[i].kind == b"fdAT" else chunks[i].body for i in run]
    need = _needed(hdr, w, h)
    raw, broken, ended, last = _inflate(bodies, need, _READ_BLOCK["pil"])
    seq = opened.seq
    for i in run[1:max(last, 0) + 1]:
        if chunks[i].kind == b"fdAT":
            seq = _fdat_seq(chunks[i], seq)
    if broken:
        raise ValueError("broken PNG data stream")
    px, whole, _ = _samples(raw, hdr, w, h)
    if whole < need and (not ended or whole < len(raw)):
        raise ValueError("PNG image file is truncated")
    _pil_tail(chunks, run[max(last, 0)] + 1, opened._replace(seq=seq))
    canvas = np.zeros((hdr.height, hdr.width, px.shape[2]), px.dtype)
    canvas[y:y + h, x:x + w] = px
    return _to_rgb(canvas, hdr, opened.palette, "clip")


# ---- the serve-body route: cv2's PngDecoder on libpng ----

def _check_fctl(c: _Chunk, size, frame: bool):
    """cv2's checks of an ``fcTL`` -> (x, y, w, h)."""
    if c.length != 26 or len(c.body) != 26:
        raise ValueError("APNG fcTL chunk not 26 bytes")
    w, h, x, y = struct.unpack(">IIII", c.body[4:20])
    dispose, blend = c.body[24], c.body[25]
    if x + w > size[0] or y + h > size[1] or dispose > 2 or blend > 1:
        raise ValueError("APNG frame outside the canvas or with a bad dispose or blend op")
    if frame and (w == 0 or h == 0):
        raise ValueError("APNG frame of zero width or height")
    return x, y, w, h


def _cv2_limits(hdr: _Header) -> None:
    if (max(hdr.width, hdr.height) > min(_CV2_MAX_SIDE, _LIBPNG_MAX_SIDE)
            or hdr.width * hdr.height > _CV2_MAX_PIXELS):
        raise ValueError("PNG past cv2's image size limits")


def _decode_cv2(data: bytes) -> np.ndarray:
    chunks = _walk(data)
    if not chunks or chunks[0].kind != b"IHDR" or chunks[0].length != 13:
        raise ValueError("PNG that does not start with IHDR")
    hdr, palette, frames, fctl = None, None, None, None
    first = None
    for i, c in enumerate(chunks):
        if c.kind == b"IDAT":
            first = i
            break
        if len(c.body) < c.length:
            raise ValueError("truncated PNG chunk")
        if c.kind == b"IHDR":
            if hdr is not None:
                raise ValueError("PNG with a second IHDR")
            if not c.crc_ok:
                raise ValueError("PNG IHDR chunk: CRC mismatch")
            hdr = _ihdr(c.body, "cv2")
        elif c.kind == b"PLTE":
            if not c.crc_ok:
                raise ValueError("PNG PLTE chunk: CRC mismatch")
            if c.length % 3 or not 0 < c.length <= 768:
                raise ValueError(f"PNG PLTE chunk of {c.length} bytes")
            palette = _palette(c.body)
        elif c.kind == b"acTL":
            if c.length != 8:
                raise ValueError("APNG acTL chunk not 8 bytes")
            frames = struct.unpack(">I", c.body[:4])[0]
        elif c.kind == b"fcTL":
            fctl = _check_fctl(c, (hdr.width, hdr.height), frame=False)
        elif c.kind == b"IEND":
            break
        elif c.kind[0] & 0x20 == 0:
            raise ValueError(f"PNG with an unknown critical chunk {c.kind!r}")
    if first is None:
        raise ValueError("PNG without image data")
    _cv2_limits(hdr)
    if frames == 0:
        raise ValueError("APNG with no frames")
    if frames is not None and frames > 1:
        return _cv2_animated(chunks, first, hdr, palette, fctl)
    return _cv2_still(chunks, first, hdr, palette)


def _cv2_still(chunks, first, hdr, palette) -> np.ndarray:
    bodies, exif = [], None
    run = True
    for c in chunks[first:]:
        if len(c.body) < c.length or c.crc_ok is None:
            raise ValueError("truncated PNG chunk")
        if c.kind == b"IEND":
            break
        if c.kind == b"IDAT":
            if not c.crc_ok:
                raise ValueError("PNG IDAT chunk: CRC mismatch")
            if run:
                bodies.append(c.body)
            continue
        run = False
        if c.kind in (b"IHDR",) or (c.kind[0] & 0x20 == 0 and c.kind != b"PLTE"):
            raise ValueError(f"PNG with an unexpected critical chunk {c.kind!r}")
        if c.kind == b"PLTE" and not c.crc_ok:
            raise ValueError("PNG PLTE chunk: CRC mismatch")
    else:
        raise ValueError("PNG without IEND")
    for c in chunks:
        if c.kind == b"IEND":
            break
        if (c.kind == b"eXIf" and c.crc_ok and c.length >= 4
                and c.body[:4] in (b"II*\x00", b"MM\x00*")):
            exif = c.body
            break
    need = _needed(hdr, hdr.width, hdr.height)
    raw, broken, _, _ = _inflate(bodies, need, _READ_BLOCK["cv2"])
    if broken or len(raw) < need:
        raise ValueError("PNG image data broken or too short")
    px = _samples(raw, hdr, hdr.width, hdr.height)[0]
    rgb = _to_rgb(px, hdr, palette, "high")
    return _orient(rgb, _tiff_orientation(exif)) if exif is not None else rgb


def _progressive(bodies, hdr: _Header, width: int, height: int):
    """libpng's progressive reader on one image's data, a chunk a call ->
    (samples, the mask of the pixels written, whether libpng ends the data
    well). A row goes through once the zlib call that fills it returns
    without an error (one that runs on past the row's end into an error in
    the same chunk loses it); a zlib error ends the data benignly, and so
    do the stream's end and output past the rows; data that stops short of
    all three does not end well. A bad row filter refuses."""
    need = _needed(hdr, width, height)
    z = zlib.decompressobj()
    out = bytearray()
    usable, ended = None, False
    for body in bodies:
        if not body:
            continue
        before, state = len(out), z.copy()
        try:
            out += z.decompress(body)
        except zlib.error:
            for k in range(len(body)):
                try:
                    out += state.decompress(body[k:k + 1])
                except zlib.error:
                    break
            usable, ended = (len(out) if before >= len(out) else len(out) - 1), True
            break
        if z.eof:
            ended = True
            break
    if usable is None:
        usable = len(out)
    ended = ended or len(out) > need
    px, _, written = _samples(bytes(out[:min(usable, need)]), hdr, width, height)
    return px, written, ended


def _cv2_animated(chunks, first, hdr, palette, fctl) -> np.ndarray:
    """cv2's first frame of an animation: the rows libpng writes go into a
    buffer of the canvas's size that the ``IDAT`` image (when it is not a
    frame) filled first, and the frame's box of that buffer is placed on a
    black canvas; a frame pixel nothing wrote is uninitialized memory in
    OpenCV, which the port refuses."""
    size = (hdr.width, hdr.height)
    buf = np.zeros((hdr.height, hdr.width, 3), np.uint8)  # libpng's rows, as RGB
    known = np.zeros((hdr.height, hdr.width), bool)
    i = first
    if fctl is None:  # the IDAT image is not a frame: decoded into the buffer
        default = []
        while i < len(chunks) and chunks[i].kind != b"fcTL":
            c = chunks[i]
            if len(c.body) < c.length or c.crc_ok is None or c.kind == b"IEND":
                raise ValueError("APNG without a frame after its IDAT image")
            if c.kind == b"IDAT":
                default.append(c.body)
            i += 1
        if i == len(chunks):
            raise ValueError("APNG without a frame after its IDAT image")
        px, known, _ = _progressive(default, hdr, hdr.width, hdr.height)
        buf = _to_rgb(px, hdr, palette, "div255")
        fctl = _check_fctl(chunks[i], size, frame=True)
        i += 1
        decoded = fctl[2:]
    else:
        decoded = size
    bodies = []
    for c in chunks[i:]:
        if len(c.body) < c.length or c.crc_ok is None:
            raise ValueError("truncated PNG chunk")
        if c.kind in (b"fcTL", b"IEND"):
            if c.kind == b"fcTL":
                _check_fctl(c, size, frame=False)
            break
        if c.kind == b"IDAT":
            bodies.append(c.body)
        elif c.kind == b"fdAT":
            if c.length < 4:
                raise ValueError("APNG fdAT chunk under 4 bytes")
            bodies.append(c.body[4:])
        elif c.kind == b"PLTE" and not c.crc_ok:
            raise ValueError("PNG PLTE chunk: CRC mismatch")
    else:
        raise ValueError("APNG frame without an end")
    px, written, ended = _progressive(bodies, hdr, decoded[0], decoded[1])
    if not ended:
        raise ValueError("APNG frame data cut short")
    fw, fh = decoded
    buf[:fh, :fw][written] = _to_rgb(px, hdr, palette, "div255")[written]
    known[:fh, :fw] |= written
    x, y, w, h = fctl
    if not known[:h, :w].all():
        raise ValueError("APNG frame with pixels cv2 leaves uninitialized")
    canvas = np.zeros_like(buf)
    canvas[y:y + h, x:x + w] = buf[:h, :w]
    return canvas


def decode_png(data: bytes, route: str = "pil") -> np.ndarray:
    """PNG or APNG bytes -> (H, W, 3) uint8 RGB by the rules of ``route``:
    ``"pil"`` (files: PIL's ``convert("RGB")``) or ``"cv2"`` (serve bodies:
    ``cv2.imdecode(..., IMREAD_COLOR)``); see the module docstring. A file
    the route's reference refuses raises ``ValueError``."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    return _decode_pil(data) if route == "pil" else _decode_cv2(data)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> PNG bytes."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    color = {1: 0, 3: 2, 4: 6}.get(image.shape[-1] if image.ndim == 3 else 0)
    if color is None:
        raise ValueError(f"encode_png takes (H, W), (H, W, 3) or (H, W, 4), "
                         f"got {image.shape}")
    h, w, c = image.shape
    rows = image.reshape(h, w * c)
    up = rows - np.concatenate([np.zeros((1, w * c), np.uint8), rows[:-1]])
    filtered = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
            + _chunk(b"IEND", b""))

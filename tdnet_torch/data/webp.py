"""WebP decoding in Python and numpy, equal byte for byte to the two
decoders the reference reads pages with: PIL's ``Image.open(path).
convert("RGB")`` for files (``route="pil"``) and ``cv2.imdecode(buf,
cv2.IMREAD_COLOR)`` for serve bodies (``route="cv2"``). Both run libwebp;
``vp8l.py`` decodes the lossless bitstream and ``vp8.py`` the lossy one.

Reads the RIFF container: the simple lossy (``VP8 ``) and lossless
(``VP8L``) forms and the extended form (``VP8X``: its flags and 24-bit
canvas; ``ICCP``, ``EXIF``, ``XMP `` and unknown chunks skipped; ``ALPH``,
raw or lossless-coded with the none, horizontal, vertical and gradient
filters, decoded and checked although RGB drops it; ``ANIM``/``ANMF``,
the first frame painted on the canvas). Chunks are walked with their odd
sizes padded. The routes reach libwebp by two paths, and refuse and read
by their own rules:

- PIL opens every file through libwebp's demuxer and decodes its first
  frame with ``WebPAnimDecoder``. The demuxer refuses a RIFF size that
  runs past the data or leaves 1 to 7 bytes after the last chunk it
  reads, a chunk that runs past the RIFF size, reserved ``VP8X`` flags,
  an image chunk other than the first, a ``VP8L`` or image after an
  ``ALPH``, a frame of a still image whose size or place differs from the
  canvas, an animated frame that reaches past it, and an animation without
  ``ANIM`` before its frames. It reads only the ``VP8 `` or ``VP8L`` chunk
  of a simple file (what follows is ignored) and drops an ``ALPH`` chunk
  when the ``VP8X`` alpha flag is off. The frame is painted on a canvas of
  transparent black (an animated frame smaller than the canvas, or offset
  in it, leaves the rest black). Bytes after the RIFF chunk are ignored.
  ``.size`` (:func:`webp_size`) is the canvas.
- cv2 refuses a body shorter than 32 bytes and reads its first 32 bytes'
  features; an animation then goes through the same demuxer and anim
  decoder as PIL's, a still image through ``WebPDecode`` on the whole
  body, which checks the RIFF size against the chunks (padding included
  in the extended form), wants a ``VP8X`` chunk of exactly 10 bytes and a
  canvas equal to the image, takes the last ``ALPH`` before the image
  (alpha flag or not) and gives the bitstream every byte after its chunk
  header, so a cut last partition can read on into the chunks after it.
  It turns the page by the EXIF orientation (the 16 bits at tag 0x0112,
  big- or little-endian TIFF without an ``Exif`` prefix) of the first
  ``EXIF`` chunk the demuxer keeps: with the ``VP8X`` EXIF flag on, and
  only when the demuxer reads the file.

cv2 also reads a bare ``VP8L`` or ``VP8 `` bitstream without the RIFF
container (a key frame whose first partition is shorter than 32 bytes:
its first 32 bytes must hold it), and so does this module's cv2 route;
PIL does not recognise one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tdnet_torch.data import vp8, vp8l
from tdnet_torch.data.jpeg import _orient, _tiff_orientation

__all__ = ["SIGNATURE", "READS", "ROUTES", "is_webp", "is_bare_bitstream", "decode_webp",
           "webp_size"]

SIGNATURE = b"RIFF"
READS = "WebP (lossy, lossless, extended with alpha, the first frame of an animation)"
ROUTES = ("pil", "cv2")

_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_AREA = 1 << 32
_PIL_MAX_PIXELS = 2 * 89478485  # past twice Image.MAX_IMAGE_PIXELS, PIL refuses to open
_CV2_MAX_SIDE, _CV2_MAX_PIXELS = 1 << 20, 1 << 30  # OpenCV's CV_IO_MAX_IMAGE_* defaults
ALPHA_FLAG, ANIMATION_FLAG, EXIF_FLAG, ICCP_FLAG, XMP_FLAG = 0x10, 0x02, 0x08, 0x20, 0x04
_VALID_FLAGS = ALPHA_FLAG | ANIMATION_FLAG | EXIF_FLAG | ICCP_FLAG | XMP_FLAG


def is_webp(data: bytes) -> bool:
    """RIFF with the form type ``WEBP``: WAV and AVI files are RIFF too."""
    return data[:4] == SIGNATURE and data[8:12] == b"WEBP"


def is_bare_bitstream(data: bytes) -> bool:
    """A ``VP8L`` header (0x2f, version 0) or a VP8 key frame's start code
    at bytes 3-6, with no container: cv2's route reads these."""
    return (len(data) >= 5 and data[0] == vp8l.SIGNATURE and not data[4] >> 5) or (
        len(data) >= 10 and not data[0] & 1 and data[3:6] == b"\x9d\x01\x2a")


def _le(data: bytes, pos: int, n: int) -> int:
    return int.from_bytes(data[pos:pos + n], "little")


class _Refused(ValueError):
    pass


class _NotEnough(ValueError):
    """libwebp's VP8_STATUS_NOT_ENOUGH_DATA."""


class _Frame:
    __slots__ = ("x", "y", "width", "height", "image", "alpha", "complete", "number")

    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.image = self.alpha = (0, 0)  # (offset, size) of the chunk, header included
        self.complete, self.number = False, 0


class _Demux:
    """libwebp's demuxer (``demux.c``) over a whole file: the canvas, the
    frames' chunks and the chunks it keeps (``EXIF``). Raises where
    ``WebPDemux`` returns NULL."""

    def __init__(self, data: bytes):
        self.data = data
        if len(data) < 20:
            raise _Refused("WebP file shorter than its RIFF and first chunk headers")
        riff_size = _le(data, 4, 4)
        if riff_size < 8 or riff_size > _MAX_PAYLOAD:
            raise _Refused(f"WebP RIFF size {riff_size}")
        self.riff_end = riff_size + 8  # bytes after the RIFF chunk are not read
        if len(data) < self.riff_end:
            raise _Refused("truncated WebP: its RIFF size runs past the data")
        self.pos = 12
        self.frames = []
        self.chunks = []  # (tag, payload offset, payload size) kept
        self.flags, self.extended = 0, False
        self.canvas = (0, 0)
        self.anim_chunks = 0
        tag = data[12:16]
        if tag in (b"VP8 ", b"VP8L"):
            self._single_image()
            self._check_simple()
        elif tag == b"VP8X":
            self._vp8x()
            self._check_extended()
        else:
            raise _Refused(f"WebP file whose first chunk is {tag!r}")

    def _left(self) -> int:
        return self.riff_end - self.pos

    def _need_more(self):
        raise _Refused("truncated WebP: a chunk or its header runs past the RIFF size")

    def _store_frame(self, number: int, min_size: int, frame: _Frame) -> None:
        """``StoreFrame``: an optional ``ALPH`` then a ``VP8 ``/``VP8L``."""
        if self._left() < 8 or self._left() < min_size:
            self._need_more()
        alpha_chunks = image_chunks = 0
        while True:
            start = self.pos
            tag, size = self.data[start:start + 4], _le(self.data, start + 4, 4)
            self.pos += 8
            if size > _MAX_PAYLOAD:
                raise _Refused("WebP chunk size too large")
            padded = size + (size & 1)
            if padded > self._left():
                raise _Refused(f"WebP chunk {tag!r} runs past the RIFF size")
            done = False
            if tag == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha, frame.number = (start, 8 + padded), number
                self.pos += padded
            elif tag in (b"VP8 ", b"VP8L") and image_chunks == 0:
                if tag == b"VP8L" and alpha_chunks:
                    raise _Refused("WebP VP8L chunk after an ALPH chunk")
                try:  # WebPGetFeatures on the chunk
                    h = _headers(self.data[start:start + 8 + padded], have_all_data=False,
                                 for_decoding=False)
                except ValueError as e:
                    raise _Refused(f"WebP image chunk: {e}") from None
                image_chunks = 1
                frame.image = (start, 8 + padded)
                frame.width, frame.height = h["width"], h["height"]
                frame.number, frame.complete = number, True
                self.pos += padded
            else:
                self.pos -= 8
                done = True
            if self.pos == self.riff_end:
                return
            if self._left() < 8:
                self._need_more()
            if done:
                return

    def _single_image(self) -> None:
        if self.frames:
            raise _Refused("WebP file with a second image")
        if 8 > self._left():
            raise _Refused("WebP image chunk runs past the RIFF size")
        frame = _Frame()
        self._store_frame(1, 0, frame)
        if not self.flags & ALPHA_FLAG and frame.alpha[1]:
            frame.alpha = (0, 0)  # the alpha flag is off: ALPH dropped
        if not self.extended and frame.width > 0 and frame.height > 0:
            self.canvas = (frame.width, frame.height)
        self._add(frame)

    def _add(self, frame: _Frame) -> None:
        if self.frames and not self.frames[-1].complete:
            raise _Refused("WebP frame after an incomplete one")
        self.frames.append(frame)

    def _vp8x(self) -> None:
        self.extended = True
        size = _le(self.data, 16, 4)
        self.pos = 20
        if size != 10:
            raise _Refused(f"WebP VP8X chunk of {size} bytes (10)")
        size += size & 1
        if size > self._left():
            raise _Refused("WebP VP8X chunk runs past the RIFF size")
        self.flags = self.data[20]
        self.canvas = (1 + _le(self.data, 24, 3), 1 + _le(self.data, 27, 3))
        if self.canvas[0] * self.canvas[1] >= _MAX_AREA:
            raise _Refused("WebP canvas too large")
        self.pos = 20 + size
        if 8 > self._left():
            raise _Refused("WebP VP8X chunk not followed by a chunk")
        animation = bool(self.flags & ANIMATION_FLAG)
        while True:
            start = self.pos
            tag, size = self.data[start:start + 4], _le(self.data, start + 4, 4)
            self.pos += 8
            if size > _MAX_PAYLOAD:
                raise _Refused("WebP chunk size too large")
            padded = size + (size & 1)
            if padded > self._left():
                raise _Refused(f"WebP chunk {tag!r} runs past the RIFF size")
            if tag == b"VP8X":
                raise _Refused("WebP file with two VP8X chunks")
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                if self.anim_chunks or animation:
                    raise _Refused("WebP animation with an image outside its frames")
                self.pos = start
                self._single_image()
            elif tag == b"ANIM" and self.anim_chunks == 0:
                if padded < 6:
                    raise _Refused("WebP ANIM chunk too short")
                self.anim_chunks = 1
                self.pos += padded
            elif tag == b"ANMF":
                if not self.anim_chunks:
                    raise _Refused("WebP ANMF chunk before its ANIM chunk")
                self._animation_frame(padded)
            else:
                keep = {b"ICCP": ICCP_FLAG, b"EXIF": EXIF_FLAG, b"XMP ": XMP_FLAG}.get(tag)
                if keep is not None and self.flags & keep:
                    self.chunks.append((tag, start + 8, size))
                self.pos += padded
            if self.pos == self.riff_end:
                return
            if self._left() < 8:
                self._need_more()

    def _animation_frame(self, size: int) -> None:
        if 16 > self._left() or size < 16:
            raise _Refused("WebP ANMF chunk too short")
        d, p = self.data, self.pos
        frame = _Frame()
        frame.x, frame.y = 2 * _le(d, p, 3), 2 * _le(d, p + 3, 3)
        frame.width, frame.height = 1 + _le(d, p + 6, 3), 1 + _le(d, p + 9, 3)
        if frame.width * frame.height >= _MAX_AREA:
            raise _Refused("WebP frame too large")
        self.pos += 16
        start = self.pos
        self._store_frame(len(self.frames) + 1, size - 16, frame)
        if self.pos - start > size - 16:
            raise _Refused("WebP frame's chunks run past its ANMF chunk")
        if self.flags & ANIMATION_FLAG and frame.number > 0:
            self._add(frame)

    def _check_simple(self) -> None:
        if not self.frames or self.frames[0].width <= 0 or self.frames[0].height <= 0:
            raise _Refused("WebP file without an image")

    def _check_extended(self) -> None:
        animation = bool(self.flags & ANIMATION_FLAG)
        cw, ch = self.canvas
        if not self.frames:
            raise _Refused("WebP file without an image")
        if self.flags & ~_VALID_FLAGS:
            raise _Refused(f"WebP VP8X flags 0x{self.flags:02x} set reserved bits")
        for f in self.frames:
            if not animation and f.number > 1:
                raise _Refused("WebP still image with two frames")
            if not f.complete:
                raise _Refused("WebP frame without its image")
            if f.alpha[1] and f.alpha[0] > f.image[0]:
                raise _Refused("WebP ALPH chunk after its image")
            if f.width <= 0 or f.height <= 0:
                raise _Refused("WebP frame without a size")
            if not animation:
                if f.x or f.y or (f.width, f.height) != (cw, ch):
                    raise _Refused(f"WebP image of {f.width}x{f.height} on a {cw}x{ch} canvas")
            elif f.x + f.width > cw or f.y + f.height > ch:
                raise _Refused("WebP frame reaches past its canvas")

    def fragment(self) -> bytes:
        """The first frame's ``ALPH`` and image chunks, as the demuxer hands
        them to the decoder."""
        f = self.frames[0]
        start, size = f.image
        if f.alpha[1]:
            size += f.alpha[1] + (f.image[0] - (f.alpha[0] + f.alpha[1]))
            start = f.alpha[0]
        return self.data[start:start + size]

    def exif(self) -> Optional[bytes]:
        for tag, pos, size in self.chunks:
            if tag == b"EXIF":
                return self.data[pos:pos + size]
        return None


def _headers(data: bytes, have_all_data: bool, for_decoding: bool) -> dict:
    """libwebp's ``ParseHeadersInternal``: the RIFF header, ``VP8X``, the
    chunks before the image (``ALPH`` kept, the last one) and the image
    chunk's header. ``for_decoding`` is ``WebPDecode``'s call (the size
    read from headers only is ``WebPGetFeatures``')."""
    size, pos, riff_size = len(data), 0, 0
    if size < 12:
        raise _NotEnough("WebP data shorter than 12 bytes")
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            raise ValueError("RIFF file that is not WebP")
        riff_size = _le(data, 4, 4)
        if riff_size < 12 or riff_size > _MAX_PAYLOAD:
            raise ValueError(f"WebP RIFF size {riff_size}")
        if have_all_data and riff_size > size - 8:
            raise ValueError("truncated WebP: its RIFF size runs past the data")
        pos = 12
    out = {"animation": False, "alpha": None}
    found_vp8x = False
    try:
        if size - pos < 8:
            raise _NotEnough("no chunk header")
        if data[pos:pos + 4] == b"VP8X":
            if _le(data, pos + 4, 4) != 10:
                raise ValueError("WebP VP8X chunk not of 10 bytes")
            if size - pos < 18:
                raise _NotEnough("short VP8X chunk")
            flags = _le(data, pos + 8, 4)
            cw, ch = 1 + _le(data, pos + 12, 3), 1 + _le(data, pos + 15, 3)
            if cw * ch >= _MAX_AREA:
                raise ValueError("WebP canvas too large")
            out.update(width=cw, height=ch, animation=bool(flags & ANIMATION_FLAG))
            pos += 18
            found_vp8x = True
        if not riff_size and found_vp8x:
            raise ValueError("WebP VP8X chunk without RIFF")
        if found_vp8x and out["animation"] and not for_decoding:
            return out
        if size - pos < 4:
            raise _NotEnough("no image chunk")
        if (riff_size and found_vp8x) or (not riff_size and not found_vp8x
                                          and data[pos:pos + 4] == b"ALPH"):
            total = 22  # "WEBP" and the VP8X chunk
            while True:
                if size - pos < 8:
                    raise _NotEnough("chunk header past the data")
                chunk = _le(data, pos + 4, 4)
                if chunk > _MAX_PAYLOAD:
                    raise ValueError("WebP chunk size too large")
                disk = (8 + chunk + 1) & ~1
                total += disk
                if riff_size and total > riff_size:
                    raise ValueError("WebP chunks run past the RIFF size")
                if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                    break
                if size - pos < disk:
                    raise _NotEnough("chunk past the data")
                if data[pos:pos + 4] == b"ALPH":
                    out["alpha"] = data[pos + 8:pos + 8 + chunk]
                pos += disk
        if size - pos < 8:
            raise _NotEnough("image chunk header past the data")
        tag = data[pos:pos + 4]
        if tag in (b"VP8 ", b"VP8L"):
            chunk = _le(data, pos + 4, 4)
            if riff_size >= 12 and chunk > riff_size - 12:
                raise ValueError("WebP image chunk larger than its RIFF")
            if have_all_data and chunk > size - pos - 8:
                raise _NotEnough("truncated WebP image chunk")
            pos += 8
            lossless = tag == b"VP8L"
        else:  # a raw bitstream
            chunk = size - pos
            lossless = size - pos >= 5 and data[pos] == vp8l.SIGNATURE and not data[pos + 4] >> 5
        if chunk > _MAX_PAYLOAD:
            raise ValueError("WebP image chunk too large")
        if not lossless:
            if size - pos < 10:
                raise _NotEnough("short VP8 frame header")
            w, h, _ = vp8.vp8_info(data[pos:], chunk)
        else:
            if size - pos < 5:
                raise _NotEnough("short VP8L header")
            w, h = vp8l.vp8l_info(data[pos:pos + 5])
        if found_vp8x and (out["width"], out["height"]) != (w, h):
            raise ValueError(f"WebP canvas {out['width']}x{out['height']} differs from its "
                             f"image's {w}x{h}")
    except _NotEnough:
        if found_vp8x and not for_decoding:
            return out
        raise
    out.update(width=w, height=h, lossless=lossless, offset=pos)
    return out


def _decode(data: bytes) -> np.ndarray:
    """``WebPDecode`` of a whole file or a frame's chunks -> (H, W, 4) uint8
    RGBA; the bitstream reads every byte after its chunk header."""
    h = _headers(data, have_all_data=True, for_decoding=True)
    if h["animation"]:
        raise ValueError("animated WebP decoded as a still image")
    body = data[h["offset"]:]
    if h["lossless"]:
        return vp8l.decode_vp8l(body)
    y, u, v = vp8.decode_vp8(body)
    rgba = np.empty(y.shape + (4,), np.uint8)
    rgba[..., :3] = vp8.yuv_to_rgb(y, u, v)
    rgba[..., 3] = 255 if h["alpha"] is None else _decode_alpha(h["alpha"], y.shape[1], y.shape[0])
    return rgba


def _decode_alpha(data: bytes, width: int, height: int) -> np.ndarray:
    """An ``ALPH`` chunk's payload -> (height, width) uint8 alpha, as
    libwebp's ``alpha_dec.c`` reads it (its level dithering off)."""
    if len(data) <= 1:
        raise ValueError("WebP ALPH chunk without data")
    method, filt, pre, rsrv = data[0] & 3, (data[0] >> 2) & 3, (data[0] >> 4) & 3, data[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise ValueError(f"WebP ALPH header 0x{data[0]:02x} (method {method}, "
                         f"pre-processing {pre}, reserved {rsrv})")
    if method == 0:
        if len(data) - 1 < width * height:
            raise ValueError("WebP ALPH chunk shorter than its raw alpha")
        a = np.frombuffer(data, np.uint8, width * height, 1).reshape(height, width)
    else:
        try:
            a = vp8l.decode_stream(data[1:], width, height)
        except ValueError as e:
            raise ValueError(f"WebP ALPH chunk: {e}") from None
    return _unfilter(a, filt)


def _unfilter(a: np.ndarray, filt: int) -> np.ndarray:
    """Undo an alpha filter: 1 horizontal, 2 vertical, 3 gradient (each
    row's first pixel predicted from above, the first row from the left)."""
    if filt == 0:
        return a.copy()
    x = a.astype(np.int64)
    h, w = x.shape
    if filt == 1:
        first = np.cumsum(x[:, 0])
        return ((np.cumsum(x, axis=1) - x[:, :1] + first[:, None]) & 255).astype(np.uint8)
    out = np.empty((h, w), np.int64)
    out[0] = np.cumsum(x[0]) & 255
    if filt == 2:
        out[1:] = (np.cumsum(x[1:], axis=0) + out[0]) & 255
        return out.astype(np.uint8)
    for y in range(1, h):
        out[y] = _gradient_row(x[y], out[y - 1])
    return out.astype(np.uint8)


def _gradient_row(row: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """One row of the gradient filter: each pixel adds clip(left + top -
    top-left). Where no clipping happens, out - prev is a running sum; the
    sum is taken at once and redone from the first pixel that clips."""
    w = len(row)
    out = np.empty(w, np.int64)
    out[0] = (row[0] + prev[0]) & 255
    i = 1
    while i < w:
        d = (out[i - 1] - prev[i - 1] + np.cumsum(row[i:])) & 255
        cand = (prev[i:] + d) & 255
        left = np.concatenate(([out[i - 1]], cand[:-1]))
        g = left + prev[i:] - prev[i - 1:w - 1]
        bad = np.flatnonzero((g < 0) | (g > 255))
        if not len(bad):
            out[i:] = cand
            break
        j = i + int(bad[0])
        out[i:j] = cand[:j - i]
        out[j] = (row[j] + min(255, max(0, int(g[j - i])))) & 255
        i = j + 1
    return out


def _first_frame(dm: _Demux) -> np.ndarray:
    """The anim decoder's first frame: its RGBA on a transparent canvas."""
    f = dm.frames[0]
    rgba = _decode(dm.fragment())
    cw, ch = dm.canvas
    canvas = np.zeros((ch, cw, 4), np.uint8)
    canvas[f.y:f.y + rgba.shape[0], f.x:f.x + rgba.shape[1]] = rgba
    return canvas


def _opened(data: bytes) -> _Demux:
    """The demuxer of a file PIL opens, or ValueError."""
    try:
        dm = _Demux(data)
    except _Refused as e:
        raise ValueError(f"{e}: PIL cannot open it") from None
    if dm.canvas[0] * dm.canvas[1] > _PIL_MAX_PIXELS:
        raise ValueError(f"WebP canvas {dm.canvas[0]}x{dm.canvas[1]}: PIL refuses it as a "
                         "decompression bomb")
    return dm


def _pil(data: bytes) -> np.ndarray:
    """PIL's read: (H, W, 4) RGBA, its ``convert("RGBA")``."""
    dm = _opened(data)
    try:
        return _first_frame(dm)
    except ValueError as e:
        raise ValueError(f"{e}: PIL fails to read its first frame") from None


def _cv2(data: bytes) -> np.ndarray:
    if len(data) < 32:
        raise ValueError("WebP body shorter than 32 bytes: OpenCV refuses it")
    try:
        head = _headers(data[:32], have_all_data=False, for_decoding=False)
    except ValueError as e:
        raise ValueError(f"WebP features: {e}: OpenCV refuses it") from None
    w, h = head["width"], head["height"]
    if w > _CV2_MAX_SIDE or h > _CV2_MAX_SIDE or w * h > _CV2_MAX_PIXELS:
        raise ValueError(f"WebP of {w}x{h}: past OpenCV's image size limits")
    try:
        dm: Optional[_Demux] = _Demux(data)
    except _Refused as e:
        if head["animation"]:
            raise ValueError(f"{e}: OpenCV refuses it") from None
        dm = None
    try:
        rgb = (_first_frame(dm) if head["animation"] else _decode(data))[..., :3]
    except ValueError as e:
        raise ValueError(f"{e}: OpenCV refuses it") from None
    exif = dm.exif() if dm is not None else None
    return _orient(rgb, _tiff_orientation(exif)) if exif is not None else np.ascontiguousarray(rgb)


def decode_webp(data: bytes, route: str = "pil") -> np.ndarray:
    """WebP bytes -> (H, W, 3) uint8 RGB, equal to PIL's ``convert("RGB")``
    (``route="pil"``) or to ``cv2.imdecode(..., IMREAD_COLOR)`` with its
    channels flipped (``route="cv2"``)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    data = bytes(data)
    if route == "cv2" and (is_webp(data) or is_bare_bitstream(data)):
        return _cv2(data)
    if not is_webp(data):
        raise ValueError(f"not a WebP file; this reader takes {READS}")
    return np.ascontiguousarray(_pil(data)[..., :3])


def webp_size(data: bytes) -> Tuple[int, int]:
    """(width, height) as PIL's ``.size``: the demuxer's canvas; raises
    where PIL cannot open the file."""
    data = bytes(data)
    if not is_webp(data):
        raise ValueError(f"not a WebP file; this reader takes {READS}")
    return _opened(data).canvas


"""PNG decoding and encoding with zlib and numpy, so the port reads pages
without PIL or cv2 (the GPU machine has neither).

Reads every PNG colour type (gray, RGB, palette, gray+alpha, RGBA) at every
bit depth the format allows (1, 2, 4, 8 and 16), non-interlaced or Adam7,
with all five row filters. An Adam7 page is seven sub-images, each filtered
on its own, whose pixels are scattered onto the full grid. 16-bit samples
are cut to 8 bits by the rule of the reference's decoder for the route:
PIL's ``convert("RGB")`` for files keeps the high byte of RGB, gray+alpha
and RGBA and clips 16-bit gray to 255; ``cv2.imdecode(..., IMREAD_COLOR)``
for serve bodies keeps the high byte of every colour type. Writes 8-bit
gray, RGB or RGBA with the Up filter on every row.

Rows whose filter is Average or Paeth depend on the reconstructed byte to
their left, so a page that uses them is reconstructed along anti-diagonals
(each step vectorised over the rows it crosses); pages with only None, Sub
and Up filters are reconstructed a row at a time.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["SIGNATURE", "READS", "decode_png", "encode_png", "png_size"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
READS = ("PNG (gray, RGB, palette, gray+alpha, RGBA at 1 to 16 bits, "
         "non-interlaced or Adam7) and .npy")
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
# 16-bit -> 8-bit, by the reference decoder of each route: colour types
# whose samples are clipped to 255 (the rest keep their high byte)
_SIXTEEN_BIT_CLIPPED = {"pil": (0,), "cv2": ()}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError(f"not a PNG file; this reader takes {READS}")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def png_size(data: bytes):
    """(width, height) from the IHDR chunk at the start of a PNG."""
    if data[:8] != SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError(f"not a PNG file; this reader takes {READS}")
    return struct.unpack(">II", data[16:24])


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
               depth: int, channels: int):
    """One filtered sub-image at ``raw[pos:]`` -> ((height, width,
    channels) samples, uint8, or uint16 at 16 bits; the position after
    it)."""
    stride = (width * channels * depth + 7) // 8
    end = pos + height * (stride + 1)
    if raw.size < end:
        raise ValueError("truncated PNG image data")
    rows = raw[pos:end].reshape(height, stride + 1)
    px = _unfilter(rows[:, 1:], rows[:, 0], max(1, channels * depth // 8))
    if depth < 8:
        vals = np.unpackbits(px, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (vals * weights).sum(axis=2, dtype=np.uint8)[:, :width]
    elif depth == 16:
        px = px.reshape(height, -1, 2).astype(np.uint16)
        px = (px[..., 0] << 8) | px[..., 1]
    return px.reshape(height, width, channels), end


def decode_png(data: bytes, sixteen_bit: str = "pil") -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as PIL's ``convert("RGB")`` gives
    it: gray is repeated, alpha is dropped, palette indices are looked up,
    gray below 8 bits is scaled to 0..255. ``sixteen_bit`` names the route
    whose rule cuts 16-bit samples to 8 bits: ``"pil"`` (files) or
    ``"cv2"`` (serve bodies); see the module docstring."""
    if sixteen_bit not in _SIXTEEN_BIT_CLIPPED:
        raise ValueError(f"sixteen_bit must be one of {sorted(_SIXTEEN_BIT_CLIPPED)}, "
                         f"got {sixteen_bit!r}")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"bad PNG colour type {color}")
    if depth not in _DEPTHS[color]:
        raise ValueError(f"bad PNG bit depth {depth} for colour type {color}")
    if interlace not in (0, 1):
        raise ValueError(f"bad PNG interlace method {interlace}")
    channels = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace:
        px = np.zeros((height, width, channels),
                      np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for y0, x0, dy, dx in _ADAM7:
            h, w = -(-(height - y0) // dy), -(-(width - x0) // dx)
            if h > 0 and w > 0:  # an empty pass has no bytes, not even filters
                px[y0::dy, x0::dx], pos = _sub_image(raw, pos, h, w, depth, channels)
    else:
        px, _ = _sub_image(raw, 0, height, width, depth, channels)
    if depth == 16:
        px = (np.minimum(px, 255) if color in _SIXTEEN_BIT_CLIPPED[sixteen_bit]
              else px >> 8).astype(np.uint8)
    elif depth < 8 and color == 0:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = px[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[idx]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


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

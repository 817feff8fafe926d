"""tdnet_torch.data.tiff against the reference's two decoders: each case
byte-equal to PIL's ``Image.open(...).convert("RGB")`` on the ``pil``
route (files, ``tdnet/data/image.py``) and to ``cv2.imdecode(...,
IMREAD_COLOR)[:, :, ::-1]`` on the ``cv2`` route (serve bodies,
``tdnet/bin/serve.py``). The files come from PIL's and cv2's TIFF writers
(libtiff) and, for the layouts they do not write (big-endian, tiles,
planar, bit depths, FillOrder), from a writer of the test's own."""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import tiff
from tdnet_torch.data.image import image_size, read_image_bgr


def _image(shape, seed, channels=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape + (channels,), dtype=np.uint8)
    if min(shape) >= 5:
        img = cv2.GaussianBlur(img, (5, 5), 0).reshape(img.shape)
    return img


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _cv2(data: bytes):
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[:, :, ::-1]


def _assert_both_routes(data: bytes):
    for route, oracle in (("pil", _pil), ("cv2", _cv2)):
        got, want = tiff.decode_tiff(data, route=route), oracle(data)
        assert want is not None, route
        assert got.dtype == np.uint8 and got.shape == want.shape, (route, got.shape, want.shape)
        if not np.array_equal(got, want):
            diff = np.argwhere(got != want)
            pytest.fail(f"{route}: {len(diff)} samples differ, first at {diff[0].tolist()}")
    assert tiff.tiff_size(data) == Image.open(io.BytesIO(data)).size


def _pil_tiff(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


# --- a TIFF writer of the test's own


class _BitWriter:
    def __init__(self):
        self.value, self.n = 0, 0

    def put(self, code, bits):
        self.value, self.n = (self.value << bits) | code, self.n + bits

    def bytes(self) -> bytes:
        pad = -self.n % 8
        return (self.value << pad).to_bytes((self.n + pad) // 8, "big")


def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW, as libtiff writes it: a clear code first, 9 to 12 bits,
    the width growing when the next free code reaches a power of two."""
    out, width = _BitWriter(), 9
    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    out.put(256, width)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        out.put(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt == 1 << width and width < 12:
            width += 1
        if nxt == 4094:
            out.put(256, width)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        w = bytes([byte])
    if w:
        out.put(table[w], width)
        nxt += 1
        if nxt == 1 << width and width < 12:
            width += 1
    out.put(257, width)
    return out.bytes()


def _packbits_encode(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_REV = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _pack_rows(block: np.ndarray, bits: int, end: str) -> bytes:
    """(rows, cols, spp) samples -> packed rows, each padded to a byte."""
    rows, cols, spp = block.shape
    flat = block.reshape(rows, cols * spp)
    if bits == 8:
        return flat.astype(np.uint8).tobytes()
    if bits == 16:
        return flat.astype(end + "u2").tobytes()
    bitplanes = ((flat[:, :, None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(rows, -1)
    return np.packbits(bitplanes.astype(np.uint8), axis=1).tobytes()


def _ycbcr_units(block: np.ndarray, h: int, v: int) -> bytes:
    """(rows, cols, 3) YCbCr samples -> subsampled data units: h * v luma
    samples row by row, then the unit's mean Cb and Cr; a partial unit at
    an edge is padded by repeating the last row and column."""
    rows, cols = block.shape[:2]
    full = np.pad(block, ((0, -rows % v), (0, -cols % h), (0, 0)), mode="edge")
    down, across = full.shape[0] // v, full.shape[1] // h
    units = full.reshape(down, v, across, h, 3).transpose(0, 2, 1, 3, 4).reshape(
        down, across, v * h, 3)
    chroma = (units[:, :, :, 1:].mean(axis=2) + 0.5).astype(np.int64)
    return np.concatenate([units[:, :, :, 0], chroma], axis=2).astype(np.uint8).tobytes()


def _tiff(samples, bits=8, photometric=2, *, compression=1, big_endian=False, tile=None,
          planar=1, rows_per_strip=None, predictor=1, fill_order=1, tags=None,
          subsampling=None, count_delta=0) -> bytes:
    """A one-page TIFF of (H, W, spp) samples. ``tile``: (width, length);
    ``tags``: more fields, tag -> (type, values); ``subsampling``: (h, v)
    of YCbCr samples, written as data units (``YCbCrSubsampling``);
    ``count_delta``: added to every strip or tile byte count written."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, spp = samples.shape
    end = ">" if big_endian else "<"
    planes = [samples[:, :, i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    if tile:
        cw, ch = tile
    else:
        cw, ch = w, rows_per_strip or h
    chunks = []
    for plane in planes:
        for y0 in range(0, h, ch):
            for x0 in range(0, w, cw):
                rows = ch if tile else min(ch, h - y0)
                block = np.zeros((rows, cw, plane.shape[2]), np.int64)
                part = plane[y0:y0 + rows, x0:x0 + cw]
                block[:part.shape[0], :part.shape[1]] = part
                if predictor == 2:
                    block[:, 1:] = (block[:, 1:] - block[:, :-1]) % (1 << bits)
                if subsampling and subsampling != (1, 1):
                    raw = _ycbcr_units(block[:part.shape[0]] if not tile else block,
                                       *subsampling)
                else:
                    raw = _pack_rows(block, bits, end)
                if compression == 5:
                    raw = _lzw_encode(raw)
                elif compression == 8:
                    raw = zlib.compress(raw)
                elif compression == 32773:
                    raw = _packbits_encode(raw)
                if fill_order == 2:
                    raw = raw.translate(_REV)
                chunks.append(raw)
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
              262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        fields[317] = (3, [predictor])
    if subsampling:
        fields[530] = (3, list(subsampling))
    if fill_order != 1:
        fields[266] = (3, [fill_order])
    if tile:
        fields[322], fields[323] = (3, [cw]), (3, [ch])
    else:
        fields[278] = (3, [ch])
    fields.update(tags or {})
    codes = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B"}  # 5: RATIONAL, as pairs
    # layout: header, chunk data, then out-of-line values, then the IFD
    body = bytearray(8)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + bytes(len(c) & 1)
    fields[324 if tile else 273] = (4, offsets)
    fields[325 if tile else 279] = (4, [len(c) + count_delta for c in chunks])
    entries = []
    for tag in sorted(fields):
        kind, values = fields[tag]
        raw = values if isinstance(values, bytes) else struct.pack(
            f"{end}{len(values)}{codes[kind]}", *values)
        count = len(raw) // struct.calcsize(codes[kind]) // (2 if kind == 5 else 1)
        if len(raw) <= 4:
            entries.append(struct.pack(end + "HHI", tag, kind, count) + raw.ljust(4, b"\0"))
        else:
            at = len(body)
            body += raw + bytes(len(raw) & 1)
            entries.append(struct.pack(end + "HHII", tag, kind, count, at))
    ifd = len(body)
    body += struct.pack(end + "H", len(entries)) + b"".join(entries) + bytes(4)
    body[:8] = (b"MM" if big_endian else b"II") + struct.pack(end + "HI", 42, ifd)
    return bytes(body)


def _jpeg_tiff(strips, h, w, photometric=6, subsampling=(2, 2), rows_per_strip=None,
               tables=None) -> bytes:
    """A JPEG-compressed TIFF of the given JPEG streams, one a strip (PIL
    writes YCbCr without subsampling only)."""
    offsets, body = [], bytearray(8)
    for s in strips:
        offsets.append(len(body))
        body += s + bytes(len(s) & 1)
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [7]),
              262: (3, [photometric]), 273: (4, offsets), 277: (3, [3]),
              278: (3, [rows_per_strip or h]), 279: (4, [len(s) for s in strips]),
              284: (3, [1]), 530: (3, list(subsampling))}
    if tables:
        fields[347] = (7, tables)
    entries = []
    for tag in sorted(fields):
        kind, values = fields[tag]
        raw = values if isinstance(values, bytes) else struct.pack(
            f"<{len(values)}{'HI'[kind == 4]}", *values)
        count = len(raw) // (1 if kind == 7 else 2 if kind == 3 else 4)
        if len(raw) <= 4:
            entries.append(struct.pack("<HHI", tag, kind, count) + raw.ljust(4, b"\0"))
        else:
            entries.append(struct.pack("<HHII", tag, kind, count, len(body)))
            body += raw + bytes(len(raw) & 1)
    ifd = len(body)
    body += struct.pack("<H", len(entries)) + b"".join(entries) + bytes(4)
    body[:8] = b"II" + struct.pack("<HI", 42, ifd)
    return bytes(body)


PIL_MODES = ["RGB", "L", "1", "P", "CMYK", "RGBA", "LA", "I;16"]
PIL_COMPRESSIONS = ["raw", "packbits", "tiff_lzw", "tiff_adobe_deflate"]


def _pil_page(mode: str, shape, seed) -> Image.Image:
    img = _image(shape, seed)
    rng = np.random.default_rng(seed)
    if mode == "I;16":  # above 255 mostly: PIL clips, cv2 keeps the high byte
        return Image.fromarray((img[..., 0].astype(np.uint16) * 257
                                - rng.integers(0, 200, shape)).astype(np.uint16))
    alpha = rng.integers(0, 256, shape, dtype=np.uint8)
    if mode == "RGBA":  # cv2 premultiplies RGB by it
        return Image.fromarray(np.dstack([img, alpha]), "RGBA")
    if mode == "LA":
        return Image.fromarray(np.dstack([img[..., 0], alpha]), "LA")
    return Image.fromarray(img).convert(mode)


@pytest.mark.parametrize("compression", PIL_COMPRESSIONS)
@pytest.mark.parametrize("mode", PIL_MODES)
def test_tiff_pil_modes_and_compressions_equal_both_routes(mode, compression):
    """Every mode PIL writes, in each compression it writes through
    libtiff, at sizes from 1x1 up: gray, bilevel, palette, RGB, CMYK,
    alpha (dropped; cv2 premultiplies RGB by it), 16-bit gray (where the
    routes part by up to 196)."""
    for shape in ((1, 1), (40, 57)):
        data = _pil_tiff(_pil_page(mode, shape, len(mode)), compression=compression)
        _assert_both_routes(data)
    if mode == "I;16":
        routes = [tiff.decode_tiff(data, r).astype(int) for r in tiff.ROUTES]
        assert np.abs(routes[0] - routes[1]).max() > 150


@pytest.mark.parametrize("case", ["RGB", "L", "YCbCr", "cv2"])
def test_tiff_jpeg_compression_equal_both_routes(case):
    """JPEG-compressed TIFF (code 7) with its JPEGTables: RGB and gray
    (no colour conversion) and YCbCr as PIL writes them, RGB as cv2
    writes it."""
    img = _image((40, 57), 4)
    if case == "cv2":
        ok, enc = cv2.imencode(".tiff", img[:, :, ::-1], [cv2.IMWRITE_TIFF_COMPRESSION, 7])
        data = enc.tobytes()
    else:
        data = _pil_tiff(Image.fromarray(img).convert(case), compression="jpeg")
    assert 347 in Image.open(io.BytesIO(data)).tag_v2
    _assert_both_routes(data)


@pytest.mark.parametrize("subsampling", [(2, 2), (2, 1), (1, 1)], ids=["420", "422", "444"])
def test_tiff_jpeg_ycbcr_subsampled_strips(subsampling):
    """YCbCr JPEG strips subsampled (which no encoder here writes into a
    TIFF): libjpeg's fancy upsampling, strip by strip, by both routes."""
    img = _image((40, 57), 5)
    sub = {(2, 2): 2, (2, 1): 1, (1, 1): 0}[subsampling]

    def jpg(part):
        buf = io.BytesIO()
        Image.fromarray(part).save(buf, "JPEG", quality=85, subsampling=sub)
        return buf.getvalue()

    _assert_both_routes(_jpeg_tiff([jpg(img)], 40, 57, subsampling=subsampling))
    strips = [jpg(img[y:y + 16]) for y in range(0, 40, 16)]
    _assert_both_routes(_jpeg_tiff(strips, 40, 57, subsampling=subsampling, rows_per_strip=16))


@pytest.mark.parametrize("compression", ["group3", "group4"])
def test_tiff_ccitt_equal_both_routes(compression):
    """CCITT Group 3 (one-dimensional; two-dimensional with T4Options bit 0;
    byte-aligned ends of line, bit 2) and Group 4, FillOrder 1 and 2."""
    page = Image.fromarray(_image((61, 83), 6)).convert("1")
    for info in ({}, {292: 1}, {292: 5}, {266: 2}, {266: 2, 292: 1}):
        data = _pil_tiff(page, compression=compression, tiffinfo=info)
        tags = Image.open(io.BytesIO(data)).tag_v2
        assert tags[259] == (3 if compression == "group3" else 4)
        _assert_both_routes(data)


def test_tiff_lzw_predictor_orientation_and_pages():
    """LZW with Predictor 2 (PIL, and cv2's own writer), Orientation 1-8
    (both routes turn the page; PIL's .size and image_size report the
    turned size), a file of two pages (both read the first)."""
    img = _image((40, 57), 7)
    page = Image.fromarray(img)
    _assert_both_routes(_pil_tiff(page, compression="tiff_lzw", tiffinfo={317: 2}))
    ok, enc = cv2.imencode(".tiff", img[:, :, ::-1])
    assert Image.open(io.BytesIO(enc.tobytes())).tag_v2[317] == 2
    _assert_both_routes(enc.tobytes())
    for orientation in range(1, 9):
        data = _pil_tiff(page, compression="tiff_lzw", tiffinfo={274: orientation})
        _assert_both_routes(data)
        turned = orientation >= 5
        assert tiff.tiff_size(data) == ((40, 57) if turned else (57, 40))
    data = _pil_tiff(page, save_all=True, append_images=[page.convert("L").rotate(90)],
                     compression="tiff_lzw")
    assert getattr(Image.open(io.BytesIO(data)), "n_frames", 1) == 2
    _assert_both_routes(data)


LAYOUTS = {  # name: _tiff arguments; sample values fit their bits
    "big_endian": dict(big_endian=True, rows_per_strip=7),
    "tiled": dict(tile=(16, 32)),
    "tiled_big_endian": dict(tile=(32, 16), big_endian=True),
    "tiled_uncompressed": dict(tile=(32, 32), compression=1),
    "planar": dict(planar=2, rows_per_strip=9),
    "planar_tiled_big_endian": dict(planar=2, tile=(16, 16), big_endian=True),
    "predictor_big_endian": dict(predictor=2, big_endian=True, rows_per_strip=11),
    "packbits_big_endian": dict(compression=32773, big_endian=True),
    "deflate_planar": dict(compression=8, planar=2),
    "rgb16_predictor": dict(bits=16, predictor=2),
    "rgb16_big_endian_planar": dict(bits=16, big_endian=True, planar=2),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_tiff_layouts_equal_both_routes(case):
    """Layouts PIL does not write, from the test's own writer (LZW unless
    named): big-endian files, tiles (cropped at the page's edges), planar
    samples, Predictor 2 at 8 and 16 bits, 16-bit RGB (PIL keeps the high
    byte, cv2 rounds)."""
    kw = dict(LAYOUTS[case])
    kw.setdefault("compression", 5)
    bits = kw.pop("bits", 8)
    img = _image((40, 57), len(case)).astype(np.int64)
    if bits == 16:
        img = img * 257 + np.random.default_rng(0).integers(0, 257, img.shape)
    _assert_both_routes(_tiff(img, bits, 2, **kw))


GRAYS = {  # name: (bits, photometric, more fields)
    "gray1": (1, 1, {}), "white1": (1, 0, {}), "gray8": (8, 1, {}), "white8": (8, 0, {}),
    "gray16_big_endian": (16, 1, {}), "white16": (16, 0, {}),
    "palette1": (1, 3, {}), "palette4": (4, 3, {}), "palette8": (8, 3, {}),
    "palette4_8bit_colormap": (4, 3, {"cmap8": True}),
    "gray2": (2, 1, {}), "white4": (4, 0, {}), "palette2": (2, 3, {}),
}


@pytest.mark.parametrize("case", sorted(GRAYS))
def test_tiff_bit_depths_and_photometrics(case):
    """Gray and palette pages at 1 to 16 bits, min-is-white and
    min-is-black, a 16-bit colormap and one whose entries all lie below
    256 (cv2, through libtiff, takes it for 8-bit). cv2 reads 2-bit pages
    and 4-bit gray not at all, and the port's cv2 route raises on them."""
    bits, photometric, more = GRAYS[case]
    rng = np.random.default_rng(len(case))
    samples = rng.integers(0, 1 << bits, (23, 37))
    tags = {}
    if photometric == 3:
        top = 256 if more.get("cmap8") else 65536
        tags[320] = (3, [int(v) for v in rng.integers(0, top, 3 << bits)])
    data = _tiff(samples, bits, photometric, compression=8, big_endian="big" in case, tags=tags)
    if bits == 2 or case == "white4":
        np.testing.assert_array_equal(tiff.decode_tiff(data, "pil"), _pil(data))
        assert _cv2(data) is None
        with pytest.raises(ValueError, match="cv2 reads"):
            tiff.decode_tiff(data, "cv2")
        return
    _assert_both_routes(data)


def test_tiff_cmyk16_alpha_and_fill_order():
    """16-bit CMYK (PIL's high bytes; cv2 fails, and its route raises),
    associated alpha (PIL divides it out, cv2 drops it), 16-bit RGBA
    (cv2 premultiplies the rounded samples), extra samples of no kind
    (dropped), FillOrder 2 on uncompressed 8-bit and 1-bit pages."""
    rng = np.random.default_rng(8)
    cmyk = _tiff(rng.integers(0, 65536, (9, 11, 4)), 16, 5)
    np.testing.assert_array_equal(tiff.decode_tiff(cmyk, "pil"), _pil(cmyk))
    assert _cv2(cmyk) is None
    with pytest.raises(ValueError, match="16-bit CMYK"):
        tiff.decode_tiff(cmyk, "cv2")
    rgba = rng.integers(0, 256, (9, 11, 4))
    rgba[..., :3] = np.minimum(rgba[..., :3], rgba[..., 3:])
    _assert_both_routes(_tiff(rgba, 8, 2, tags={338: (3, [1])}))
    _assert_both_routes(_tiff(rng.integers(0, 65536, (9, 11, 4)), 16, 2, tags={338: (3, [2])}))
    _assert_both_routes(_tiff(rng.integers(0, 256, (9, 11, 4)), 8, 2, tags={338: (3, [0])}))
    _assert_both_routes(_tiff(rng.integers(0, 256, (9, 11)), 8, 1, fill_order=2))
    _assert_both_routes(_tiff(rng.integers(0, 2, (9, 11)), 1, 0, fill_order=2))


def _assert_routes_or_same_refusal(data: bytes):
    """Both routes equal their references, or the port raises on a route
    whose reference refuses the file (PIL's "image file is truncated" on
    uncompressed YCbCr, which it reads as RGBX), naming the case."""
    for route, oracle in (("pil", _pil), ("cv2", _cv2)):
        try:
            want = oracle(data)
        except OSError as e:
            assert "truncated" in str(e), (route, e)
            with pytest.raises(ValueError, match="image file is truncated"):
                tiff.decode_tiff(data, route=route)
            continue
        np.testing.assert_array_equal(tiff.decode_tiff(data, route=route), want, err_msg=route)


def test_tiff_ycbcr_outside_jpeg_from_pil():
    """YCbCr pages as PIL writes them (1x1, PackBits, LZW, deflate, and
    uncompressed with ReferenceBlackWhite): libtiff's TIFFYCbCrtoRGB on
    both routes; uncompressed, PIL reads 4 bytes a pixel and runs past
    the end of the file, and the port's pil route raises as it does."""
    page = Image.fromarray(_image((40, 57), 11)).convert("YCbCr")
    for compression in ("packbits", "tiff_lzw", "tiff_adobe_deflate"):
        _assert_both_routes(_pil_tiff(page, compression=compression))
    raw = _pil_tiff(page, compression="raw")
    assert 532 in Image.open(io.BytesIO(raw)).tag_v2
    with pytest.raises(OSError, match="image file is truncated"):
        _pil(raw)
    with pytest.raises(ValueError, match="image file is truncated"):
        tiff.decode_tiff(raw, route="pil")
    np.testing.assert_array_equal(tiff.decode_tiff(raw, route="cv2"), _cv2(raw))


@pytest.mark.parametrize("subsampling", [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tiff_ycbcr_subsampled_outside_jpeg(subsampling):
    """Subsampled YCbCr data units (the test's own writer: neither library
    writes them) in LZW strips and tiles and uncompressed, at sizes whose
    edges cut the units: libtiff's putcontig8bitYCbCr tiles on both routes,
    its 4x4 misreads included (a strip's short read, a tile's hidden units
    skipped as 10 bytes). Uncompressed, PIL reads the bytes as RGBX: a page
    whose data lies far enough before the end decodes (as garbage), the
    others raise."""
    rng = np.random.default_rng(sum(subsampling))
    for shape in ((40, 57), (7, 9), (16, 16)):
        ycc = np.asarray(Image.fromarray(_image(shape, int(rng.integers(99)))).convert("YCbCr"))
        _assert_both_routes(_tiff(ycc, 8, 6, compression=5, subsampling=subsampling))
        _assert_routes_or_same_refusal(_tiff(ycc, 8, 6, subsampling=subsampling))
    _assert_both_routes(_tiff(ycc[:, :, :], 8, 6, compression=8, subsampling=subsampling,
                              rows_per_strip=8))
    ycc = np.asarray(Image.fromarray(_image((40, 57), 12)).convert("YCbCr"))
    _assert_both_routes(_tiff(ycc, 8, 6, compression=5, subsampling=subsampling, tile=(16, 16)))


def test_tiff_ycbcr_coefficients_reference_and_planes():
    """YCbCrCoefficients and ReferenceBlackWhite (RATIONAL; BT.709 and
    video range) in libtiff's float tables, the default 2x2 subsampling of
    a page without the field, and planar YCbCr at 1x1 (PIL's raw decoder
    takes the planes as R, G and B unconverted)."""
    ycc = np.asarray(Image.fromarray(_image((24, 30), 13)).convert("YCbCr"))
    video = {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}
    bt709 = {529: (5, [2126, 10000, 7152, 10000, 722, 10000])}
    for tags, sub in ((video, (1, 1)), (bt709, (2, 2)), ({**video, **bt709}, (2, 1))):
        _assert_both_routes(_tiff(ycc, 8, 6, compression=5, subsampling=sub, tags=tags))
    _assert_both_routes(_tiff(ycc, 8, 6, compression=5))
    _assert_both_routes(_tiff(ycc, 8, 6, compression=5, planar=2, subsampling=(1, 1)))
    _assert_both_routes(_tiff(ycc, 8, 6, planar=2, subsampling=(1, 1)))


def test_tiff_cases_that_raise():
    """What the port does not read raises on both routes with a message
    that names it; a YCbCr page outside JPEG and a CIE L*a*b* page, once
    among them, decode."""
    img = _image((12, 16), 9)
    page = Image.fromarray(img)
    cases = {
        "old-style JPEG": _tiff(img, compression=6),
        "CCITT modified Huffman RLE": _pil_tiff(page.convert("1"), compression="tiff_ccitt"),
        "Zstandard": _tiff(img, compression=50000),
        "subsampled 2x2 in planes": _tiff(img, photometric=6, compression=5, planar=2),
        "YCbCr TIFF of 4 samples": _tiff(np.dstack([img, img[:, :, :1]]), photometric=6,
                                         compression=5, subsampling=(1, 1)),
        "ICC L\\*a\\*b\\*": _tiff(img, photometric=9),
        "ITU L\\*a\\*b\\*": _tiff(img, photometric=10),
        "Predictor 3": _tiff(img, compression=5, predictor=3),
        "sample format": _tiff(img, tags={339: (3, [3, 3, 3])}),
        "at 32 bits": _tiff(img.astype(np.int64), 32, 2),
        "BigTIFF": b"II+\x00" + bytes(12),
        "truncated": _tiff(img)[:100] + _tiff(img)[-200:],
        "fewer strip": _tiff(img, rows_per_strip=4, tags={278: (3, [2])}),
    }
    for match, data in cases.items():
        for route in tiff.ROUTES:
            with pytest.raises(ValueError, match=match):
                tiff.decode_tiff(data, route=route)
    with pytest.raises(ValueError, match="route"):
        tiff.decode_tiff(_tiff(img), route="tf")
    # read outside JPEG since YCbCr's conversion was ported; both routes
    _assert_both_routes(_pil_tiff(page.convert("YCbCr"), compression="tiff_lzw"))
    _assert_both_routes(_tiff(img, photometric=8))  # since CIE L*a*b*'s were


def test_tiff_through_read_image_and_image_size(tmp_path):
    """read_image_bgr and image_size take TIFF pages by their content, as
    PIL does, the turned size of an Orientation 6 page included."""
    img = _image((21, 34), 10)
    for name, info in (("a.tif", {}), ("b.tiff", {274: 6}), ("c.dat", {317: 2})):
        path = tmp_path / name
        path.write_bytes(_pil_tiff(Image.fromarray(img), compression="tiff_lzw", tiffinfo=info))
        want = np.asarray(Image.open(path).convert("RGB"))[:, :, ::-1]
        np.testing.assert_array_equal(read_image_bgr(path), want)
        assert image_size(path) == Image.open(path).size
    assert image_size(tmp_path / "b.tiff") == (21, 34)


def _routes_or_refusals(data: bytes, name: str = ""):
    """Each route equals its reference, or raises where the reference
    refuses the file (PIL raises, cv2 returns None)."""
    for route, oracle in (("pil", _pil), ("cv2", _cv2)):
        try:
            want = oracle(data)
        except (OSError, ValueError):
            want = None
        if want is None:
            with pytest.raises(ValueError):
                tiff.decode_tiff(data, route=route)
            continue
        got = tiff.decode_tiff(data, route=route)
        assert got.shape == want.shape and np.array_equal(got, want), (name, route)


LAB = {  # name: (bits, samples, _tiff arguments); sample values fit their bits
    "strips": (8, 3, dict(rows_per_strip=7)),
    "lzw_predictor_big_endian": (8, 3, dict(compression=5, predictor=2, big_endian=True)),
    "deflate": (8, 3, dict(compression=8)),
    "lzw_tiles": (8, 3, dict(compression=5, tile=(16, 32))),
    "planar": (8, 3, dict(planar=2, compression=32773)),
    "orientation": (8, 3, dict(tags={274: (3, [6])})),
    "white_point_d65": (8, 3, dict(tags={318: (5, [3127, 10000, 3290, 10000])})),
    "16_bit": (16, 3, dict(compression=5)),
    "one_sample": (8, 1, {}),
    "alpha": (8, 4, dict(tags={338: (3, [2])})),
}


@pytest.mark.parametrize("case", sorted(LAB))
def test_tiff_cielab_by_each_route(case):
    """CIE L*a*b* pages (photometric 8, a* and b* signed): PIL reads 3
    8-bit samples in any layout and converts them through LittleCMS, cv2
    reads 3 chunky 8- or 16-bit samples through libtiff's RGBA interface
    against the WhitePoint tag; the two part by up to 80 on random
    samples. Each refuses the rest."""
    bits, spp, kw = LAB[case]
    rng = np.random.default_rng(len(case))
    lab = rng.integers(0, 1 << bits, (40, 57, spp)).astype(np.int64)
    _routes_or_refusals(_tiff(lab, bits, 8, **kw), case)


def test_tiff_cielab_from_pil_and_the_photometrics_both_refuse():
    """PIL's own LAB writer; the routes part by up to 80 on its random
    samples. ICC L*a*b* (9) and ITU L*a*b* (10) are refused by both
    references and by the port."""
    rng = np.random.default_rng(3)
    lab = rng.integers(0, 256, (30, 44, 3), dtype=np.uint8)
    data = _pil_tiff(Image.frombytes("LAB", (44, 30), lab.tobytes()), compression="tiff_lzw")
    _assert_both_routes(data)
    routes = [tiff.decode_tiff(data, route=r).astype(int) for r in tiff.ROUTES]
    assert 60 <= np.abs(routes[0] - routes[1]).max() <= 90
    for photometric in (9, 10):
        data = _tiff(lab.astype(np.int64), 8, photometric)
        with pytest.raises(OSError):
            _pil(data)
        assert _cv2(data) is None
        for route in tiff.ROUTES:
            with pytest.raises(ValueError, match="L\\*a\\*b\\*"):
                tiff.decode_tiff(data, route=route)


def test_cielab_conversions_equal_their_references():
    """``data/cielab.py`` on 60000 random 8-bit triples, and the 16-bit
    libtiff path on 20000, against PIL's LittleCMS transform and cv2's
    libtiff read (the whole 8-bit cube was held once, outside the
    suite)."""
    from tdnet_torch.data import cielab

    rng = np.random.default_rng(4)
    lab = rng.integers(0, 256, (200, 300, 3), dtype=np.uint8)
    want = np.asarray(Image.frombytes("LAB", (300, 200), lab.tobytes()).convert("RGB"))
    # Image.frombytes("LAB") flips 0x80 of a* and b*, as PIL's TIFF reader does
    np.testing.assert_array_equal(cielab.lcms_rgb(lab ^ np.array([0, 0x80, 0x80], np.uint8)),
                                  want)
    np.testing.assert_array_equal(cielab.libtiff_rgb(lab, 8),
                                  _cv2(_tiff(lab.astype(np.int64), 8, 8)))
    lab16 = rng.integers(0, 65536, (100, 200, 3)).astype(np.int64)
    np.testing.assert_array_equal(cielab.libtiff_rgb(lab16, 16), _cv2(_tiff(lab16, 16, 8)))


@pytest.mark.parametrize("shape", [(32, 32), (20, 28), (17, 40), (40, 70)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tiff_uncompressed_ycbcr_tiles_on_the_pil_route(shape):
    """Uncompressed YCbCr in tiles, chunky and planar: PIL reads each tile
    as RGBX from its offset (rows 3 * tile width bytes apart in a tile past
    the right edge), and fails where that runs past the end of the file or
    the row's bytes exceed that stride, as the port's pil route does."""
    rng = np.random.default_rng(shape[1])
    ycc = rng.integers(0, 256, shape + (3,)).astype(np.int64)
    for tile in ((16, 16), (32, 16), (48, 16)):
        for planar in (1, 2):
            data = _tiff(ycc, 8, 6, subsampling=(1, 1), tile=tile, planar=planar)
            try:
                want = _pil(data)
            except OSError:
                with pytest.raises(ValueError, match="PIL reads"):
                    tiff.decode_tiff(data, route="pil")
                continue
            np.testing.assert_array_equal(tiff.decode_tiff(data, route="pil"), want)


C12_TILES = [(t, bits, spp, planar) for t in (16, 32, 48, 64) for bits in (8, 16)
             for spp, planar in ((1, 1), (3, 1), (3, 2), (4, 1), (4, 2))]


@pytest.mark.parametrize("tile,bits,spp,planar", C12_TILES,
                         ids=lambda v: str(v))
def test_tiff_uncompressed_tile_byte_counts_by_each_route(tile, bits, spp, planar):
    """Uncompressed square tiles on a 40x70 page (the right and bottom
    tiles clipped), each tile's byte count exact, one short and one long.
    cv2 (libtiff 4.7) refuses a count that, rounded up to a multiple of
    1024, is not the tile's size ("Invalid tile byte count"), and reads a
    short one whose rounding passes as a tile of zero samples; its 16-bit
    gray tiles clipped on the right read with libtiff's skew. The port's
    cv2 route refuses exactly where cv2 returns None; PIL's route reads the
    exact counts as before."""
    rng = np.random.default_rng(tile * 7 + bits + spp * 3 + planar)
    samples = rng.integers(0, 1 << bits, (40, 70, spp)).astype(np.int64)
    photometric = 1 if spp == 1 else 2
    tags = {338: (3, [2])} if spp == 4 else None
    for delta in (0, -1, 1):
        data = _tiff(samples, bits, photometric, tile=(tile, tile), planar=planar, tags=tags,
                     count_delta=delta)
        want = _cv2(data)
        if want is None:
            with pytest.raises(ValueError, match="Invalid tile byte count"):
                tiff.decode_tiff(data, route="cv2")
        else:
            np.testing.assert_array_equal(tiff.decode_tiff(data, route="cv2"), want)
        if delta == 0:
            np.testing.assert_array_equal(tiff.decode_tiff(data, route="pil"), _pil(data))


def test_tiff_c12_pages_in_16x16_tiles():
    """The pages C12 was found on: 24x32 RGB and CIE L*a*b*, uncompressed in
    16x16 tiles. cv2 refuses both (a 768-byte tile rounds to 1024); PIL
    reads both; 16x16 LZW tiles read on both routes."""
    rng = np.random.default_rng(12)
    for photometric in (2, 8):
        samples = rng.integers(0, 256, (24, 32, 3)).astype(np.int64)
        data = _tiff(samples, 8, photometric, tile=(16, 16))
        assert _cv2(data) is None
        with pytest.raises(ValueError, match="Invalid tile byte count"):
            tiff.decode_tiff(data, route="cv2")
        np.testing.assert_array_equal(tiff.decode_tiff(data, route="pil"), _pil(data))
        _assert_both_routes(_tiff(samples, 8, photometric, tile=(16, 16), compression=5))


PLANAR16 = {  # name: (samples, photometric, more fields)
    "gray": (1, 1, None), "white": (1, 0, None), "gray_alpha": (2, 1, {338: (3, [2])}),
    "rgb": (3, 2, None), "rgba": (4, 2, {338: (3, [2])}),
    "rgba_associated": (4, 2, {338: (3, [1])}), "cmyk": (4, 5, None), "lab": (3, 8, None),
}


@pytest.mark.parametrize("case", sorted(PLANAR16))
def test_tiff_uncompressed_16_bit_planes_on_the_pil_route(case):
    """Uncompressed 16-bit samples in planes, in tiles and in strips: PIL
    gives each plane one letter of the chunky raw mode and reads its bytes
    as 8-bit samples; it has no raw mode for gray or associated alpha and
    cannot identify gray with alpha or L*a*b*. The port's pil route reads
    and refuses as PIL does."""
    spp, photometric, tags = PLANAR16[case]
    rng = np.random.default_rng(len(case))
    samples = rng.integers(0, 1 << 16, (40, 70, spp)).astype(np.int64)
    for kw in (dict(tile=(32, 32)), dict(rows_per_strip=8)):
        data = _tiff(samples, 16, photometric, planar=2, tags=tags, **kw)
        try:
            want = _pil(data)
        except (OSError, ValueError):
            with pytest.raises(ValueError):
                tiff.decode_tiff(data, route="pil")
            continue
        np.testing.assert_array_equal(tiff.decode_tiff(data, route="pil"), want)


GRAY_EXTRA = [(bits, photometric, extra) for bits in (8, 16) for photometric in (0, 1)
              for extra in (0, 1, 2)]


@pytest.mark.parametrize("bits,photometric,extra", GRAY_EXTRA, ids=lambda v: str(v))
def test_tiff_gray_with_an_extra_sample_by_each_route(bits, photometric, extra):
    """Gray with one extra sample (unspecified, associated or unassociated
    alpha), chunky and planar, in strips and in 32x32 tiles (a 40x70 page:
    the right tiles clipped), uncompressed and LZW. PIL reads only 8-bit
    min-is-black with unassociated alpha (``LA``; not uncompressed in
    planes). cv2 reads them all through libtiff's RGBA interface: chunky,
    the alpha ignored and the clipped tiles read with its row skew; in
    planes, as RGB (no min-is-white inversion, 16 bits rounded to 8, an
    unassociated alpha premultiplied)."""
    rng = np.random.default_rng(bits + 3 * photometric + extra)
    samples = rng.integers(0, 1 << bits, (40, 70, 2)).astype(np.int64)
    for planar in (1, 2):
        for layout in (dict(rows_per_strip=8), dict(tile=(32, 32))):
            for compression in (1, 5):
                data = _tiff(samples, bits, photometric, tags={338: (3, [extra])},
                             planar=planar, compression=compression, **layout)
                for route, oracle in (("pil", _pil), ("cv2", _cv2)):
                    try:
                        want = oracle(data)
                    except (OSError, ValueError):
                        want = None
                    if want is None:
                        with pytest.raises(ValueError):
                            tiff.decode_tiff(data, route=route)
                    else:
                        np.testing.assert_array_equal(tiff.decode_tiff(data, route=route), want)

"""Regenerate tests/golden/pages/: full-size (1100x850) table pages in the
formats the port reads beyond sequential JPEG, and ``digests.json``, which
holds for each file the SHA-256 of the two reference decodes the port must
equal byte for byte (as tools/make_jpeg_pages.py does for tests/golden/jpeg):

- ``pil_rgb_sha256``: ``np.asarray(Image.open(path).convert("RGB"))``
  (the reference's file route, ``tdnet/data/image.py``);
- ``cv2_bgr_sha256``: ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` (the
  reference's serve-body route, ``tdnet/bin/serve.py``);

with each file's size (as PIL's ``.size``) and the table boxes drawn. The
pages come from tools/make_jpeg_pages.py's ``table_page`` with seed 8:

- ``prog_pil.jpg``: progressive JPEG, 4:2:0, quality 90 (PIL);
- ``prog_cv2.jpg``: progressive JPEG, 4:2:0, quality 85 (cv2);
- ``cmyk.jpg``: CMYK JPEG (Adobe, inverted), quality 85 (PIL); the routes
  differ by 1 (each has its own CMYK rule);
- ``sub411.jpg``: 4:1:1 JPEG, quality 90 (cv2);
- ``rle8.bmp``: 8-bit palette BMP with BI_RLE8 (an encoder of this tool's
  own: neither PIL nor cv2 writes RLE), the page's colours as its palette;
- ``g4.tif``: the page thresholded to bilevel, CCITT Group 4 (PIL);
- ``lzw_pred.tif``: RGB, LZW with Predictor 2 (PIL);
- ``jpeg_ycc.tif``: YCbCr, JPEG compression with JPEGTables (PIL);
- ``ycc_lzw.tif``: YCbCr outside JPEG, LZW (PIL);
- ``page.pbm``: the page thresholded to bilevel, binary PBM (P4, PIL);
- ``page.gif``: GIF, an adaptive palette of the page's colours (PIL);
- ``arith_seq.jpg``, ``arith_prog.jpg``: sequential (SOF9) and progressive
  (SOF10) arithmetic-coded JPEG, quality 75, transcoded from PIL's Huffman
  JPEG by tools/jpeg_arith.py;
- ``arith_big.jpg``: sequential arithmetic-coded JPEG, quality 90, whose
  entropy-coded data runs past the first 65536 bytes: PIL refuses it
  (libjpeg's arithmetic decoder cannot wait for the rest of the file),
  cv2 reads it;
- ``lossless.jpg``: lossless JPEG (SOF3), RGB, predictor 7, of the page at
  half size (550x425, boxes halved), by tools/jpeg_lossless.py;
- ``rle.ras``: 8-bit Sun raster, byte-encoded (type 2), the page's colours
  as its colormap (an encoder of this tool's own): PIL reads it, cv2
  refuses the type;

six WebP pages drawn from a generator of their own (seed 9), so that the
pages above keep their bytes:

- ``vp8l_palette.webp``: Pillow's default lossless (``VP8L``: a palette of
  the page's colours, bundled);
- ``vp8l_rgb.webp``: the page after a JPEG at quality 75 (thousands of
  colours), saved lossless;
- ``vp8_q80.webp``: Pillow's default lossy (``VP8 ``, quality 80);
- ``vp8x_alpha.webp``: RGBA, lossy with an ``ALPH`` chunk (an alpha
  that fades and a transparent top margin; RGB drops it);
- ``vp8x_exif6.webp``: lossy with an EXIF Orientation of 6: cv2 turns the
  page, PIL does not, so the routes part;
- ``vp8_simple4.webp``: lossy, rewritten by tools/webp_rewrite.py to the
  simple loop filter in 4 token partitions;

and six more from a third generator (seed 13):

- ``apng_default.png``: an animated PNG whose IDAT image is not a frame
  (Pillow's ``default_image=True``; two frames, the second a one-pixel
  change of the first): PIL reads the IDAT image, cv2 the first frame;
- ``exif6.png``: a PNG with an ``eXIf`` Orientation of 6: cv2 turns the
  page, PIL does not;
- ``lab.tif``: CIE L*a*b* TIFF, LZW (Pillow's ``convert("LAB")``): PIL
  converts it through LittleCMS, cv2 through libtiff, so the routes part;
- ``jpeg12.jpg``: a 12-bit sequential JPEG (SOF1; Pillow's quality-90
  Huffman data under precision 12): both references refuse it;
- ``gray.pfm``: a gray PFM (``Pf``, little-endian) of the page at half
  size (floats 0.25 above its gray levels): PIL reads it, cv2 returns one
  channel, which the serve route refuses;
- ``page.hdr``: Radiance HDR, run-length scanlines (cv2's encoder, the
  page / 255): cv2 reads it, PIL cannot identify it;

and four JPEG 2000 pages from a fourth generator (seed 17):

- ``j2k_97.jp2``: PIL's JP2, the irreversible 9/7 with ICT, three
  quality layers at rates 40, 20 and 10 (code-blocks cut short by the
  layers, reconstructed half-way);
- ``j2k_rpcl.j2k``: PIL's raw codestream, reversible 5/3 with RCT, RPCL
  progression, 512x512 tiles, 128x128 precincts and PLT markers;
- ``j2k_cv2.jp2``: cv2's own JP2 writer (``IMWRITE_JPEG2000_COMPRESSION_X1000``
  250);
- ``j2k_gray16.jp2``: PIL's JP2 of the page at half size in 16-bit gray
  (``I;16``, each gray level times 257): PIL clips it to 255, cv2 keeps
  the high byte, so the routes part.

and ten pages that only PIL reads, from a fifth generator (seed 25);
cv2 refuses each:

- ``f32.tif``: 32-bit float gray (``F``), LZW with the floating-point
  predictor (3), the page's gray levels times 1.6 less 80.37 (values
  below 0 and past 255, which PIL clips);
- ``i32.tif``: 32-bit signed gray (``I``), deflate, the gray levels
  times 3 less 200;
- ``page.tga``: an adaptive 256-colour palette, run-length encoded, the
  top-left origin (flag 0x20);
- ``page.pcx``: 8 bits with its 256-colour palette after the pixels;
- ``page16.sgi``: RGB at 2 bytes a channel (each level times 257),
  run-length encoded (an encoder of this tool's own: PIL writes SGI
  verbatim only);
- ``page.ico``: two frames, the page as a PNG (its directory entry 0 x 0,
  that is 256 x 256, the largest, which PIL loads at the PNG's own size)
  and a 32 x 32 8-bit BMP;
- ``bc7.dds``, ``bc6h.dds``: DX10 DDS of the page at half size in BC7
  (mode 6 blocks) and unsigned BC6H (mode 11 blocks), by encoders of this
  tool's own (PIL writes neither), PIL's decode their reference;
- ``page.qoi``: QOI, RGB;
- ``page.im``: IM of the page at half size with a 256-colour ``Lut:``.

and twenty pages of the other formats only PIL reads, from a sixth
generator (seed 33), most at a quarter of the page's size; cv2 refuses
each: ``page.dib`` (PIL's DIB writer, 256 colours), ``page.cur`` (a
cursor of an 8-bit bitmap), ``page.dcx`` (one PCX page), ``page.msp``
(PIL's version 1 of the bilevel page, full size), ``page.xbm`` (PIL's
writer), ``page.spi`` (PIL's SPIDER writer, the gray levels times 1.25
less 40.5), ``page.icns`` (a 256 x 256 PNG icon, an RLE 16 x 16 icon and
its mask), ``page.blp`` (BLP2 DXT1 by this tool's own encoder, half
size), ``page.psd`` (PackBits RGB, half size), ``page.xpm`` (its
palette's colours, one character each), ``page.fits`` (8-bit gray),
``page.gbr`` (a version-2 gray brush), ``page.ftc`` (BC1), ``page.pxr``
(RGB), ``page.area`` (an 8-bit McIDAS area), ``page.imt``,
``page.xvt`` (the 3-3-2 thumbnail), ``page.flc`` (a 256-colour chunk and
a BRUN frame, half size), ``page.pcd`` (the page at 768 x 512 in PhotoYCC
by the usual coefficients; PIL's decode is its reference) and
``page.iptc`` (raw gray).

and six AVIF pages from a seventh generator (seed 42), read by both
routes (PIL's libavif 1.3.0, cv2's 1.4.2):
- ``avif_pil.avif``: Pillow's default encode of the full page (libaom's
  all-intra screen-content tools: palette, intra block copy, 128x128
  superblocks, 2x2 tiles);
- ``avif_cv2.avif``: cv2's default encode of the full page (quantizer
  matrices, delta q, deblocking, CDEF);
- ``avif_444_q100.avif``: 4:4:4 at quality 100 (lossless blocks, the WHT),
  a quarter of the page's size;
- ``avif_lowq_lr.avif``: quality 15, speed 0, loop restoration on and the
  screen tools off (heavy deblocking, switchable restoration units), a
  quarter size;
- ``avif_400_tiles.avif``: 4:0:0 in 2x2 tiles, a quarter size;
- ``avif_709_limited.avif``: 4:2:2 at quality 70, its ``colr`` rewritten
  by tools/avif_rewrite.py to BT.709 limited range, a quarter size.
``--avif`` remakes only these six and their ``digests.json`` entries.
Where a reference refuses a page, ``digests.json`` holds null for its
digest and the reason under ``refused`` (PIL's exception, or cv2's None or
one-channel array); a page PIL cannot open has a null ``size``.

The GPU machine has neither PIL nor cv2, so the files are made here and
committed. Run from the repo root:  python tools/make_pages.py
``--full-size DIR`` writes instead the twenty pages of seed 33 at the
page's full size into DIR (no digests), each held to PIL's decode, for
timing with ``tools/time_page_decodes.py --dir DIR``.
"""

import hashlib
import io
import json
import os
import struct
import sys

import cv2
import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))
from jpeg_arith import transcode  # noqa: E402
from jpeg_lossless import encode as lossless_jpeg  # noqa: E402
from make_jpeg_pages import LANDSCAPE, table_page  # noqa: E402
from webp_rewrite import rewrite as webp_rewrite  # noqa: E402
import avif_rewrite  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden", "pages")
SEED = 8  # the first seed whose pages table_page draws without an empty range
N_PAGES = 16
WEBP_SEED = 9  # the WebP pages' own generator: the pages above keep theirs
# the APNG, EXIF PNG, Lab TIFF, 12-bit JPEG, PFM and HDR pages: the first
# seed from 10 whose seven pages table_page draws
SLICE20_SEED = 13
J2K_SEED = 17  # the JPEG 2000 pages' own generator
PIL_ONLY_SEED = 25  # the pages only PIL reads: the first seed from 21 whose ten pages draw
A1420_SEED = 33  # the formats of A14.20: the first seed from 26 whose twenty pages draw
AVIF_SEED = 42  # the AVIF pages: the first seed from 41 whose six pages draw


def pil_bytes(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def cv2_jpeg(rgb, *params) -> bytes:
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(rgb[:, :, ::-1]), list(params))
    assert ok
    return enc.tobytes()


def rle8_bmp(rgb) -> bytes:
    """An 8-bit BI_RLE8 BMP of a page of at most 256 colours: encoded runs
    of 3 or more pixels, absolute runs (padded to 16 bits) between them, an
    end of line after each row and an end of bitmap after the last."""
    h, w = rgb.shape[:2]
    colours, index = np.unique(rgb.reshape(-1, 3), axis=0, return_inverse=True)
    assert len(colours) <= 256, f"{len(colours)} colours"
    index = index.reshape(h, w).astype(np.uint8)
    stream = bytearray()
    for r, row in enumerate(index[::-1]):
        row, x = row.tolist(), 0
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3:
                stream += bytes([run, row[x]])
                x += run
                continue
            end = x
            while end < w and end - x < 255 and not (
                    end + 2 < w and row[end] == row[end + 1] == row[end + 2]):
                end += 1
            if end - x < 3:
                stream += b"".join(bytes([1, v]) for v in row[x:end])
            else:
                stream += bytes([0, end - x]) + bytes(row[x:end]) + bytes((end - x) & 1)
            x = end
        stream += b"\x00\x01" if r == h - 1 else b"\x00\x00"
    palette = b"".join(bytes([b, g, r, 0]) for r, g, b in colours)
    offset = 14 + 40 + len(palette)
    info = np.array([40, w, h], "<i4").tobytes() + np.array([1, 8], "<u2").tobytes() \
        + np.array([1, len(stream), 2835, 2835, len(colours), 0], "<u4").tobytes()
    return (b"BM" + np.array([offset + len(stream)], "<u4").tobytes() + bytes(4)
            + np.array([offset], "<u4").tobytes() + info + palette + bytes(stream))


def rle_ras(rgb) -> bytes:
    """An 8-bit byte-encoded (type 2) Sun raster of a page of at most 256
    colours, its colormap as three planes: runs of 3 or more as 0x80 n v,
    a 0x80 byte as 0x80 0, rows of whole bytes as PIL decodes them."""
    h, w = rgb.shape[:2]
    colours, index = np.unique(rgb.reshape(-1, 3), axis=0, return_inverse=True)
    assert len(colours) <= 256, f"{len(colours)} colours"
    raw, out, i = index.astype(np.uint8).tobytes(), bytearray(), 0
    while i < len(raw):
        run = 1
        while i + run < len(raw) and run < 256 and raw[i + run] == raw[i]:
            run += 1
        if run >= 3:
            out += bytes([0x80, run - 1, raw[i]])
        elif raw[i] == 0x80:
            out += b"\x80\x00" * run
        else:
            out += raw[i:i + run]
        i += run
    cmap = colours.T.astype(np.uint8).tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, 8, len(out), 2, 1, len(cmap)) + cmap + bytes(out)


def webp_pages(pages) -> dict:
    """The six WebP pages, drawn from their own generator and appended to
    ``pages`` (page, boxes) in the order of the files returned."""
    rng = np.random.default_rng(WEBP_SEED)
    drawn = [table_page(rng, LANDSCAPE) for _ in range(6)]
    pages += drawn
    page = [Image.fromarray(p) for p, _ in drawn]
    jpeg75 = Image.open(io.BytesIO(pil_bytes(page[1], "JPEG", quality=75))).convert("RGB")
    h, w = LANDSCAPE
    yy, xx = np.mgrid[:h, :w]
    alpha = np.clip(255 - np.hypot(yy - h / 2, xx - w / 2) / 3, 64, 255).astype(np.uint8)
    alpha[:40] = 0
    rgba = page[3].convert("RGBA")
    rgba.putalpha(Image.fromarray(alpha))
    exif = Image.Exif()
    exif[0x0112] = 6
    return {
        "vp8l_palette.webp": pil_bytes(page[0], "WEBP", lossless=True),
        "vp8l_rgb.webp": pil_bytes(jpeg75, "WEBP", lossless=True),
        "vp8_q80.webp": pil_bytes(page[2], "WEBP"),
        "vp8x_alpha.webp": pil_bytes(rgba, "WEBP"),
        "vp8x_exif6.webp": pil_bytes(page[4], "WEBP", exif=exif),
        "vp8_simple4.webp": webp_rewrite(pil_bytes(page[5], "WEBP"), simple=1, partitions=4),
    }


def slice20_pages(pages) -> dict:
    """The six pages of PNG, TIFF, JPEG, PFM and HDR cases, drawn from their
    own generator and appended to ``pages`` in the order of the files
    returned."""
    rng = np.random.default_rng(SLICE20_SEED)
    drawn = [table_page(rng, LANDSCAPE) for _ in range(7)]
    drawn[5] = (np.ascontiguousarray(drawn[5][0][::2, ::2]),
                [[v // 2 for v in b] for b in drawn[5][1]])
    frame = drawn.pop(1)[0]  # the APNG's first frame (cv2's), not a page of its own
    pages += drawn
    page = [Image.fromarray(p) for p, _ in drawn]
    changed = frame.copy()
    changed[0, 0] = 255 - changed[0, 0]
    exif = Image.Exif()
    exif[0x0112] = 6
    gray = np.asarray(page[4].convert("L"), np.float32) + np.float32(0.25)
    ok, hdr = cv2.imencode(".hdr", drawn[5][0][:, :, ::-1].astype(np.float32) / 255)
    assert ok
    twelve = pil_bytes(page[3], "JPEG", quality=90)
    assert twelve.count(b"\xff\xc0\x00\x11\x08") == 1
    return {
        "apng_default.png": pil_bytes(page[0], "PNG", save_all=True, default_image=True,
                                      append_images=[Image.fromarray(frame),
                                                     Image.fromarray(changed)]),
        "exif6.png": pil_bytes(page[1], "PNG", exif=exif),
        "lab.tif": pil_bytes(page[2].convert("LAB"), "TIFF", compression="tiff_lzw"),
        "jpeg12.jpg": twelve.replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc1\x00\x11\x0c"),
        "gray.pfm": b"Pf\n%d %d\n-1.0\n" % gray.shape[::-1] + gray[::-1].astype("<f4").tobytes(),
        "page.hdr": hdr.tobytes(),
    }


def j2k_pages(pages) -> dict:
    """The four JPEG 2000 pages, drawn from their own generator and
    appended to ``pages`` in the order of the files returned."""
    rng = np.random.default_rng(J2K_SEED)
    drawn = [table_page(rng, LANDSCAPE) for _ in range(4)]
    drawn[3] = (np.ascontiguousarray(drawn[3][0][::2, ::2]),
                [[v // 2 for v in b] for b in drawn[3][1]])
    pages += drawn
    page = [Image.fromarray(p) for p, _ in drawn]
    ok, cv2_jp2 = cv2.imencode(".jp2", drawn[2][0][:, :, ::-1],
                               [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 250])
    assert ok
    gray16 = np.asarray(page[3].convert("L")).astype(np.uint16) * 257
    return {
        "j2k_97.jp2": pil_bytes(page[0], "JPEG2000", irreversible=True, quality_mode="rates",
                                quality_layers=[40, 20, 10]),
        "j2k_rpcl.j2k": pil_bytes(page[1], "JPEG2000", no_jp2=True, progression="RPCL",
                                  tile_size=(512, 512), precinct_size=(128, 128), plt=True),
        "j2k_cv2.jp2": cv2_jp2.tobytes(),
        "j2k_gray16.jp2": pil_bytes(Image.fromarray(gray16), "JPEG2000"),
    }


def sgi_rle16(rgb) -> bytes:
    """An RGB SGI file at 2 bytes a channel (each level times 257), each
    row of each channel run-length encoded (runs of 3 or more, literal
    spans between them, a 0 count to end the row), rows bottom up."""
    h, w = rgb.shape[:2]
    header = struct.pack(">HBBHHHH", 474, 1, 2, 3, w, h, 3).ljust(512, b"\0")
    rows = []
    for c in range(3):
        for row in rgb[::-1, :, c].astype(np.uint16) * 257:
            v, out, x = row.tolist(), bytearray(), 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and v[x + run] == v[x]:
                    run += 1
                if run >= 3:
                    out += struct.pack(">HH", run, v[x])
                    x += run
                    continue
                end = x
                while end < w and end - x < 127 and not (
                        end + 2 < w and v[end] == v[end + 1] == v[end + 2]):
                    end += 1
                out += struct.pack(f">H{end - x}H", 0x80 | (end - x), *v[x:end])
                x = end
            rows.append(bytes(out) + b"\0\0")
    base = 512 + 8 * len(rows)
    starts = np.cumsum([0] + [len(r) for r in rows[:-1]]) + base
    return (header + struct.pack(f">{len(rows)}I", *starts.tolist())
            + struct.pack(f">{len(rows)}I", *[len(r) for r in rows]) + b"".join(rows))


def _blocks4(rgb):
    """(N, 16, 3) int64 pixels of the 4 x 4 blocks, the page padded by
    repeating its last row and column."""
    h, w = rgb.shape[:2]
    full = np.pad(rgb, ((0, -h % 4), (0, -w % 4), (0, 0)), mode="edge").astype(np.int64)
    down, across = full.shape[0] // 4, full.shape[1] // 4
    return full.reshape(down, 4, across, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)


def _project(px, e0, e1, levels):
    """Each pixel's index on the segment e0 -> e1, 0 to levels - 1."""
    d = (e1 - e0)[:, None, :]
    den = np.maximum((d * d).sum(axis=2), 1)
    t = ((px - e0[:, None, :]) * d).sum(axis=2) / den
    return np.clip(np.rint(t * (levels - 1)), 0, levels - 1).astype(np.int64)


def _pack_bits(fields, n):
    """Blocks of 128 bits from (values (N,), width) fields, least
    significant bit first."""
    bits, pos = np.zeros((n, 128), np.uint8), 0
    for values, width in fields:
        for b in range(width):
            bits[:, pos] = (np.asarray(values) >> b) & 1
            pos += 1
    assert pos == 128
    return np.packbits(bits, axis=1, bitorder="little").tobytes()


def _anchor_first(index, levels):
    """Indices with pixel 0's below half the levels (its top bit is not
    stored), by swapping the endpoints where it is not; -> (indices,
    swapped)."""
    swap = index[:, 0] >= levels // 2
    return np.where(swap[:, None], levels - 1 - index, index), swap


def bc7_blocks(rgb) -> bytes:
    """BC7 mode 6 blocks: each block's RGB minimum and maximum as its
    endpoints (7 bits and a p-bit, opaque), 4-bit indices on the segment."""
    px = _blocks4(rgb)
    e0, e1 = px.min(axis=1), px.max(axis=1)
    index, swap = _anchor_first(_project(px, e0, e1, 16), 16)
    e0, e1 = np.where(swap[:, None], e1, e0), np.where(swap[:, None], e0, e1)
    n = len(px)
    fields = [(1 << 6, 7)]
    for c in range(3):
        fields += [(e0[:, c] >> 1, 7), (e1[:, c] >> 1, 7)]
    fields += [(np.full(n, 127), 7), (np.full(n, 127), 7)]
    fields += [(np.ones(n, np.int64), 1), (np.ones(n, np.int64), 1)]
    fields += [(index[:, 0], 3)] + [(index[:, i], 4) for i in range(1, 16)]
    return _pack_bits(fields, n)


def bc6h_blocks(rgb) -> bytes:
    """Unsigned BC6H mode 11 blocks (10-bit endpoints, 4-bit indices): each
    channel's minimum and maximum, each quantized to the 10-bit value whose
    8-bit decode is nearest."""
    q = np.arange(1024)
    unq = np.where(q == 1023, 0xFFFF, ((q << 16) + 0x8000) >> 10)
    unq[0] = 0
    half = (unq * 31 >> 6).astype(np.uint16).view(np.float16).astype(np.float32)
    level = (np.clip(half, 0, 1) * np.float32(255)).astype(np.int64)
    nearest = np.abs(level[None, :] - np.arange(256)[:, None]).argmin(axis=1)
    px = _blocks4(rgb)
    e0, e1 = px.min(axis=1), px.max(axis=1)
    index, swap = _anchor_first(_project(px, e0, e1, 16), 16)
    e0, e1 = np.where(swap[:, None], e1, e0), np.where(swap[:, None], e0, e1)
    n = len(px)
    fields = [(np.full(n, 3), 5)]
    fields += [(nearest[e0[:, c]], 10) for c in range(3)]
    fields += [(nearest[e1[:, c]], 10) for c in range(3)]
    fields += [(index[:, 0], 3)] + [(index[:, i], 4) for i in range(1, 16)]
    return _pack_bits(fields, n)


def dds_dx10(width: int, height: int, dxgi: int, blocks: bytes) -> bytes:
    """A DDS file of one surface: the header, a DX10 header, the blocks."""
    pf = struct.pack("<II4sI4I", 32, 4, b"DX10", 0, 0, 0, 0, 0)
    header = (struct.pack("<7I", 124, 0x81007, height, width, len(blocks), 0, 1) + bytes(44)
              + pf + struct.pack("<4I", 0x1000, 0, 0, 0) + bytes(4))
    return b"DDS " + header + struct.pack("<5I", dxgi, 3, 0, 1, 0) + blocks


def ico_two_frames(page: Image.Image, small: Image.Image) -> bytes:
    """An ICO of two frames: ``page`` as a PNG (entry 0 x 0, 256 x 256) and
    ``small`` as an 8-bit BMP (its DIB's height doubled, an AND mask)."""
    png = pil_bytes(page, "PNG")
    dib = bytearray(pil_bytes(small.quantize(256), "BMP")[14:])
    w, h = small.size
    dib[8:12] = struct.pack("<i", 2 * h)
    dib += bytes(-(-w // 32) * 4 * h)
    head = struct.pack("<HHH", 0, 1, 2)
    first = 6 + 32
    entries = struct.pack("<BBBBHHII", 0, 0, 0, 0, 1, 32, len(png), first)
    entries += struct.pack("<BBBBHHII", w, h, 0, 0, 1, 8, len(dib), first + len(png))
    return head + entries + png + bytes(dib)


def pil_only_pages(pages) -> dict:
    """The ten pages only PIL reads, drawn from their own generator and
    appended to ``pages`` in the order of the files returned."""
    rng = np.random.default_rng(PIL_ONLY_SEED)
    drawn = [table_page(rng, LANDSCAPE) for _ in range(10)]
    for k in (6, 7, 9):  # the DDS and IM pages at half size
        drawn[k] = (np.ascontiguousarray(drawn[k][0][::2, ::2]),
                    [[v // 2 for v in b] for b in drawn[k][1]])
    pages += drawn
    page = [Image.fromarray(p) for p, _ in drawn]
    gray = [np.asarray(page[k].convert("L")) for k in (0, 1)]
    floats = (gray[0].astype(np.float32) * np.float32(1.6) - np.float32(80.37))
    ints = gray[1].astype(np.int32) * 3 - 200
    h7, w7 = drawn[7][0].shape[:2]
    h6, w6 = drawn[6][0].shape[:2]
    return {
        "f32.tif": pil_bytes(Image.fromarray(floats), "TIFF", compression="tiff_lzw",
                             tiffinfo={317: 3}),
        "i32.tif": pil_bytes(Image.fromarray(ints), "TIFF", compression="tiff_adobe_deflate"),
        "page.tga": pil_bytes(page[2].quantize(256), "TGA", compression="tga_rle",
                              orientation=1),
        "page.pcx": pil_bytes(page[3].quantize(256), "PCX"),
        "page16.sgi": sgi_rle16(drawn[4][0]),
        "page.ico": ico_two_frames(page[5], page[5].resize((32, 32))),
        "bc7.dds": dds_dx10(w6, h6, 98, bc7_blocks(drawn[6][0])),
        "bc6h.dds": dds_dx10(w7, h7, 95, bc6h_blocks(drawn[7][0])),
        "page.qoi": pil_bytes(page[8], "QOI"),
        "page.im": pil_bytes(page[9].quantize(256), "IM"),
    }


def _dxt1_blocks(rgb) -> bytes:
    """DXT1 (BC1) blocks of the page: per block the brightest and darkest
    pixel as 5-6-5 endpoints, the first above the second (four colours),
    each pixel the nearest of the four by PIL's BLP decoder's rule."""
    px = _blocks4(rgb)
    luma = px @ np.array([3, 6, 1])
    hi = px[np.arange(len(px)), luma.argmax(1)]
    lo = px[np.arange(len(px)), luma.argmin(1)]

    def q(c):
        return (c[:, 0] >> 3) << 11 | (c[:, 1] >> 2) << 5 | (c[:, 2] >> 3)

    c0, c1 = q(hi), q(lo)
    swap = c0 < c1
    c0, c1 = np.where(swap, c1, c0), np.where(swap, c0, c1)
    c1 = np.where(c0 == c1, np.maximum(c1 - 1, 0), c1)
    c0 = np.where(c0 == c1, c0 + 1, c0)

    def rgb565(c):
        return np.stack([(c >> 11 & 31) << 3, (c >> 5 & 63) << 2, (c & 31) << 3], 1)

    a, b = rgb565(c0), rgb565(c1)
    table = np.stack([a, b, (2 * a + b) // 3, (2 * b + a) // 3], 1)
    index = ((px[:, :, None, :] - table[:, None, :, :]) ** 2).sum(3).argmin(2)
    bits = (index.astype(np.uint64) << (2 * np.arange(16, dtype=np.uint64))).sum(1)
    out = np.zeros((len(px), 8), np.uint8)
    out[:, 0:2] = np.stack([c0 & 255, c0 >> 8], 1)
    out[:, 2:4] = np.stack([c1 & 255, c1 >> 8], 1)
    out[:, 4:8] = bits.astype("<u4").view(np.uint8).reshape(-1, 4)
    return out.tobytes()


def _packbits(row) -> bytes:
    out, i, b = bytearray(), 0, bytes(row)
    while i < len(b):
        j = i
        while j < len(b) and j - i < 128 and b[j] == b[i]:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i), b[i]])
            i = j
            continue
        k = i + 1
        while k < len(b) and k - i < 128 and not (k + 1 < len(b) and b[k] == b[k + 1]):
            k += 1
        out += bytes([k - i - 1]) + b[i:k]
        i = k
    return bytes(out)


def _runs(row, literal):
    """Runs of a row for FLI BRUN and ICNS: (count, byte) repeats of 3 or
    more and literal spans up to ``literal`` long between them."""
    v, x, out = bytes(row), 0, []
    while x < len(v):
        n = 1
        while x + n < len(v) and v[x + n] == v[x] and n < 127:
            n += 1
        if n >= 3:
            out.append((n, v[x:x + 1]))
        else:
            n = 1
            while x + n < len(v) and n < literal and not (
                    x + n + 2 < len(v) and v[x + n] == v[x + n + 1] == v[x + n + 2]):
                n += 1
            out.append((-n, v[x:x + n]))
        x += n
    return out


def _icns_rle(band) -> bytes:
    out = bytearray()
    for n, v in _runs(band.ravel(), 128):
        while n >= 3 and n > 130:
            out += bytes([130 + 125]) + v
            n -= 130
        out += bytes([n + 125]) + v if n > 0 else bytes([-n - 1]) + v
    return bytes(out)


def _fli(index, palette) -> bytes:
    """An FLC of one frame: a 256-colour chunk and the BRUN-coded page."""
    h, w = index.shape
    body = bytearray()
    for row in index:
        body += b"\x01"
        for n, v in _runs(row, 127):
            body += bytes([n]) + v if n > 0 else bytes([256 + n]) + v

    def sub(kind, data):
        chunk = struct.pack("<IH", 6 + len(data), kind) + data
        return chunk + b"\0" * (len(chunk) % 2)

    subs = sub(4, struct.pack("<H", 1) + b"\0\0" + palette.tobytes()) + sub(15, bytes(body))
    frame = struct.pack("<IHH", 16 + len(subs), 0xF1FA, 2) + bytes(8) + subs
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(frame), 0xAF12, 1, w, h, 8, 0, 5)
    return bytes(head) + frame


def _pcd(rgb) -> bytes:
    """A Photo CD of the page at 768 x 512: PhotoYCC by the inverse of its
    usual coefficients (PIL's decode is the digest's reference)."""
    rgb = np.asarray(Image.fromarray(rgb).resize((768, 512), Image.Resampling.BILINEAR),
                     np.float64)
    lum = rgb @ np.array([0.299, 0.587, 0.114])
    y = np.clip(lum / 1.3584, 0, 255)
    cb = np.clip(156 + (rgb[:, :, 2] - lum) / 2.2179, 0, 255)
    cr = np.clip(137 + (rgb[:, :, 0] - lum) / 1.8215, 0, 255)
    y, cb, cr = (np.rint(v).astype(np.uint8) for v in (y, cb, cr))
    cb = cb.reshape(256, 2, 384, 2).mean((1, 3)).round().astype(np.uint8)
    cr = cr.reshape(256, 2, 384, 2).mean((1, 3)).round().astype(np.uint8)
    pairs = np.concatenate([y.reshape(256, 2 * 768), cb, cr], axis=1)
    data = bytearray(96 * 2048)
    data[2048:2052] = b"PCD_"
    return bytes(data) + pairs.tobytes()


def _iptc(gray) -> bytes:
    h, w = gray.shape

    def field(record, dataset, value):
        if len(value) < 32768:
            return bytes([0x1C, record, dataset]) + struct.pack(">H", len(value)) + value
        return bytes([0x1C, record, dataset, 0x84, 0]) + struct.pack(">I", len(value)) + value

    return (field(2, 0, b"\0\2") + field(3, 60, b"\1\0") + field(3, 20, struct.pack(">H", w))
            + field(3, 30, struct.pack(">H", h)) + field(3, 120, b"\1")
            + field(8, 10, gray.tobytes()))


def _fits(gray) -> bytes:
    def card(key, value=""):
        return (key.ljust(8).encode() + (b"= " + value.encode() if value else b"")).ljust(80)

    h, w = gray.shape
    head = b"".join([card("SIMPLE", "T"), card("BITPIX", "8"), card("NAXIS", "2"),
                     card("NAXIS1", str(w)), card("NAXIS2", str(h)), card("END")])
    head += b" " * (-len(head) % 2880)
    body = gray[::-1].tobytes()  # FITS rows run from the bottom
    return head + body + b"\0" * (-len(body) % 2880)


def _xpm(page: Image.Image) -> bytes:
    p = page.quantize(60)
    index = np.asarray(p)
    n = int(index.max()) + 1
    pal = np.asarray(p.getpalette()[:3 * n], np.uint8).reshape(-1, 3)
    keys = [bytes([48 + i]) for i in range(n)]
    h, w = index.shape
    lines = [b"/* XPM */", b"static char *page[] = {", b'"%d %d %d 1",' % (w, h, n)]
    lines += [b'"' + k + b' c #%02x%02x%02x",' % tuple(c) for k, c in zip(keys, pal)]
    lines += [b"/* pixels */"]
    lines += [b'"' + b"".join(keys[i] for i in row) + b'",' for row in index]
    return b"\n".join(lines) + b"\n};\n"


def _psd(rgb) -> bytes:
    h, w = rgb.shape[:2]
    rows = [_packbits(r) for c in range(3) for r in rgb[:, :, c]]
    return (b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, h, w, 8, 3) + bytes(12)
            + struct.pack(">H", 1) + b"".join(struct.pack(">H", len(r)) for r in rows)
            + b"".join(rows))


def _icns(page: Image.Image) -> bytes:
    big = pil_bytes(page.resize((256, 256), Image.Resampling.BILINEAR), "PNG")
    small = np.asarray(page.resize((16, 16), Image.Resampling.BILINEAR))
    rle = b"".join(_icns_rle(small[:, :, c]) for c in range(3))

    def element(kind, body):
        return kind + struct.pack(">I", 8 + len(body)) + body

    body = element(b"ic08", big) + element(b"is32", rle) + element(b"s8mk", b"\xff" * 256)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def _cur(page: Image.Image) -> bytes:
    dib = bytearray(pil_bytes(page.quantize(256), "BMP")[14:])
    w, h = page.size
    dib[8:12] = struct.pack("<i", 2 * h)
    dib += bytes(-(-w // 32) * 4 * h)
    return (struct.pack("<HHH", 0, 2, 1) + struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, 1,
                                                       len(dib), 22) + bytes(dib))


def _dcx(page: Image.Image) -> bytes:
    pcx = pil_bytes(page.quantize(256), "PCX")
    return struct.pack("<III", 987654321, 12, 0) + pcx


def a1420_pages(pages, full=False) -> dict:
    """The twenty pages of the formats only PIL reads that the port gained
    in slice 23, drawn from their own generator and appended to ``pages``
    in the order of the files returned: the golden files at a quarter of
    the page's size (DCX, BLP, PSD and FLI at half, MSP at full), or all
    at the page's full size (``full``); the ICNS page is a 256 x 256 icon
    and the Photo CD's base image is 768 x 512 at either scale."""
    rng = np.random.default_rng(A1420_SEED)
    drawn = [table_page(rng, LANDSCAPE) for _ in range(20)]
    scale = {k: 1 if full else 4 for k in range(20)}
    if not full:
        scale.update({2: 2, 3: 1, 7: 2, 8: 2, 17: 2, 18: 1})  # DCX, MSP, BLP, PSD, FLI, PCD
    for k, f in scale.items():
        if f > 1:
            drawn[k] = (np.ascontiguousarray(drawn[k][0][::f, ::f]),
                        [[v // f for v in b] for b in drawn[k][1]])
    h18, w18 = drawn[18][0].shape[:2]  # the Photo CD page: its boxes at 768 x 512
    drawn[18] = (drawn[18][0], [[b[0] * 768 // w18, b[1] * 512 // h18, b[2] * 768 // w18,
                                 b[3] * 512 // h18] for b in drawn[18][1]])
    pages += drawn
    page = [Image.fromarray(p) for p, _ in drawn]
    gray = [np.asarray(im.convert("L")) for im in page]

    def bilevel(k):
        return page[k].convert("L").point(lambda v: 255 if v > 160 else 0).convert("1")

    def words(k, values):
        h, w = gray[k].shape
        words = [0] * 64
        words[1], words[8], words[9], words[10], words[13], words[33] = 4, h, w, 1, 1, 256
        return struct.pack(">64i", *words) + values

    quantized = page[17].quantize(256)
    flc_palette = np.asarray(quantized.getpalette()[:768], np.uint8)
    flc_palette = np.pad(flc_palette, (0, 768 - len(flc_palette)))
    h13, w13 = gray[13].shape
    pixar = bytearray(1024)
    pixar[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<HH", pixar, 416, *drawn[13][0].shape[:2])
    struct.pack_into("<HH", pixar, 424, 14, 2)
    h7, w7 = drawn[7][0].shape[:2]
    blp_mip = _dxt1_blocks(drawn[7][0])
    blp = (b"BLP2" + struct.pack("<i", 1) + struct.pack("<bbbb", 2, 0, 0, 0)
           + struct.pack("<II", w7, h7) + struct.pack("<16I", 148 + 1024, *([0] * 15))
           + struct.pack("<16I", len(blp_mip), *([0] * 15)) + bytes(1024) + blp_mip)
    h12, w12 = drawn[12][0].shape[:2]
    bc1 = _dxt1_blocks(drawn[12][0])
    return {
        "page.dib": pil_bytes(page[0].quantize(256), "DIB"),
        "page.cur": _cur(page[1]),
        "page.dcx": _dcx(page[2]),
        "page.msp": pil_bytes(bilevel(3), "MSP"),
        "page.xbm": pil_bytes(bilevel(4), "XBM"),
        "page.spi": pil_bytes(Image.fromarray(gray[5].astype(np.float32) * np.float32(1.25)
                                              - np.float32(40.5)), "SPIDER"),
        "page.icns": _icns(page[6]),
        "page.blp": blp,
        "page.psd": _psd(drawn[8][0]),
        "page.xpm": _xpm(page[9]),
        "page.fits": _fits(gray[10]),
        "page.gbr": struct.pack(">5I", 28, 2, *gray[11].shape[::-1], 1) + b"GIMP"
        + struct.pack(">I", 10) + gray[11].tobytes(),
        "page.ftc": b"FTEX" + struct.pack("<5i", 0, w12, h12, 1, 1) + struct.pack("<2i", 0, 32)
        + struct.pack("<i", len(bc1)) + bc1,
        "page.pxr": bytes(pixar) + drawn[13][0].tobytes(),
        "page.area": words(14, gray[14].tobytes()),
        "page.imt": b"* a table page\nwidth %d\nheight %d\npixel n8\n\x0c" % gray[15].shape[::-1]
        + gray[15].tobytes(),
        "page.xvt": b"P7 332\n#XVVERSION:Version 2.28\n#END_OF_COMMENTS\n%d %d 255\n"
        % gray[16].shape[::-1] + (np.asarray(page[16])[:, :, 0] >> 5 << 5
                                   | np.asarray(page[16])[:, :, 1] >> 5 << 2
                                   | np.asarray(page[16])[:, :, 2] >> 6).astype(np.uint8).tobytes(),
        "page.flc": _fli(np.asarray(quantized), flc_palette),
        "page.pcd": _pcd(drawn[18][0]),
        "page.iptc": _iptc(gray[19]),
    }


def avif_pages(pages) -> dict:
    """The six AVIF pages, drawn from their own generator and appended to
    ``pages`` in the order of the files returned."""
    rng = np.random.default_rng(AVIF_SEED)
    drawn = [table_page(rng, LANDSCAPE) for _ in range(6)]
    for k in range(2, 6):
        drawn[k] = (np.ascontiguousarray(drawn[k][0][::2, ::2]),
                    [[v // 2 for v in b] for b in drawn[k][1]])
    pages += drawn
    page = [Image.fromarray(p) for p, _ in drawn]
    payload, props = avif_rewrite.items(pil_bytes(page[5], "AVIF", quality=70,
                                                  subsampling="4:2:2"))
    props[b"colr"] = avif_rewrite.nclx(1, 1, 1, False)
    return {
        "avif_pil.avif": pil_bytes(page[0], "AVIF"),
        "avif_cv2.avif": cv2.imencode(".avif", drawn[1][0][:, :, ::-1].copy())[1].tobytes(),
        "avif_444_q100.avif": pil_bytes(page[2], "AVIF", quality=100, subsampling="4:4:4"),
        "avif_lowq_lr.avif": pil_bytes(page[3], "AVIF", quality=15, speed=0, advanced={
            "enable-restoration": "1", "enable-intrabc": "0", "enable-palette": "0"}),
        "avif_400_tiles.avif": pil_bytes(page[4], "AVIF", subsampling="4:0:0", tile_rows=1,
                                         tile_cols=1),
        "avif_709_limited.avif": avif_rewrite.write(payload, props),
    }


def reference_decodes(data: bytes):
    """(PIL's RGB decode or None, cv2's BGR decode or None, the refusals)."""
    refused = {}
    try:
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except (OSError, ValueError) as e:
        pil, refused["pil"] = None, f"{type(e).__name__}: {e}"
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        refused["cv2"] = "cv2.imdecode returned None"
    elif bgr.ndim == 2:
        bgr, refused["cv2"] = None, "cv2.imdecode returned one channel, not a BGR page"
    return pil, bgr, refused


def page_digest(name: str, data: bytes, boxes) -> dict:
    """The ``digests.json`` entry of one page."""
    pil, bgr, refused = reference_decodes(data)
    assert len(refused) < 2 or name == "jpeg12.jpg", (name, refused)  # both refuse it
    decoded = bgr if bgr is not None else pil
    try:
        size = list(Image.open(io.BytesIO(data)).size)
    except OSError:  # PIL cannot open it: image_size raises
        size = None
    entry = {
        "bytes": len(data),
        "size": size,
        "cv2_shape": None if decoded is None else list(decoded.shape),
        "pil_rgb_sha256": None if pil is None else hashlib.sha256(pil.tobytes()).hexdigest(),
        "cv2_bgr_sha256": None if bgr is None else hashlib.sha256(bgr.tobytes()).hexdigest(),
        "routes_equal": None if refused else bool(np.array_equal(pil, bgr[:, :, ::-1])),
        "boxes": [[int(v) for v in b] for b in boxes],
    }
    if refused:
        entry["refused"] = refused
    print(name, len(data), "bytes", entry["size"], refused or (
        "routes equal" if entry["routes_equal"] else "routes differ"))
    return entry


def avif_only() -> None:
    """Remake the AVIF pages and their entries of ``digests.json`` alone."""
    path = os.path.join(OUT, "digests.json")
    with open(path) as f:
        digests = json.load(f)
    pages = []
    for (name, data), (_, boxes) in zip(avif_pages(pages).items(), pages):
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        digests[name] = page_digest(name, data, boxes)
    with open(path, "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")


def full_size_pages(out: str) -> None:
    """Write slice 23's twenty pages at the page's full size into ``out``
    (for tools/time_page_decodes.py ``--dir``; no digests), each checked to
    decode by the port's file route as PIL decodes it."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tdnet_torch.data.image import decode_image

    os.makedirs(out, exist_ok=True)
    for name, data in a1420_pages([], full=True).items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert np.array_equal(decode_image(data, route="pil"), pil), name
        print(name, len(data), "bytes", list(Image.open(io.BytesIO(data)).size))


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--full-size":
        full_size_pages(sys.argv[2])
        return
    if sys.argv[1:] == ["--avif"]:
        avif_only()
        return
    rng = np.random.default_rng(SEED)
    os.makedirs(OUT, exist_ok=True)
    pages = [table_page(rng, LANDSCAPE) for _ in range(N_PAGES)]
    pages[14] = (np.ascontiguousarray(pages[14][0][::2, ::2]),
                 [[v // 2 for v in b] for b in pages[14][1]])
    page = [Image.fromarray(p) for p, _ in pages]
    bilevel9 = page[9].convert("L").point(lambda v: 255 if v > 160 else 0).convert("1")
    bilevel = page[5].convert("L").point(lambda v: 255 if v > 160 else 0).convert("1")
    files = {
        "prog_pil.jpg": pil_bytes(page[0], "JPEG", quality=90, subsampling=2, progressive=True),
        "prog_cv2.jpg": cv2_jpeg(pages[1][0], cv2.IMWRITE_JPEG_QUALITY, 85,
                                 cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "cmyk.jpg": pil_bytes(page[2].convert("CMYK"), "JPEG", quality=85),
        "sub411.jpg": cv2_jpeg(pages[3][0], cv2.IMWRITE_JPEG_QUALITY, 90,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
        "rle8.bmp": rle8_bmp(pages[4][0]),
        "g4.tif": pil_bytes(bilevel, "TIFF", compression="group4"),
        "lzw_pred.tif": pil_bytes(page[6], "TIFF", compression="tiff_lzw",
                                  tiffinfo={317: 2}),
        "jpeg_ycc.tif": pil_bytes(page[7].convert("YCbCr"), "TIFF", compression="jpeg"),
        "ycc_lzw.tif": pil_bytes(page[8].convert("YCbCr"), "TIFF", compression="tiff_lzw"),
        "page.pbm": pil_bytes(bilevel9, "PPM"),
        "page.gif": pil_bytes(page[10].convert("P", palette=Image.Palette.ADAPTIVE), "GIF"),
        "arith_seq.jpg": transcode(pil_bytes(page[11], "JPEG", quality=75)),
        "arith_prog.jpg": transcode(pil_bytes(page[12], "JPEG", quality=75), progressive=True),
        "arith_big.jpg": transcode(pil_bytes(page[13], "JPEG", quality=90)),
        "lossless.jpg": lossless_jpeg(pages[14][0], 7, rgb=True),
        "rle.ras": rle_ras(pages[15][0]),
    }
    files.update(webp_pages(pages))
    files.update(slice20_pages(pages))
    files.update(j2k_pages(pages))
    files.update(pil_only_pages(pages))
    files.update(a1420_pages(pages))
    files.update(avif_pages(pages))
    digests = {}
    for (name, data), (_, boxes) in zip(files.items(), pages):
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        digests[name] = page_digest(name, data, boxes)
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")
    print("total", sum(d["bytes"] for d in digests.values()), "bytes")


if __name__ == "__main__":
    main()

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

Where a reference refuses a page, ``digests.json`` holds null for its
digest and the reason under ``refused`` (PIL's exception, or cv2's None or
one-channel array); a page PIL cannot open has a null ``size``.

The GPU machine has neither PIL nor cv2, so the files are made here and
committed. Run from the repo root:  python tools/make_pages.py
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

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden", "pages")
SEED = 8  # the first seed whose pages table_page draws without an empty range
N_PAGES = 16
WEBP_SEED = 9  # the WebP pages' own generator: the pages above keep theirs
# the APNG, EXIF PNG, Lab TIFF, 12-bit JPEG, PFM and HDR pages: the first
# seed from 10 whose seven pages table_page draws
SLICE20_SEED = 13
J2K_SEED = 17  # the JPEG 2000 pages' own generator


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


def main():
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
    digests = {}
    for (name, data), (_, boxes) in zip(files.items(), pages):
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        pil, bgr, refused = reference_decodes(data)
        assert len(refused) < 2 or name == "jpeg12.jpg", (name, refused)  # both refuse it
        decoded = bgr if bgr is not None else pil
        try:
            size = list(Image.open(io.BytesIO(data)).size)
        except OSError:  # PIL cannot open it: image_size raises
            size = None
        digests[name] = {
            "bytes": len(data),
            "size": size,
            "cv2_shape": None if decoded is None else list(decoded.shape),
            "pil_rgb_sha256": None if pil is None else hashlib.sha256(pil.tobytes()).hexdigest(),
            "cv2_bgr_sha256": None if bgr is None else hashlib.sha256(bgr.tobytes()).hexdigest(),
            "routes_equal": None if refused else bool(np.array_equal(pil, bgr[:, :, ::-1])),
            "boxes": [[int(v) for v in b] for b in boxes],
        }
        if refused:
            digests[name]["refused"] = refused
        print(name, len(data), "bytes", digests[name]["size"], refused or (
            "routes equal" if digests[name]["routes_equal"] else "routes differ"))
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")
    print("total", sum(d["bytes"] for d in digests.values()), "bytes")


if __name__ == "__main__":
    main()

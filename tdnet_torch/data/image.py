"""Host-side image reading and preprocessing in numpy, the counterpart of
``tdnet/data/image.py``.

:func:`read_image_bgr` decodes every format that PIL 12.1's ``Image.open``
reads and ``convert("RGB")`` converts, with the port's own decoders (zlib,
gzip and numpy), byte for byte as the reference's PIL does: PNG (APNG
too), JPEG, BMP and DIB, TIFF (``cielab.py`` for Lab), PNM (PFM too), GIF,
Sun raster, WebP (``vp8.py``, ``vp8l.py``), JPEG 2000 (``jp2.py`` with
``j2k.py``, ``j2k_t1.py`` and ``j2k_dwt.py``), AVIF (``avif.py`` with the
AV1 decoder of ``av1.py`` and ``yuv_rgb.py``), TGA, PCX and DCX, SGI, ICO,
CUR, DDS (``bcn.py``), QOI, IM, MSP, XBM, SPIDER, ICNS, BLP, PSD, XPM,
FITS, FLI, PCD (``photoycc.py``), IPTC and the small raw formats of
``raw_plugins.py`` (GBR, FTEX, PIXAR, McIDAS, IMT, XV thumbnails); it
also reads ``.npy`` arrays.
:func:`decode_image` also reads Radiance HDR (``hdr.py``) on the serve
route, as ``cv2.imdecode`` does. The format is told from the content, not
from the file's extension: on the file route in the order PIL's
``Image.open`` offers a file to its plugins (:data:`_PIL_ORDER`), so that
a file with no magic number (TGA, IM, SPIDER, IMT, IPTC, PCD) goes to the
reader PIL would give it, and one that a plugin the port does not read
would take, or one that PIL opens and cannot load (``data/plugins.py``),
is refused, naming the plugin; on the serve route by cv2's signatures,
where the formats only PIL reads are refused, each by name.

The GPU machine has neither cv2 nor PIL, so :func:`resize_image` is a numpy
bilinear resize that reproduces cv2's ``INTER_LINEAR`` (the reference's
``cv2.resize(img, None, fx=scale, fy=scale)``) bit for bit: output size
``round(side * scale)``, half-pixel centres ``src = (dst + 0.5) / scale -
0.5``, the horizontal pass first. cv2 takes two routes, and so does this
module: uint8 pages go through cv2's own 11-bit fixed-point path, float32
pages through IPP's (source positions in float64, each pass one fused
multiply-add ``a + (b - a) * t`` in float32).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from tdnet_torch.data import (avif, blp, bmp, cur, dds, fits, fli, gif, hdr, icns, ico, im, iptc,
                               jp2, jpeg, msp, pcd, pcx, plugins, png, pnm, psd, qoi, raw_plugins,
                               sgi, spider, sunras, tga, tiff, webp, xbm, xpm)

__all__ = [
    "CAFFE_MEAN_BGR",
    "READS",
    "decode_image",
    "read_image_bgr",
    "write_image_bgr",
    "image_size",
    "preprocess_image",
    "compute_resize_scale",
    "resize_image",
]

# caffe-mode BGR means (reference utils/image.py preprocess_image)
CAFFE_MEAN_BGR = np.array([103.939, 116.779, 123.68], dtype=np.float32)

# the formats only the file route reads
_PIL_ONLY = (tga, pcx, sgi, ico, dds, qoi, im)
_PIL_ONLY_READS = "; ".join([m.READS for m in _PIL_ONLY] + [
    bmp.DIB_READS, cur.READS, pcx.DCX_READS, msp.READS, xbm.READS, spider.READS, icns.READS,
    blp.READS, psd.READS, xpm.READS, fits.READS, raw_plugins.READS, fli.READS, pcd.READS,
    iptc.READS])
_BOTH = (png, jpeg, bmp, tiff, pnm, gif, sunras, webp, jp2, avif)
READS = "; ".join([m.READS for m in _BOTH] + [_PIL_ONLY_READS, hdr.READS])
# what each route reads, for its messages: files all but Radiance HDR, serve
# bodies all but the formats only PIL reads
_FILE_READS = "; ".join([m.READS for m in _BOTH] + [_PIL_ONLY_READS])
_SERVE_READS = "; ".join(m.READS for m in _BOTH + (hdr,))


def _raw(name: str):
    return name, raw_plugins.opens(name), raw_plugins.decode(name), raw_plugins.size(name)


# The readers in the order of PIL's Image.open, each (PIL's name for the
# format, takes the file, decode, size), with the plugins the port does not
# read that PIL tries between them (a group of data/plugins.py: (name,
# claims, failure) triples).
_PIL_ORDER = (
    ("BMP", lambda d: d.startswith(bmp.SIGNATURE), bmp.decode_bmp, bmp.bmp_size),
    ("DIB", bmp.is_dib, bmp.decode_dib, bmp.dib_size),
    ("GIF", lambda d: d.startswith(gif.SIGNATURES), gif.decode_gif, gif.gif_size),
    ("JPEG", lambda d: d.startswith(jpeg.SIGNATURE), jpeg.decode_jpeg, jpeg.jpeg_size),
    # PIL's PPM plugin takes P0-P6, Pf and Py: not PAM (P7) nor PF
    ("PPM", lambda d: d[:1] == b"P" and d[1:2] != b"" and d[1:2] in b"0123456fy", pnm.decode_pnm,
     pnm.pnm_size),
    ("PNG", lambda d: d.startswith(png.SIGNATURE), png.decode_png, png.png_size),
    ("AVIF", avif.is_avif, avif.decode_avif, avif.avif_size),
    ("BLP", blp.is_blp, blp.decode_blp, blp.blp_size),
    plugins.BUFR,
    ("CUR", cur.is_cur, cur.decode_cur, cur.cur_size),
    ("PCX", pcx.is_pcx, pcx.decode_pcx, pcx.pcx_size),
    ("DCX", pcx.is_dcx, pcx.decode_dcx, pcx.dcx_size),
    ("DDS", dds.is_dds, dds.decode_dds, dds.dds_size),
    plugins.EPS,
    ("FITS", fits.is_fits, fits.decode_fits, fits.fits_size),
    ("FLI", fli.is_fli, fli.decode_fli, fli.fli_size),
    _raw("FTEX"),
    _raw("GBR"),
    plugins.GRIB_HDF5,
    ("JPEG2000", jp2.is_jpeg2000, jp2.decode_jpeg2000, jp2.jpeg2000_size),
    ("ICNS", icns.is_icns, icns.decode_icns, icns.icns_size),
    ("ICO", ico.is_ico, ico.decode_ico, ico.ico_size),
    ("IM", im.is_im, im.decode_im, im.im_size),
    _raw("IMT"),
    ("IPTC", iptc.is_iptc, iptc.decode_iptc, iptc.iptc_size),
    _raw("MCIDAS"),
    plugins.MPEG,
    ("TIFF", lambda d: d.startswith(tiff.SIGNATURES), tiff.decode_tiff, tiff.tiff_size),
    ("MSP", msp.is_msp, msp.decode_msp, msp.msp_size),
    ("PCD", pcd.is_pcd, pcd.decode_pcd, pcd.pcd_size),
    _raw("PIXAR"),
    ("PSD", psd.is_psd, psd.decode_psd, psd.psd_size),
    ("QOI", qoi.is_qoi, qoi.decode_qoi, qoi.qoi_size),
    ("SGI", sgi.is_sgi, sgi.decode_sgi, sgi.sgi_size),
    ("SPIDER", spider.is_spider, spider.decode_spider, spider.spider_size),
    ("SUN", lambda d: d.startswith(sunras.SIGNATURE), sunras.decode_sunras, sunras.sunras_size),
    ("TGA", tga.is_tga, tga.decode_tga, tga.tga_size),
    ("WEBP", webp.is_webp, webp.decode_webp, webp.webp_size),
    plugins.WMF,
    ("XBM", xbm.is_xbm, xbm.decode_xbm, xbm.xbm_size),
    ("XPM", xpm.is_xpm, xpm.decode_xpm, xpm.xpm_size),
    _raw("XVTHUMB"),
)


def pil_plugin(data: bytes):
    """(name, reader, failure) of the plugin that PIL's ``Image.open``
    hands ``data`` to: reader is the port's (decode, size), None for a
    plugin that PIL opens the file by and cannot load it with, whose
    failure is PIL's own error; None where no plugin takes the file."""
    for entry in _PIL_ORDER:
        if isinstance(entry[0], tuple):
            found = plugins.foreign(data, entry)
            if found is not None:
                return found[0], None, found[1]
        elif entry[1](data):
            return entry[0], entry[2:], None
    return None


def _pil_reader(data: bytes):
    """(decode, size) of the port's reader that PIL's ``Image.open`` hands
    ``data`` to, or None where no plugin takes it; ValueError where a
    plugin that PIL opens but cannot load would."""
    found = pil_plugin(data)
    if found is None or found[1] is not None:
        return found and found[1]
    name, _, failure = found
    raise ValueError(f"PIL opens this file by its {name} plugin and then cannot load it "
                     f"({failure}); the port reads {_FILE_READS}")


def decode_image(data: bytes, route: str = "pil") -> np.ndarray:
    """Image bytes of any format of :data:`READS` -> (H, W, 3) uint8 RGB by
    the rule of ``route``: ``"pil"`` (files: PIL's ``convert("RGB")``, the
    format found in PIL's plugin order) or ``"cv2"`` (serve bodies:
    ``cv2.imdecode(..., IMREAD_COLOR)``, which turns a JPEG, PNG or WebP by
    its EXIF orientation, reads Radiance HDR, and refuses the formats only
    PIL reads; both turn a TIFF by its ``Orientation``). A file
    that the route's reference refuses raises, naming the case."""
    if route == "pil":
        reader = _pil_reader(data)
        if reader is not None:
            return reader[0](data, route=route)
        if hdr.is_hdr(data):
            return hdr.decode_hdr(data, route=route)
        raise ValueError(f"unsupported image format: PIL cannot identify it; the file route "
                         f"reads {_FILE_READS}")
    if data.startswith(png.SIGNATURE):
        return png.decode_png(data, route=route)
    if data.startswith(jpeg.SIGNATURE):
        return jpeg.decode_jpeg(data, route=route)
    if data.startswith(bmp.SIGNATURE):
        return bmp.decode_bmp(data, route=route)
    if data.startswith(tiff.SIGNATURES):
        return tiff.decode_tiff(data, route=route)
    if data[:2] in pnm.SIGNATURES:
        return pnm.decode_pnm(data, route=route)
    if data.startswith(gif.SIGNATURES):
        return gif.decode_gif(data, route=route)
    if data.startswith(sunras.SIGNATURE):
        return sunras.decode_sunras(data, route=route)
    if webp.is_webp(data) or (route == "cv2" and webp.is_bare_bitstream(data)):
        return webp.decode_webp(data, route=route)
    if jp2.is_jpeg2000(data):
        return jp2.decode_jpeg2000(data, route=route)
    if avif.is_avif_body(data):
        return avif.decode_avif(data, route=route)
    if hdr.is_hdr(data):
        return hdr.decode_hdr(data, route=route)
    if route == "cv2":  # what only PIL reads: its reader refuses it by name
        try:
            reader = _pil_reader(data)
        except ValueError:
            reader = None
        if reader is not None:
            return reader[0](data, route=route)
    raise ValueError(f"unsupported image format: cv2 cannot decode it; the serve route reads "
                     f"{_SERVE_READS}")


def read_image_bgr(path) -> np.ndarray:
    """An image file -> (H, W, 3) float32 BGR: any format of :data:`READS`
    (decoded as PIL's ``convert("RGB")``, then the channels flipped) or a
    ``.npy`` array that is already (H, W, 3) BGR."""
    path = os.fspath(path)
    if path.endswith(".npy"):
        image = np.load(path, allow_pickle=False)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"{path}: a .npy image must be (H, W, 3) BGR, "
                             f"got {image.shape}")
        return np.asarray(image, np.float32)
    with open(path, "rb") as f:
        data = f.read()
    try:
        rgb = decode_image(data, route="pil")
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return rgb[:, :, ::-1].astype(np.float32)


def write_image_bgr(path, image_bgr: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 BGR image as PNG."""
    with open(path, "wb") as f:
        f.write(png.encode_png(np.ascontiguousarray(image_bgr[:, :, ::-1])))


def image_size(path):
    """(width, height) of any format of :data:`READS` (from its headers,
    without decoding pixels, as PIL's ``.size``: a JPEG's EXIF orientation
    is not applied, a TIFF's ``Orientation`` is, a GIF's screen grows to
    hold its first frame, a WebP's is its canvas, an ICO's is its largest
    frame's) or of a ``.npy`` image."""
    path = os.fspath(path)
    if path.endswith(".npy"):
        h, w = np.load(path, mmap_mode="r", allow_pickle=False).shape[:2]
        return w, h
    with open(path, "rb") as f:
        data = f.read()
    try:
        reader = _pil_reader(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if reader is not None:
        return reader[1](data)
    if hdr.is_hdr(data):
        raise ValueError(f"{path}: Radiance HDR: PIL cannot identify it")
    raise ValueError(f"{path}: unsupported image format: PIL cannot identify it; the file "
                     f"route reads {_FILE_READS}")


def preprocess_image(x: np.ndarray, mode: str = "caffe") -> np.ndarray:
    """Normalize a BGR image to float32: 'caffe' subtracts the BGR means,
    'tf' maps [0, 255] to [-1, 1]."""
    x = np.asarray(x, np.float32)
    if mode == "caffe":
        return x - CAFFE_MEAN_BGR
    if mode == "tf":
        return (x / np.float32(127.5)) - np.float32(1.0)
    raise ValueError(f"unknown preprocessing mode {mode!r}")


def compute_resize_scale(image_shape: Tuple[int, ...], min_side: int = 800,
                         max_side: int = 1333) -> float:
    """Aspect-preserving scale: min side -> min_side, capped so the max side
    stays within max_side."""
    rows, cols = image_shape[:2]
    scale = min_side / min(rows, cols)
    largest_side = max(rows, cols)
    if largest_side * scale > max_side:
        scale = max_side / largest_side
    return scale


def _source_positions(n_dst: int, scale: float) -> np.ndarray:
    """Source coordinate of each output position along one axis, float64."""
    return (np.arange(n_dst, dtype=np.float64) + 0.5) * (1.0 / scale) - 0.5


def _fixed_taps(n_src: int, n_dst: int, scale: float, clamp: bool):
    """cv2's uint8 INTER_LINEAR taps along one axis: int32 source indices
    (lo, hi) and 11-bit weights (c0, c1), each weight rounded on its own
    from the float32 position. With ``clamp`` (the x axis) a position
    outside [0, n_src - 1] takes the edge pixel whole; without it (the y
    axis) only the indices are clipped and the weights stay as computed."""
    pos = _source_positions(n_dst, scale).astype(np.float32)
    lo = np.floor(pos)
    frac = pos - lo
    lo = lo.astype(np.int32)
    if clamp:
        below = lo < 0
        lo[below], frac[below] = 0, 0.0
        above = lo >= n_src - 1
        lo[above], frac[above] = n_src - 1, 0.0
    one = np.float32(2048.0)
    c0 = np.rint((np.float32(1.0) - frac) * one).astype(np.int32)
    c1 = np.rint(frac * one).astype(np.int32)
    return (np.clip(lo, 0, n_src - 1), np.clip(lo + 1, 0, n_src - 1), c0, c1)


def _float_taps(n_src: int, n_dst: int, scale: float):
    """IPP's float INTER_LINEAR taps along one axis: source indices (lo, hi)
    and the float32 weight t of hi, from float64 positions. Before the
    first pixel t is 0 on pixel 0; past the last, IPP blends pixels n-2 and
    n-1 with t = 1 (which rounds b - a + a, so it is not always b)."""
    pos = _source_positions(n_dst, scale)
    lo = np.floor(pos)
    t = pos - lo
    lo = lo.astype(np.intp)
    below = lo < 0
    lo[below], t[below] = 0, 0.0
    above = lo >= n_src - 1
    lo[above], t[above] = max(n_src - 2, 0), (1.0 if n_src > 1 else 0.0)
    return lo, np.minimum(lo + 1, n_src - 1), t.astype(np.float32)


def _lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """float32 fma(b - a, t, a): the product of two float32 values is exact
    in float64, so one rounding of the float64 sum to float32 gives it."""
    d = np.subtract(b, a).astype(np.float64)
    d *= t
    d += a
    return d.astype(np.float32)


_CHUNK_ROWS = 16  # output rows a step: the step's arrays stay in the cache


def _row_chunks(y0: np.ndarray, y1: np.ndarray, out_h: int):
    """(first, end) output rows of each step and (lo, hi) the source rows
    its vertical pass reads."""
    for r0 in range(0, out_h, _CHUNK_ROWS):
        r1 = min(out_h, r0 + _CHUNK_ROWS)
        yield r0, r1, int(y0[r0:r1].min()), int(y1[r0:r1].max()) + 1


def _columns(px: np.ndarray, cols: np.ndarray, dtype, tail) -> np.ndarray:
    """Gather whole pixels (one void element each) of rows px at cols, back
    as (rows, len(cols)) + tail of dtype."""
    g = np.ascontiguousarray(px[:, cols])
    return g.view(dtype).reshape(g.shape + tail)


def _resize(img: np.ndarray, out_h: int, out_w: int, scale: float):
    h, w = img.shape[:2]
    tail = img.shape[2:]
    src = np.ascontiguousarray(img)
    item = src.dtype.itemsize * int(np.prod(tail, dtype=np.int64))
    px = src.reshape(h, w, -1).view(np.dtype((np.void, item))).reshape(h, w)
    ones = (1,) * len(tail)
    if src.dtype == np.uint8:
        x0, x1, a0, a1 = _fixed_taps(w, out_w, scale, clamp=True)
        y0, y1, b0, b1 = _fixed_taps(h, out_h, scale, clamp=False)
        a0, a1 = a0.reshape((1, out_w) + ones), a1.reshape((1, out_w) + ones)
        b0, b1 = b0.reshape((out_h, 1) + ones), b1.reshape((out_h, 1) + ones)
        out = np.empty((out_h, out_w) + tail, np.uint8)
        for r0, r1, lo, hi in _row_chunks(y0, y1, out_h):
            rows = px[lo:hi]
            # horizontal pass: 22-bit sums, kept at 18 bits for the vertical
            hor = (_columns(rows, x0, np.uint8, tail).astype(np.int32) * a0
                   + _columns(rows, x1, np.uint8, tail).astype(np.int32) * a1) >> 4
            v = (((hor[y0[r0:r1] - lo] * b0[r0:r1]) >> 16)
                 + ((hor[y1[r0:r1] - lo] * b1[r0:r1]) >> 16) + 2) >> 2
            out[r0:r1] = v
        return out
    x0, x1, tx = _float_taps(w, out_w, scale)
    y0, y1, ty = _float_taps(h, out_h, scale)
    tx = tx.astype(np.float64).reshape((1, out_w) + ones)
    ty = ty.astype(np.float64).reshape((out_h, 1) + ones)
    out = np.empty((out_h, out_w) + tail, np.float32)
    for r0, r1, lo, hi in _row_chunks(y0, y1, out_h):
        rows = px[lo:hi]
        hor = _lerp(_columns(rows, x0, src.dtype, tail).astype(np.float32),
                    _columns(rows, x1, src.dtype, tail).astype(np.float32), tx)
        out[r0:r1] = _lerp(hor[y0[r0:r1] - lo], hor[y1[r0:r1] - lo], ty[r0:r1])
    return out


def resize_image(img: np.ndarray, min_side: int = 800, max_side: int = 1333):
    """Resize an (H, W, C) image so its min side is min_side (capped by
    max_side). Returns (image, scale): a uint8 image for uint8 input, else
    float32, equal to the reference's cv2 resize bit for bit; a scale of 1.0
    returns the input unchanged. Each step resizes 16 output rows from the
    source rows they read, gathering whole pixels."""
    scale = compute_resize_scale(img.shape, min_side=min_side, max_side=max_side)
    if scale == 1.0:
        return img, 1.0
    h, w = img.shape[:2]
    out_h, out_w = int(np.rint(h * scale)), int(np.rint(w * scale))
    return _resize(img, out_h, out_w, scale), scale

"""Write JPEG 2000 test fixtures that neither PIL's nor cv2's writer makes,
through ctypes into the libopenjp2 that Pillow bundles (``pillow.libs/
libopenjp2-*.so*``, found beside the ``PIL`` package), and by editing the
boxes of a JP2 file by hand.

:func:`encode` takes (H, W) or (H, W, C) samples and the encoder's
parameters: code-block styles (``mode``: BYPASS 1, RESET 2, TERMALL 4,
VSC 8, PTERM 16, SEGSYM 32), progression order changes (``pocs``), SOP and
EPH markers (``csty`` 2 and 4), tile-parts (``tile_parts``: "R", "L" or
"C"), an ROI shift, component subsampling and offsets, signed samples
and any precision from 1 to 16 bits. :func:`jp2` wraps a codestream in a
JP2 file of the boxes given (``ihdr``, ``colr``, ``pclr``, ``cmap``,
``cdef``, ``res ``), so a test can build what the encoder's own JP2
writer does not: palettes, channel definitions, sYCC, CMYK and ICC.

It needs Pillow's libopenjp2 and runs where PIL is installed (the CPU
tests), never where the port runs. Every fixture is checked against PIL
and cv2 by the tests that use it.
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct
import tempfile
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = ["encode", "jp2", "box", "library"]

_MAXRLVLS, _PATH_LEN, _JPWL_TILES, _JPWL_PACKS = 33, 4096, 16, 16
_PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


class _Poc(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_uint32) for n in ("resno0", "compno0", "layno1", "resno1",
                                                  "compno1", "layno0", "precno0", "precno1")]
                + [("prg1", ctypes.c_int), ("prg", ctypes.c_int),
                   ("progorder", ctypes.c_char * 5), ("tile", ctypes.c_uint32)]
                + [(n, ctypes.c_int32) for n in ("tx0", "tx1", "ty0", "ty1")]
                + [(n, ctypes.c_uint32) for n in (
                    "layS", "resS", "compS", "prcS", "layE", "resE", "compE", "prcE", "txS",
                    "txE", "tyS", "tyE", "dx", "dy", "lay_t", "res_t", "comp_t", "prc_t",
                    "tx0_t", "ty0_t")])


class _Params(ctypes.Structure):
    """``opj_cparameters_t`` of OpenJPEG 2.5."""
    _fields_ = [
        ("tile_size_on", ctypes.c_int), ("cp_tx0", ctypes.c_int), ("cp_ty0", ctypes.c_int),
        ("cp_tdx", ctypes.c_int), ("cp_tdy", ctypes.c_int), ("cp_disto_alloc", ctypes.c_int),
        ("cp_fixed_alloc", ctypes.c_int), ("cp_fixed_quality", ctypes.c_int),
        ("cp_matrice", ctypes.c_void_p), ("cp_comment", ctypes.c_char_p),
        ("csty", ctypes.c_int), ("prog_order", ctypes.c_int), ("POC", _Poc * 32),
        ("numpocs", ctypes.c_uint32), ("tcp_numlayers", ctypes.c_int),
        ("tcp_rates", ctypes.c_float * 100), ("tcp_distoratio", ctypes.c_float * 100),
        ("numresolution", ctypes.c_int), ("cblockw_init", ctypes.c_int),
        ("cblockh_init", ctypes.c_int), ("mode", ctypes.c_int),
        ("irreversible", ctypes.c_int), ("roi_compno", ctypes.c_int),
        ("roi_shift", ctypes.c_int), ("res_spec", ctypes.c_int),
        ("prcw_init", ctypes.c_int * _MAXRLVLS), ("prch_init", ctypes.c_int * _MAXRLVLS),
        ("infile", ctypes.c_char * _PATH_LEN), ("outfile", ctypes.c_char * _PATH_LEN),
        ("index_on", ctypes.c_int), ("index", ctypes.c_char * _PATH_LEN),
        ("image_offset_x0", ctypes.c_int), ("image_offset_y0", ctypes.c_int),
        ("subsampling_dx", ctypes.c_int), ("subsampling_dy", ctypes.c_int),
        ("decod_format", ctypes.c_int), ("cod_format", ctypes.c_int),
        ("jpwl_epc_on", ctypes.c_int), ("jpwl_hprot_MH", ctypes.c_int),
        ("jpwl_hprot_TPH_tileno", ctypes.c_int * _JPWL_TILES),
        ("jpwl_hprot_TPH", ctypes.c_int * _JPWL_TILES),
        ("jpwl_pprot_tileno", ctypes.c_int * _JPWL_PACKS),
        ("jpwl_pprot_packno", ctypes.c_int * _JPWL_PACKS),
        ("jpwl_pprot", ctypes.c_int * _JPWL_PACKS), ("jpwl_sens_size", ctypes.c_int),
        ("jpwl_sens_addr", ctypes.c_int), ("jpwl_sens_range", ctypes.c_int),
        ("jpwl_sens_MH", ctypes.c_int), ("jpwl_sens_TPH_tileno", ctypes.c_int * _JPWL_TILES),
        ("jpwl_sens_TPH", ctypes.c_int * _JPWL_TILES), ("cp_cinema", ctypes.c_int),
        ("max_comp_size", ctypes.c_int), ("cp_rsiz", ctypes.c_int), ("tp_on", ctypes.c_char),
        ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char), ("jpip_on", ctypes.c_int),
        ("mct_data", ctypes.c_void_p), ("max_cs_size", ctypes.c_int),
        ("rsiz", ctypes.c_uint16)]


class _CompParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec",
                                               "bpp", "sgnd")]


class _Comp(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec",
                                                "bpp", "sgnd", "resno_decoded", "factor")]
                + [("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)])


class _Image(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_uint32) for n in ("x0", "y0", "x1", "y1", "numcomps")]
                + [("color_space", ctypes.c_int), ("comps", ctypes.POINTER(_Comp)),
                   ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", ctypes.c_uint32)])


_LIB = None


def library() -> ctypes.CDLL:
    """Pillow's bundled libopenjp2, with the prototypes this module calls."""
    global _LIB
    if _LIB is None:
        import PIL

        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        found = sorted(glob.glob(os.path.join(libs, "libopenjp2*.so*")))
        if not found:
            raise RuntimeError(f"no libopenjp2 in {libs}")
        lib = ctypes.CDLL(found[-1])
        vp = ctypes.c_void_p
        lib.opj_create_compress.restype = vp
        lib.opj_image_create.restype = ctypes.POINTER(_Image)
        lib.opj_image_create.argtypes = [ctypes.c_uint32, ctypes.POINTER(_CompParm), ctypes.c_int]
        lib.opj_set_default_encoder_parameters.argtypes = [ctypes.POINTER(_Params)]
        lib.opj_setup_encoder.argtypes = [vp, ctypes.POINTER(_Params), ctypes.POINTER(_Image)]
        lib.opj_stream_create_default_file_stream.restype = vp
        lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.opj_start_compress.argtypes = [vp, ctypes.POINTER(_Image), vp]
        lib.opj_encode.argtypes = [vp, vp]
        lib.opj_end_compress.argtypes = [vp, vp]
        lib.opj_stream_destroy.argtypes = [vp]
        lib.opj_destroy_codec.argtypes = [vp]
        lib.opj_encoder_set_extra_options.argtypes = [vp, ctypes.POINTER(ctypes.c_char_p)]
        lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]
        p = _Params()
        lib.opj_set_default_encoder_parameters(ctypes.byref(p))
        if (p.numresolution, p.cblockw_init, p.roi_compno, p.subsampling_dx,
                p.decod_format) != (6, 64, -1, 1, -1):
            raise RuntimeError("opj_cparameters_t does not match this libopenjp2")
        _LIB = lib
    return _LIB


def encode(samples: np.ndarray, *, prec=8, signed: bool = False,
           subsampling: Optional[Sequence[Tuple[int, int]]] = None,
           offset: Tuple[int, int] = (0, 0), color_space: int = 0, levels: int = 5,
           irreversible: bool = False, mct: Optional[int] = None,
           rates: Sequence[float] = (), layers: int = 1, mode: int = 0,
           csty: int = 0, progression: str = "LRCP",
           pocs: Iterable[Tuple[int, int, int, int, int, str]] = (),
           tile: Optional[Tuple[int, int]] = None, tile_offset: Tuple[int, int] = (0, 0),
           tile_parts: Optional[str] = None, precincts: Sequence[Tuple[int, int]] = (),
           codeblock: Tuple[int, int] = (64, 64), roi: Optional[Tuple[int, int]] = None,
           tlm: bool = False, jp2_file: bool = False) -> bytes:
    """A codestream (or, with ``jp2_file``, OpenJPEG's own JP2 file) of
    ``samples``: (H, W) or (H, W, C), each component at ``prec`` bits (or
    a precision a component);
    ``subsampling`` (dx, dy) per component takes every dx-th sample of the
    component from the image origin; ``offset`` is (XOsiz, YOsiz); ``pocs``
    are (RSpoc, CSpoc, LYEpoc, REpoc, CEpoc, order); ``roi`` is (component,
    shift); ``rates`` the layers' compression ratios (empty: ``layers``
    lossless layers)."""
    lib = library()
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, n = samples.shape
    x0, y0 = offset
    sub = list(subsampling or [(1, 1)] * n)
    parms = (_CompParm * n)()
    for i, (dx, dy) in enumerate(sub):
        parms[i].dx, parms[i].dy = dx, dy
        parms[i].x0, parms[i].y0 = -(-x0 // dx), -(-y0 // dy)
        parms[i].w = -(-(x0 + w) // dx) - parms[i].x0
        parms[i].h = -(-(y0 + h) // dy) - parms[i].y0
        parms[i].prec = prec[i] if isinstance(prec, (list, tuple)) else prec
        parms[i].sgnd = int(signed)
    image = lib.opj_image_create(n, parms, color_space)
    im = image.contents
    im.x0, im.y0, im.x1, im.y1 = x0, y0, x0 + w, y0 + h
    for i, (dx, dy) in enumerate(sub):
        comp = im.comps[i]
        gx = np.arange(comp.x0, comp.x0 + comp.w) * dx - x0
        gy = np.arange(comp.y0, comp.y0 + comp.h) * dy - y0
        # a C-ordered copy held in a name while the library copies it
        plane = np.ascontiguousarray(
            samples[np.clip(gy, 0, h - 1)][:, np.clip(gx, 0, w - 1), i], np.int32)
        ctypes.memmove(comp.data, plane.ctypes.data, plane.nbytes)
    p = _Params()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    p.numresolution = levels + 1
    p.irreversible = int(irreversible)
    p.tcp_mct = bytes([int(n >= 3 if mct is None else mct)])
    if rates:
        p.tcp_numlayers = len(rates)
        for i, r in enumerate(rates):
            p.tcp_rates[i] = r
        p.cp_disto_alloc = 1
    else:
        p.tcp_numlayers = layers
        for i in range(layers):
            p.tcp_rates[i] = 0
        p.cp_disto_alloc = 1
    p.mode, p.csty = mode, csty
    p.prog_order = _PROGRESSIONS[progression]
    p.cblockw_init, p.cblockh_init = codeblock
    if precincts:
        p.res_spec = len(precincts)
        for i, (pw, ph) in enumerate(precincts):
            p.prcw_init[i], p.prch_init[i] = pw, ph
        p.csty |= 1
    if tile:
        p.tile_size_on = 1
        p.cp_tdx, p.cp_tdy = tile
        p.cp_tx0, p.cp_ty0 = tile_offset
    if tile_parts:
        p.tp_on, p.tp_flag = b"\x01", tile_parts.encode()
    if roi:
        p.roi_compno, p.roi_shift = roi
    pocs = list(pocs)
    for i, (rs, cs, ly, re, ce, order) in enumerate(pocs):
        poc = p.POC[i]
        poc.tile = 1
        poc.resno0, poc.compno0, poc.layno1, poc.resno1, poc.compno1 = rs, cs, ly, re, ce
        poc.prg1 = _PROGRESSIONS[order]
    p.numpocs = len(pocs)
    codec = lib.opj_create_compress(2 if jp2_file else 0)
    fd, path = tempfile.mkstemp(suffix=".jp2" if jp2_file else ".j2k")
    os.close(fd)
    try:
        if not lib.opj_setup_encoder(codec, ctypes.byref(p), image):
            raise ValueError("opj_setup_encoder refused the parameters")
        if tlm:
            options = (ctypes.c_char_p * 2)(b"TLM=YES", None)
            if not lib.opj_encoder_set_extra_options(codec, options):
                raise ValueError("opj_encoder_set_extra_options refused TLM")
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
              and lib.opj_end_compress(codec, stream))
        lib.opj_stream_destroy(stream)
        if not ok:
            raise ValueError("OpenJPEG failed to encode")
        with open(path, "rb") as f:
            return f.read()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
        os.unlink(path)


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def ihdr(h: int, w: int, nc: int, bpc: int) -> bytes:
    return box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))


def colr(enumcs: Optional[int] = None, icc: Optional[bytes] = None) -> bytes:
    if icc is not None:
        return box(b"colr", bytes([2, 0, 0]) + icc)
    return box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", enumcs))


def pclr(entries: np.ndarray, depth: int = 8) -> bytes:
    """A palette of (N, C) entries at ``depth`` bits each."""
    entries = np.asarray(entries)
    n, c = entries.shape
    size = (depth + 7) // 8
    body = struct.pack(">HB", n, c) + bytes([depth - 1]) * c
    for row in entries:
        for v in row:
            body += int(v).to_bytes(size, "big")
    return box(b"pclr", body)


def cmap(entries: Sequence[Tuple[int, int, int]]) -> bytes:
    """(component, type 0 direct or 1 palette, palette column) per channel."""
    return box(b"cmap", b"".join(struct.pack(">HBB", *e) for e in entries))


def cdef(entries: Sequence[Tuple[int, int, int]]) -> bytes:
    """(channel, type, association) per channel."""
    return box(b"cdef", struct.pack(">H", len(entries))
               + b"".join(struct.pack(">HHH", *e) for e in entries))


def jp2(codestream: bytes, header: Sequence[bytes], brand: bytes = b"jp2 ") -> bytes:
    """A JP2 file: the signature, ``ftyp`` of ``brand``, a ``jp2h`` of the
    boxes given (``ihdr`` first, as the format wants) and the codestream
    in ``jp2c``."""
    sig = box(b"jP  ", b"\r\n\x87\n")
    ftyp = box(b"ftyp", brand + b"\0\0\0\0" + brand)
    return sig + ftyp + box(b"jp2h", b"".join(header)) + box(b"jp2c", codestream)

"""libaom's and dav1d's decodes of an AV1 payload, for holding the port's
AV1 decoder (``tdnet_torch/data/av1.py``) to them plane by plane, before
any colour conversion: libaom is OpenCV's decoder (``strict=True``), dav1d
PIL's (``strict=False``).

It calls the ``libaom-a0d22147.so.3.14.1`` bundled beside OpenCV through
ctypes: ``aom_codec_dec_init_ver`` on ``aom_codec_av1_dx()``,
``aom_codec_decode`` on the OBUs, ``aom_codec_get_frame``; and the dav1d
that Pillow's libavif links in and exports (``dav1d_open`` with several
threads and the default frame delay, as Pillow's libavif runs it on a
machine of several cores: dav1d then parses every OBU of the payload
before it hands out the picture; ``dav1d_send_data``,
``dav1d_get_picture`` until it drains). The card's machine has neither: tests and tools
here use them, the port never does.

    python tools/av1_ref.py page.avif    # prints the planes' shapes
"""

import ctypes
import glob
import os
import sys

import numpy as np

LIB_NAME = "libaom-a0d22147.so.3.14.1"
_ABI = 22  # AOM_DECODER_ABI_VERSION of libaom 3.x: 6 + (7 + 9)
_HIGHBITDEPTH = 0x800

_lib = None


def _library():
    global _lib
    if _lib is None:
        import cv2
        found = glob.glob(os.path.join(os.path.dirname(cv2.__file__), "..",
                                       "opencv_python.libs", LIB_NAME))
        if not found:
            raise RuntimeError(f"{LIB_NAME} not found beside cv2")
        lib = ctypes.CDLL(os.path.realpath(found[0]))
        lib.aom_codec_av1_dx.restype = ctypes.c_void_p
        lib.aom_codec_dec_init_ver.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                               ctypes.c_long, ctypes.c_int]
        lib.aom_codec_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                                         ctypes.c_void_p]
        lib.aom_codec_get_frame.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.aom_codec_get_frame.restype = ctypes.c_void_p
        lib.aom_codec_destroy.argtypes = [ctypes.c_void_p]
        lib.aom_codec_error_detail.argtypes = [ctypes.c_void_p]
        lib.aom_codec_error_detail.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def decode_obus(obus: bytes):
    """libaom's planes of the first frame of ``obus``: a list of 2-D
    uint16 arrays (Y, then U and V unless monochrome), or None where libaom
    refuses the stream."""
    lib = _library()
    ctx = ctypes.create_string_buffer(256)
    if lib.aom_codec_dec_init_ver(ctx, lib.aom_codec_av1_dx(), None, 0, _ABI) != 0:
        raise RuntimeError("aom_codec_dec_init_ver failed")
    try:
        buf = bytes(obus)
        if lib.aom_codec_decode(ctx, buf, len(buf), None) != 0:
            return None
        it = ctypes.c_void_p(0)
        img = lib.aom_codec_get_frame(ctx, ctypes.byref(it))
        if not img:
            return None
        ints = (ctypes.c_uint32 * 16).from_address(img)
        fmt, monochrome = ints[0], ints[4]
        d_w, d_h = ints[10], ints[11]
        xs, ys = ints[14], ints[15]
        planes = (ctypes.c_uint64 * 3).from_address(img + 64)
        strides = (ctypes.c_int32 * 3).from_address(img + 88)
        wide = bool(fmt & _HIGHBITDEPTH)
        out = []
        for p in range(1 if monochrome else 3):
            w = d_w if p == 0 else (d_w + xs) >> xs
            h = d_h if p == 0 else (d_h + ys) >> ys
            stride = strides[p]
            raw = ctypes.string_at(planes[p], stride * (h - 1) + w * (2 if wide else 1))
            a = np.frombuffer(raw + bytes(stride * h - len(raw)), np.uint16 if wide else np.uint8)
            a = a.reshape(h, stride // (2 if wide else 1))[:, :w]
            out.append(a.astype(np.uint16))
        return out
    finally:
        lib.aom_codec_destroy(ctx)


_dav1d = None
_EAGAIN = -11


def _dav1d_library():
    global _dav1d
    if _dav1d is None:
        import PIL
        found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                       "libavif-*.so*"))
        if not found:
            raise RuntimeError("Pillow's libavif not found")
        lib = ctypes.CDLL(os.path.realpath(found[0]))
        lib.dav1d_data_create.restype = ctypes.c_void_p
        lib.dav1d_data_create.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        _dav1d = lib
    return _dav1d


def decode_obus_dav1d(obus: bytes):
    """dav1d's planes of the first frame of ``obus`` (uint8: Y, then U and V
    unless monochrome), or None where dav1d refuses the stream."""
    lib = _dav1d_library()
    settings = ctypes.create_string_buffer(1024)  # Dav1dSettings, and room to spare
    lib.dav1d_default_settings(settings)
    ctypes.c_int.from_buffer(settings).value = 4  # n_threads
    ctx = ctypes.c_void_p()
    if lib.dav1d_open(ctypes.byref(ctx), settings) != 0:
        raise RuntimeError("dav1d_open failed")
    try:
        data = ctypes.create_string_buffer(128)  # Dav1dData: data, sz, ...
        ctypes.memmove(lib.dav1d_data_create(data, len(obus)), bytes(obus), len(obus))
        pic = ctypes.create_string_buffer(1024)  # Dav1dPicture
        for _ in range(64):
            if ctypes.c_size_t.from_buffer(data, 8).value:
                res = lib.dav1d_send_data(ctx, data)
                if res < 0 and res != _EAGAIN:
                    return None
            res = lib.dav1d_get_picture(ctx, pic)
            if res != _EAGAIN:
                break
        if res < 0:
            return None
        planes = (ctypes.c_uint64 * 3).from_buffer(pic, 16)
        strides = (ctypes.c_int64 * 2).from_buffer(pic, 40)
        w, h, layout, _ = (ctypes.c_int * 4).from_buffer(pic, 56)  # I400, I420, I422, I444
        out = []
        for p in range(1 if layout == 0 else 3):
            xs = int(p > 0 and layout != 3)
            ys = int(p > 0 and layout == 1)
            pw, ph = (w + xs) >> xs, (h + ys) >> ys
            stride = strides[min(p, 1)]
            raw = ctypes.string_at(planes[p], stride * (ph - 1) + pw)
            a = np.frombuffer(raw + bytes(stride * ph - len(raw)), np.uint8)
            out.append(a.reshape(ph, stride)[:, :pw].copy())
        lib.dav1d_picture_unref(pic)
        return out
    finally:
        lib.dav1d_close(ctypes.byref(ctx))


def avif_planes(data: bytes):
    """libaom's planes of an AVIF file's primary item."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tdnet_torch.data import avif
    c = avif.parse(data)
    return decode_obus(c.payload(data, c.items[c.primary]))


if __name__ == "__main__":
    for path in sys.argv[1:]:
        planes = avif_planes(open(path, "rb").read())
        print(path, None if planes is None else [p.shape for p in planes])

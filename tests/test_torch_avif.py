"""AVIF pages (``tdnet_torch/data/avif.py``, ``yuv_rgb.py`` and the AV1
decoder) against the two references: PIL 12.1's ``Image.open(...).
convert("RGB")`` (libavif 1.3.0) on the file route and ``cv2.imdecode``
(libavif 1.4.2) on the body route, byte for byte, with ``image_size``
equal to PIL's ``.size``. Fixtures come from both encoders here over the
settings their users reach for, and from containers written by hand
(``tools/avif_rewrite.py``); a fuzz of encoder settings and one of damaged
containers hold the port to the references' outcomes."""

import io
import os
import struct
import sys
import warnings

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

import avif_rewrite as rw  # noqa: E402
from tdnet_torch.data import avif  # noqa: E402
from tdnet_torch.data import image as port_image  # noqa: E402


def _page(h=120, w=168, seed=0, noise=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    page = np.repeat((245 - 6 * yy / h - 3 * xx / w)[:, :, None], 3, 2)
    for y in range(10, h - 8, 16):
        page[y, 6:w - 6] = 60
        for x in range(12, w - 24, 30):
            page[y + 4:y + 10, x:x + int(rng.integers(6, 22))] = 45
    page[:16, :, 2] -= 40
    if noise:
        page = page + rng.integers(-noise, noise + 1, page.shape)
    return np.clip(page, 0, 255).astype(np.uint8)


def _pil(img, mode=None, **kw):
    b = io.BytesIO()
    Image.fromarray(img, mode).save(b, "AVIF", **kw)
    return b.getvalue()


def _cv2(img, *params):
    return cv2.imencode(".avif", img[:, :, ::-1].copy(), list(params))[1].tobytes()


def references(data):
    """(PIL's RGB or None, cv2's RGB or None, PIL's .size or None)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im = Image.open(io.BytesIO(data))
            size = im.size
            pil = np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 (any failure of PIL's plugin is a refusal)
        pil, size = None, None
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return pil, None if bgr is None else bgr[:, :, ::-1], size


def outcome(data, route):
    try:
        return port_image.decode_image(data, route=route)
    except ValueError as e:
        return e


def assert_as_references(data, named=()):
    """Each route equals its reference, or raises where the reference
    refuses; a refusal of the port's own may only name one of ``named``."""
    pil, rgb, size = references(data)
    for route, want in (("pil", pil), ("cv2", rgb)):
        got = outcome(data, route)
        if isinstance(got, ValueError):
            assert want is None or any(n in str(got) for n in named), (route, str(got))
        else:
            assert want is not None, route
            np.testing.assert_array_equal(got, want)
    if size is not None:
        assert port_image.pil_plugin(data)[0] == "AVIF"
        assert avif.avif_size(data) == size


RGBA = np.dstack([_page(seed=8), np.linspace(0, 255, 168, dtype=np.uint8)[None, :].repeat(120, 0)])
FIXTURES = {
    "pil_default": lambda: _pil(_page(200, 264)),
    "cv2_default": lambda: _cv2(_page(seed=1, noise=10)),
    "cv2_q10": lambda: _cv2(_page(seed=2, noise=16), cv2.IMWRITE_AVIF_QUALITY, 10),
    "s422": lambda: _pil(_page(seed=3), subsampling="4:2:2", quality=60),
    "s444": lambda: _pil(_page(seed=4), subsampling="4:4:4"),
    "s400": lambda: _pil(_page(seed=5), subsampling="4:0:0"),
    "s400_limited": lambda: _pil(_page(seed=5), subsampling="4:0:0", range="limited"),
    "limited": lambda: _pil(_page(seed=6, noise=6), range="limited"),
    "q100": lambda: _pil(_page(seed=7), quality=100),
    "q5": lambda: _pil(_page(seed=9, noise=20), quality=5),
    "speed0": lambda: _pil(_page(seed=10, noise=8), speed=0),
    "speed10": lambda: _pil(_page(seed=11, noise=8), speed=10),
    "tiles_auto": lambda: _pil(_page(264, 528, seed=12), autotiling=True, tile_rows=1,
                               tile_cols=1),
    "screen_sb128": lambda: _pil(_page(seed=13), advanced={"tune-content": "screen",
                                                           "sb-size": "128"}),
    "restoration": lambda: _pil(_page(seed=14, noise=20), quality=30, speed=1, advanced={
        "enable-restoration": "1", "enable-intrabc": "0", "enable-palette": "0"}),
    "deltaq_cfl": lambda: _pil(_page(seed=15, noise=8), quality=50, advanced={
        "deltaq-mode": "3", "delta-lf-mode": "1", "enable-cfl-intra": "1",
        "enable-filter-intra": "1"}),
    "rgba": lambda: _pil(RGBA, "RGBA"),
    "rgba_premultiplied": lambda: _pil(RGBA, "RGBA", quality=70, alpha_premultiplied=True),
    "icc_exif6": lambda: _pil(_page(seed=16), exif=b"Exif\0\0MM\0*\0\0\0\x08\0\x01\x01\x12\0\3"
                              b"\0\0\0\1\0\6\0\0\0\0\0\0", icc_profile=b"\0" * 128),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_reads_as_the_references(name):
    """Each encoder fixture, by each route, byte-equal to its reference,
    and its size PIL's ``.size``."""
    data = FIXTURES[name]()
    pil, rgb, _ = references(data)
    assert pil is not None and rgb is not None
    assert_as_references(data)


def test_unpremultiply_equals_libavif():
    """``yuv_rgb.unpremultiply`` against each libavif's
    ``avifRGBImageUnpremultiplyAlpha`` (PIL's 1.3.0 and cv2's 1.4.2, through
    ctypes) on an RGBA image of every 8-bit value under every alpha."""
    import ctypes
    import glob

    from tdnet_torch.data import yuv_rgb

    class RGBImage(ctypes.Structure):  # avifRGBImage of libavif 1.x
        _fields_ = ([(n, ctypes.c_uint32) for n in (
            "width", "height", "depth", "format", "chroma_upsampling", "chroma_downsampling",
            "avoid_libyuv", "ignore_alpha", "alpha_premultiplied", "is_float")]
            + [("max_threads", ctypes.c_int), ("pixels", ctypes.c_void_p),
               ("row_bytes", ctypes.c_uint32)])

    value, alpha = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                               indexing="ij")
    want = yuv_rgb.unpremultiply(np.dstack([value] * 3), alpha)
    libs = [glob.glob(os.path.join(os.path.dirname(m.__file__), "..", d, "libavif-*.so*"))[0]
            for m, d in ((Image, "pillow.libs"), (cv2, "opencv_python.libs"))]
    for lib in libs:
        rgba = np.ascontiguousarray(np.dstack([value] * 3 + [alpha]))
        image = RGBImage(256, 256, 8, 1, 0, 0, 0, 0, 1, 0, 1, rgba.ctypes.data, 1024)  # RGBA
        assert ctypes.CDLL(os.path.realpath(lib)).avifRGBImageUnpremultiplyAlpha(
            ctypes.byref(image)) == 0
        np.testing.assert_array_equal(rgba[:, :, :3], want)
        np.testing.assert_array_equal(rgba[:, :, 3], alpha)


def test_hand_written_containers():
    """Rewritten boxes around one payload: ``colr`` matrices and ranges,
    ``irot``/``imir``/``clap`` (neither reference turns or crops),
    ``pixi`` and ``ispe`` cases, essential properties, brands, alpha items
    (full and limited range, premultiplied or not, beside 4:4:4 and 4:0:0)
    and a grid; property boxes of other items, cut short or of odd values
    (libavif checks every box of ``ipco``), an ``av1C`` whose monochrome
    flag is not the stream's (OpenCV's gray image follows ``av1C``),
    ``meta``, ``hdlr`` and ``iinf`` fields, an ``mdat`` past the file's
    end; each read as the references read it, or refused where they
    refuse, or refused by name (libavif scales a mismatched ``ispe``, reads
    grids and limited-range identity)."""
    payload, props = rw.items(_pil(_page(56, 72, seed=20), subsampling="4:4:4"))
    w, h = struct.unpack(">II", props[b"ispe"][4:12])
    mono, mono_props = rw.items(_pil(_page(56, 72, seed=20), subsampling="4:0:0"))
    alpha, alpha_props = rw.items(_pil(_page(56, 72, seed=21, noise=30), subsampling="4:0:0",
                                       range="limited", quality=60))
    alpha_props.pop(b"colr")
    named = ("ispe", "identity matrix", "grid")

    def with_(**kw):
        p = dict(props)
        for k, v in kw.items():
            if v is None:
                p.pop(k.encode(), None)
            else:
                p[k.encode()] = v
        return p

    cases = [rw.write(payload, with_(colr=rw.nclx(1, 13, mc, full)))
             for mc in (1, 9, 0, 5, 12, 10) for full in (True, False)]
    cases += [
        rw.write(payload, with_(irot=b"\1"), essential=(b"irot",)),
        rw.write(payload, with_(imir=b"\1"), essential=(b"imir",)),
        rw.write(payload, with_(clap=struct.pack(">8I", w - 8, 1, h - 8, 1, 0, 1, 0, 1))),
        rw.write(payload, with_(clap=struct.pack(">8I", w + 8, 1, h, 1, 0, 1, 0, 1))),
        rw.write(payload, with_(pixi=None)), rw.write(payload, with_(pixi=rw.pixi(8))),
        rw.write(payload, with_(pixi=rw.pixi(10, 10, 10))),
        rw.write(payload, with_(ispe=None)), rw.write(payload, with_(ispe=rw.ispe(w - 8, h))),
        rw.write(payload, with_(xxxx=b"abc")),
        rw.write(payload, with_(xxxx=b"abc"), essential=(b"xxxx",)),
        rw.write(payload, props, essential=(b"av1C",)),
        rw.write(payload, props, major=b"mif1"),
        rw.write(payload, props, major=b"mif1", brands=(b"mif1",)),
        rw.write(payload, props, alpha=(mono, mono_props)),
        rw.write(payload, props, alpha=(mono, mono_props), premultiplied=True),
        rw.write(payload, props, alpha=(alpha, alpha_props), premultiplied=True),
        rw.write(mono, mono_props, alpha=(alpha, alpha_props), premultiplied=True),
        rw.write(b"", {b"ispe": props[b"ispe"]}, item_type=b"grid",
                 extra_items=[(b"av01", payload, props)]),
    ]

    def alpha_with(**kw):  # the 4:0:0 page as the alpha of the 4:4:4 one, premultiplied
        p = dict(mono_props)
        p.update({k.encode(): v for k, v in kw.items()})
        return rw.write(payload, props, alpha=(mono, {k: v for k, v in p.items() if v}),
                        premultiplied=True, essential=(b"xxxx",))

    def other_item(essential=(), kind=b"av01", **kw):  # an item of no use to the image
        p = dict(mono_props)
        p.update({k.encode(): v for k, v in kw.items()})
        return rw.write(payload, props, essential=essential,
                        extra_items=[(kind, mono, {k: v for k, v in p.items() if v is not None})])

    def flipped_mono(pl, pr):
        a = bytearray(pr[b"av1C"])
        a[2] ^= 0x10
        return rw.write(pl, {**pr, b"av1C": bytes(a)})

    cases += [
        alpha_with(xxxx=b"abc"),  # an unsupported alpha item is passed over
        alpha_with(av1C=None, xxxx=b"abc"), alpha_with(ispe=None),  # OpenCV's libavif wants none
        other_item(pixi=rw.pixi(17)), other_item(pixi=rw.pixi(0)),  # OpenCV refuses
        other_item(ispe=bytes(6)), other_item(auxC=bytes(4) + b"urn"),
        other_item(pixi=bytes(5)), other_item(clli=bytes(3)), other_item(irot=b"\1"),
        other_item(a1op=b"\0", essential=(b"a1op",)), other_item(a1op=b""),
        other_item(a1lx=bytes(7), essential=(b"a1lx",)), other_item(mdcv=b""),
        other_item(ispe=None), other_item(kind=b"mime", ispe=None),
        rw.write(mono, {**mono_props, b"colr": rw.nclx(1, 13, 3, True)}),  # libavif refuses
        rw.write(mono, {**mono_props, b"colr": rw.nclx(1, 13, 8, False)}),  # these matrices
        flipped_mono(payload, props), flipped_mono(mono, mono_props),
        flipped_mono(*rw.items(_pil(_page(56, 72, seed=22), subsampling="4:0:0",
                                    range="limited"))),
        rw.write(mono, mono_props, alpha=(alpha, alpha_props)),  # OpenCV refuses
    ]
    for bits, depth in ((0x40, 10), (0x20, 8), (0x60, 12)):  # pixi against av1C's depth
        config = bytearray(props[b"av1C"])
        config[2] |= bits
        cases.append(rw.write(payload, with_(av1C=bytes(config), pixi=rw.pixi(*[depth] * 3))))
    with_alpha = rw.write(payload, props, alpha=(mono, mono_props), premultiplied=True)
    cases.append(with_alpha.replace(b"iref\0", b"iref\2"))  # an iref libavif passes over
    plain = rw.write(payload, props)
    meta = plain.index(b"meta")
    for at, value in ((meta + 4, b"\1"), (meta + 24, b"\1"), (meta + 33, b"\1"),
                      (plain.index(b"infe"), b"x"), (plain.index(b"infe") + 4, b"\4"),
                      (plain.index(b"iloc") + 22, bytes(4)), (plain.index(b"mdat") - 2, b"\x40")):
        edited = bytearray(plain)
        edited[at:at + len(value)] = value  # meta version, hdlr pre_defined and reserved, infe
        cases.append(bytes(edited))  # type and version, an extent of no length, mdat's size
    for data in cases:
        assert_as_references(data, named)
    heic = rw.write(payload, props, major=b"heic")  # cv2's decoder takes it, PIL's plugin not
    assert_as_references(heic, named)
    assert isinstance(outcome(heic, "pil"), ValueError)
    assert not isinstance(outcome(heic, "cv2"), ValueError)


def test_encoder_settings_fuzz():
    """Random encoder settings on random pages: every encode decodes equal
    to both references, or is refused by name where one refuses; none
    differs."""
    rng = np.random.default_rng(21)
    adv_options = [{}, {"enable-restoration": "1"}, {"tune-content": "screen"},
                   {"sb-size": "128"}, {"enable-palette": "0", "enable-intrabc": "0"},
                   {"deltaq-mode": "2"}, {"enable-filter-intra": "0"}, {"enable-qm": "1"}]
    for k in range(10):
        h, w = int(rng.integers(24, 100)), int(rng.integers(24, 140))
        img = _page(h + 20, w + 20, seed=30 + k, noise=int(rng.integers(0, 30)))[:h, :w]
        if k % 4 == 3:
            data = _cv2(img, cv2.IMWRITE_AVIF_QUALITY, int(rng.integers(1, 100)))
        else:
            if k % 3 == 1:  # alpha, with zero, one and opaque pixels
                a = rng.integers(0, 256, (h, w)).astype(np.uint8)
                img = np.dstack([img, np.where(a > 200, 255, np.where(a < 30, a // 15, a))])
            data = _pil(img, "RGBA" if img.shape[2] == 4 else None,
                        alpha_premultiplied=bool(k % 2),
                        quality=int(rng.integers(0, 101)), speed=int(rng.integers(0, 11)),
                        subsampling=("4:2:0", "4:2:2", "4:4:4", "4:0:0")[int(rng.integers(4))],
                        range=("full", "limited")[int(rng.integers(2))],
                        advanced=adv_options[int(rng.integers(len(adv_options)))])
        assert_as_references(data, ("10-bit",))


def test_damaged_containers():
    """Cuts and byte flips of a file's boxes (and cuts into its payload),
    then of its AV1 payload alone (header and tile bits flipped, OBUs of
    every type appended): the port refuses where a reference refuses and
    reads as it reads. PIL's libavif decodes with dav1d, which checks no
    trailing or padding bits and stops only a tile whose symbols used up
    its bytes; OpenCV's with libaom, which checks them all."""
    named = ("ispe", "identity matrix", "grid", "10-bit")
    data = _pil(_page(48, 64, seed=40), quality=60)
    meta_end = data.index(b"mdat") - 4
    rng = np.random.default_rng(41)
    for k in range(40):
        d = bytearray(data)
        if k % 2:
            del d[int(rng.integers(8, len(d))):]
        else:
            i = int(rng.integers(0, meta_end))
            d[i] ^= 1 << int(rng.integers(0, 8))
        assert_as_references(bytes(d), named)
    payload, props = rw.items(data)
    for k in range(40):
        p = bytearray(payload)
        i = int(rng.integers(0, 30 if k % 2 else len(p)))
        p[i] ^= 1 << int(rng.integers(0, 8))
        assert_as_references(rw.write(bytes(p), props), named)
    for extra in (b"\x02\x01\x00", b"\x0a\x00", b"\x12\x01\x80", b"\x2a\x01\x01", b"\x3a\x00",
                  b"\x42\x01\x00", b"\x7a\x02\x12\x34", b"\x7a\x01\x80", b"\xfa\x00", b"\x00",
                  b"\x78", b"\x2a\x02\x04\x80", b"\x2a\x06\x01\0\0\0\0\x80",
                  b"\x2a\x05\x01\0\0\0\x80"):
        assert_as_references(rw.write(payload + extra, props), named)

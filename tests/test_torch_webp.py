"""``tdnet_torch/data/webp.py``, ``vp8.py`` and ``vp8l.py`` against the two
decoders the reference reads WebP pages with, both libwebp: PIL's
``Image.open(path).convert("RGB")`` (the file route) and
``cv2.imdecode(buf, IMREAD_COLOR)`` (the serve-body route), byte for byte,
on small pages written by Pillow's encoder, by hand-assembled chunks and by
``tools/webp_rewrite.py``. Where a reference refuses a file, that route
raises ``ValueError``; ``image_size`` equals PIL's ``.size``. The constant
tables are held against their bytes in the libwebp shared object beside
PIL."""

import glob
import io
import os
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import image as port_image
from tdnet_torch.data import jpeg, vp8, vp8l, webp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from webp_rewrite import rewrite  # noqa: E402

SIZES = [(1, 1), (16, 16), (17, 33), (57, 40), (100, 3)]


def _save(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "WEBP", **kw)
    return buf.getvalue()


def _chunks(data: bytes):
    pos, out = 12, {}
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.setdefault(tag, data[pos + 8:pos + 8 + n])
        pos += 8 + n + (n & 1)
    return out


def _riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + bytes(len(payload) & 1)


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                  + (h - 1).to_bytes(3, "little"))


def _anmf(x: int, y: int, w: int, h: int, frame: bytes, bits: int = 0) -> bytes:
    fields = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 100))
    return _chunk(b"ANMF", fields + bytes([bits]) + frame)


def _references(data: bytes):
    """(PIL's RGB or None, cv2's decode as RGB or None, PIL's .size or None:
    a file PIL opens has its size even where its pixels fail to decode)."""
    pil = size = None
    try:
        im = Image.open(io.BytesIO(data))
        size = im.size
        pil = np.asarray(im.convert("RGB"))
    except (OSError, ValueError, Image.DecompressionBombError):
        pass
    try:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        bgr = None
    return pil, None if bgr is None else bgr[:, :, ::-1], size


def _check(data: bytes, name: str, size_too: bool = True):
    """Both routes equal their references (a refusal raising), and
    webp_size equals PIL's .size (raising where PIL cannot open the file)."""
    pil, cv, size = _references(data)
    for route, want in (("pil", pil), ("cv2", cv)):
        if want is None:
            with pytest.raises(ValueError):
                webp.decode_webp(data, route=route)
            continue
        got = webp.decode_webp(data, route=route)
        assert got.shape == want.shape and np.array_equal(got, want), (name, route)
    if size_too:
        if size is None:
            with pytest.raises(ValueError):
                webp.webp_size(data)
        else:
            assert webp.webp_size(data) == size, name
    return pil, cv


def _kinds(h, w, rng):
    yy, xx = np.mgrid[:h, :w]
    palettes = {n: rng.integers(0, 256, (n, 3), dtype=np.uint8) for n in (2, 4, 16, 200)}
    return {
        "2 colours": palettes[2][rng.integers(0, 2, (h, w))],
        "3-4 colours": palettes[4][rng.integers(0, 3 + (w > 8), (h, w))],
        "5-16 colours": palettes[16][rng.integers(0, 16, (h, w))],
        "over 16 colours": palettes[200][rng.integers(0, 200, (h, w))],
        "gradient": np.dstack([(xx * 7) % 256, (yy * 5) % 256,
                               (xx + 2 * yy) % 256]).astype(np.uint8),
        "noise": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        "blocks": np.kron(rng.integers(0, 256, ((h + 3) // 4, (w + 3) // 4, 3)),
                          np.ones((4, 4, 1)))[:h, :w].astype(np.uint8),
    }


KINDS = ["2 colours", "3-4 colours", "5-16 colours", "over 16 colours", "gradient", "noise",
         "blocks"]


@pytest.mark.parametrize("kind", KINDS)
def test_lossless_matches_both_references(kind):
    """VP8L at every Pillow method 0-6 (a quality each), at every small
    size: colour indexing with each bundling width, predictor and
    cross-colour on gradients, literals and the colour cache on noise,
    back-references on blocks."""
    rng = np.random.default_rng(KINDS.index(kind))
    qualities = (0, 25, 50, 75, 100, 10, 90)
    for h, w in SIZES:
        a = _kinds(h, w, rng)[kind]
        for method in range(7):
            _check(_save(Image.fromarray(a), lossless=True, method=method,
                         quality=qualities[method]), f"{kind} {h}x{w} m{method}",
                   size_too=method == 0)


@pytest.mark.parametrize("exact", [False, True])
def test_lossless_rgba(exact):
    """RGBA lossless, with and without ``exact`` (the encoder keeps or
    rewrites the colour under transparent pixels): RGB as both routes give
    it, and RGBA as PIL gives it."""
    rng = np.random.default_rng(7)
    for h, w in SIZES:
        a = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        a[..., 3] = np.where(rng.random((h, w)) < 0.3, 0, a[..., 3])
        data = _save(Image.fromarray(a, "RGBA"), lossless=True, exact=exact)
        _check(data, f"rgba {h}x{w}")
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        np.testing.assert_array_equal(webp._pil(data), want)


@pytest.mark.parametrize("method", range(7))
def test_lossy_matches_both_references(method):
    """VP8 key frames at every small size and Pillow method, over the
    quality range: segments, skipped macroblocks, token-probability
    updates, both block sizes and all intra modes, the normal loop
    filter at many levels."""
    rng = np.random.default_rng(10 + method)
    qualities = (0, 10, 30, 50, 70, 90, 100)
    for i, (h, w) in enumerate(SIZES):
        kinds = _kinds(h, w, rng)
        for j, kind in enumerate(("gradient", "noise", "blocks")):
            q = qualities[(method + i + 3 * j) % 7]
            _check(_save(Image.fromarray(kinds[kind]), quality=q, method=method),
                   f"{kind} {h}x{w} q{q}", size_too=j == 0)


def test_files_from_opencvs_encoder():
    """WebP written by cv2.imencode (OpenCV's own libwebp build): lossy at
    qualities 1-100, lossless above 100, BGR and BGRA."""
    rng = np.random.default_rng(21)
    for h, w in ((1, 1), (17, 33), (57, 40)):
        yy, xx = np.mgrid[:h, :w]
        img = np.dstack([(xx * 7) % 256, (yy * 5) % 256,
                         rng.integers(0, 256, (h, w))]).astype(np.uint8)
        for q in (1, 30, 75, 100, 101):
            for a in (img, np.dstack([img, (xx * 11) % 256]).astype(np.uint8)):
                ok, enc = cv2.imencode(".webp", a, [cv2.IMWRITE_WEBP_QUALITY, q])
                assert ok
                _check(enc.tobytes(), f"cv2 {h}x{w} q{q} {a.shape[2]} channels")


def test_lossy_full_quality_range_on_one_page():
    """Every tenth quality from 0 to 100 on a 48x64 page with flat areas,
    edges and texture."""
    rng = np.random.default_rng(3)
    page = np.full((48, 64, 3), 235, np.uint8)
    page[8:30, 5:50] = rng.integers(20, 120, 3)
    page[8:30:4, 5:50] = 250
    page[34:, :] = rng.integers(0, 256, (14, 64, 3))
    for q in range(0, 101, 10):
        _check(_save(Image.fromarray(page), quality=q), f"q{q}", size_too=False)


def _filtered(alpha: np.ndarray, filt: int) -> np.ndarray:
    """libwebp's alpha filters forward (the encoder's side)."""
    if filt == 0:
        return alpha.copy()
    a = alpha.astype(np.int64)
    out = np.empty_like(a)
    h, w = a.shape
    out[0, 0] = a[0, 0]
    out[0, 1:] = a[0, 1:] - a[0, :-1]
    for y in range(1, h):
        if filt == 1:
            out[y, 0] = a[y, 0] - a[y - 1, 0]
            out[y, 1:] = a[y, 1:] - a[y, :-1]
        elif filt == 2:
            out[y] = a[y] - a[y - 1]
        else:
            out[y, 0] = a[y, 0] - a[y - 1, 0]
            for x in range(1, w):
                g = min(255, max(0, a[y, x - 1] + a[y - 1, x] - a[y - 1, x - 1]))
                out[y, x] = a[y, x] - g
    return (out & 255).astype(np.uint8)


def test_lossy_alpha_chunks():
    """RGBA lossy (``VP8X`` + ``ALPH`` + ``VP8 ``) from Pillow, raw and
    lossless-coded, and raw ``ALPH`` chunks written here with each filter
    (none, horizontal, vertical, gradient): RGB on both routes, the alpha
    as PIL's RGBA gives it."""
    rng = np.random.default_rng(5)
    for h, w in SIZES[1:]:
        yy, xx = np.mgrid[:h, :w]
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        alphas = [rng.integers(0, 256, (h, w)), np.where((xx // 5 + yy // 3) % 2, 255, 0),
                  np.clip(255 - 9 * np.hypot(yy - h / 2, xx - w / 2), 0, 255)]
        for k, a in enumerate(alphas):
            rgba = np.dstack([rgb, a]).astype(np.uint8)
            data = _save(Image.fromarray(rgba, "RGBA"), quality=30 + 20 * k, method=k)
            _check(data, f"alpha {h}x{w} #{k}", size_too=False)
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
            np.testing.assert_array_equal(webp._pil(data), want)
        frame = _chunks(_save(Image.fromarray(rgb), quality=60))[b"VP8 "]
        a = alphas[2].astype(np.uint8)
        for filt in range(4):
            alph = bytes([filt << 2]) + _filtered(a, filt).tobytes()
            data = _riff(_vp8x(0x10, w, h) + _chunk(b"ALPH", alph) + _chunk(b"VP8 ", frame))
            _check(data, f"raw alpha filter {filt}", size_too=False)
            np.testing.assert_array_equal(webp._pil(data)[..., 3], a)


def test_animation_first_frame():
    """A 2-frame animation from Pillow, and hand-made ones whose first
    frame is smaller than the canvas and offset in it (lossless and lossy,
    with blend bits): the first frame on a black canvas, on both routes."""
    rng = np.random.default_rng(4)
    frames = [Image.fromarray(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)) for _ in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], lossless=True)
    pil, _ = _check(buf.getvalue(), "pillow animation")
    np.testing.assert_array_equal(pil, np.asarray(frames[0]))
    small = rng.integers(0, 256, (10, 12, 3), dtype=np.uint8)
    anim = _chunk(b"ANIM", struct.pack("<IH", 0xFF336699, 0))
    for kw, tag in ((dict(lossless=True), b"VP8L"), (dict(quality=60), b"VP8 ")):
        frame = _chunk(tag, _chunks(_save(Image.fromarray(small), **kw))[tag])
        for x, y, bits in ((4, 6, 0), (18, 10, 3), (0, 0, 1)):
            data = _riff(_vp8x(0x02, 30, 20) + anim + _anmf(x, y, 12, 10, frame, bits))
            pil, _ = _check(data, f"frame at {x},{y}")
            assert (pil[:y] == 0).all() and (pil[y + 10:] == 0).all() and (pil[:, :x] == 0).all()


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_turns_the_cv2_route_only(orientation):
    """A ``VP8X`` file with an EXIF Orientation: cv2 turns the page, PIL
    does not (its ``.size`` stays the stored one), as with JPEG."""
    rng = np.random.default_rng(orientation)
    a = rng.integers(0, 256, (17, 33, 3), dtype=np.uint8)
    exif = Image.Exif()
    exif[0x0112] = orientation
    for kw in (dict(lossless=True), dict(quality=70)):
        pil, cv = _check(_save(Image.fromarray(a), exif=exif, **kw), f"exif {orientation}")
        assert np.array_equal(cv, jpeg._orient(pil, orientation))


def test_exif_rules_on_the_cv2_route():
    """The EXIF chunk cv2 reads: the first one, before or after the image,
    with the VP8X flag on, raw TIFF of either byte order, the 16 bits at
    the Orientation entry whatever its type; not with the flag off, not
    behind an ``Exif`` prefix, not when the demuxer refuses the file. The
    JPEG route reads an Orientation of any type the same way."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    ll = _chunks(_save(Image.fromarray(a), lossless=True))[b"VP8L"]

    def tiff(order, kind, value):
        e = "<" if order == b"II" else ">"
        v = struct.pack(e + ("I" if kind == 4 else "H") , value).ljust(4, b"\0")
        return order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1) + struct.pack(
            e + "HHI", 0x0112, kind, 1) + v + bytes(4)

    le6, be3, long6 = tiff(b"II", 3, 6), tiff(b"MM", 3, 3), tiff(b"II", 4, 6)
    for name, body in [
            ("after", _vp8x(8, 30, 20) + _chunk(b"VP8L", ll) + _chunk(b"EXIF", le6)),
            ("before", _vp8x(8, 30, 20) + _chunk(b"EXIF", le6) + _chunk(b"VP8L", ll)),
            ("big-endian", _vp8x(8, 30, 20) + _chunk(b"VP8L", ll) + _chunk(b"EXIF", be3)),
            ("two", _vp8x(8, 30, 20) + _chunk(b"VP8L", ll) + _chunk(b"EXIF", be3)
             + _chunk(b"EXIF", le6)),
            ("LONG", _vp8x(8, 30, 20) + _chunk(b"VP8L", ll) + _chunk(b"EXIF", long6)),
            ("flag off", _vp8x(0, 30, 20) + _chunk(b"VP8L", ll) + _chunk(b"EXIF", le6)),
            ("prefix", _vp8x(8, 30, 20) + _chunk(b"VP8L", ll) + _chunk(b"EXIF", b"Exif\0\0" + le6)),
            ("reserved flag", _vp8x(9, 30, 20) + _chunk(b"VP8L", ll) + _chunk(b"EXIF", le6)),
            ("simple file", _chunk(b"VP8L", ll) + _chunk(b"EXIF", le6))]:
        _check(_riff(body), name)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", quality=95)
    for kind in (1, 3, 4):
        app1 = b"Exif\0\0" + tiff(b"II", kind, 6)
        data = buf.getvalue()
        data = data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, route="cv2"), want)


@pytest.fixture(scope="module")
def parts():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    rgba = np.dstack([img, np.where(rng.random((20, 30)) < 0.5, 0, 255)]).astype(np.uint8)
    coded = _chunks(_save(Image.fromarray(rgba, "RGBA"), quality=70))
    assert coded[b"ALPH"][0] & 3 == 1  # lossless-coded alpha
    return dict(ll=_chunks(_save(Image.fromarray(img), lossless=True))[b"VP8L"],
                vp=_chunks(_save(Image.fromarray(img), quality=70))[b"VP8 "],
                alph=coded[b"ALPH"], vpa=coded[b"VP8 "],
                small=_chunks(_save(Image.fromarray(img[:10, :12]), lossless=True))[b"VP8L"])


def _probes(p):
    ll, vp, alph, vpa = p["ll"], p["vp"], p["alph"], p["vpa"]
    anim = _chunk(b"ANIM", struct.pack("<IH", 0, 0))
    g = _riff(_chunk(b"VP8L", ll))
    riff = struct.unpack("<I", g[4:8])[0]
    odd = vp + bytes(1 - len(vp) % 2)
    nopad = b"VP8 " + struct.pack("<I", len(odd)) + odd
    out = {
        "trailing bytes": g + b"garbage!",
        "RIFF size short by 2": g[:4] + struct.pack("<I", riff - 2) + g[8:],
        "RIFF size odd, past the data": g[:4] + struct.pack("<I", riff + 1) + g[8:],
        "RIFF size odd, a byte after": g[:4] + struct.pack("<I", riff + 1) + g[8:] + b"\0",
        "RIFF size 2 over, padded": g[:4] + struct.pack("<I", riff + 2) + g[8:] + bytes(2),
        "cut to half": g[:len(g) // 2],
        "cut by 5": g[:-5],
        "lossy cut by 5": _riff(_chunk(b"VP8 ", vp))[:-5],
        "odd VP8 chunk, no pad": b"RIFF" + struct.pack("<I", 4 + len(nopad)) + b"WEBP" + nopad,
        "odd VP8X chunk, no pad": b"RIFF" + struct.pack("<I", 22 + len(nopad)) + b"WEBP"
        + _vp8x(0, 30, 20) + nopad,
        "canvas wider than the image": _riff(_vp8x(0, 31, 20) + _chunk(b"VP8L", ll)),
        "canvas shorter than the image": _riff(_vp8x(0, 30, 19) + _chunk(b"VP8 ", vp)),
        "VP8X of 12 bytes": _riff(_chunk(b"VP8X", bytes(4) + (29).to_bytes(3, "little")
                                         + (19).to_bytes(3, "little") + bytes(2))
                                  + _chunk(b"VP8L", ll)),
        "reserved VP8X flag": _riff(_vp8x(0x80, 30, 20) + _chunk(b"VP8L", ll)),
        "unknown chunk first": _riff(_vp8x(0, 30, 20) + _chunk(b"ABCD", b"xyz")
                                     + _chunk(b"VP8L", ll)),
        "unknown chunk in a simple file": _riff(_chunk(b"VP8L", ll) + _chunk(b"ABCD", b"x")),
        "two images": _riff(_vp8x(0, 30, 20) + _chunk(b"VP8L", ll) + _chunk(b"VP8L", ll)),
        "no image": _riff(_vp8x(0, 30, 20) + _chunk(b"ABCD", b"xyz")),
        "ALPH before VP8L": _riff(_vp8x(0x10, 30, 20) + _chunk(b"ALPH", alph)
                                  + _chunk(b"VP8L", ll)),
        "ALPH after VP8": _riff(_vp8x(0x10, 30, 20) + _chunk(b"VP8 ", vpa) + _chunk(b"ALPH", alph)),
        "two ALPH, the second cut": _riff(_vp8x(0x10, 30, 20) + _chunk(b"ALPH", alph)
                                          + _chunk(b"ALPH", alph[:5]) + _chunk(b"VP8 ", vpa)),
        "two ALPH, the first cut": _riff(_vp8x(0x10, 30, 20) + _chunk(b"ALPH", alph[:5])
                                         + _chunk(b"ALPH", alph) + _chunk(b"VP8 ", vpa)),
        "raw ALPH short": _riff(_vp8x(0x10, 30, 20) + _chunk(b"ALPH", bytes(300))
                                + _chunk(b"VP8 ", vpa)),
        "ALPH method 2": _riff(_vp8x(0x10, 30, 20) + _chunk(b"ALPH", b"\2" + alph[1:])
                               + _chunk(b"VP8 ", vpa)),
        "ALPH reserved bits": _riff(_vp8x(0x10, 30, 20) + _chunk(b"ALPH", b"\x40" + bytes(600))
                                    + _chunk(b"VP8 ", vpa)),
        "ALPH pre-processing 2": _riff(_vp8x(0x10, 30, 20) + _chunk(b"ALPH", b"\x20" + bytes(600))
                                       + _chunk(b"VP8 ", vpa)),
        "ALPH of one byte": _riff(_vp8x(0x10, 30, 20) + _chunk(b"ALPH", b"\0")
                                  + _chunk(b"VP8 ", vpa)),
        "animation frame past the canvas": _riff(
            _vp8x(0x02, 30, 20) + anim + _anmf(20, 12, 12, 10, _chunk(b"VP8L", p["small"]))),
        "animation without ANIM": _riff(_vp8x(0x02, 30, 20)
                                        + _anmf(0, 0, 30, 20, _chunk(b"VP8L", ll))),
        "ANMF without the animation flag": _riff(_vp8x(0, 30, 20) + anim
                                                 + _anmf(0, 0, 30, 20, _chunk(b"VP8L", ll))),
        "animation flag, a still image": _riff(_vp8x(0x02, 30, 20) + anim + _chunk(b"VP8L", ll)),
        "lossy partition cut": _riff(_chunk(b"VP8 ", vp[:-40])),
        "lossy partition cut, a chunk after": _riff(_vp8x(0, 30, 20) + _chunk(b"VP8 ", vp[:-40])
                                                    + _chunk(b"ABCD", bytes(200))),
        "lossless stream cut": _riff(_chunk(b"VP8L", ll[:-40])),
        "lossless stream cut, a chunk after": _riff(_vp8x(0, 30, 20) + _chunk(b"VP8L", ll[:-40])
                                                    + _chunk(b"ABCD", bytes(2000))),
        "shorter than 32 bytes": _riff(_chunk(b"VP8L", bytes([0x2F, 0, 0, 0, 0]) + bytes(3))),
        "VP8L version 1": _riff(_chunk(b"VP8L", ll[:4] + bytes([ll[4] | 0x20]) + ll[5:])),
        "VP8 interframe": _riff(_chunk(b"VP8 ", bytes([vp[0] | 1]) + vp[1:])),
        "VP8 bad start code": _riff(_chunk(b"VP8 ", vp[:3] + b"\x9d\x01\x2b" + vp[6:])),
    }
    for name, a in (("cut to half", alph[:len(alph) // 2]), ("cut by 1", alph[:-1]),
                    ("garbage", alph[:3] + b"\xff" * (len(alph) - 3))):
        for flag in (0x10, 0):
            out[f"ALPH {name}, alpha flag {flag:#x}"] = _riff(
                _vp8x(flag, 30, 20) + _chunk(b"ALPH", a) + _chunk(b"VP8 ", vpa))
        out[f"animation with ALPH {name}"] = _riff(
            _vp8x(0x12, 30, 20) + anim + _anmf(0, 0, 30, 20, _chunk(b"ALPH", a)
                                               + _chunk(b"VP8 ", vpa)))
    return out


PROBES = ["trailing bytes", "RIFF size short by 2", "RIFF size odd, past the data",
          "RIFF size odd, a byte after", "RIFF size 2 over, padded", "cut to half", "cut by 5",
          "lossy cut by 5", "odd VP8 chunk, no pad", "odd VP8X chunk, no pad",
          "canvas wider than the image", "canvas shorter than the image", "VP8X of 12 bytes",
          "reserved VP8X flag", "unknown chunk first", "unknown chunk in a simple file",
          "two images", "no image", "ALPH before VP8L", "ALPH after VP8",
          "two ALPH, the second cut", "two ALPH, the first cut", "raw ALPH short",
          "ALPH method 2", "ALPH reserved bits", "ALPH pre-processing 2", "ALPH of one byte",
          "animation frame past the canvas", "animation without ANIM",
          "ANMF without the animation flag", "animation flag, a still image",
          "lossy partition cut", "lossy partition cut, a chunk after", "lossless stream cut",
          "lossless stream cut, a chunk after", "shorter than 32 bytes", "VP8L version 1",
          "VP8 interframe", "VP8 bad start code"] + [
    f"ALPH {n}, alpha flag {f:#x}" for n in ("cut to half", "cut by 1", "garbage")
    for f in (0x10, 0)] + [f"animation with ALPH {n}" for n in ("cut to half", "cut by 1",
                                                                 "garbage")]


@pytest.mark.parametrize("case", PROBES)
def test_container_cases_read_or_refuse_as_each_reference(case, parts):
    """Each container and bitstream case on both routes: read as the
    reference reads it, or refused (``ValueError``) where it refuses, and
    ``image_size`` as PIL's ``.size``."""
    _check(_probes(parts)[case], case)


FUZZ_BASES = ["lossless", "lossy", "lossy with alpha", "EXIF", "8 partitions"]


@pytest.mark.parametrize("base", FUZZ_BASES)
def test_damaged_files_read_or_refuse_as_each_reference(base):
    """Random byte changes to small files, each held to both references:
    they cover libwebp's lossy decoder where a damaged stream leaves it (a
    partition that starts at 0xff puts the value above the range, and
    libwebp's 64-bit value and 32-bit window then decide; huge
    coefficients, where its SSE2 transform's 16-bit lanes part from the C
    code), unread partitions left empty, and damaged EXIF, ALPH and VP8L
    data."""
    rng = np.random.default_rng(FUZZ_BASES.index(base))
    yy, xx = np.mgrid[:40, :48]
    img = np.dstack([(xx * 7 + rng.integers(0, 20, (40, 48))) % 256, (yy * 5) % 256,
                     ((xx + yy) * 3) % 256]).astype(np.uint8)
    exif = Image.Exif()
    exif[0x0112] = 6
    data = {
        "lossless": lambda: _save(Image.fromarray(img), lossless=True),
        "lossy": lambda: _save(Image.fromarray(img), quality=60),
        "lossy with alpha": lambda: _save(Image.fromarray(
            np.dstack([img, (xx * 9) % 256]).astype(np.uint8), "RGBA"), quality=50),
        "EXIF": lambda: _save(Image.fromarray(img), quality=40, exif=exif),
        "8 partitions": lambda: rewrite(_save(Image.fromarray(img), quality=40), partitions=8,
                                        simple=1),
    }[base]()
    first_token = None
    if base in ("lossy", "8 partitions"):
        frame = _chunks(data)[b"VP8 "]
        first = (frame[0] | frame[1] << 8 | frame[2] << 16) >> 5
        first_token = data.index(frame) + 10 + first + (21 if base == "8 partitions" else 0)
    for i in range(24):
        d = bytearray(data)
        if first_token is not None and i < 4:  # a token partition that starts at 0xff
            d[first_token] = 0xFF
        for _ in range(int(rng.integers(1, 4))):
            pos = int(rng.integers(20, len(d)))
            d[pos] ^= 1 << int(rng.integers(8))
        _check(bytes(d), f"{base} #{i}", size_too=i % 4 == 0)


def test_exif_parse_as_opencv_parses_it():
    """OpenCV's ExifReader reads little-endian only after ``II`` (big-endian
    otherwise), parses the IFD0 entries in turn and stops at the first
    whose value lies past the data: an orientation after such an entry is
    not seen. Held on WebP's cv2 route and JPEG's."""
    rng = np.random.default_rng(12)
    a = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    ll = _chunks(_save(Image.fromarray(a), lossless=True))[b"VP8L"]
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", quality=95)
    jpg = buf.getvalue()

    def ifd(order, entries):
        e = "<" if order == b"II" else ">"
        body = b"".join(struct.pack(e + "HHI", tag, kind, count) + value.ljust(4, b"\0")
                        for tag, kind, count, value in entries)
        return order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", len(entries)) + body

    six_le, six_be = struct.pack("<H", 6), struct.pack(">H", 6)
    cases = {
        "make past the data first": ifd(b"II", [(0x010F, 2, 40, struct.pack("<I", 900)),
                                                (0x0112, 3, 1, six_le)]),
        "make inside, then orientation": ifd(b"II", [(0x010F, 2, 3, b"ab\0"),
                                                     (0x0112, 3, 1, six_le)]),
        "resolution past the data first": ifd(b"II", [(0x011A, 5, 1, struct.pack("<I", 500)),
                                                      (0x0112, 3, 1, six_le)]),
        "orientation, then a bad make": ifd(b"II", [(0x0112, 3, 1, six_le),
                                                    (0x010F, 2, 40, struct.pack("<I", 900))]),
        "XX order reads big-endian": b"XX" + ifd(b"MM", [(0x0112, 3, 1, six_be)])[2:],
        "IM order reads big-endian": b"IM" + ifd(b"MM", [(0x0112, 3, 1, six_be)])[2:],
        "entries past the data": ifd(b"II", [(0x0112, 3, 1, six_le)])[:-6],
        "two orientations": ifd(b"II", [(0x0112, 3, 1, struct.pack("<H", 3)),
                                        (0x0112, 3, 1, six_le)]),
    }
    for name, tiff in cases.items():
        _check(_riff(_vp8x(8, 30, 20) + _chunk(b"VP8L", ll) + _chunk(b"EXIF", tiff)), name)
        app1 = b"Exif\0\0" + tiff
        data = jpg[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + jpg[2:]
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, route="cv2"), want, err_msg=name)


def test_size_limits_of_each_reference():
    """cv2 refuses an image wider or taller than 2^20 pixels (OpenCV's
    default limits); PIL and cv2 both refuse a 40000x40000 canvas (PIL as a
    decompression bomb)."""
    small = _chunk(b"VP8L", _chunks(_save(Image.fromarray(np.zeros((10, 12, 3), np.uint8)),
                                          lossless=True))[b"VP8L"])
    anim = _chunk(b"ANIM", struct.pack("<IH", 0, 0))
    for w, h in (((1 << 20) + 1, 10), (40000, 40000)):
        _check(_riff(_vp8x(0x02, w, h) + anim + _anmf(0, 0, 12, 10, small)), f"{w}x{h}")


def test_riff_that_is_not_webp_is_not_sniffed(tmp_path):
    """WAV and AVI files start with RIFF too: the sniff wants WEBP at bytes
    8-12, so they raise as an unsupported format."""
    for form in (b"WAVE", b"AVI "):
        data = b"RIFF" + struct.pack("<I", 36) + form + b"fmt " + bytes(28)
        (tmp_path / "x.bin").write_bytes(data)
        for fn in (lambda: port_image.decode_image(data),
                   lambda: port_image.image_size(tmp_path / "x.bin")):
            with pytest.raises(ValueError, match="unsupported image format"):
                fn()


def test_bare_bitstreams_on_the_body_route():
    """A VP8L or VP8 bitstream without its container: cv2 reads it when
    its first 32 bytes hold the header (a lossless stream of 32 bytes or
    more, a key frame whose first partition is shorter), PIL never; the
    port's decode_image routes likewise."""
    rng = np.random.default_rng(8)
    for shape in ((20, 30), (1, 1), (64, 64)):
        noise = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        flat = np.full(shape + (3,), 200, np.uint8)
        for bare in (_chunks(_save(Image.fromarray(noise), lossless=True))[b"VP8L"],
                     _chunks(_save(Image.fromarray(flat), quality=50))[b"VP8 "],
                     _chunks(_save(Image.fromarray(noise), quality=50))[b"VP8 "]):
            pil, cv, _ = _references(bare)
            assert pil is None
            with pytest.raises(ValueError, match="unsupported image format"):
                port_image.decode_image(bare, route="pil")
            if cv is None:
                with pytest.raises(ValueError):
                    port_image.decode_image(bare, route="cv2")
            else:
                np.testing.assert_array_equal(port_image.decode_image(bare, route="cv2"), cv)


def test_rewritten_frames_match_both_references():
    """tools/webp_rewrite.py: a rewrite that changes nothing gives the
    original bytes; the simple filter, 2/4/8 token partitions, sharpness,
    filter levels and loop-filter deltas decode as PIL and cv2 decode
    them."""
    rng = np.random.default_rng(2)
    for (h, w), q in (((57, 40), 20), ((40, 100), 75)):
        yy, xx = np.mgrid[:h, :w]
        a = np.dstack([(xx * 7 + rng.integers(0, 30, (h, w))) % 256, (yy * 5) % 256,
                       ((xx + yy) * 3) % 256]).astype(np.uint8)
        data = _save(Image.fromarray(a), quality=q)
        assert rewrite(data) == data
        for kw in (dict(simple=1), dict(partitions=2), dict(partitions=4), dict(partitions=8),
                   dict(sharpness=5), dict(sharpness=2, level=45), dict(level=63, simple=1),
                   dict(deltas=(3, 0, 0, 0, -5, 0, 0, 0)),
                   dict(simple=1, partitions=4, sharpness=7, deltas=(-2, 1, 0, 0, 6, 0, 0, 0))):
            _check(rewrite(data, **kw), f"{h}x{w} {kw}", size_too=False)
    alpha = np.dstack([a, (xx * 3) % 256]).astype(np.uint8)
    data = _save(Image.fromarray(alpha, "RGBA"), quality=60)
    assert rewrite(data) == data
    _check(rewrite(data, simple=1, partitions=2), "rgba rewrite")


def _libwebp() -> bytes:
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs",
                                  "libwebp-*.so*"))
    if not libs:
        pytest.skip("no libwebp shared object beside PIL to hold the tables against")
    with open(libs[0], "rb") as f:
        return f.read()


def test_constant_tables_are_libwebps():
    """Every constant table, as bytes in the layout libwebp stores it, is
    found in the libwebp shared object PIL loads: the token probabilities
    and their update probabilities, the 4x4 mode probabilities and their
    tree, the DC and AC quantizer steps, the zigzag, the bands, the extra
    bits' probabilities of the large categories, VP8L's code-length order
    and distance map."""
    lib = _libwebp()
    tables = {
        "COEFF_PROBS": np.array(vp8.COEFF_PROBS, np.uint8).tobytes(),
        "COEFF_UPDATE_PROBS": np.array(vp8.COEFF_UPDATE_PROBS, np.uint8).tobytes(),
        "BMODE_PROBS": np.array(vp8.BMODE_PROBS, np.uint8).tobytes(),
        "BMODE_TREE": np.array(vp8.BMODE_TREE, np.int8).tobytes(),
        "DC_TABLE": bytes(vp8.DC_TABLE),
        "AC_TABLE": np.array(vp8.AC_TABLE, "<u2").tobytes(),
        "ZIGZAG": bytes(vp8.ZIGZAG),
        "BANDS": bytes(vp8.BANDS),
        **{f"CAT_PROBS[{i}]": bytes(c) + b"\0" for i, c in enumerate(vp8.CAT_PROBS)},
        "CODE_LENGTH_ORDER": bytes(vp8l.CODE_LENGTH_ORDER),
        "DISTANCE_MAP": bytes(vp8l.DISTANCE_MAP),
    }
    for name, raw in tables.items():
        assert raw in lib, name


def test_webp_through_the_loader_and_serve(tmp_path):
    """WebP pages (lossless, lossy, lossy with alpha, EXIF 6) in a CSV:
    the port's BatchLoader gives batches bit-equal to tdnet's over the same
    CSV for two epochs, read_image_bgr and image_size equal the reference's
    reads, and the port's serve decodes each body as cv2 does."""
    from tdnet.data.csv_dataset import CSVDataset as RefDataset
    from tdnet.data.generator import BatchLoader as RefLoader
    from tdnet.data.generator import LoaderConfig as RefConfig
    from tdnet.data.image import read_image_bgr as ref_read

    from tdnet_torch.bin.serve import _decode_body
    from tdnet_torch.data.csv_dataset import CSVDataset
    from tdnet_torch.data.generator import BatchLoader, LoaderConfig

    rng = np.random.default_rng(6)
    exif = Image.Exif()
    exif[0x0112] = 6
    makers = {"lossless.webp": dict(lossless=True), "lossy.webp": dict(quality=80),
              "alpha.webp": dict(quality=70), "exif6.webp": dict(quality=85, exif=exif)}
    rows = []
    for i, (name, kw) in enumerate(makers.items()):
        h, w = (64, 96) if i % 2 else (96, 64)
        page = np.full((h, w, 3), 236, np.uint8)
        x0, y0 = int(rng.integers(2, w // 2)), int(rng.integers(2, h // 2))
        page[y0:h - 4, x0:w - 3] = rng.integers(20, 120, 3)
        im = Image.fromarray(page)
        if name == "alpha.webp":
            im = im.convert("RGBA")
            im.putalpha(Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8)))
        data = _save(im, **kw)
        (tmp_path / name).write_bytes(data)
        rows.append(f"{tmp_path / name},{x0},{y0},{w - 3},{h - 4},table")
        np.testing.assert_array_equal(port_image.read_image_bgr(tmp_path / name),
                                      ref_read(str(tmp_path / name)))
        assert port_image.image_size(tmp_path / name) == Image.open(tmp_path / name).size
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(_decode_body(data, "image/webp", keep_u8=True), want)
    (tmp_path / "annotations.csv").write_text("\n".join(rows) + "\n")
    (tmp_path / "classes.csv").write_text("table,0\n")
    ann, classes = str(tmp_path / "annotations.csv"), str(tmp_path / "classes.csv")
    kw = dict(batch_size=2, seed=5, min_side=48, max_side=80, device_normalize=False)
    ref = RefLoader(RefDataset(ann, classes), RefConfig(process_index=0, process_count=1, **kw))
    port = BatchLoader(CSVDataset(ann, classes), LoaderConfig(**kw))
    want = [b for _ in range(2) for b in ref.epoch()]
    got = [b for _ in range(2) for b in port.epoch()]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)

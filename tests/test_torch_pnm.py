"""tdnet_torch.data.pnm against the reference's two decoders: each case
byte-equal to PIL's ``Image.open(...).convert("RGB")`` on the ``pil``
route (files, ``tdnet/data/image.py``) and to ``cv2.imdecode(...,
IMREAD_COLOR)[:, :, ::-1]`` on the ``cv2`` route (serve bodies,
``tdnet/bin/serve.py``); where a reference refuses a file, the port raises
on that route. The files come from PIL's and cv2's writers and, for the
maxvals, comments and PAM layouts they do not write, from the test's own
bytes."""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import pnm
from tdnet_torch.data.image import decode_image, image_size, read_image_bgr


def _image(shape, seed, channels=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape + (channels,), dtype=np.uint8)
    if min(shape) >= 5:
        img = cv2.GaussianBlur(img, (5, 5), 0).reshape(img.shape)
    return img


def _pil(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # noqa: BLE001 - any failure is PIL's refusal
        return None


def _cv2(data: bytes):
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[:, :, ::-1]


def _check(data: bytes, refused=(), match=None):
    """Both routes against their references; ``refused`` names the routes
    whose reference refuses the file (the port raises there, its message
    matching ``match``)."""
    for route, oracle in (("pil", _pil), ("cv2", _cv2)):
        want = oracle(data)
        assert (want is None) == (route in refused), (route, data[:40])
        if want is None:
            with pytest.raises(ValueError, match=match):
                pnm.decode_pnm(data, route=route)
            continue
        got = pnm.decode_pnm(data, route=route)
        assert got.dtype == np.uint8 and got.shape == want.shape, (route, got.shape, want.shape)
        if not np.array_equal(got, want):
            diff = np.argwhere(got != want)
            pytest.fail(f"{route}: {len(diff)} samples differ, first at {diff[0].tolist()}")
    if "pil" not in refused:
        assert pnm.pnm_size(data) == Image.open(io.BytesIO(data)).size


def _pil_bytes(im: Image.Image) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PPM")
    return buf.getvalue()


def _cv2_bytes(img, ext, binary=1) -> bytes:
    ok, enc = cv2.imencode(ext, img, [cv2.IMWRITE_PXM_BINARY, binary])
    assert ok
    return enc.tobytes()


def _ascii(magic: bytes, w: int, h: int, values, maxval=None, sep=b" ") -> bytes:
    head = magic + b"\n%d %d\n" % (w, h) + (b"%d\n" % maxval if maxval is not None else b"")
    return head + sep.join(b"%d" % v for v in np.asarray(values).reshape(-1)) + b"\n"


@pytest.mark.parametrize("mode", ["1", "L", "RGB", "I;16"])
def test_pnm_from_pil_writer(mode):
    """P4, P5, P6 and 16-bit P5 (maxval 65535) as PIL writes them, at 1x1
    and 40x57; the routes part on 16-bit gray (PIL clips, cv2 keeps the
    high byte)."""
    for shape in ((1, 1), (40, 57)):
        img = _image(shape, len(mode))
        if mode == "I;16":
            wide = img[:, :, 0].astype(np.int64) * 257 - 100 * (img[:, :, 1] > 9)
            im = Image.fromarray(np.maximum(wide, 0).astype(np.uint16))
        else:
            im = Image.fromarray(img).convert(mode)
        _check(_pil_bytes(im))
    if mode == "I;16":
        data = _pil_bytes(im)
        routes = [pnm.decode_pnm(data, r).astype(int) for r in pnm.ROUTES]
        assert np.abs(routes[0] - routes[1]).max() > 150


@pytest.mark.parametrize("ext", [".pbm", ".pgm", ".ppm"])
def test_pnm_from_cv2_writer(ext):
    """cv2's writer, binary and ASCII, 8-bit and 16-bit (maxval 65535)."""
    img = _image((23, 31), len(ext))
    src = img[:, :, 0] if ext != ".ppm" else img
    if ext == ".pbm":
        src = np.where(src > 127, 255, 0).astype(np.uint8)
    for binary in (1, 0):
        _check(_cv2_bytes(src, ext, binary))
        if ext != ".pbm":
            wide = src.astype(np.uint16) * 257 + 3
            _check(_cv2_bytes(wide, ext, binary))


MAXVALS = [1, 7, 100, 254, 256, 1000, 65534, 65535]


@pytest.mark.parametrize("maxval", MAXVALS)
def test_pnm_maxvals_by_each_route_rule(maxval):
    """Binary and ASCII gray and colour at maxvals other than 255: PIL
    scales by maxval (gray above 255 to 16 bits, clipped to 255), cv2
    keeps binary samples (the high byte above 255) and scales ASCII ones
    by ``v * 255 // maxval``; they part by up to 255."""
    rng = np.random.default_rng(maxval)
    w, h = 13, 6
    for magic, bands in ((b"P5", 1), (b"P6", 3), (b"P2", 1), (b"P3", 3)):
        values = rng.integers(0, maxval + 1, (h, w, bands))
        values.flat[0], values.flat[1] = 0, maxval
        if magic in (b"P5", b"P6"):
            raw = values.astype(">u2" if maxval > 255 else np.uint8).tobytes()
            data = magic + b"\n%d %d\n%d\n" % (w, h, maxval) + raw
        else:
            data = _ascii(magic, w, h, values, maxval)
        _check(data)


def test_pnm_bitmaps_comments_and_whitespace():
    """P1 with and without spaces between its digits, comments in the
    header and between ASCII samples, CR LF and tab separators, a P4 whose
    width is not a multiple of 8, trailing bytes after the samples."""
    bits = np.random.default_rng(1).integers(0, 2, (5, 11))
    rows = b"\n".join(b"".join(b"%d" % v for v in r) for r in bits)
    _check(b"P1\n# a scanner\n11 5\n" + rows + b"\n")
    _check(b"P1 11 5 " + b" ".join(b"%d" % v for v in bits.reshape(-1)) + b"\n")
    _check(b"P1\n11 5\n" + rows[:20] + b"\n# mid\n" + rows[20:] + b"\n")
    packed = np.packbits(bits, axis=1).tobytes()
    _check(b"P4\n11 5\n" + packed)
    _check(b"P4 # c\n11 # width\n5\n" + packed + b"trailing")
    img = _image((4, 6), 2)
    _check(b"P6\r\n6 4\r\n255\r" + img.tobytes())
    _check(b"P6\t6\t4\t255\t" + img.tobytes())
    _check(b"P5 # gray\n#another\n6 4 # size\n255\n" + img[:, :, 0].tobytes())
    values = img.reshape(-1)
    _check(b"P3\n6 4\n255\n" + b"  \n".join(b"%d" % v for v in values) + b"\n# tail\n")
    _check(b"P3\n6 4\n255\n" + b" ".join(b"%d" % v for v in values[:30]) + b"\n# mid\n"
           + b" ".join(b"%d" % v for v in values[30:]) + b"\n")


def test_pnm_cases_one_route_refuses():
    """Where one reference refuses and the other reads, the port follows
    each: an ASCII sample above maxval (cv2 clamps it; PIL refuses), a P1
    digit 2 (cv2 takes it for black), a sign or a comment glued to an
    ASCII sample and no byte after the last sample (cv2's number reader
    fails)."""
    _check(b"P2\n4 1\n100\n0 50 100 150\n", refused=("pil",), match="outside 0..100")
    _check(b"P2\n4 1\n1000\n0 500 1000 40000\n", refused=("pil",), match="outside")
    _check(b"P1\n4 1\n0201\n", refused=("pil",), match="other than 0 and 1")
    _check(b"P2\n4 1\n255\n+0 1 2 3\n", refused=("cv2",), match="not a number")
    _check(b"P2\n4 1\n255\n0 1#x\n2 3 4\n", refused=("cv2",), match="not a number")
    _check(b"P2\n4 1\n255\n0 1 2 3", refused=("cv2",), match="byte after")


def test_pnm_cases_both_refuse():
    """Truncated samples (binary and ASCII), maxval 0 and above 65535, a
    zero width, a magic glued to its header: both references refuse, and
    the port raises on both routes naming the case."""
    cases = {
        "ends early": b"P6\n4 2\n255\n" + bytes(12),
        "P4 data ends early": b"P4\n9 3\n" + bytes(5),
        "ASCII data ends early|data ends": b"P2\n4 2\n255\n1 2 3\n",
        "maxval 0|maxval 0": b"P5\n4 1\n0\n" + bytes(4),
        "maxval 65536": b"P6\n1 1\n65536\n" + bytes(6),
        "bad PNM size|size 0x1": b"P5\n0 1\n255\n",
        "magic|whitespace": b"P6#x\n4 1 255\n" + bytes(12),
    }
    for match, data in cases.items():
        _check(data, refused=("pil", "cv2"), match=match)


def _pam(w, h, depth, maxval, tupltype, samples) -> bytes:
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (w, h, depth, maxval)
    if tupltype:
        head += b"TUPLTYPE " + tupltype + b"\n"
    return head + b"ENDHDR\n" + samples


def test_pam_by_the_cv2_route():
    """PAM (P7), which PIL does not identify (the pil route raises): cv2's
    writer (gray, BGR), and by hand every tuple type at 8 and 16 bits,
    maxval below 255 kept as it is, maxval 1 as bits, comments and blank
    lines in the header. cv2's faults are kept: RGB's samples land in its
    BGR output as they are. The alpha types raise on the cv2 route: OpenCV
    fills the first width / depth pixels of a row and leaves the rest as
    its memory held it."""
    img = _image((9, 14), 3)
    for src in (img[:, :, 0], img):
        ok, enc = cv2.imencode(".pam", src)
        _check(enc.tobytes(), refused=("pil",), match="PIL cannot identify")
    rng = np.random.default_rng(4)
    w, h = 13, 3
    for depth, tupltype in ((2, b"GRAYSCALE_ALPHA"), (4, b"RGB_ALPHA")):
        data = _pam(w, h, depth, 255, tupltype, bytes(w * h * depth))
        assert _cv2(data) is not None and _pil(data) is None
        for route in pnm.ROUTES:
            with pytest.raises(ValueError, match="uninitialized|PIL cannot identify"):
                pnm.decode_pnm(data, route=route)
    for depth, tupltype in ((1, b"GRAYSCALE"), (3, b"RGB"), (1, None), (3, None)):
        for maxval in (255, 100, 65535, 1000):
            if tupltype is None and maxval > 255:
                continue
            samples = rng.integers(0, maxval + 1, (h, w * depth))
            raw = samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()
            _check(_pam(w, h, depth, maxval, tupltype, raw), refused=("pil",))
    bits = rng.integers(0, 256, (h, 16), dtype=np.uint8).tobytes()
    _check(_pam(16, h, 1, 1, b"BLACKANDWHITE", bits), refused=("pil",))
    _check(_pam(11, h, 1, 1, None, bits[:11 * h]), refused=("pil",))
    _check(b"P7\n# made by hand\n\nWIDTH   4\nHEIGHT 1  \nDEPTH 1\nMAXVAL 255\n"
           b"TUPLTYPE GRAYSCALE\nENDHDR\n" + bytes([0, 1, 2, 3]), refused=("pil",))
    _check(b"P7\rWIDTH 4\rHEIGHT 1\rDEPTH 1\rMAXVAL 255\rENDHDR\r" + bytes(4), refused=("pil",))


def test_pam_cases_cv2_refuses():
    """PAM headers OpenCV refuses: a lower-case TUPLTYPE, an unknown one or
    field, a TUPLTYPE whose depth differs, 16 bits or depth 2 without
    TUPLTYPE, ENDHDR followed by a space, truncated samples."""
    cases = {
        "TUPLTYPE b'grayscale'": _pam(4, 1, 1, 255, b"grayscale", bytes(4)),
        "TUPLTYPE b'FOO'": _pam(4, 1, 1, 255, b"FOO", bytes(4)),
        "at depth 3": _pam(4, 1, 3, 255, b"GRAYSCALE", bytes(12)),
        "without TUPLTYPE": _pam(4, 1, 1, 1000, None, bytes(8)),
        "depth 2, maxval 255 without": _pam(4, 1, 2, 255, None, bytes(8)),
        "ENDHDR not followed": b"P7\nWIDTH 4\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR \n" + bytes(4),
        "field b'FOO'": b"P7\nWIDTH 4\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nFOO 3\nENDHDR\n" + bytes(4),
        "PAM data ends early": _pam(4, 2, 1, 255, None, bytes(5)),
    }
    for match, data in cases.items():
        _check(data, refused=("pil", "cv2"), match=f"{match}|PIL cannot identify")


def test_pnm_through_decode_image_read_image_and_image_size(tmp_path):
    """decode_image sniffs P1-P7 by content, read_image_bgr reads a PNM
    page as PIL does, image_size is PIL's .size from the header and raises
    on PAM, which PIL does not identify."""
    img = _image((21, 34), 5)
    for name, data in (("a.ppm", _pil_bytes(Image.fromarray(img))),
                       ("b.pgm", _cv2_bytes(img[:, :, 0], ".pgm", 0)),
                       ("c.dat", _cv2_bytes((img[:, :, 0] > 99).astype(np.uint8) * 255, ".pbm"))):
        path = tmp_path / name
        path.write_bytes(data)
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(read_image_bgr(path), want[:, :, ::-1])
        np.testing.assert_array_equal(decode_image(data, route="cv2"), _cv2(data))
        assert image_size(path) == Image.open(path).size == (34, 21)
    ok, enc = cv2.imencode(".pam", img)
    (tmp_path / "d.pam").write_bytes(enc.tobytes())
    with pytest.raises(ValueError, match="PIL cannot identify"):
        image_size(tmp_path / "d.pam")
    np.testing.assert_array_equal(decode_image(enc.tobytes(), route="cv2"), _cv2(enc.tobytes()))
    with pytest.raises(ValueError, match="route"):
        pnm.decode_pnm(enc.tobytes(), route="tf")


def _pfm(magic: bytes, values: np.ndarray, scale: bytes = b"-1.0", header=None) -> bytes:
    """A PFM of (H, W) or (H, W, 3) floats, rows bottom-up, little-endian
    where the scale is negative (or nan)."""
    h, w = values.shape[:2]
    little = scale.startswith(b"-") or scale == b"nan"
    head = header if header is not None else magic + b"\n%d %d\n" % (w, h) + scale + b"\n"
    return head + values.astype("<f4" if little else ">f4")[::-1].tobytes()


def _check_pfm(data: bytes):
    """PIL reads Pf (mode F, each value cut toward zero into 0..255);
    cv2 reads PF (each value times 1 / |scale|, rounded half to even) and
    returns Pf as one channel, which the port's cv2 route refuses."""
    want_pil = _pil(data)
    try:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:  # an exception from the decoder is a refusal
        bgr = None
    if want_pil is None:
        with pytest.raises(ValueError):
            pnm.decode_pnm(data, route="pil")
    else:
        np.testing.assert_array_equal(pnm.decode_pnm(data, route="pil"), want_pil)
        assert pnm.pnm_size(data) == Image.open(io.BytesIO(data)).size
    if bgr is None or bgr.ndim == 2:
        with pytest.raises(ValueError):
            pnm.decode_pnm(data, route="cv2")
    else:
        np.testing.assert_array_equal(pnm.decode_pnm(data, route="cv2"), bgr[:, :, ::-1])
    return want_pil, bgr


@pytest.mark.parametrize("magic", [b"Pf", b"PF"], ids=["gray", "colour"])
def test_pfm_by_each_route(magic):
    """PFM at scales of either sign and size, with NaN, infinities, halves
    and values past 255 and past 2**31: PIL reads gray PFM only; cv2 reads
    both, the gray one as a single channel (not an (H, W, 3) page)."""
    rng = np.random.default_rng(len(magic) + magic[1])
    values = (rng.random((9, 13, 3)) * 320 - 30).astype(np.float32)
    values[0, :6, 0] = [np.nan, np.inf, -np.inf, 254.5, 0.5, 1e10]
    values = values[:, :, 0] if magic == b"Pf" else values
    outcomes = set()
    for scale in (b"-1.0", b"1.0", b"-3.5", b"2", b"-0.3", b"1e999", b"-inf", b"0", b"nan",
                  b"-1e-400", b"-1x"):
        pil, bgr = _check_pfm(_pfm(magic, values, scale))
        outcomes.add((pil is not None, None if bgr is None else bgr.ndim))
    assert outcomes == ({(True, 2), (False, 2), (False, None)} if magic == b"Pf"
                        else {(False, 3), (False, None)})


def test_pfm_headers():
    """Header forms each route parses its own way: cv2 wants a line feed
    right after the magic and reads each token up to one whitespace byte
    (a leading number, as std::stoi does); PIL reads tokens as for any
    PNM, comments too. A short body fails on both."""
    values = np.random.default_rng(5).random((4, 6, 3)).astype(np.float32) * 255
    for magic, v in ((b"Pf", values[:, :, 0]), (b"PF", values)):
        for head in (b"%s 6 4 -1\n", b"%s\r\n6 4\r\n-1\r\n", b"%s\n6  4\n-1\n",
                     b"%s\n# c\n6 4\n-1\n", b"%s\n6\t4\n-1\n", b"%s\n6.0 4\n-1\n",
                     b"%s\n0 4\n-1\n", b"%s\n6 4\n-1 "):
            _check_pfm(_pfm(magic, v, header=head % magic))
        _check_pfm(_pfm(magic, v)[:-3])
        _check_pfm(_pfm(magic, v) + b"more")


@pytest.mark.parametrize("magic", [b"P0CMYK", b"PyCMYK", b"PyRGBA", b"PyP"])
def test_pil_extension_magics(magic):
    """PIL's own magics: binary samples at maxvals 255, 100, 1000 and
    65535 (PIL scales by maxval), CMYK through PIL's cmyk2rgb, RGBA without
    its alpha, P black (no palette is read); a short body fails. cv2 reads
    none of them."""
    bands = 1 if magic == b"PyP" else 4
    px = np.random.default_rng(len(magic)).integers(0, 256, (5, 7, bands))
    for maxval in (255, 100, 1000, 65535):
        body = (np.minimum(px, maxval) if maxval < 256 else px * (maxval // 255))
        data = magic + b" 7 5 %d\n" % maxval + body.astype(
            ">u2" if maxval > 255 else np.uint8).tobytes()
        _check(data, refused=("cv2",))
    with pytest.raises(ValueError):
        pnm.decode_pnm(data[:-3], route="pil")

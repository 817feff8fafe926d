"""``tdnet_torch/data/hdr.py`` against ``cv2.imdecode(buf, IMREAD_COLOR)``,
the reference's decoder for serve bodies, byte for byte, on Radiance HDR
bodies from cv2's own encoder and from the test's writer (flat and
run-length scanlines, header variants, extreme exponents, damaged files).
Where cv2 refuses a body, the port's cv2 route raises ``ValueError``. PIL
cannot identify the format, so the file route (``read_image_bgr``,
``image_size``) refuses every one."""

import cv2
import numpy as np
import pytest

from tdnet_torch.data import hdr
from tdnet_torch.data.image import decode_image, image_size, read_image_bgr

HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"


def _cv2(data: bytes):
    try:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:  # an exception from the decoder is a refusal
        bgr = None
    return None if bgr is None else bgr[:, :, ::-1]


def _check(data: bytes, name: str = ""):
    want = _cv2(data)
    if want is None:
        with pytest.raises(ValueError):
            hdr.decode_hdr(data, route="cv2")
        return None
    got = decode_image(data, route="cv2")
    assert got.shape == want.shape and np.array_equal(got, want), name
    return got


def _rgbe(f: np.ndarray) -> np.ndarray:
    """(H, W, 3) floats -> Ward's RGBE bytes (H, W, 4)."""
    top = f.max(-1)
    lit = top > 1e-32
    e = np.ceil(np.log2(np.where(lit, top, 1.0))).astype(np.int64)
    m = np.clip(np.floor(f / np.exp2(e)[..., None] * 256), 0, 255)
    out = np.zeros(f.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.where(lit[..., None], m, 0)
    out[..., 3] = np.where(lit, e + 128, 0)
    return out


def _hdr(px: np.ndarray, header: bytes = HEADER, size: bytes = None, rle: bool = False,
         run: bool = False) -> bytes:
    """An HDR file of (H, W, 4) RGBE bytes: flat, or each scanline's
    channels as literal spans (``rle``) or as one run each (``run``)."""
    h, w = px.shape[:2]
    body = b""
    if not (rle or run):
        body = px.tobytes()
    else:
        for r in range(h):
            body += bytes([2, 2, w >> 8, w & 255])
            for c in range(4):
                if run:
                    body += bytes([128 + w, px[r, 0, c]])
                else:
                    line = px[r, :, c]
                    body += b"".join(bytes([len(line[s:s + 128])]) + line[s:s + 128].tobytes()
                                     for s in range(0, w, 128))
    return header + (size if size is not None else b"-Y %d +X %d\n" % (h, w)) + body


@pytest.fixture(scope="module")
def pixels():
    return _rgbe(np.random.default_rng(0).random((10, 12, 3)) * 2)


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (10, 12), (9, 130), (40, 57)])
def test_hdr_from_cv2_encoder(shape):
    """cv2's encoder (run-length scanlines from 8 pixels wide up, flat
    under); a ``page / 255`` body reads back within 2 of the page."""
    rng = np.random.default_rng(shape[1])
    for scale in (1.0, 3.0, 1e-3):
        ok, enc = cv2.imencode(".hdr", (rng.random(shape + (3,)) * scale).astype(np.float32))
        assert ok
        _check(enc.tobytes(), f"{shape} x{scale}")
    page = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    ok, enc = cv2.imencode(".hdr", page[:, :, ::-1].astype(np.float32) / 255)
    got = _check(enc.tobytes(), "page")
    assert np.abs(got.astype(int) - page).max() <= 2


HEADERS = {
    "RGBE signature": (b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n", None),
    "no signature": (b"FORMAT=32-bit_rle_rgbe\n\n", None),
    "other signature": (b"#?XYZ\nFORMAT=32-bit_rle_rgbe\n\n", None),
    "comments and exposure": (b"#?RADIANCE\n# a comment\nEXPOSURE=2.0\nGAMMA=1.5\n"
                              b"FORMAT=32-bit_rle_rgbe\n\n", None),
    "exposure after format": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=2\n\n", None),
    "blank line before format": (b"#?RADIANCE\n\nFORMAT=32-bit_rle_rgbe\n\n", None),
    "carriage returns": (b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n", None),
    "xyze": (b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n", None),
    "no blank line": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n", None),
    "long line": (b"#?RADIANCE\n" + b"x" * 200 + b"\nFORMAT=32-bit_rle_rgbe\n\n", None),
    "format after 127 bytes": (b"#?RADIANCE\n" + b"x" * 127 + b"FORMAT=32-bit_rle_rgbe\n\n",
                               None),
    "NUL line": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\0\n", None),
    "NUL line, then the blank one": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\0\n\n", None),
    "NUL line before the format": (b"#?RADIANCE\n\0x\nFORMAT=32-bit_rle_rgbe\n\n", None),
    "+Y": (HEADER, b"+Y 10 +X 12\n"),
    "-X": (HEADER, b"-Y 10 -X 12\n"),
    "X first": (HEADER, b"+X 12 -Y 10\n"),
    "spaces": (HEADER, b"-Y  10   +X  12\n"),
    "trailing words": (HEADER, b"-Y 10 +X 12 junk\n"),
    "no line feed": (HEADER, b"-Y 10 +X 12"),
    "signs": (HEADER, b"-Y +10 +X 12\n"),
    "hex": (HEADER, b"-Y 010 +X 0x0c\n"),
    "width missing": (HEADER, b"-Y 10\n"),
    "height 0": (HEADER, b"-Y 0 +X 12\n"),
}


@pytest.mark.parametrize("case", sorted(HEADERS))
def test_hdr_headers(pixels, case):
    """The header as OpenCV's ``rgbe.c`` reads it through ``fgets`` into
    128 bytes: the signature, the FORMAT line before the blank one, and
    ``sscanf("-Y %d +X %d")`` (the only orientation)."""
    header, size = HEADERS[case]
    _check(_hdr(pixels, header, size), case)


def test_hdr_scanlines(pixels):
    """Flat and run-length scanlines, runs, widths under 8 (always flat,
    even where the first pixel looks like a scanline header), a
    run-length scanline then flat ones, bytes after the data; refused: a
    scanline of the wrong width, a count of 0, data cut short."""
    rng = np.random.default_rng(1)
    narrow = _rgbe(rng.random((4, 7, 3)))
    narrow[0, 0] = [2, 2, 0, 7]
    later = pixels.copy()
    later[1, 0] = [1, 1, 1, 130]
    first = bytes([2, 2, 0, 12]) + b"".join(bytes([12]) + pixels[0, :, c].tobytes()
                                            for c in range(4))
    rle = _hdr(pixels, rle=True)
    at = rle.index(bytes([2, 2, 0, 12]))
    cases = {
        "flat": _hdr(pixels), "rle": rle, "runs": _hdr(np.repeat(pixels[:, :1], 12, 1), run=True),
        "width 7": _hdr(narrow), "rle then flat": _hdr(later)[:len(HEADER) + 12] + first
        + later[1:].tobytes(),
        "bytes after": _hdr(pixels) + b"junk", "wrong width": rle[:at + 3] + b"\x0b" + rle[at + 4:],
        "count 0": rle[:at + 4] + b"\0" + rle[at + 5:], "cut flat": _hdr(pixels)[:-10],
        "cut rle": rle[:-10],
    }
    refused = {k for k, v in cases.items() if _cv2(v) is None}
    assert refused == {"wrong width", "count 0", "cut flat", "cut rle"}
    for name, data in cases.items():
        _check(data, name)


def test_hdr_extreme_exponents():
    """Every exponent with bright, mid and dark mantissas: ``m * 2**(e -
    136) * 255`` rounded half to even, 0 for e = 0, and 0 from 2**31 up
    (cvRound overflows)."""
    px = np.zeros((2, 256, 4), np.uint8)
    px[0, :, :3] = [255, 128, 1]
    px[1, :, :3] = [3, 5, 7]
    px[:, :, 3] = np.arange(256)
    got = _check(_hdr(px))
    assert (got[:, 0] == 0).all() and (got[0, 255] == 0).all() and (got[0, 136] == 255).all()


FUZZ = [(12, 10), (7, 5), (40, 9)]


@pytest.mark.parametrize("shape", FUZZ, ids=[f"{w}x{h}" for w, h in FUZZ])
def test_damaged_files_read_or_refuse_as_the_reference(shape):
    """Random bit flips in cv2-encoded bodies (header, scanline heads,
    runs and literal spans, exponents): each reads as cv2 reads it or is
    refused where cv2 refuses it."""
    w, h = shape
    rng = np.random.default_rng(w)
    ok, enc = cv2.imencode(".hdr", (rng.random((h, w, 3)) * 3).astype(np.float32))
    enc = enc.tobytes()
    for i in range(24):
        d = bytearray(enc)
        for _ in range(int(rng.integers(1, 4))):
            d[int(rng.integers(10, len(d)))] ^= 1 << int(rng.integers(8))
        _check(bytes(d), f"{shape} #{i}")


def test_file_route_refuses_hdr(tmp_path, pixels):
    """PIL cannot identify Radiance HDR: ``read_image_bgr``, ``image_size``
    and the pil route refuse it; the cv2 route reads it."""
    data = _hdr(pixels, rle=True)
    path = tmp_path / "page.hdr"
    path.write_bytes(data)
    for call in (read_image_bgr, image_size):
        with pytest.raises(ValueError, match="PIL cannot identify"):
            call(path)
    with pytest.raises(ValueError, match="PIL cannot identify"):
        decode_image(data, route="pil")
    with pytest.raises(ValueError, match="route"):
        hdr.decode_hdr(data, route="libpng")
    assert decode_image(data, route="cv2").shape == (10, 12, 3)

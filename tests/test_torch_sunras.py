"""tdnet_torch.data.sunras against the reference's two decoders: each case
byte-equal to PIL's ``Image.open(...).convert("RGB")`` on the ``pil``
route (files, ``tdnet/data/image.py``) and to ``cv2.imdecode(...,
IMREAD_COLOR)[:, :, ::-1]`` on the ``cv2`` route (serve bodies,
``tdnet/bin/serve.py``); where a reference refuses a file, the port raises
on that route. The files come from cv2's writer and, for the types,
depths and colormaps it does not write, from a writer of the test's
own (its byte encoding as Sun's ``rle`` writes it)."""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import sunras
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
    """Both routes against their references (``refused``: the routes whose
    reference refuses, where the port raises matching ``match``)."""
    for route, oracle in (("pil", _pil), ("cv2", _cv2)):
        want = oracle(data)
        assert (want is None) == (route in refused), route
        if want is None:
            with pytest.raises(ValueError, match=match):
                sunras.decode_sunras(data, route=route)
            continue
        got = sunras.decode_sunras(data, route=route)
        assert got.shape == want.shape, (route, got.shape, want.shape)
        if not np.array_equal(got, want):
            diff = np.argwhere(got != want)
            pytest.fail(f"{route}: {len(diff)} samples differ, first at {diff[0].tolist()}")
    if "pil" not in refused:
        assert sunras.sunras_size(data) == Image.open(io.BytesIO(data)).size


def _rle(raw: bytes) -> bytes:
    """Sun's byte encoding: runs of 3 to 256 as 0x80 n v, a 0x80 byte as
    0x80 0, every other byte itself."""
    out, i = bytearray(), 0
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
    return bytes(out)


def _ras(pixels, depth, kind=1, colormap=None, map_type=None, padded_rle=False) -> bytes:
    """A Sun raster of (H, W) samples (or (H, W, depth / 8) bytes), rows
    padded to 16 bits (byte-encoded: rows of whole bytes, as PIL reads
    them, unless ``padded_rle``); ``colormap`` (n, 3) stored as planes."""
    pixels = np.asarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    if depth < 8:
        per = 8 // depth
        full = np.zeros((h, -(-w // per) * per), np.uint8)
        full[:, :w] = pixels
        packed = np.zeros((h, full.shape[1] // per), np.uint8)
        for j in range(per):
            packed |= full[:, j::per] << (8 - depth * (j + 1))
        rows = packed
    else:
        rows = pixels.reshape(h, -1)
    pad = rows.shape[1] % 2
    padded = np.concatenate([rows, np.zeros((h, pad), np.uint8)], axis=1)
    if kind == 2:
        data = _rle((padded if padded_rle else rows).tobytes())
    else:
        data = padded.tobytes()
    cmap = b"" if colormap is None else np.asarray(colormap, np.uint8).T.tobytes()
    kind_map = (1 if cmap else 0) if map_type is None else map_type
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind, kind_map,
                       len(cmap)) + cmap + data


RNG = np.random.default_rng(0)
TABLE = RNG.integers(0, 256, (256, 3))


@pytest.mark.parametrize("channels", [1, 3])
def test_sunras_from_cv2_writer(channels):
    """cv2's writer (standard type, 8-bit gray and 24-bit BGR) at odd widths;
    its 1x1 colour page has a length field of 4, which PIL's GIMP brush
    plugin claims (PIL fails on it, and the port's pil route raises)."""
    for shape in ((1, 1), (5, 7), (40, 57)):
        img = _image(shape, channels)
        src = img[:, :, 0] if channels == 1 else img[:, :, ::-1]
        data = cv2.imencode(".ras", np.ascontiguousarray(src))[1].tobytes()
        brush = shape == (1, 1) and channels == 3
        _check(data, refused=("pil",) if brush else (), match="GIMP brush")


def test_sunras_pages_pil_takes_for_gimp_brushes():
    """PIL tries its GIMP brush plugin before the Sun raster one: a page 1
    pixel wide whose length field is 1 or 4 opens as a brush (its .size the
    brush's, image_size too) and fails to load; width 2, or another
    length, reads as a Sun raster."""
    for width, height, depth, kind in ((1, 2, 8, 1), (1, 1, 8, 2), (1, 1, 24, 1), (1, 2, 1, 1),
                                       (2, 2, 8, 1), (1, 3, 8, 1), (1, 1, 32, 2)):
        n = max(depth // 8, 1)
        pixels = np.full((height, width, n) if n > 1 else (height, width), 7 if depth > 1 else 1)
        data = _ras(pixels, depth, kind)
        length = struct.unpack(">I", data[16:20])[0]
        refused = (("pil",) if width == 1 and length in (1, 4) else ()) + (
            ("cv2",) if kind == 2 else ())
        _check(data, refused=refused, match="GIMP brush|types 0 and 1")
        assert sunras.sunras_size(data) == Image.open(io.BytesIO(data)).size


@pytest.mark.parametrize("kind", [0, 1, 3, 4, 5])
@pytest.mark.parametrize("depth", [8, 24, 32])
def test_sunras_types_and_depths(depth, kind):
    """The plain types at 8, 24 and 32 bits, with an odd width (rows padded
    to 16 bits): the routes read 24 bits alike; at 32 they part (cv2 pad,
    blue, green, red; PIL blue, green, red, pad); type 3 is RGB for PIL,
    and cv2 refuses types 3 to 5."""
    n = depth // 8
    pixels = RNG.integers(0, 256, (5, 7, n)) if n > 1 else RNG.integers(0, 256, (5, 7))
    refused = () if kind in (0, 1) else ("cv2",)
    _check(_ras(pixels, depth, kind), refused=refused, match="types 0 and 1")


def test_sunras_colormaps_and_bitmaps():
    """8-bit pages through full and short colormaps, 4-bit pages (PIL only:
    gray scaled by 17, or indices), 1-bit pages (PIL: a set bit is black;
    cv2: white, or the colormap's second entry; PIL refuses a colormap at
    1 bit), widths that leave a partial byte."""
    idx = RNG.integers(0, 256, (6, 11))
    _check(_ras(idx, 8, colormap=TABLE))
    _check(_ras(idx % 16, 8, colormap=TABLE[:16]))
    _check(_ras(idx, 8, colormap=np.repeat(np.arange(256)[:, None], 3, axis=1)))
    _check(_ras(idx % 16, 4), refused=("cv2",), match="reads 1, 8, 24 and 32")
    _check(_ras(idx % 16, 4, colormap=TABLE[:16]), refused=("cv2",), match="reads 1, 8")
    bits = RNG.integers(0, 2, (6, 13))
    _check(_ras(bits, 1))
    _check(_ras(bits, 1, colormap=TABLE[:2]), refused=("pil",), match="colormap at|with a colormap")
    data = _ras(bits, 1)
    routes = [sunras.decode_sunras(data, r) for r in sunras.ROUTES]
    assert (routes[0] == 255 - routes[1]).all()


@pytest.mark.parametrize("depth", [1, 8, 24, 32])
def test_sunras_byte_encoded(depth):
    """Byte-encoded pages (type 2) of runs, literal 0x80 bytes and runs
    longer than a row: PIL's sun_rle decodes rows of whole bytes (a run
    crosses into the next row); cv2 refuses type 2. A stream of padded
    rows decodes as PIL reads it, shifted."""
    w = 13
    n = max(depth // 8, 1)
    base = RNG.integers(0, 2 if depth == 1 else 256, (7, w, n))
    base[1] = base[1, :1]  # a flat row
    base[2:4] = 0x80 if depth > 1 else 1  # two rows of 0x80 bytes: a run across rows
    pixels = base[:, :, 0] if n == 1 else base
    for padded in (False, True):
        _check(_ras(pixels, depth, kind=2, colormap=TABLE if depth == 8 else None,
                    padded_rle=padded), refused=("cv2",), match="types 0 and 1")


def test_sunras_cases_that_raise():
    """Both references refuse: depths 16 and 2, an unknown type, a raw
    colormap, data cut short, a colormap at 24 bits."""
    px = RNG.integers(0, 256, (4, 5))
    cases = {
        "at 16 bits": _ras(RNG.integers(0, 256, (4, 5, 2)), 16),
        "at 2 bits": _ras(px % 4, 2),
        "type 6": _ras(px, 8, kind=6),
        "colormap of type 2": _ras(px, 8, colormap=TABLE, map_type=2),
        "ends early": _ras(px, 8)[:-3],
    }
    for match, data in cases.items():
        _check(data, refused=("pil", "cv2"), match=f"{match}|reads|OpenCV|refuses")
    _check(_ras(RNG.integers(0, 256, (4, 5, 3)), 24, colormap=TABLE[:4]),
           refused=("pil", "cv2"), match="colormap")
    with pytest.raises(ValueError, match="route"):
        sunras.decode_sunras(_ras(px, 8), route="tf")


def test_sunras_through_decode_image_read_image_and_image_size(tmp_path):
    """decode_image and read_image_bgr take Sun raster pages by content,
    image_size reads PIL's .size from the header."""
    img = _image((21, 34), 6)
    for name, data in (("a.ras", cv2.imencode(".ras", img[:, :, ::-1])[1].tobytes()),
                       ("b.dat", _ras(RNG.integers(0, 256, (21, 34)), 8, kind=2,
                                      colormap=TABLE))):
        path = tmp_path / name
        path.write_bytes(data)
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(read_image_bgr(path), want[:, :, ::-1])
        np.testing.assert_array_equal(decode_image(data, route="pil"), want)
        assert image_size(path) == Image.open(path).size == (34, 21)

"""``tdnet_torch/data/png.py`` on animated PNG (APNG), EXIF and damaged
PNG streams against the reference's two decoders: PIL's
``Image.open(path).convert("RGB")`` (the file route) and
``cv2.imdecode(buf, IMREAD_COLOR)`` (the serve-body route), byte for byte.
Where a reference refuses a file, that route raises ``ValueError``;
``image_size`` equals PIL's ``.size`` (raising where PIL cannot open the
file). The files come from PIL's APNG writer and from the test's own
chunks (:func:`_apng`), which PIL's writer cannot make: offset and small
frames, dispose and blend ops, damaged counts, sequence numbers, chunk
sizes, CRCs and zlib streams.

cv2 5.0 crashes (a segmentation fault) on two inputs: an ``fdAT`` of under
4 bytes and a bad row filter in an ``fdAT`` frame. Those are held to a
refusal of the port's without calling cv2."""

import io
import struct
import warnings
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import png
from tdnet_torch.data.image import decode_image, image_size
from tdnet_torch.data.jpeg import _orient

W, H = 20, 16
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
UNINITIALIZED = "uninitialized"  # the port's refusal where cv2 reads memory it never wrote


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _rows(px: np.ndarray, depth: int = 8, bad_filter_row=None) -> bytes:
    """Filter-0 rows of (h, w, c) samples at the bit depth."""
    h = px.shape[0]
    if depth == 16:
        rows = px.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth < 8:
        bits = np.unpackbits(px.reshape(h, -1, 1).astype(np.uint8), axis=2)[..., 8 - depth:]
        rows = np.packbits(bits.reshape(h, -1), axis=1)
    else:
        rows = px.reshape(h, -1)
    filt = np.zeros((h, 1), np.uint8)
    if bad_filter_row is not None:
        filt[bad_filter_row] = 9
    return np.concatenate([filt, rows], 1).tobytes()


def _fctl(seq, w, h, x=0, y=0, dispose=0, blend=0) -> bytes:
    return _chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, x, y, 1, 10, dispose, blend))


def _apng(color, depth, idat, frames, default_image=True, num=None, before=b"",
          first_fctl=None, ihdr=None):
    """IHDR, acTL, ``before``, then the IDAT image (a frame when
    ``default_image`` is false, with ``first_fctl`` or a whole-canvas
    fcTL), then each (samples, x, y, dispose, blend) frame as fcTL + fdAT.
    Frames and the IDAT image may be given as zlib bytes."""
    h, w = idat.shape[:2] if isinstance(idat, np.ndarray) else (H, W)
    out = png.SIGNATURE + _chunk(b"IHDR", ihdr or struct.pack(">IIBBBBB", w, h, depth, color,
                                                              0, 0, 0))
    count = len(frames) + (0 if default_image else 1) if num is None else num
    out += _chunk(b"acTL", struct.pack(">II", count, 0)) + before
    seq = 0
    if not default_image:
        out += first_fctl if first_fctl is not None else _fctl(seq, w, h)
        seq += 1
    out += _chunk(b"IDAT", idat if isinstance(idat, bytes) else zlib.compress(_rows(idat, depth)))
    for px, x, y, dispose, blend in frames:
        fw, fh = (px.shape[1], px.shape[0]) if isinstance(px, np.ndarray) else (w, h)
        data = px if isinstance(px, bytes) else zlib.compress(_rows(px, depth))
        out += _fctl(seq, fw, fh, x, y, dispose, blend)
        out += _chunk(b"fdAT", struct.pack(">I", seq + 1) + data)
        seq += 2
    return out + _chunk(b"IEND", b"")


def _still(px, color=2, depth=8, before=b"", after=b"", idat=None):
    h, w = px.shape[:2]
    return (png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + before
            + _chunk(b"IDAT", idat if idat is not None else zlib.compress(_rows(px, depth)))
            + after + _chunk(b"IEND", b""))


def _references(data: bytes):
    pil = size = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            im = Image.open(io.BytesIO(data))
            size = im.size
            pil = np.asarray(im.convert("RGB"))
        except Exception:  # noqa: BLE001 - any failure is PIL's refusal
            pass
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return pil, None if bgr is None else bgr[:, :, ::-1], size


def _check(data: bytes, name: str = "", allow_uninitialized: bool = False):
    """Both routes equal their references (a refusal raising) and
    ``png_size`` equals PIL's ``.size``. With ``allow_uninitialized`` the
    cv2 route may refuse a file cv2 reads, where the port's message says
    the frame holds pixels cv2 leaves uninitialized."""
    pil, cv, size = _references(data)
    for route, want in (("pil", pil), ("cv2", cv)):
        if want is None:
            with pytest.raises(ValueError):
                png.decode_png(data, route=route)
            continue
        if route == "cv2" and allow_uninitialized:
            try:
                got = png.decode_png(data, route=route)
            except ValueError as e:
                assert UNINITIALIZED in str(e), (name, str(e))
                continue
        else:
            got = png.decode_png(data, route=route)
        assert got.shape == want.shape and np.array_equal(got, want), (name, route)
    if size is None:
        with pytest.raises(ValueError):
            png.png_size(data)
    else:
        assert png.png_size(data) == size, name
    return pil, cv


@pytest.fixture(scope="module")
def pages():
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, 256, (H, W, 4), dtype=np.uint8) for k in "vfg"}


def _pil_apng(frames, mode, **kw) -> bytes:
    buf = io.BytesIO()
    ims = [Image.fromarray(f, mode) for f in frames]
    ims[0].save(buf, "PNG", save_all=True, append_images=ims[1:], **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
@pytest.mark.parametrize("default_image", [True, False])
def test_apng_from_pil_reads_as_each_reference(mode, default_image):
    """C10: with ``default_image`` the IDAT image is not a frame, and cv2
    returns the first fcTL frame where PIL returns the IDAT image."""
    rng = np.random.default_rng(1)
    shape = {"RGB": (37, 53, 3), "RGBA": (30, 40, 4), "L": (30, 40), "P": (30, 40)}[mode]
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(3)]
    data = _pil_apng(frames, mode, default_image=default_image)
    pil, cv = _check(data, mode)
    if mode == "RGB":
        assert np.array_equal(pil, frames[0]) and np.array_equal(cv, frames[int(default_image)])


def _structures(p):
    v, f, g = p["v"], p["f"], p["g"]
    fr = [(f, 0, 0, 0, 0), (g, 0, 0, 0, 0)]
    b = _apng(6, 8, v, fr)
    k = b.index(b"fdAT") - 4
    n = struct.unpack(">I", b[k:k + 4])[0]
    fd = b[k + 8:k + 8 + n]
    j = b.index(b"acTL") - 4
    i2 = b.index(b"fcTL", b.index(b"fdAT")) - 4
    n2 = struct.unpack(">I", b[i2:i2 + 4])[0]

    def second_fctl(fn):
        return b[:i2] + _chunk(b"fcTL", fn(b[i2 + 8:i2 + 8 + n2])) + b[i2 + 12 + n2:]

    rows = _rows(f)
    cases = {
        "default image": b,
        "IDAT is the first frame": _apng(6, 8, v, fr[:1], default_image=False),
        "one frame counted": _apng(6, 8, v, fr, num=1),
        "no frame counted": _apng(6, 8, v, fr, num=0),
        "five frames counted": _apng(6, 8, v, fr, num=5),
        "count past 2**31": _apng(6, 8, v, fr, num=0x80000001),
        "small offset frame": _apng(6, 8, v, [(f[:7, :9], 3, 5, 0, 0), fr[1]]),
        "frame past the canvas": _apng(6, 8, v, [(f[:8, :10], 15, 10, 0, 0), fr[1]]),
        "dispose previous, blend over": _apng(6, 8, v, [(f, 0, 0, 2, 1), fr[1]]),
        "dispose op 3": _apng(6, 8, v, [(f, 0, 0, 3, 0), fr[1]]),
        "blend op 2": _apng(6, 8, v, [(f, 0, 0, 0, 2), fr[1]]),
        "second frame past the canvas": _apng(6, 8, v, [fr[0], (g, 5, 5, 0, 0)]),
        "third frame past the canvas": _apng(6, 8, v, fr + [(g, 5, 5, 0, 0)]),
        "IDAT frame with sequence 1": _apng(6, 8, v, fr[:1], default_image=False,
                                            first_fctl=_fctl(1, W, H)),
        "IDAT frame box smaller": _apng(6, 8, v, fr[:1], default_image=False,
                                        first_fctl=_fctl(0, W - 3, H - 2)),
        "IDAT frame box offset": _apng(6, 8, v, fr[:1], default_image=False,
                                       first_fctl=_fctl(0, W - 3, H - 2, 2, 1)),
        "IDAT frame box past the canvas": _apng(6, 8, v, fr[:1], default_image=False,
                                                first_fctl=_fctl(0, W, H, 2, 1)),
        "IDAT frame of width 0": _apng(6, 8, v, fr[:1], default_image=False,
                                       first_fctl=_fctl(0, 0, H)),
        "IDAT frame of height 0": _apng(6, 8, v, fr[:1], default_image=False,
                                        first_fctl=_fctl(0, W, 0)),
        "IDAT frame dispose op 3": _apng(6, 8, v, fr[:1], default_image=False,
                                         first_fctl=_fctl(0, W, H, 0, 0, 3, 0)),
        "IDAT frame short fcTL": _apng(6, 8, v, fr[:1], default_image=False,
                                       first_fctl=_chunk(b"fcTL", _fctl(0, W, H)[8:28])),
        "IDAT frame long fcTL": _apng(6, 8, v, fr[:1], default_image=False,
                                      first_fctl=_chunk(b"fcTL", _fctl(0, W, H)[8:34] + b"xx")),
        "IDAT frame box, one frame counted": _apng(6, 8, v, fr[:1], default_image=False, num=1,
                                                   first_fctl=_fctl(0, W - 3, H - 2, 2, 1)),
        "short acTL": b[:j] + _chunk(b"acTL", b"\0\0\0\2") + b[j + 20:],
        "long acTL": b[:j] + _chunk(b"acTL", b"\0\0\0\2" + bytes(6)) + b[j + 20:],
        "two acTL": b[:j + 20] + _chunk(b"acTL", struct.pack(">II", 1, 0)) + b[j + 20:],
        "second fcTL short": second_fctl(lambda s: s[:20]),
        "second fcTL of width 0": second_fctl(lambda s: s[:4] + bytes(4) + s[8:]),
        "first frame fcTL short": b[:b.index(b"fcTL") - 4] + _chunk(b"fcTL", _fctl(0, W, H)[8:28])
        + b[b.index(b"fcTL") + 30:],
        "first frame of width 0": _apng(6, 8, v, [(np.zeros((H, 0, 4), np.uint8), 0, 0, 0, 0),
                                                  fr[1]]),
        "cut after the first fdAT": b[:i2],
        "IEND after the first fdAT": b[:i2] + _chunk(b"IEND", b""),
        "tEXt inside the frame": b[:i2] + _chunk(b"tEXt", b"a\0b") + b[i2:],
        "fdAT split": b[:k] + _chunk(b"fdAT", fd[:4] + fd[4:100])
        + _chunk(b"fdAT", fd[:4] + fd[100:]) + b[k + 12 + n:],
        "frame data in an IDAT": b[:k] + _chunk(b"IDAT", fd[4:]) + b[k + 12 + n:],
        "no fdAT": b[:k] + b[k + 12 + n:],
        "frame zlib cut": b[:k] + _chunk(b"fdAT", fd[:-30]) + b[k + 12 + n:],
        "frame zlib past the rows": b[:k] + _chunk(b"fdAT", fd + b"junkjunk") + b[k + 12 + n:],
        "frame adler32 cut": _apng(6, 8, v, [(zlib.compress(rows)[:-4], 0, 0, 0, 0), fr[1]]),
        "frame ends early": _apng(6, 8, v, [(zlib.compress(rows[:3 * (W * 4 + 1)]), 0, 0, 0, 0),
                                            fr[1]]),
        "frame stream broken at row 3": _apng(6, 8, v, [(_broken(rows, 3 * (W * 4 + 1)), 0, 0, 0,
                                                         0), fr[1]]),
        "IDAT image cut": _apng(6, 8, zlib.compress(_rows(v))[:-40], fr),
        "IDAT image broken": _apng(6, 8, b"garbage!", fr),
        "IDAT image bad filter": _apng(6, 8, zlib.compress(_rows(v, bad_filter_row=5)), fr),
        "IDAT frame bad filter": _apng(6, 8, zlib.compress(_rows(v, bad_filter_row=5)), fr[:1],
                                       default_image=False),
    }
    for kind in (b"acTL", b"IDAT", b"fcTL", b"fdAT", b"IEND", b"IHDR"):
        bad = bytearray(b)
        at = b.index(kind) + 4 + struct.unpack(">I", b[b.index(kind) - 4:b.index(kind)])[0]
        bad[at] ^= 0x55
        cases[f"{kind.decode()} CRC"] = bytes(bad)
    return cases


def _broken(rows: bytes, at: int) -> bytes:
    """A zlib stream of ``rows[:at]`` stored, then an invalid block."""
    c = zlib.compressobj(0)
    return c.compress(rows[:at]) + c.flush(zlib.Z_SYNC_FLUSH) + b"\xff\xff\xff\xff"


STRUCTURES = [
    "default image", "IDAT is the first frame", "one frame counted", "no frame counted",
    "five frames counted", "count past 2**31", "small offset frame", "frame past the canvas",
    "dispose previous, blend over", "dispose op 3", "blend op 2", "second frame past the canvas",
    "third frame past the canvas", "IDAT frame with sequence 1", "IDAT frame box smaller",
    "IDAT frame box offset", "IDAT frame box past the canvas", "IDAT frame of width 0",
    "IDAT frame of height 0", "IDAT frame dispose op 3", "IDAT frame short fcTL",
    "IDAT frame long fcTL", "IDAT frame box, one frame counted", "short acTL", "long acTL",
    "two acTL", "second fcTL short", "second fcTL of width 0", "first frame fcTL short",
    "first frame of width 0", "cut after the first fdAT", "IEND after the first fdAT",
    "tEXt inside the frame", "fdAT split", "frame data in an IDAT", "no fdAT", "frame zlib cut",
    "frame zlib past the rows", "frame adler32 cut", "frame ends early",
    "frame stream broken at row 3", "IDAT image cut", "IDAT image broken",
    "IDAT image bad filter", "IDAT frame bad filter", "acTL CRC", "IDAT CRC", "fcTL CRC",
    "fdAT CRC", "IEND CRC", "IHDR CRC"]


@pytest.mark.parametrize("case", STRUCTURES)
def test_apng_structures_read_or_refuse_as_each_reference(pages, case):
    """Hand-made APNG structures, each probed on both references first:
    how cv2 places a first frame, what it checks of each fcTL and acTL,
    where a frame ends, and which zlib damage it takes; PIL's sequence
    checks and the box an fcTL before the IDAT gives."""
    _check(_structures(pages)[case], case)


def test_apng_stream_errors_keep_the_rows_cv2_keeps(pages):
    """A frame whose zlib stream breaks keeps the rows libpng wrote before
    the break (the row that the failing zlib call filled is lost) and the
    IDAT image's rows below them; where the IDAT image is itself the frame,
    those rows are uninitialized in OpenCV and the port refuses."""
    v, f, g = pages["v"][..., :3], pages["f"][..., :3], pages["g"][..., :3]
    rows = _rows(f)
    stride = W * 3 + 1
    for at in (0, 3, 15):
        data = _apng(2, 8, v, [(_broken(rows, at * stride), 0, 0, 0, 0), (g, 0, 0, 0, 0)])
        got = png.decode_png(data, route="cv2")
        keep = max(at - 1, 0)
        assert np.array_equal(got[:keep], f[:keep]) and np.array_equal(got[keep:], v[keep:])
        _check(data, f"broken at {at}")
        idat_frame = _apng(2, 8, _broken(_rows(v), at * stride), [(g, 0, 0, 0, 0)],
                           default_image=False)
        with pytest.raises(ValueError, match=UNINITIALIZED):
            png.decode_png(idat_frame, route="cv2")
    small = f[:8, :10]
    data = _apng(2, 8, v, [(_broken(_rows(small), 2 * 31), 3, 4, 0, 0), (g, 0, 0, 0, 0)])
    _check(data, "small frame broken")


@pytest.mark.parametrize("color,depth", [(0, 1), (0, 4), (0, 16), (2, 16), (3, 2), (3, 8),
                                         (4, 16), (6, 16)])
def test_apng_colour_types_and_depths(color, depth):
    """Every colour type through cv2's animation path, where 16-bit samples
    become ``(v + 127) // 255`` and not the high byte; one frame counted
    reads a still image with the high byte."""
    rng = np.random.default_rng(color * 17 + depth)
    top = 1 << depth
    dtype = np.uint16 if depth == 16 else np.uint8
    v, f = (rng.integers(0, top, (H, W, _CHANNELS[color])).astype(dtype) for _ in range(2))
    before = b""
    if color == 3:
        before = _chunk(b"PLTE", rng.integers(0, 256, 3 * top, dtype=np.uint8).tobytes())
        before += _chunk(b"tRNS", rng.integers(0, 256, top // 2, dtype=np.uint8).tobytes())
    for frames, num in (([(f, 0, 0, 0, 0), (f, 0, 0, 0, 0)], None), ([(f, 0, 0, 0, 0)], 1)):
        _check(_apng(color, depth, v, frames, before=before, num=num), f"{color}/{depth} {num}")


def test_apng_interlaced_frames():
    """Adam7 frames, a small offset one too, on both routes."""
    rng = np.random.default_rng(5)
    v, f, g = (rng.integers(0, 256, (H, W, 4), dtype=np.uint8) for _ in range(3))

    def adam7(px):
        out = b""
        for y0, x0, dy, dx in png._ADAM7:
            sub = px[y0::dy, x0::dx]
            if sub.size:
                out += _rows(sub)
        return zlib.compress(out)

    for first in (f, f[:7, :9]):
        data = _apng(6, 8, adam7(v), [(adam7(first), 3, 2, 0, 0), (adam7(g), 0, 0, 0, 0)])
        data = data.replace(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 6, 0, 0, 0)),
                            _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 6, 0, 0, 1)))
        data = data.replace(_fctl(1, W, H, 3, 2), _fctl(1, first.shape[1], first.shape[0], 3, 2))
        _check(data, f"adam7 {first.shape}")


def test_apng_inputs_that_crash_cv2_are_refused(pages):
    """cv2 5.0 crashes on these, so the port refuses them and cv2 is not
    called: an fdAT of under 4 bytes and a bad row filter in an fdAT
    frame. PIL reads both (its IDAT image)."""
    v, f, g = pages["v"], pages["f"], pages["g"]
    b = _apng(6, 8, v, [(f, 0, 0, 0, 0), (g, 0, 0, 0, 0)])
    k = b.index(b"fdAT") - 4
    n = struct.unpack(">I", b[k:k + 4])[0]
    short = b[:k] + _chunk(b"fdAT", b[k + 8:k + 11]) + b[k + 12 + n:]
    bad = _apng(6, 8, v, [(zlib.compress(_rows(f, bad_filter_row=3)), 0, 0, 0, 0),
                          (g, 0, 0, 0, 0)])
    for data in (short, bad):
        with pytest.raises(ValueError):
            png.decode_png(data, route="cv2")
        assert np.array_equal(png.decode_png(data, route="pil"), v[..., :3])


def _exif(orientation, order=b"MM"):
    e = ">" if order == b"MM" else "<"
    return (order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHI", 0x0112, 3, 1) + struct.pack(e + "H", orientation)
            + bytes(6))


@pytest.mark.parametrize("order", [b"MM", b"II"])
def test_png_exif_orientation_on_the_cv2_route(order):
    """C11: cv2 turns a PNG by its eXIf chunk's orientation, before or after
    the IDAT; PIL does not."""
    rng = np.random.default_rng(6)
    page = rng.integers(0, 256, (30, 44, 3), dtype=np.uint8)
    for orientation in range(10):
        ex = _chunk(b"eXIf", _exif(orientation, order))
        for data in (_still(page, before=ex), _still(page, after=ex)):
            pil, cv = _check(data, f"orientation {orientation}")
            assert np.array_equal(pil, page)
            want = _orient(page, orientation) if 1 <= orientation <= 8 else page
            assert np.array_equal(cv, want)


def test_png_exif_cases():
    """PIL's own eXIf; two eXIf chunks (the first counts); an eXIf with
    a bad CRC, an ``Exif`` prefix or under 4 bytes (ignored); "Raw profile
    type exif" text chunks (not read); an animation (not turned); and a
    gray page."""
    rng = np.random.default_rng(7)
    page = rng.integers(0, 256, (30, 44, 3), dtype=np.uint8)
    exif = Image.Exif()
    exif[0x0112] = 6
    buf = io.BytesIO()
    Image.fromarray(page).save(buf, "PNG", exif=exif)
    six, three = _chunk(b"eXIf", _exif(6)), _chunk(b"eXIf", _exif(3))
    bad_crc = bytearray(six)
    bad_crc[-1] ^= 1
    hexed = b"\nexif\n%8d\n" % (len(_exif(6)) + 6) + (b"Exif\0\0" + _exif(6)).hex().encode() + b"\n"
    cases = {
        "PIL's": buf.getvalue(),
        "two": _still(page, before=six + three),
        "before and after": _still(page, before=six, after=three),
        "bad CRC": _still(page, before=bytes(bad_crc)),
        "Exif prefix": _still(page, before=_chunk(b"eXIf", b"Exif\0\0" + _exif(6))),
        "3 bytes": _still(page, before=_chunk(b"eXIf", _exif(6)[:3])),
        "tEXt": _still(page, before=_chunk(b"tEXt", b"Raw profile type exif\0" + hexed)),
        "zTXt": _still(page, before=_chunk(b"zTXt", b"Raw profile type exif\0\0"
                                           + zlib.compress(hexed))),
        "animation": _apng(2, 8, page, [(page, 0, 0, 0, 0), (page, 0, 0, 0, 0)], before=six),
        "one frame counted": _apng(2, 8, page, [(page, 0, 0, 0, 0)], before=six, num=1),
        "gray": _still(page[..., :1], color=0, before=six),
    }
    for name, data in cases.items():
        _check(data, name)
    turned = png.decode_png(cases["PIL's"], route="cv2")
    assert turned.shape == (44, 30, 3)


def test_png_stream_and_chunk_rules():
    """Still pages: a zlib stream that ends early (PIL keeps the rows it
    has), ends inside a row, or has a bad checksum in its own chunk or the
    next; no IEND; bytes after it; IDAT runs split by another chunk; a
    second IHDR; unknown critical chunks; CRCs each route checks."""
    rng = np.random.default_rng(8)
    page = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    rows = _rows(page)
    stride = W * 4 + 1
    full = zlib.compress(rows)
    bad_adler = full[:-2] + bytes([full[-2] ^ 0xFF, full[-1]])
    base = _still(page, color=6, after=_chunk(b"tEXt", b"c\0d"))
    iend = base.index(b"IEND") - 4
    ihdr = _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 6, 0, 0, 0))
    cases = {
        "ends 3 rows early": _still(page, 6, idat=zlib.compress(rows[:-3 * stride])),
        "ends inside a row": _still(page, 6, idat=zlib.compress(rows[:-3 * stride + 10])),
        "cut": _still(page, 6, idat=full[:-20]),
        "past the rows": _still(page, 6, idat=zlib.compress(rows + bytes(2 * stride))),
        "bad adler32": _still(page, 6, idat=bad_adler),
        "bad adler32 in the next IDAT": (_still(page, 6, idat=bad_adler[:-4])[:-12]
                                         + _chunk(b"IDAT", bad_adler[-4:]) + _chunk(b"IEND", b"")),
        "bad zlib header": _still(page, 6, idat=b"\x9c\x78" + full[2:]),
        "bad filter": _still(page, 6, idat=zlib.compress(_rows(page, bad_filter_row=5))),
        "no IEND": base[:iend],
        "cut inside tEXt": base[:iend - 5],
        "junk after IEND": base + b"junkjunk",
        "IDAT after a tEXt": base[:iend] + _chunk(b"IDAT", b"xx") + base[iend:],
        "IDAT split by a tEXt": _still(page, 6, idat=full[:50])[:-12] + _chunk(b"tEXt", b"a\0b")
        + _chunk(b"IDAT", full[50:]) + _chunk(b"IEND", b""),
        "second IHDR": _still(page, 6, before=ihdr),
        "unknown critical chunk": _still(page, 6, after=_chunk(b"ABCD", b"xx")),
        "IEND with a body": base[:iend] + _chunk(b"IEND", b"abc"),
        "interlace byte 2": base.replace(ihdr, _chunk(b"IHDR", ihdr[8:20] + b"\2")),
        "compression byte 1": base.replace(ihdr, _chunk(b"IHDR", ihdr[8:18] + b"\1\0\0")),
    }
    for kind in (b"IHDR", b"tEXt", b"IDAT", b"IEND"):
        bad = bytearray(base)
        at = base.index(kind) + 4 + struct.unpack(">I", base[base.index(kind) - 4:
                                                               base.index(kind)])[0]
        bad[at] ^= 0x55
        cases[f"{kind.decode()} CRC"] = bytes(bad)
    for name, data in cases.items():
        _check(data, name)


FUZZ_BASES = ["default image", "IDAT frame", "small frame", "gray 16", "palette 4", "exif still"]


def _fuzz_base(name, rng):
    w, h = 13, 9
    v, f, g = (rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for _ in range(3))
    if name == "default image":
        return _apng(6, 8, v, [(f, 0, 0, 0, 0), (g, 0, 0, 0, 0)])
    if name == "IDAT frame":
        return _apng(6, 8, v, [(f, 0, 0, 0, 0)], default_image=False)
    if name == "small frame":
        return _apng(2, 8, v[..., :3], [(f[:5, :7, :3], 2, 3, 1, 1), (g[..., :3], 0, 0, 0, 0)])
    if name == "gray 16":
        v16 = rng.integers(0, 65536, (h, w, 1)).astype(np.uint16)
        return _apng(0, 16, v16, [(v16, 0, 0, 0, 0), (v16, 0, 0, 0, 0)])
    if name == "palette 4":
        p = rng.integers(0, 16, (h, w, 1)).astype(np.uint8)
        return _apng(3, 4, p, [(p, 0, 0, 0, 0), (p, 0, 0, 0, 0)],
                     before=_chunk(b"PLTE", rng.integers(0, 256, 48, dtype=np.uint8).tobytes()))
    return _still(v[..., :3], before=_chunk(b"eXIf", _exif(6)))


def _chunk_spans(data):
    spans, pos = [], 8
    while pos + 8 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        spans.append((pos, n))
        pos += 12 + n
    return spans


def _bad_frame_filter(data) -> bool:
    """Whether the first fdAT frame after a non-frame IDAT image holds a
    row with a bad filter (cv2 crashes on one)."""
    spans = [(data[p + 4:p + 8], data[p + 8:p + 8 + n]) for p, n in _chunk_spans(data)]
    width, height, depth, color = struct.unpack(">IIBB", spans[0][1][:10])
    if color not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        return False
    state, stream = 0, b""
    for kind, body in spans:
        if kind == b"IDAT" and state == 0:
            state = 1
        elif kind == b"fcTL" and state == 1:
            state, (width, height) = 2, struct.unpack(">II", body[4:12])
        elif kind == b"fcTL":
            break
        elif state == 2 and kind in (b"fdAT", b"IDAT"):
            stream += body[4:] if kind == b"fdAT" else body
    if state != 2:
        return False
    z, out = zlib.decompressobj(), b""
    for i in range(len(stream)):
        try:
            out += z.decompress(stream[i:i + 1])
        except zlib.error:
            break
    stride = (width * _CHANNELS[color] * depth + 7) // 8 + 1
    return any(out[r * stride] > 4 for r in range(min(height, len(out) // stride)))


@pytest.mark.parametrize("base", FUZZ_BASES)
def test_damaged_files_read_or_refuse_as_each_reference(base):
    """Random bit flips inside chunk bodies with the CRCs made good again
    (so the damage reaches the fields and streams, not the checksums),
    held to both references: frame counts and boxes, dispose and blend
    ops, sequence numbers, IHDR's depth, colour type and interlace bytes,
    zlib streams of the IDAT image and the frames, EXIF. IHDR's size is
    left alone (cv2 crashes on some damaged sizes), and so is a file whose
    first fdAT frame has a bad row filter (the port must refuse it: cv2
    crashes). Where cv2's frame holds rows it never wrote, the port's
    refusal names them."""
    rng = np.random.default_rng(FUZZ_BASES.index(base))
    data = _fuzz_base(base, rng)
    spans = _chunk_spans(data)
    for i in range(30):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            pos, n = spans[int(rng.integers(len(spans)))]
            if n == 0:
                continue
            at = pos + 8 + int(rng.integers(n))
            if data[pos + 4:pos + 8] == b"IHDR" and at < pos + 16:
                continue
            d[at] ^= 1 << int(rng.integers(8))
        for pos, n in spans:
            crc = zlib.crc32(bytes(d[pos + 4:pos + 8 + n])) & 0xFFFFFFFF
            d[pos + 8 + n:pos + 12 + n] = struct.pack(">I", crc)
        d = bytes(d)
        if _bad_frame_filter(d):
            with pytest.raises(ValueError):
                png.decode_png(d, route="cv2")
            continue
        _check(d, f"{base} #{i}", allow_uninitialized=True)


def test_decode_image_and_image_size_take_apng(tmp_path, pages):
    """``decode_image`` reaches the APNG rules on both routes, and
    ``image_size`` raises where PIL cannot open the file."""
    data = _apng(6, 8, pages["v"], [(pages["f"], 0, 0, 0, 0), (pages["g"], 0, 0, 0, 0)])
    assert np.array_equal(decode_image(data, route="cv2"), pages["f"][..., :3])
    assert np.array_equal(decode_image(data, route="pil"), pages["v"][..., :3])
    path = tmp_path / "a.png"
    path.write_bytes(data)
    assert image_size(path) == (W, H)
    path.write_bytes(_apng(6, 8, pages["v"], [(pages["f"], 0, 0, 0, 0)], default_image=False,
                           first_fctl=_fctl(0, W, H, 2, 1)))
    with pytest.raises(ValueError, match="invalid frames"):
        image_size(path)

"""tdnet_torch.data.gif against the reference's two decoders: each case
byte-equal to PIL's ``Image.open(...).convert("RGB")`` on the ``pil``
route (files, ``tdnet/data/image.py``) and to ``cv2.imdecode(...,
IMREAD_COLOR)[:, :, ::-1]`` on the ``cv2`` route (serve bodies,
``tdnet/bin/serve.py``); where a reference refuses a file, the port raises
on that route. The files come from PIL's and cv2's writers and, for the
layouts they do not write (offset frames, local tables, transparency by
hand, code sizes, screens a frame overruns), from a writer of the test's
own."""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import gif
from tdnet_torch.data.image import decode_image, image_size, read_image_bgr


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 0).reshape(img.shape)


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
    reference refuses the file, where the port raises matching
    ``match``), and gif_size against PIL's .size."""
    for route, oracle in (("pil", _pil), ("cv2", _cv2)):
        want = oracle(data)
        assert (want is None) == (route in refused), route
        if want is None:
            with pytest.raises(ValueError, match=match):
                gif.decode_gif(data, route=route)
            continue
        got = gif.decode_gif(data, route=route)
        assert got.shape == want.shape, (route, got.shape, want.shape)
        if not np.array_equal(got, want):
            diff = np.argwhere(got != want)
            pytest.fail(f"{route}: {len(diff)} samples differ, first at {diff[0].tolist()}")
    if "pil" not in refused:
        assert gif.gif_size(data) == Image.open(io.BytesIO(data)).size


# --- a GIF writer of the test's own


def _lzw(indices: bytes, m: int) -> bytes:
    """GIF LZW as encoders write it: LSB-first codes from m + 1 bits, a
    clear code first, a bit wider when the next code passes a power of
    two, a clear code when the table is full."""
    clear, end = 1 << m, (1 << m) + 1
    out, acc, nbits, width = bytearray(), 0, 0, m + 1

    def put(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    table, nxt = {bytes([i]): i for i in range(clear)}, end + 1
    put(clear)
    w = b""
    for b in indices:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        if nxt < 4096:
            table[wc], nxt = nxt, nxt + 1
            if nxt > 1 << width and width < 12:
                width += 1
        else:
            put(clear)
            table, nxt, width = {bytes([i]): i for i in range(clear)}, end + 1, m + 1
        w = bytes([b])
    put(table[w])
    nxt += 1
    if nxt > 1 << width and width < 12:
        width += 1
    put(end)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def _table_bytes(table):
    bits = max(1, (len(table) - 1).bit_length())
    full = np.zeros((1 << bits, 3), np.uint8)
    full[:len(table)] = table
    return bits, full.tobytes()


def _gif(frames, screen, table=None, background=0, version=b"GIF89a", extensions=b""):
    """A GIF of ``frames`` (dicts: idx (h, w) indices, x, y, local table,
    interlace, transparent, min_code) on a screen of (width, height)."""
    flags, head = 0, b""
    if table is not None:
        bits, head = _table_bytes(table)
        flags = 0x80 | ((bits - 1) << 4) | (bits - 1)
    out = version + struct.pack("<HHBBB", *screen, flags, background, 0) + head + extensions
    for f in frames:
        idx = np.asarray(f["idx"], np.uint8)
        h, w = idx.shape
        t = f.get("transparent")
        if t is not None:
            out += b"!\xf9\x04\x01\x00\x00" + bytes([t]) + b"\x00"
        lflags, local = 0, b""
        if f.get("local") is not None:
            bits, local = _table_bytes(f["local"])
            lflags = 0x80 | (bits - 1)
        if f.get("interlace"):
            lflags |= 0x40
            idx = idx[np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                      np.arange(2, h, 4), np.arange(1, h, 2)])]
        out += b"," + struct.pack("<HHHHB", f.get("x", 0), f.get("y", 0), w, h, lflags) + local
        m = f.get("min_code") or max(2, int(idx.max()).bit_length())
        out += bytes([m]) + _blocks(_lzw(idx.tobytes(), m))
    return out + b";"


def _pil_gif(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "GIF", **kw)
    return buf.getvalue()


RNG = np.random.default_rng(0)
TABLE = RNG.integers(0, 256, (16, 3)).astype(np.uint8)
GRAY = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, axis=1)


@pytest.mark.parametrize("case", ["P", "P_flat", "L", "1", "two_frames", "transparency",
                                  "adaptive", "cv2", "cv2_gray"])
def test_gif_from_the_writers(case):
    """What PIL writes (web palette, interlaced or not, gray, bilevel, two
    frames, a transparent index, an adaptive palette) and what cv2 writes."""
    img = _image((40, 57), len(case))
    im = Image.fromarray(img)
    if case == "cv2":
        data = cv2.imencode(".gif", img[:, :, ::-1])[1].tobytes()
    elif case == "cv2_gray":
        data = cv2.imencode(".gif", np.repeat(img[:, :, :1], 3, axis=2))[1].tobytes()
    elif case == "two_frames":
        data = _pil_gif(im.convert("P"), save_all=True, append_images=[im.rotate(90)])
    elif case == "transparency":
        data = _pil_gif(im.convert("P"), transparency=int(np.asarray(im.convert("P"))[0, 0]))
    elif case == "adaptive":
        data = _pil_gif(im.convert("P", palette=Image.Palette.ADAPTIVE, colors=16))
    elif case == "P_flat":
        data = _pil_gif(im.convert("P"), interlace=False)
    else:
        data = _pil_gif(im.convert(case))
    _check(data)


def test_gif_lzw_code_sizes_interlace_and_tables():
    """Minimum code sizes 2 to 8, interlaced heights 1 to 17 (every pass
    short or empty), long runs that fill the 4096-code table, GIF87a,
    local tables over a global one and alone, identity gray tables (PIL
    reads the page as gray) and no table at all, skipped extensions."""
    for m in range(2, 9):
        idx = RNG.integers(0, 1 << min(m, 4), (9, 13)).astype(np.uint8)
        _check(_gif([dict(idx=idx, min_code=m)], (13, 9), TABLE))
    for h in range(1, 18):
        idx = RNG.integers(0, 16, (h, 5)).astype(np.uint8)
        _check(_gif([dict(idx=idx, interlace=True)], (5, h), TABLE))
    runs = np.zeros((120, 300), np.uint8)
    runs[30:90, 40:260] = 1
    runs[::7] = RNG.integers(0, 16, 300)
    _check(_gif([dict(idx=runs)], (300, 120), TABLE))
    noise = RNG.integers(0, 256, (64, 80)).astype(np.uint8)
    _check(_gif([dict(idx=noise)], (80, 64), RNG.integers(0, 256, (256, 3))))
    idx = RNG.integers(0, 16, (7, 9)).astype(np.uint8)
    _check(_gif([dict(idx=idx)], (9, 7), TABLE, version=b"GIF87a"))
    _check(_gif([dict(idx=idx, local=TABLE[::-1])], (9, 7), TABLE))
    _check(_gif([dict(idx=idx, local=TABLE)], (9, 7)))
    _check(_gif([dict(idx=idx)], (9, 7), GRAY))
    _check(_gif([dict(idx=idx, local=GRAY)], (9, 7), TABLE))
    _check(_gif([dict(idx=idx)], (9, 7)))
    comment = b"!\xfe" + _blocks(b"scanned page") + b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    _check(_gif([dict(idx=idx)], (9, 7), TABLE, extensions=comment))


def test_gif_offset_frames_and_transparency():
    """A first frame smaller than the screen at an offset (PIL fills the
    rest with index 0, or the transparent index; cv2 with the background
    colour, black without a global table), transparent pixels (PIL draws
    them, cv2 leaves the background: the routes part), and a frame that
    reaches past the screen (PIL grows the screen, and .size with it; cv2
    refuses)."""
    idx = RNG.integers(0, 16, (7, 9)).astype(np.uint8)
    for kw in ({}, {"transparent": 3}, {"transparent": 0}):
        _check(_gif([dict(idx=idx, x=3, y=2, **kw)], (15, 12), TABLE, background=5))
        _check(_gif([dict(idx=idx, x=2, y=1, local=TABLE, **kw)], (12, 9), background=5))
        _check(_gif([dict(idx=idx, **kw)], (9, 7), TABLE, background=5))
    data = _gif([dict(idx=idx, transparent=int(idx[0, 0]))], (9, 7), TABLE, background=5)
    routes = [gif.decode_gif(data, r).astype(int) for r in gif.ROUTES]
    assert (routes[0] != routes[1]).any()
    past = _gif([dict(idx=idx, x=3, y=2)], (8, 6), TABLE)
    _check(past, refused=("cv2",), match="reaches past its screen")
    assert gif.gif_size(past) == (12, 9)


def test_gif_indices_past_the_table():
    """Indices past the colour table: PIL paints them black (gray where
    the table is the identity), cv2 refuses them, except where a local
    table lies over a longer global one (the global entries stay in use);
    a background index past the global table (cv2 refuses)."""
    idx = RNG.integers(0, 8, (7, 9)).astype(np.uint8)
    idx[0, :2] = 6, 7
    _check(_gif([dict(idx=idx, min_code=3)], (9, 7), TABLE[:4]), refused=("cv2",),
           match="past its colour table")
    _check(_gif([dict(idx=idx, min_code=3, local=TABLE[:4])], (9, 7), TABLE[8:]))
    _check(_gif([dict(idx=idx, min_code=3, local=TABLE[:4])], (9, 7)), refused=("cv2",),
           match="past its colour table")
    wide = np.full((2, 3), 20, np.uint8)
    _check(_gif([dict(idx=wide, min_code=5, local=GRAY)], (3, 2)), refused=("cv2",),
           match="past its colour table")
    _check(_gif([dict(idx=idx % 4)], (9, 7), TABLE, background=200), refused=("cv2",),
           match="background index 200")


def test_gif_cases_that_raise():
    """Files both references refuse raise on both routes, naming the
    case: data cut short, an LZW code size of 1, no image."""
    idx = RNG.integers(0, 16, (7, 9)).astype(np.uint8)
    cases = {
        "truncated GIF|ends after": _gif([dict(idx=idx)], (9, 7), TABLE)[:-12],
        "code size 1": _gif([dict(idx=idx % 2, min_code=1)], (9, 7), TABLE[:2]),
        "without an image": _gif([], (9, 7), TABLE),
    }
    for match, data in cases.items():
        _check(data, refused=("pil", "cv2"), match=match)
    with pytest.raises(ValueError, match="route"):
        gif.decode_gif(_gif([dict(idx=idx)], (9, 7), TABLE), route="tf")


def test_gif_through_decode_image_read_image_and_image_size(tmp_path):
    """decode_image and read_image_bgr take GIF pages by their content,
    image_size is PIL's .size (the grown screen of an overrunning
    frame)."""
    idx = RNG.integers(0, 16, (7, 9)).astype(np.uint8)
    for name, data in (("a.gif", _pil_gif(Image.fromarray(_image((21, 34), 1)).convert("P"))),
                       ("b.dat", _gif([dict(idx=idx, x=3, y=2)], (8, 6), TABLE))):
        path = tmp_path / name
        path.write_bytes(data)
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(read_image_bgr(path), want[:, :, ::-1])
        assert image_size(path) == Image.open(path).size
        np.testing.assert_array_equal(decode_image(data, route="pil"), want)
    assert image_size(tmp_path / "b.dat") == (12, 9)

"""tdnet_torch.data.tga against the reference's file route: each case
byte-equal to PIL's ``Image.open(...).convert("RGB")`` (``tdnet/data/
image.py``) and ``image_size`` equal to PIL's ``.size``; where PIL
refuses a file the port raises, and the serve route (``cv2.imdecode``,
which returns None) refuses every TGA. The files come from PIL's TGA
writer and, for the layouts it does not write (colour maps with an offset
or 16-bit entries, 16-bit pixels, the orientation flags, packets that
cross rows), from the test's own header writer. The helpers here serve
the other formats' tests too."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import image as port_image
from tdnet_torch.data import tga


def pil_bytes(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def pil_rgb(data: bytes):
    """PIL's ``convert("RGB")`` and ``.size``, or None where it refuses."""
    try:
        im = Image.open(io.BytesIO(data))
        return np.asarray(im.convert("RGB")), im.size
    except Exception:  # noqa: BLE001 (any refusal: PIL raises many kinds)
        return None


def assert_as_pil(data: bytes, decode=None, size=None):
    """The port's file route (``decode_image``, or ``decode`` and ``size``
    of one module) equals PIL's decode and size, or raises where PIL does;
    returns whether PIL read the file."""
    decode = decode or (lambda d: port_image.decode_image(d, route="pil"))
    want = pil_rgb(data)
    if want is None:
        with pytest.raises(ValueError):
            decode(data)
        return False
    got = decode(data)
    assert got.dtype == np.uint8 and got.shape == want[0].shape, (got.shape, want[0].shape)
    if not np.array_equal(got, want[0]):
        diff = np.argwhere((got != want[0]).any(axis=2))
        pytest.fail(f"{len(diff)} pixels differ, first at {diff[0].tolist()}: "
                    f"{got[tuple(diff[0])]} vs {want[0][tuple(diff[0])]}")
    if size is not None:
        assert tuple(size(data)) == tuple(want[1])
    return True


def assert_read_image_equal(tmp_path, data: bytes, name: str, body_match="OpenCV cannot read it"):
    """The port's ``read_image_bgr`` and ``image_size`` of a file equal
    ``tdnet.data.image.read_image_bgr`` and PIL's size, exactly; cv2
    refuses the body, and so does the port's serve route."""
    from tdnet.data.image import read_image_bgr as reference

    path = tmp_path / name
    path.write_bytes(data)
    got, want = port_image.read_image_bgr(path), reference(path)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert tuple(port_image.image_size(path)) == Image.open(path).size
    assert_body_refused(data, body_match)


def assert_body_refused(data: bytes, match="OpenCV cannot read it"):
    """``cv2.imdecode`` returns None for the body, and the port's serve
    route refuses it, naming the format (or, where cv2 takes the body for
    another format, that format's fault)."""
    import cv2

    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match=match):
        port_image.decode_image(data, route="cv2")


def page(shape, seed, channels=3):
    """A small smooth page of ``shape`` (H, W)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(yy * 9 + xx * 5) % 256, (xx * 11) % 256, (yy * 13 + 40) % 256,
                     (yy * 7 + xx * 3 + 100) % 256], axis=2)
    noise = rng.integers(0, 2, (h, w, 4))
    return (base + noise).astype(np.uint8)[:, :, :channels]


def tga_file(pixels: bytes, w, h, kind, depth, map_type=0, cmap=b"", start=0, length=0,
             map_depth=0, flags=0, ident=b"") -> bytes:
    header = struct.pack("<BBBHHBHHHHBB", len(ident), map_type, kind, start, length,
                         map_depth, 0, 0, w, h, depth, flags)
    return header + ident + cmap + pixels


def _decode(d):
    return tga.decode_tga(d, route="pil")


@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1"])
@pytest.mark.parametrize("orientation", [-1, 1], ids=["bottom_up", "top_down"])
def test_tga_from_pil_equals_pil(mode, rle, orientation):
    im = Image.fromarray(page((13, 17), 1))
    im = im.quantize(37) if mode == "P" else im.convert(mode)
    data = pil_bytes(im, "TGA", compression="tga_rle" if rle else None, orientation=orientation)
    read = assert_as_pil(data, _decode, tga.tga_size)
    assert read != (rle and mode == "1")  # 1-bit RLE never finishes in PIL


def _rle_rows(rows: np.ndarray, size: int, runs=True) -> bytes:
    """Run-length packets for each row on its own."""
    out = bytearray()
    for row in rows:
        px = row.reshape(-1, size)
        i = 0
        while i < len(px):
            run = 1
            while runs and i + run < len(px) and run < 128 and (px[i + run] == px[i]).all():
                run += 1
            if run > 1:
                out += bytes([0x80 | (run - 1)]) + px[i].tobytes()
            else:
                out += bytes([0]) + px[i].tobytes()
            i += run
    return bytes(out)


@pytest.mark.parametrize("depth", [16, 24, 32])
@pytest.mark.parametrize("kind", [2, 10])
@pytest.mark.parametrize("flags", [0x00, 0x10, 0x20, 0x30, 0x28])
def test_tga_true_colour_depths_and_orientation(depth, kind, flags):
    rng = np.random.default_rng(depth + kind + flags)
    w, h = 7, 5
    px = rng.integers(0, 256, (h, w * depth // 8), dtype=np.uint8)
    px[:, :depth // 8 * 3] = px[:1, :depth // 8 * 3]  # some runs
    body = _rle_rows(px, depth // 8) if kind == 10 else px.tobytes()
    assert assert_as_pil(tga_file(body, w, h, kind, depth, flags=flags), _decode, tga.tga_size)


@pytest.mark.parametrize("map_depth", [16, 24])
@pytest.mark.parametrize("kind", [1, 9])
@pytest.mark.parametrize("start,length", [(0, 256), (3, 20), (250, 6), (0, 0)])
def test_tga_colour_maps_with_an_offset(map_depth, kind, start, length):
    rng = np.random.default_rng(start + length)
    w, h = 9, 4
    cmap = rng.integers(0, 256, length * map_depth // 8, dtype=np.uint8).tobytes()
    index = rng.integers(0, 256, (h, w), dtype=np.uint8)
    body = _rle_rows(index, 1) if kind == 9 else index.tobytes()
    data = tga_file(body, w, h, kind, 8, 1, cmap, start, length, map_depth,
                    ident=b"an ID field")
    assert assert_as_pil(data, _decode, tga.tga_size)


def test_tga_gray_with_a_colour_map_is_looked_up_and_gray_alpha_too():
    cmap = bytes(range(30, 90))
    for depth, body in ((8, bytes(range(12))), (16, bytes(range(24)))):
        data = tga_file(body, 4, 3, 3, depth, 1, cmap, 2, 20, 24)
        assert assert_as_pil(data, _decode, tga.tga_size)
    assert assert_as_pil(tga_file(bytes([0b10110000, 0, 0b01000000]), 3, 3, 3, 1), _decode)


def test_tga_packets_across_rows():
    """A literal packet may run on into the next row (and past the last
    row, where it is cut); a run may not cross a row's end (PIL: buffer
    overrun)."""
    literal = tga_file(bytes([0x05]) + bytes(range(6)), 2, 3, 11, 8)
    assert assert_as_pil(literal, _decode)
    cut = tga_file(bytes([0x07]) + bytes(range(8)), 2, 3, 11, 8)
    assert assert_as_pil(cut, _decode)
    run = tga_file(bytes([0x82, 7, 0x00, 9]), 2, 2, 11, 8)
    assert not assert_as_pil(run, _decode)
    with pytest.raises(ValueError, match="crosses the end of a row"):
        _decode(run)


@pytest.mark.parametrize("case", [
    "no_map_type1", "map_depth_15", "map_depth_32", "too_many_entries", "rgb_with_map",
    "depth_15", "type_3_depth_24", "rle_1_bit", "raw_short", "rle_short", "map_short",
    "type_0", "bomb"])
def test_tga_refusals_equal_pil(case):
    cmap = bytes(range(6))
    data = {
        "no_map_type1": tga_file(bytes(4), 2, 2, 1, 8),
        "map_depth_15": tga_file(bytes(4), 2, 2, 1, 8, 1, cmap, 0, 3, 15),
        "map_depth_32": tga_file(bytes(4), 2, 2, 1, 8, 1, bytes(12), 0, 3, 32),
        "too_many_entries": tga_file(bytes(4), 2, 2, 1, 8, 1, bytes(30), 250, 10, 24),
        "rgb_with_map": tga_file(bytes(12), 2, 2, 2, 24, 1, cmap, 0, 2, 24),
        "depth_15": tga_file(bytes(8), 2, 2, 2, 15),
        "type_3_depth_24": tga_file(bytes(12), 2, 2, 3, 24),
        "rle_1_bit": tga_file(bytes([0x81, 0xFF]), 2, 2, 11, 1),
        "raw_short": tga_file(bytes(3), 2, 2, 3, 8),
        "rle_short": tga_file(bytes([0x81, 7]), 2, 2, 11, 8),
        "map_short": tga_file(b"", 2, 2, 1, 8, 1, bytes(5), 0, 4, 24),
        "type_0": tga_file(bytes(4), 2, 2, 0, 8),
        "bomb": tga_file(b"", 65535, 65535, 3, 8),
    }[case]
    assert not assert_as_pil(data)
    if case in ("map_depth_15", "depth_15", "type_0"):  # PIL passes these on
        assert not tga.is_tga(data)


def test_tga_read_image_equals_reference(tmp_path):
    im = Image.fromarray(page((21, 30), 2)).quantize(64)
    data = pil_bytes(im, "TGA", compression="tga_rle")
    assert_read_image_equal(tmp_path, data, "page.tga")

"""tdnet_torch.data.ico against PIL's ``Image.open(...).convert("RGB")``
and ``.size`` (the reference's file route): PIL's own ICO files (PNG
frames, and BMP frames with ``bitmap_format="bmp"``) and directories of
the test's own around PNG and BMP frames (1, 4, 8, 24 and 32 bits, an AND
mask), for PIL's choice of frame (the largest; of those, the lowest colour
depth; then the first; a 0 in the directory meaning 256), a frame whose
own size differs from its entry's, and the frames PIL fails on; cv2
refuses ICO."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import ico
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal, page, pil_bytes

pytestmark = pytest.mark.filterwarnings("ignore:Image was not the expected size")


def dib_frame(im: Image.Image, mask=True) -> bytes:
    """``im`` as a BMP without its file header, its height doubled and an
    AND mask after the pixels."""
    dib = bytearray(pil_bytes(im, "BMP")[14:])
    w, h = im.size
    dib[8:12] = struct.pack("<i", 2 * h)
    return bytes(dib) + (bytes(-(-w // 32) * 4 * h) if mask else b"")


def ico_file(frames) -> bytes:
    """frames: (entry width, entry height, bpp, colours, data)."""
    out = struct.pack("<HHH", 0, 1, len(frames))
    at, blob = 6 + 16 * len(frames), b""
    for w, h, bpp, colours, data in frames:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colours, 0, 1, bpp, len(data),
                           at + len(blob))
        blob += data
    return out + blob


def _decode(d):
    return ico.decode_ico(d, route="pil")


@pytest.mark.parametrize("bitmap_format", ["png", "bmp"])
def test_ico_from_pil_equals_pil(bitmap_format):
    im = Image.fromarray(page((48, 48), 9, 4))
    data = pil_bytes(im, "ICO", sizes=[(16, 16), (32, 32), (48, 48)],
                     bitmap_format=bitmap_format)
    assert assert_as_pil(data, _decode, ico.ico_size)


@pytest.mark.parametrize("mode", ["1", "P16", "P", "RGB", "RGBA"])
def test_ico_bmp_frames_of_each_depth(mode):
    im = Image.fromarray(page((13, 20), 10, 4))
    im = {"1": lambda: im.convert("1"), "P16": lambda: im.convert("RGB").quantize(16),
          "P": lambda: im.convert("RGB").quantize(200), "RGB": lambda: im.convert("RGB"),
          "RGBA": lambda: im}[mode]()
    bpp = {"1": 1, "P16": 4, "P": 8, "RGB": 24, "RGBA": 32}[mode]
    data = ico_file([(20, 13, bpp, 0, dib_frame(im))])
    assert assert_as_pil(data, _decode, ico.ico_size)


def test_ico_frame_choice_and_sizes():
    """The largest entry wins; of equal ones the lowest depth (the entry's
    bits, else from its colour count), then the first; 0 means 256; the
    PNG's own size is the image's."""
    big = pil_bytes(Image.fromarray(page((40, 30), 11)), "PNG")
    small = pil_bytes(Image.fromarray(page((8, 8), 12)), "PNG")
    other = pil_bytes(Image.fromarray(page((30, 40), 13)), "PNG")
    for frames in ([(8, 8, 32, 0, small), (0, 0, 32, 0, big)],
                   [(30, 40, 32, 0, big), (30, 40, 8, 0, other)],
                   [(30, 40, 0, 16, big), (30, 40, 0, 0, other)],
                   [(30, 40, 0, 1, big), (30, 40, 8, 0, other)],
                   [(30, 40, 24, 0, big), (30, 40, 24, 0, other)]):
        assert assert_as_pil(ico_file(frames), _decode, ico.ico_size)


@pytest.mark.parametrize("case", ["no_mask", "alpha_short", "no_entries", "short_directory",
                                  "frame_outside", "bad_header"])
def test_ico_refusals_equal_pil(case):
    im = Image.fromarray(page((8, 8), 14)).quantize(16)
    frame = dib_frame(im)
    data = {"no_mask": ico_file([(8, 8, 8, 0, dib_frame(im, mask=False))])[:-8],
            "alpha_short": ico_file([(8, 8, 32, 0, frame)]),
            "no_entries": struct.pack("<HHH", 0, 1, 0),
            "short_directory": ico_file([(8, 8, 8, 0, frame)])[:15],
            "frame_outside": ico_file([(8, 8, 8, 0, frame)])[:22],
            "bad_header": ico_file([(8, 8, 8, 0, b"\x07" + frame[1:])])}[case]
    assert not assert_as_pil(data)
    assert ico.is_ico(data) == (case not in ("no_entries", "short_directory"))


def test_ico_read_image_equals_reference(tmp_path):
    big = pil_bytes(Image.fromarray(page((30, 41), 15)), "PNG")
    small = dib_frame(Image.fromarray(page((16, 16), 16)).quantize(100))
    assert_read_image_equal(tmp_path, ico_file([(0, 0, 32, 0, big), (16, 16, 8, 0, small)]),
                            "page.ico")


# --- CUR (CurImagePlugin): the first entry unless a later one is larger in
# both of its size bytes, a bitmap at its offset, its height halved


def cur_file(frames) -> bytes:
    """frames: (entry width, entry height, data)."""
    out = struct.pack("<HHH", 0, 2, len(frames))
    at, blob = 6 + 16 * len(frames), b""
    for w, h, data in frames:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, 1, len(data), at + len(blob))
        blob += data
    return out + blob


def _cur(d):
    from tdnet_torch.data import cur

    return cur.decode_cur(d, route="pil")


def _cur_size(d):
    from tdnet_torch.data import cur

    return cur.cur_size(d)


@pytest.mark.parametrize("mode", ["1", "P16", "P", "RGB", "RGBA"])
def test_cur_bitmaps_of_each_depth(mode):
    im = Image.fromarray(page((11, 19), 20, 4))
    im = {"1": lambda: im.convert("1"), "P16": lambda: im.convert("RGB").quantize(16),
          "P": lambda: im.convert("RGB").quantize(200), "RGB": lambda: im.convert("RGB"),
          "RGBA": lambda: im}[mode]()
    data = cur_file([(19, 11, dib_frame(im))])
    assert assert_as_pil(data, _cur, _cur_size)
    assert Image.open(io.BytesIO(data)).format == "CUR"


def test_cur_entry_choice():
    """A later entry wins only where both its size bytes are larger; the
    AND mask is neither read nor checked."""
    a = dib_frame(Image.fromarray(page((8, 8), 21)).quantize(100), mask=False)
    b = dib_frame(Image.fromarray(page((12, 16), 22)).convert("RGB"))
    for frames in ([(8, 8, a), (16, 12, b)], [(16, 12, b), (8, 8, a)],
                   [(8, 8, a), (16, 8, b)], [(0, 0, a), (16, 12, b)]):
        assert assert_as_pil(cur_file(frames), _cur, _cur_size)


@pytest.mark.parametrize("case,opens", [("no_entries", False), ("short_entry", False),
                                        ("bitmap_outside", False), ("one_row", False),
                                        ("bad_header", True), ("short_pixels", True)])
def test_cur_refusals_and_files_passed_on(case, opens):
    from tdnet_torch.data import cur

    frame = dib_frame(Image.fromarray(page((8, 8), 23)).convert("RGB"))
    one = bytearray(frame)
    one[8:12] = struct.pack("<i", 1)
    data = {"no_entries": struct.pack("<HHH", 0, 2, 0) + bytes(20),
            "short_entry": cur_file([(8, 8, frame)])[:20],
            "bitmap_outside": cur_file([(8, 8, frame)])[:24],
            "one_row": cur_file([(8, 8, bytes(one))]),
            "bad_header": cur_file([(8, 8, b"\x07" + frame[1:])]),
            "short_pixels": cur_file([(8, 8, frame[:60])])}[case]
    assert not assert_as_pil(data)
    assert cur.is_cur(data) == opens


def test_cur_read_image_equals_reference(tmp_path):
    frame = dib_frame(Image.fromarray(page((24, 20), 24)).convert("RGB"))
    assert_read_image_equal(tmp_path, cur_file([(20, 24, frame)]), "page.cur")

"""tdnet_torch.data.bmp on RLE-compressed BMP (BI_RLE8, BI_RLE4) against
the reference's two decoders: PIL's ``convert("RGB")`` (files, route
``pil``) and ``cv2.imdecode(..., IMREAD_COLOR)`` (serve bodies, route
``cv2``). Neither encoder here writes RLE, so the files are built by hand:
a writer of the test's own for the headers, an encoder for whole pages,
and byte streams for the escapes (delta, absolute mode, early end of line
and of bitmap) and for the streams on which the two references part."""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import bmp
from tdnet_torch.data.image import image_size, read_image_bgr


def _rle_bmp(stream: bytes, width: int, height: int, rle4: bool, palette=None,
             top_down=False, gap=0) -> bytes:
    """A BMP with a 40-byte header, the palette (16 or 256 entries unless
    given) and the RLE stream, ``gap`` bytes after the palette."""
    bits = 4 if rle4 else 8
    if palette is None:
        rng = np.random.default_rng(bits)
        palette = rng.integers(0, 256, (1 << bits, 3))
    info = struct.pack("<IiiHHIIiiII", 40, width, -height if top_down else height, 1, bits,
                       2 if rle4 else 1, len(stream), 2835, 2835, len(palette), 0)
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in np.asarray(palette, np.uint8))
    offset = 14 + len(info) + len(pal) + gap
    return (b"BM" + struct.pack("<IHHI", offset + len(stream), 0, 0, offset) + info + pal
            + bytes(gap) + stream)


def _encode_rle(index: np.ndarray, rle4: bool, rng) -> bytes:
    """An RLE stream of (H, W) palette indices, rows bottom-up: encoded
    runs where a row repeats (RLE4: two alternating indices), absolute runs
    of 3 or more pixels elsewhere (RLE4: an even number), an end of line after each row and an end
    of bitmap after the last."""
    out = bytearray()
    for r, row in enumerate(index[::-1]):
        row, x, w = row.tolist(), 0, len(row)
        while x < w:
            pair = row[x:x + 2] if rle4 else row[x:x + 1]
            run = 1
            while x + run < w and run < 255 and row[x + run] == pair[run % len(pair)]:
                run += 1
            if run >= 3 or x + run == w or rng.random() < 0.5:
                hi = row[x] if not rle4 else (row[x] << 4) | (row[x + 1] if run > 1 else 0)
                out += bytes([run, hi])
                x += run
                continue
            n = min(w - x, int(rng.integers(3, 12)))
            n -= n & rle4  # PIL drops the last pixel of an odd RLE4 run
            if n < 3:
                out += bytes([1, row[x] << 4 if rle4 else row[x]])
                x += 1
                continue
            chunk = row[x:x + n]
            if rle4:
                padded = chunk + [0] * (n & 1)
                body = bytes((a << 4) | b for a, b in zip(padded[0::2], padded[1::2]))
            else:
                body = bytes(chunk)
            out += bytes([0, n]) + body + bytes(len(body) & 1)
            x += n
        out += b"\x00\x01" if r == len(index) - 1 else b"\x00\x00"
    return bytes(out)


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _cv2(data: bytes):
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[:, :, ::-1]


def _check_routes(data: bytes):
    """Each route equals its reference, or raises where the reference fails;
    returns whether each reference decoded."""
    decoded = []
    for route, oracle in (("pil", _pil), ("cv2", _cv2)):
        try:
            want = oracle(data)
        except (OSError, ValueError):
            want = None
        if want is None:
            with pytest.raises(ValueError):
                bmp.decode_bmp(data, route=route)
        else:
            np.testing.assert_array_equal(bmp.decode_bmp(data, route=route), want, err_msg=route)
        decoded.append(want is not None)
    return decoded


_PAL4 = [(10, 20, 30), (200, 0, 0), (0, 200, 0), (0, 0, 200)]
_PAL16 = [(i * 15, 255 - i * 15, i * 70 % 256) for i in range(16)]
_C8 = bytes([3, 1, 3, 2, 0, 0, 2, 3, 4, 0, 0, 0, 6, 1, 0, 0, 0, 1])

# name: (stream, width, height, RLE4, palette, other header arguments,
#        (PIL decodes, cv2 decodes))
STREAMS = {
    # ROADMAP C8's page: 6x3, bottom-up rows (3,1)(3,2) / (2,3)(4,0) / (6,1)
    "rle8_6x3": (_C8, 6, 3, False, _PAL4, {}, (True, True)),
    "rle8_without_end_of_bitmap": (_C8[:-2], 6, 3, False, _PAL4, {}, (True, True)),
    "rle8_top_down": (_C8, 6, 3, False, _PAL4, {"top_down": True}, (True, True)),
    "rle8_gray_palette": (_C8, 6, 3, False, [(i, i, i) for i in range(256)], {}, (True, True)),
    # an end of line after 2 pixels: the other 4 take palette entry 0
    "rle8_early_end_of_line": (bytes([2, 1, 0, 0, 2, 3, 4, 0, 0, 0, 6, 1, 0, 1]), 6, 3, False,
                               _PAL4, {}, (True, True)),
    "rle8_delta": (bytes([1, 1, 0, 2, 2, 1, 3, 2, 0, 0, 6, 3, 0, 1]), 6, 3, False, _PAL4, {},
                   (True, True)),
    "rle8_delta_across_rows": (bytes([3, 1, 0, 2, 4, 1, 2, 2, 0, 0, 6, 3, 0, 1]), 6, 3, False,
                               _PAL4, {}, (True, True)),
    "rle8_absolute_odd_and_even": (bytes([0, 3, 1, 2, 3, 0, 3, 2, 0, 0, 0, 6, 1, 1, 2, 2, 3, 3,
                                          0, 0, 6, 1, 0, 1]), 6, 3, False, _PAL4, {},
                                   (True, True)),
    "rle8_double_end_of_line": (bytes([6, 1, 0, 0, 0, 0, 6, 3, 0, 0, 6, 2, 0, 1]), 6, 3, False,
                                _PAL4, {}, (True, True)),
    # the references part: PIL fails on an end of bitmap before the last
    # pixel, on an absolute run off the file's 16-bit words and on a black
    # and white palette; cv2 on a run past its row and on a stream that
    # ends early
    "rle8_early_end_of_bitmap": (bytes([3, 1, 3, 2, 0, 0, 2, 3, 0, 1]), 6, 3, False, _PAL4, {},
                                 (False, True)),
    "rle8_absolute_at_odd_offset": (bytes([0, 3, 1, 2, 3, 0, 3, 2, 0, 0, 0, 6, 1, 1, 2, 2, 3, 3,
                                           0, 0, 6, 1, 0, 1]), 6, 3, False, _PAL4, {"gap": 1},
                                    (False, True)),
    "rle8_run_past_its_row": (bytes([4, 1, 4, 2, 0, 0, 6, 3, 0, 0, 6, 1, 0, 1]), 6, 3, False,
                              _PAL4, {}, (True, False)),
    "rle8_run_after_a_full_row": (bytes([6, 1, 6, 2, 0, 0, 6, 3, 0, 1]), 6, 3, False, _PAL4, {},
                                  (False, True)),
    "rle8_black_and_white": (_C8, 6, 3, False, [(0, 0, 0), (255, 255, 255)], {},
                             (False, True)),
    "rle8_stream_ends_early": (_C8[:8], 6, 3, False, _PAL4, {}, (False, False)),
    "rle4_runs": (bytes([5, 0x12, 0, 0, 3, 0x34, 2, 0x55, 0, 0, 4, 0xAB, 0, 0, 0, 1]), 5, 3,
                  True, _PAL16, {}, (True, True)),
    "rle4_absolute_even": (bytes([0, 4, 0x12, 0x34, 1, 0x50, 0, 0, 5, 0x66, 0, 0, 5, 0x77, 0, 1]),
                           5, 3, True, _PAL16, {}, (True, True)),
    # PIL reads n // 2 bytes of an odd absolute run: the row shifts
    "rle4_absolute_odd": (bytes([0, 5, 0x12, 0x34, 0x50, 0, 0, 0, 5, 0x66, 0, 0, 5, 0x77, 0, 1]),
                          5, 3, True, _PAL16, {}, (True, True)),
    "rle4_absolute_three": (bytes([0, 3, 0x12, 0x30, 2, 0x55, 0, 0, 5, 0x66, 0, 0, 5, 0x77, 0, 1]),
                            5, 3, True, _PAL16, {}, (True, True)),
    "rle4_end_of_line_after_a_full_row": (bytes([5, 0x12, 0, 0, 5, 0x34, 0, 0, 5, 0x56, 0, 0]),
                                          5, 3, True, _PAL16, {}, (True, True)),
    "rle4_double_end_of_line": (bytes([5, 0x12, 0, 0, 0, 0, 5, 0x56, 0, 0, 5, 0x11, 0, 1]), 5, 3,
                                True, _PAL16, {}, (True, True)),
    # cv2's RLE4 delta moves right only; its end of bitmap ends one row
    "rle4_delta_across_rows": (bytes([3, 0x10, 0, 2, 4, 2, 2, 0x30, 0, 0, 5, 0x77, 0, 0]), 5, 3,
                               True, _PAL16, {}, (True, True)),
    "rle4_delta_down": (bytes([1, 0x10, 0, 2, 2, 1, 2, 0x30, 0, 0, 5, 0x77, 0, 1]), 5, 3, True,
                        _PAL16, {}, (True, False)),
    "rle4_end_of_bitmap_on_the_last_row": (bytes([5, 0x10, 0, 0, 5, 0x20, 0, 0, 1, 0x30, 0, 1]),
                                           5, 3, True, _PAL16, {}, (False, True)),
    "rle4_early_end_of_bitmap": (bytes([5, 0x12, 0, 0, 3, 0x34, 0, 1]), 5, 3, True, _PAL16, {},
                                 (False, False)),
}


# streams both references decode, to different pages: a double end of
# line (cv2 skips a row), a delta (PIL reads the two bytes after it), an
# odd absolute RLE4 run (PIL drops its last pixel)
PARTED = {"rle8_double_end_of_line", "rle8_delta", "rle8_delta_across_rows",
          "rle4_double_end_of_line", "rle4_delta_across_rows", "rle4_absolute_odd",
          "rle4_absolute_three"}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_rle_streams_equal_each_route(name):
    """Hand-built streams for each escape, and those on which the two
    references part: each route equals its reference, or raises where it
    fails. Where both decode a stream that keeps the format's rules, they
    agree."""
    stream, w, h, rle4, palette, kw, decodes = STREAMS[name]
    data = _rle_bmp(stream, w, h, rle4, palette, **kw)
    assert tuple(_check_routes(data)) == decodes
    if all(decodes):
        same = np.array_equal(bmp.decode_bmp(data, "pil"), bmp.decode_bmp(data, "cv2"))
        assert same == (name not in PARTED), name
    assert bmp.bmp_size(data) == (w, h)


@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (17, 33), (40, 57)],
                         ids=["1x1", "3x5", "17x33", "40x57"])
def test_rle_encoded_pages_equal_both_routes(shape, rle4):
    """Pages through an encoder of the test's own (encoded and absolute
    runs, an end of line each row, an end of bitmap): both routes equal
    their references and each other; read_image_bgr and image_size read
    the file as PIL does."""
    rng = np.random.default_rng(shape[0] + rle4)
    index = rng.integers(0, 16 if rle4 else 256, shape).astype(np.uint8)
    index[:, shape[1] // 3:shape[1] // 2] = 5
    data = _rle_bmp(_encode_rle(index, rle4, rng), shape[1], shape[0], rle4)
    assert _check_routes(data) == [True, True]
    rgb = bmp.decode_bmp(data, "pil")
    np.testing.assert_array_equal(rgb, bmp.decode_bmp(data, "cv2"))
    assert Image.open(io.BytesIO(data)).size == bmp.bmp_size(data) == shape[::-1]


def test_rle_page_through_read_image(tmp_path):
    rng = np.random.default_rng(9)
    index = rng.integers(0, 4, (21, 34)).astype(np.uint8)
    path = tmp_path / "page.bmp"
    path.write_bytes(_rle_bmp(_encode_rle(index, False, rng), 34, 21, False, _PAL4))
    want = np.asarray(Image.open(path).convert("RGB"))[:, :, ::-1]
    np.testing.assert_array_equal(read_image_bgr(path), want)
    assert image_size(path) == Image.open(path).size == (34, 21)

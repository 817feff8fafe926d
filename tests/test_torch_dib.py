"""DIB (a BMP without its file header, ``BmpImagePlugin.DibImageFile``)
through ``tdnet_torch.data.bmp`` against PIL's ``Image.open(...).convert(
"RGB")`` and ``.size``: PIL's DIB writer at every mode, hand-made headers
(every size, bit masks, a top-down page, RLE), the files PIL refuses and
those it passes on; cv2 refuses DIB bodies."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import bmp
from tdnet_torch.data import image as port_image
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal, page, pil_bytes


def _decode(d):
    return bmp.decode_dib(d, route="pil")


def dib_of(im: Image.Image) -> bytes:
    return pil_bytes(im, "DIB")


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("shape", [(13, 17), (1, 1), (4, 32)])
def test_dib_from_pil_equals_pil(mode, shape):
    im = Image.fromarray(page(shape, 1))
    im = im.quantize(40) if mode == "P" else im.convert(mode)
    assert assert_as_pil(dib_of(im), _decode, bmp.dib_size)
    assert port_image.pil_plugin(dib_of(im))[0] == Image.open(io.BytesIO(dib_of(im))).format \
        == "DIB"


def _header(size, w, h, bits, compression=0, colors=0):
    if size == 12:
        return struct.pack("<IHHHH", 12, w, h, 1, bits)
    head = struct.pack("<IiiHHIIiiII", size, w, h, 1, bits, compression, 0, 0, 0, colors, 0)
    return head + bytes(size - 40)


@pytest.mark.parametrize("size", [12, 40, 52, 56, 64, 108, 124])
@pytest.mark.parametrize("bits", [8, 24])
def test_dib_header_sizes(size, bits):
    px = page((5, 7), 2)
    stride = (7 * bits + 31) // 32 * 4
    rows = b"".join(r[:7 * bits // 8].tobytes().ljust(stride, b"\0")
                    for r in (px[::-1, :, 0] if bits == 8 else px[::-1, :, ::-1]))
    pal = b"".join(bytes([i, 255 - i, i // 2] + ([0] if size != 12 else []))
                   for i in range(256)) if bits == 8 else b""
    assert assert_as_pil(_header(size, 7, 5, bits) + pal + rows, _decode, bmp.dib_size)


@pytest.mark.parametrize("masks", [(0xFF0000, 0xFF00, 0xFF, 0),
                                   (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                                   (0xFF000000, 0xFF0000, 0xFF00, 0), (0, 0, 0, 0),
                                   (0xFF00, 0xFF, 0xFF0000, 0)])
@pytest.mark.parametrize("size", [40, 56])
def test_dib_32_bit_masks(masks, size):
    px = page((4, 6), 3, 4)
    head = _header(size, 6, -4, 32, 3)
    if size == 40:
        head += struct.pack("<III", *masks[:3])
    else:
        head = head[:40] + struct.pack("<4I", *masks) + head[56:]
    assert_as_pil(head + px.tobytes(), _decode, bmp.dib_size)


def test_dib_rle8_and_16_bit():
    pal = bytes(range(256)) * 4
    rle = bytes([3, 7, 0, 0, 2, 9, 1, 200, 0, 0, 0, 1])
    assert assert_as_pil(_header(40, 3, 2, 8, 1) + pal + rle, _decode, bmp.dib_size)
    px = page((3, 4), 4).astype(np.uint16)
    v = (px[:, :, 0] >> 3 << 10 | px[:, :, 1] >> 3 << 5 | px[:, :, 2] >> 3).astype("<u2")
    assert assert_as_pil(_header(40, 4, 3, 16) + v.tobytes(), _decode, bmp.dib_size)


@pytest.mark.parametrize("case,opens", [("zero_width", False), ("short_masks", False),
                                        ("short_header", True), ("bits_7", True),
                                        ("compression_9", True), ("short_pixels", True),
                                        ("bad_masks", True)])
def test_dib_refusals_and_files_passed_on(case, opens):
    """PIL fails on some (the port refuses them by its DIB reader) and
    passes others on to its later plugins (which here take none)."""
    px = bytes(range(200))
    data = {"zero_width": _header(40, 0, 4, 24) + px,
            "short_masks": _header(40, 4, 4, 32, 3) + b"\0\0",
            "short_header": _header(40, 4, 4, 24)[:30],
            "bits_7": _header(40, 4, 4, 7) + px,
            "compression_9": _header(40, 4, 4, 24, 9) + px,
            "short_pixels": _header(40, 4, 4, 24) + px[:20],
            "bad_masks": _header(40, 4, 4, 32, 3) + struct.pack("<III", 1, 2, 4) + px}[case]
    assert not assert_as_pil(data)
    assert bmp.is_dib(data) == opens
    assert (port_image.pil_plugin(data) or ("",))[0] == ("DIB" if opens else "")


def test_dib_read_image_equals_reference(tmp_path):
    assert_read_image_equal(tmp_path, dib_of(Image.fromarray(page((20, 31), 5))), "page.dib")


@pytest.mark.parametrize("height", [2, 0xFFFE])
@pytest.mark.parametrize("file_header", [True, False], ids=["bmp", "dib"])
def test_core_header_sizes_are_unsigned(height, file_header):
    """PIL reads an OS/2 core header's width and height unsigned: a height
    past 32767 is not a top-down page (PIL refuses this one: its pixels
    run past the end)."""
    dib = struct.pack("<IHHHH", 12, 3, height, 1, 1) + bytes([0, 0, 0, 255, 255, 255]) + bytes(8)
    data = (b"BM" + struct.pack("<IHHI", 14 + len(dib), 0, 0, 14 + 18) + dib) if file_header \
        else dib
    decode = (lambda d: bmp.decode_bmp(d, route="pil")) if file_header else _decode
    assert assert_as_pil(data, decode) == (height == 2)

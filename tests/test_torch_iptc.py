"""IPTC/NAA images through ``tdnet_torch.data.iptc`` against PIL's
``Image.open(...).convert("RGB")`` and ``.size`` on hand-made files (PIL
has no IPTC writer): raw gray, a raw band of RGB and CMYK, image data in
several fields and in a long one, JPEG data (of its own size, and as a
gray band), other fields in the header, and the files PIL refuses or
passes on; cv2 refuses IPTC bodies."""

import io
import struct

import pytest
from PIL import Image

from tdnet_torch.data import iptc
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal, page, pil_bytes


def _decode(d):
    return iptc.decode_iptc(d, route="pil")


def field(record, dataset, value):
    if len(value) < 32768:
        return bytes([0x1C, record, dataset]) + struct.pack(">H", len(value)) + value
    # PIL reads 5 header bytes, then the size's own 4 bytes after them
    return bytes([0x1C, record, dataset, 0x84, 0]) + struct.pack(">I", len(value)) + value


def iptc_file(w, h, layers, component, compression, data, band=None, split=1, extra=b""):
    out = (field(2, 0, b"\0\2") + field(3, 60, bytes([layers, component]))
           + field(3, 20, struct.pack(">H", w)) + field(3, 30, struct.pack(">H", h)))
    if compression is not None:
        out += field(3, 120, bytes([compression]))
    if band is not None:
        out += field(3, 65, bytes([band]))
    out += extra
    step = max(1, -(-len(data) // split))
    for i in range(0, len(data), step):
        out += field(8, 10, data[i:i + step])
    return out


PX = page((9, 13), 3)
GRAY = PX[:, :, 0].tobytes()
JPEG = pil_bytes(Image.fromarray(PX), "JPEG", quality=85)
JPEG_GRAY = pil_bytes(Image.fromarray(PX[:, :, 0]), "JPEG", quality=85)
CASES = {
    "raw_gray": (iptc_file(13, 9, 1, 0, 1, GRAY), True),
    "raw_split": (iptc_file(13, 9, 1, 0, 1, GRAY, split=3), True),
    "raw_rgb_band_2": (iptc_file(13, 9, 3, 1, 1, GRAY, band=2), True),
    "raw_rgb_first_band": (iptc_file(13, 9, 3, 1, 1, GRAY), True),
    "raw_cmyk_band_4": (iptc_file(13, 9, 4, 1, 1, GRAY, band=4), True),
    "raw_rgb_band_5": (iptc_file(13, 9, 3, 1, 1, GRAY, band=5), False),
    "raw_short": (iptc_file(13, 9, 1, 0, 1, GRAY[:-1]), False),
    "long_field": (iptc_file(300, 200, 1, 0, 1, page((200, 300), 4)[:, :, 0].tobytes()), True),
    "jpeg_in_gray": (iptc_file(13, 9, 1, 0, 5, JPEG), True),
    "jpeg_gray_band": (iptc_file(13, 9, 3, 1, 5, JPEG_GRAY, band=1), True),
    "jpeg_of_another_size": (iptc_file(20, 9, 1, 0, 5, JPEG), True),
    "compression_7": (iptc_file(13, 9, 1, 0, 7, GRAY), False),
    "no_compression": (iptc_file(13, 9, 1, 0, None, GRAY), False),
    "no_image_fields": (iptc_file(13, 9, 1, 0, 1, b""), False),
    "other_fields": (iptc_file(13, 9, 1, 0, 1, GRAY, extra=field(2, 5, b"title")), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_iptc_files(case):
    data, reads = CASES[case]
    assert assert_as_pil(data, _decode) == reads
    assert iptc.is_iptc(data)
    if reads:
        assert iptc.iptc_size(data) == Image.open(io.BytesIO(data)).size


@pytest.mark.parametrize("data", [
    iptc_file(13, 9, 2, 0, 1, GRAY), iptc_file(0, 9, 1, 0, 1, GRAY),
    field(2, 0, b"\0\2") + bytes([0x1D, 2, 0, 0, 2]) + bytes(20),
    field(3, 20, b"\0\1") + field(8, 10, GRAY)])
def test_iptc_files_pil_passes_on(data):
    assert not iptc.is_iptc(data)
    assert_as_pil(data)


def test_iptc_read_image_equals_reference(tmp_path):
    assert_read_image_equal(tmp_path, iptc_file(31, 22, 1, 0, 1, page((22, 31), 5)[:, :, 1]
                                                .tobytes()), "page.iptc")


def test_repeated_fields_are_walked_in_linear_time():
    """A body of 200,000 repeats of one empty field passes every plugin
    before IPTC, whose walk keeps each repeat (PIL appends them to one
    list): the serve route refuses it, as cv2 does, in linear time (a walk
    that copied the list at each repeat took ~50 s on this body)."""
    import time

    import cv2
    import numpy as np

    from tdnet_torch.data import image

    data = b"\x1c\x02\x00\x00\x00" * 200_000
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    start = time.perf_counter()
    with pytest.raises(ValueError, match="cv2 cannot decode it"):
        image.decode_image(data, route="cv2")
    assert not iptc.is_iptc(data)
    assert time.perf_counter() - start < 10

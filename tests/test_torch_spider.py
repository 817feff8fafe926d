"""SPIDER through ``tdnet_torch.data.spider`` against PIL's
``Image.open(...).convert("RGB")`` and ``.size``: PIL's writer (big-endian
floats, values outside 0..255 and NaN), little-endian and stacked files
by hand, and the headers PIL fails on or passes on; cv2 refuses SPIDER
bodies."""

import struct

import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import spider
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal, pil_bytes


def _decode(d):
    return spider.decode_spider(d, route="pil")


def _floats(shape, seed):
    rng = np.random.default_rng(seed)
    a = (rng.random(shape) * 400 - 60).astype(np.float32)
    a[0, 0] = np.nan
    return a


@pytest.mark.parametrize("shape", [(9, 13), (1, 1), (20, 3)])
def test_spider_from_pil_equals_pil(shape):
    data = pil_bytes(Image.fromarray(_floats(shape, 6), "F"), "SPIDER")
    assert assert_as_pil(data, _decode, spider.spider_size)


def spider_file(a, end=">", stack=0.0, number=0.0, form=1.0, records=None, length=None,
                extra=()):
    h, w = a.shape
    length = length if length is not None else 4 * w
    records = records if records is not None else max(1, -(-1024 // length))
    header = [0.0] * 27
    header[0], header[1], header[4], header[11] = h, h, form, w
    header[12], header[21], header[22] = records, records * length, length
    header[23], header[25], header[26] = stack, 1.0, number
    for i, v in extra:
        header[i - 1] = v
    head = struct.pack(end + "27f", *header).ljust(int(records * length), b"\0")
    pixels = a.astype(end + "f4").tobytes()
    return head + (head if stack > 0 and number == 0 else b"") + pixels


@pytest.mark.parametrize("end", [">", "<"])
@pytest.mark.parametrize("stack", [0.0, 2.0])
def test_spider_byte_orders_and_stacks(end, stack):
    data = spider_file(_floats((7, 11), 7), end, stack=stack)
    assert assert_as_pil(data, _decode, spider.spider_size)


@pytest.mark.parametrize("case,opens", [("form_3", False), ("not_whole", False),
                                        ("image_in_stack", True), ("nan_stack", True),
                                        ("negative_stack", False), ("short_pixels", True),
                                        ("short_header", False), ("zero_length", False)])
def test_spider_refusals_and_files_passed_on(case, opens):
    a = _floats((4, 5), 8)
    data = {"form_3": spider_file(a, form=3.0), "not_whole": spider_file(a, extra=[(2, 4.5)]),
            "image_in_stack": spider_file(a, number=1.0),
            "nan_stack": spider_file(a, stack=float("nan")),
            "negative_stack": spider_file(a, stack=-1.0),
            "short_pixels": spider_file(a)[:-1], "short_header": spider_file(a)[:100],
            "zero_length": spider_file(a, records=0)}[case]
    assert not assert_as_pil(data)
    assert spider.is_spider(data) == opens


def test_spider_read_image_equals_reference(tmp_path):
    data = pil_bytes(Image.fromarray(_floats((21, 30), 9), "F"), "SPIDER")
    assert_read_image_equal(tmp_path, data, "page.spi")

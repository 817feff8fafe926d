"""XBM through ``tdnet_torch.data.xbm`` against PIL's
``Image.open(...).convert("RGB")`` and ``.size``: PIL's writer at several
sizes, hot spots, hand-written bodies (characters that are not hex
digits, bytes without ``0``, a body that ends inside a byte), headers
PIL's pattern does not match; cv2 refuses XBM bodies."""

import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import xbm
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal, pil_bytes


def _decode(d):
    return xbm.decode_xbm(d, route="pil")


def _bits(shape, seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 2, shape, dtype=np.uint8) * 255).convert("1")


@pytest.mark.parametrize("shape", [(3, 10), (9, 17), (1, 8), (5, 1), (16, 16)])
@pytest.mark.parametrize("hotspot", [None, (2, 1)])
def test_xbm_from_pil_equals_pil(shape, hotspot):
    kw = {"hotspot": hotspot} if hotspot else {}
    assert assert_as_pil(pil_bytes(_bits(shape, 4), "XBM", **kw), _decode, xbm.xbm_size)


HEAD = b"#define a_width 8\n#define a_height 2\nstatic char a_bits[] = {\n"


@pytest.mark.parametrize("body,reads", [
    (b"0x01, 0x80 };", True), (b"0xg1,0x1g};", True), (b"0xA1,0xFf", True), (b"x01x02", True),
    (b"0x:1,0x;;", True), (b"0xxx1x2", False), (b"0x01 0x8", False), (b"0x01", False)])
def test_xbm_bodies(body, reads):
    assert assert_as_pil(HEAD + body, _decode, xbm.xbm_size) == reads


@pytest.mark.parametrize("data", [
    b"   \n\n  #define a_width 8\n#define a_height 1\nchar a_bits[] = {0x01};",
    b"#define a_width 0\n#define a_height 1\nchar a_bits[] = {0x01};",
    b"#define a_width 8\n#define b_height 1\nchar a_bits = {0x01};",
    b"#define a_width 8\r\n#define a_height 1\r\n" + b" " * 600 + b"_bits[] = {0x01};",
    b"                 #define a_width 8\n#define a_height 1\nchar a_bits[] = {0x01};"])
def test_xbm_headers_pil_reads_or_passes_on(data):
    assert_as_pil(data)
    assert xbm.is_xbm(data) == (xbm._header(data) is not None)


def test_xbm_read_image_equals_reference(tmp_path):
    assert_read_image_equal(tmp_path, pil_bytes(_bits((21, 30), 5), "XBM"), "page.xbm")

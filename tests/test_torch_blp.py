"""BLP through ``tdnet_torch.data.blp`` against PIL's
``Image.open(...).convert("RGB")`` and ``.size``: PIL's writer (palette
BLP1 and BLP2, with and without alpha), and by hand BLP2 DXT1/3/5 with
each alpha depth at sizes that are not multiples of 4, raw palette BLP2
and BLP1 JPEG (its shared header, a page larger or smaller than the
header's size, CMYK), and the files PIL refuses; cv2 refuses BLP
bodies."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import blp
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal, page, pil_bytes


def _decode(d):
    return blp.decode_blp(d, route="pil")


@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("channels", [3, 4])
def test_blp_from_pil_equals_pil(version, channels):
    im = Image.fromarray(page((13, 17), 1, channels)).quantize(50)
    data = pil_bytes(im, "BLP", blp_version=version)
    assert assert_as_pil(data, _decode, blp.blp_size)


def blp2(w, h, encoding, alpha, alpha_encoding, mip, seed=0, compression=1):
    rng = np.random.default_rng(seed)
    head = (b"BLP2" + struct.pack("<i", compression)
            + struct.pack("<bbbb", encoding, alpha, alpha_encoding, 0) + struct.pack("<II", w, h))
    offsets = [20 + 128 + 1024] + [0] * 15
    lengths = [len(mip)] + [0] * 15
    return (head + struct.pack("<16I", *offsets) + struct.pack("<16I", *lengths)
            + rng.integers(0, 256, 1024, dtype=np.uint8).tobytes() + mip)


@pytest.mark.parametrize("alpha_encoding", [0, 1, 7])
@pytest.mark.parametrize("alpha", [0, 8])
@pytest.mark.parametrize("shape", [(8, 8), (9, 13), (3, 5)])
def test_blp2_dxt(alpha_encoding, alpha, shape):
    h, w = shape
    rng = np.random.default_rng(alpha_encoding * 10 + alpha + w)
    size = 8 if alpha_encoding == 0 else 16
    mip = rng.integers(0, 256, -(-w // 4) * -(-h // 4) * size, dtype=np.uint8).tobytes()
    assert assert_as_pil(blp2(w, h, 2, alpha, alpha_encoding, mip), _decode, blp.blp_size)


@pytest.mark.parametrize("alpha", [0, 8])
def test_blp2_raw_palette(alpha):
    mip = np.random.default_rng(alpha).integers(0, 256, 9 * 13, dtype=np.uint8).tobytes()
    assert assert_as_pil(blp2(13, 9, 1, alpha, 0, mip), _decode, blp.blp_size)


def blp1_jpeg(jpeg: bytes, alpha=0, size=None):
    """The shared header is the JPEG up to its first scan."""
    w, h = size or Image.open(io.BytesIO(jpeg)).size
    sos = jpeg.index(b"\xff\xda")
    shared, rest = jpeg[:sos], jpeg[sos:]
    head = b"BLP1" + struct.pack("<iIIIiI", 0, alpha, w, h, 5, 0)
    first = 28 + 128 + 4 + len(shared) + 3
    return (head + struct.pack("<16I", first, *([0] * 15))
            + struct.pack("<16I", len(rest), *([0] * 15))
            + struct.pack("<I", len(shared)) + shared + b"pad" + rest)


@pytest.mark.parametrize("case", ["rgb", "alpha", "smaller", "larger", "cmyk"])
def test_blp1_jpeg(case):
    if case == "cmyk":
        jpeg = pil_bytes(Image.fromarray(page((16, 24), 2, 4), "CMYK"), "JPEG", quality=80)
    else:
        jpeg = pil_bytes(Image.fromarray(page((16, 24), 2)), "JPEG", quality=80)
    size = {"smaller": (20, 10), "larger": (30, 20)}.get(case)
    data = blp1_jpeg(jpeg, alpha=8 if case == "alpha" else 0, size=size)
    assert assert_as_pil(data, _decode, blp.blp_size) == (case != "larger")


@pytest.mark.parametrize("case", ["alpha_encoding_3", "encoding_3", "compression_2",
                                  "short_mip", "short_palette", "blp1_encoding_2"])
def test_blp_refusals(case):
    data = {"alpha_encoding_3": blp2(8, 8, 2, 0, 3, bytes(64)),
            "encoding_3": blp2(8, 8, 3, 0, 0, bytes(256)),
            "compression_2": blp2(8, 8, 1, 0, 0, bytes(64), compression=2),
            "short_mip": blp2(8, 8, 2, 0, 0, bytes(32))[:-1],
            "short_palette": blp2(8, 8, 1, 0, 0, b"")[:600],
            "blp1_encoding_2": b"BLP1" + struct.pack("<iIIIiI", 1, 0, 4, 4, 2, 0)
            + bytes(2000)}[case]
    assert not assert_as_pil(data)
    assert blp.is_blp(data)


def test_blp_read_image_equals_reference(tmp_path):
    rng = np.random.default_rng(3)
    mip = rng.integers(0, 256, 6 * 8 * 16, dtype=np.uint8).tobytes()
    assert_read_image_equal(tmp_path, blp2(22, 30, 2, 8, 7, mip), "page.blp")

"""The small raw formats of ``tdnet_torch.data.raw_plugins`` (GBR, FTEX,
PIXAR, McIDAS, IMT, XV thumbnails) against PIL's ``Image.open(...)
.convert("RGB")`` and ``.size``, on hand-made files (PIL writes none of
them): each depth and mode PIL reads, row padding, PIL's refusals and the
files it passes on; cv2 refuses each body."""

import struct

import numpy as np
import pytest

from tdnet_torch.data import image as port_image
from tdnet_torch.data import raw_plugins
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal, page

PX = page((7, 9), 2, 4)


def gbr(depth, version=1, header=None, data=None):
    pixels = PX[:, :, 0].tobytes() if depth == 1 else PX.tobytes()
    if version == 1:
        header = header or 20
        head = struct.pack(">5I", header, 1, 9, 7, depth).ljust(header, b"c")
    else:
        header = header or 28
        head = struct.pack(">5I", header, 2, 9, 7, depth) + b"GIMP" + struct.pack(">I", 3)
        head = head.ljust(header, b"c")
    return head + (pixels if data is None else data)


def ftex(fmt, body, count=1, w=9, h=7):
    return (b"FTEX" + struct.pack("<5i", 0, w, h, 1, count) + struct.pack("<2i", fmt, 32)
            + struct.pack("<i", len(body)) + body)


def pixar(mode=(14, 2), w=9, h=7):
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, *mode)
    return bytes(head) + PX[:, :, :3].tobytes()


def mcidas(depth, pixels, prefix=0, bands=1, offset=256, w=9, h=7):
    words = [0] * 64
    words[1], words[8], words[9], words[10] = 4, h, w, depth
    words[13], words[14], words[33] = bands, prefix, offset
    return struct.pack(">64i", *words) + pixels


def _values(depth, seed):
    rng = np.random.default_rng(seed)
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[depth]
    return rng.integers(-10 if depth == 4 else 0, 400 if depth > 1 else 256, (7, 9)).astype(dt)


BC1 = np.random.default_rng(3).integers(0, 256, 3 * 2 * 8, dtype=np.uint8).tobytes()
CASES = {
    "gbr_gray": ("GBR", gbr(1), True), "gbr_rgba": ("GBR", gbr(4), True),
    "gbr_v2": ("GBR", gbr(4, 2), True), "gbr_comment": ("GBR", gbr(1, header=25), True),
    "gbr_v2_short_header": ("GBR", gbr(1, 2, header=24), False),
    "gbr_short": ("GBR", gbr(1)[:-1], False),
    "ftex_rgb": ("FTEX", ftex(1, PX[:, :, :3].tobytes()), True),
    "ftex_bc1": ("FTEX", ftex(0, BC1), True), "ftex_bc1_short": ("FTEX", ftex(0, BC1[:-1]), False),
    "ftex_format_2": ("FTEX", ftex(2, BC1), False),
    "ftex_two_formats": ("FTEX", ftex(0, BC1, count=2), False),
    "pixar": ("PIXAR", pixar(), True), "pixar_short": ("PIXAR", pixar()[:-1], False),
    "mcidas_8": ("MCIDAS", mcidas(1, _values(1, 4).tobytes()), True),
    "mcidas_16": ("MCIDAS", mcidas(2, _values(2, 5).tobytes()), True),
    "mcidas_32": ("MCIDAS", mcidas(4, _values(4, 6).tobytes()), True),
    "mcidas_prefix": ("MCIDAS", mcidas(2, b"".join(b"ab" + r.tobytes() for r in _values(2, 7)),
                                       prefix=2), True),
    "mcidas_no_bands_32": ("MCIDAS", mcidas(4, _values(4, 8).tobytes(), bands=0), True),
    "mcidas_short": ("MCIDAS", mcidas(1, _values(1, 9).tobytes()[:-1]), False),
    "imt": ("IMT", b"width 9\nheight 7\npixel n8\n\x0c" + PX[:, :, 0].tobytes(), True),
    "imt_comment": ("IMT", b"* made by hand\nwidth 9\nheight 7\npixel n8\n\x0c"
                    + PX[:, :, 0].tobytes(), True),
    "imt_no_form_feed": ("IMT", b"width 9\nheight 7\npixel n8\n", False),
    "imt_short": ("IMT", b"width 9\nheight 7\npixel n8\n\x0c" + bytes(62), False),
    "xv": ("XVTHUMB", b"P7 332\n#XVVERSION:Version 2.28\n#END_OF_COMMENTS\n9 7 255\n"
           + PX[:, :, 0].tobytes(), True),
    "xv_short": ("XVTHUMB", b"P7 332\n#END\n9 7 255\n" + bytes(62), False),
    "xv_no_size": ("XVTHUMB", b"P7 332\n#END\n9\n" + bytes(62), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_raw_formats_equal_pil(case):
    name, data, reads = CASES[case]
    assert assert_as_pil(data, raw_plugins.decode(name), raw_plugins.size(name)) == reads
    assert port_image.pil_plugin(data)[0] == name


@pytest.mark.parametrize("name,data", [
    ("GBR", struct.pack(">5I", 20, 1, 0, 7, 1) + bytes(100)),
    ("GBR", struct.pack(">5I", 28, 2, 9, 7, 1) + b"GIMQ" + bytes(100)),
    ("PIXAR", pixar(mode=(14, 1))), ("PIXAR", pixar(w=0)),
    ("MCIDAS", mcidas(3, bytes(200))), ("MCIDAS", mcidas(1, bytes(200), w=0)),
    ("XVTHUMB", b"P7 332\n#END\n0 7 255\n" + bytes(62)),
    ("IMT", b"width 9\nheight 7\n\x0c" + bytes(63))])
def test_raw_formats_pil_passes_on(name, data):
    assert not raw_plugins.opens(name)(data)
    assert (port_image.pil_plugin(data) or ("",))[0] != name
    assert_as_pil(data)


@pytest.mark.parametrize("case", ["gbr_rgba", "ftex_bc1", "pixar", "mcidas_16", "imt", "xv"])
def test_raw_formats_read_image_equals_reference(case, tmp_path):
    # cv2 takes an XV thumbnail ("P7 332") for PAM, whose header it refuses
    match = "PAM" if case == "xv" else "OpenCV cannot read it"
    assert_read_image_equal(tmp_path, CASES[case][1], f"page.{case}", body_match=match)

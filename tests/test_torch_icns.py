"""ICNS through ``tdnet_torch.data.icns`` against PIL's
``Image.open(...).convert("RGB")`` and ``.size`` (which, before loading,
is the largest size times its scale): PIL's writer (PNG elements), and
hand-made files of PNG, JPEG 2000 (8 and 16 bits), raw and run-length RGB
elements with their masks, the largest-size choice, an icon of a smaller
size than its element claims, and the files PIL refuses or passes on;
cv2 refuses ICNS bodies."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import icns
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal, page, pil_bytes


def _decode(d):
    return icns.decode_icns(d, route="pil")


def element(kind, body):
    return kind + struct.pack(">I", len(body) + 8) + body


def icns_file(*elements):
    body = b"".join(elements)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


def rle(band) -> bytes:
    """PIL's read_32 runs: repeats of 3 to 130, copies of up to 128."""
    out, i, b = bytearray(), 0, band.tobytes()
    while i < len(b):
        j = i
        while j < len(b) and j - i < 130 and b[j] == b[i]:
            j += 1
        if j - i >= 3:
            out += bytes([j - i + 125, b[i]])
            i = j
        else:
            k = min(len(b), i + 128)
            out += bytes([k - i - 1]) + b[i:k]
            i = k
    return bytes(out)


def rle_rgb(px):
    return b"".join(rle(px[:, :, c]) for c in range(3))


def test_icns_from_pil_equals_pil():
    data = pil_bytes(Image.fromarray(page((32, 32), 1)), "ICNS")
    assert assert_as_pil(data, _decode, icns.icns_size)


@pytest.mark.parametrize("case", ["png16", "raw16", "rle16_mask", "rle48", "it32", "j2k",
                                  "j2k_gray", "j2k_16bit", "png_and_it32", "png_64_in_128"])
def test_icns_elements(case):
    p16, p48, p128 = page((16, 16), 2), page((48, 48), 3), page((128, 128), 4)
    j2k = pil_bytes(Image.fromarray(p128), "JPEG2000")
    data = {
        "png16": icns_file(element(b"icp4", pil_bytes(Image.fromarray(p16), "PNG"))),
        "raw16": icns_file(element(b"is32", p16.tobytes())),
        "rle16_mask": icns_file(element(b"is32", rle_rgb(p16)), element(b"s8mk", bytes(256))),
        "rle48": icns_file(element(b"is32", p16.tobytes()), element(b"ih32", rle_rgb(p48))),
        "it32": icns_file(element(b"it32", bytes(4) + rle_rgb(p128))),
        "j2k": icns_file(element(b"ic07", j2k)),
        "j2k_gray": icns_file(element(b"ic07", pil_bytes(Image.fromarray(p128[:, :, 0]),
                                                         "JPEG2000"))),
        "j2k_16bit": icns_file(element(b"ic07", pil_bytes(
            Image.fromarray(p128[:, :, 0].astype(np.uint16) * 200), "JPEG2000"))),
        "png_and_it32": icns_file(element(b"it32", bytes(4) + rle_rgb(p128)),
                                  element(b"ic07", pil_bytes(Image.fromarray(p128[::-1]),
                                                             "PNG"))),
        "png_64_in_128": icns_file(element(b"ic07", pil_bytes(Image.fromarray(page((64, 64), 5)),
                                                              "PNG"))),
    }[case]
    assert assert_as_pil(data, _decode)
    assert icns.icns_size(data) == Image.open(io.BytesIO(data)).size


@pytest.mark.parametrize("case,opens", [("mask_only", True), ("rle_short", True),
                                        ("rle_overrun", True), ("it32_no_zeros", True),
                                        ("odd_png", True), ("unknown_element", True),
                                        ("short_mask", True), ("no_sizes", False),
                                        ("zero_length", False), ("cut_directory", False)])
def test_icns_refusals_and_files_passed_on(case, opens):
    p16 = page((16, 16), 6)
    data = {"mask_only": icns_file(element(b"s8mk", bytes(256))),
            "rle_short": icns_file(element(b"is32", b"\x85\x01")),
            "rle_overrun": icns_file(element(b"is32", b"\xff\x01" * 3)),
            "it32_no_zeros": icns_file(element(b"it32", b"\1\0\0\0" + rle_rgb(page((128, 128),
                                                                                  7)))),
            "odd_png": icns_file(element(b"icp4", pil_bytes(Image.fromarray(page((10, 16), 8)),
                                                            "PNG"))),
            "unknown_element": icns_file(element(b"icp4", b"GIF89a" + bytes(20))),
            "short_mask": icns_file(element(b"is32", p16.tobytes()), element(b"s8mk", bytes(9))),
            "no_sizes": icns_file(element(b"TOC ", bytes(8))),
            "zero_length": b"icns" + struct.pack(">I", 100) + b"is32" + bytes(4),
            "cut_directory": icns_file(element(b"is32", p16.tobytes()))[:12]}[case]
    assert not assert_as_pil(data)
    assert icns.is_icns(data) == opens


def test_icns_read_image_equals_reference(tmp_path):
    data = icns_file(element(b"il32", rle_rgb(page((32, 32), 9))),
                     element(b"ic12", pil_bytes(Image.fromarray(page((64, 64), 10)), "PNG")))
    assert_read_image_equal(tmp_path, data, "page.icns")

"""tdnet_torch.data.pcx against PIL's ``Image.open(...).convert("RGB")``
and ``.size`` (the reference's file route): PIL's own PCX files (bilevel,
gray, palette, RGB) and files of the test's own writer for the layouts
PIL does not write (1 bit in 2 or 4 planes with the header's colours,
padded lines given or not in the header, runs across a line, a gray
palette), with each refusal PIL makes; cv2 refuses PCX."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import pcx
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal, page, pil_bytes


def pcx_file(data: bytes, w, h, bits, planes, version=5, stride=None, colours=b"", tail=b"",
             x0=0, y0=0) -> bytes:
    stride = stride if stride is not None else ((w * bits + 7) // 8 + 1) // 2 * 2
    header = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0, x0 + w - 1, y0 + h - 1,
                         72, 72) + colours.ljust(48, b"\0")[:48] + bytes([0, planes])
    return (header + struct.pack("<HH", stride, 1)).ljust(128, b"\0") + data + tail


def _literal(raw: bytes) -> bytes:
    """Bytes as single literals, those of 0xC0 and above as runs of one."""
    return b"".join(bytes([0xC1, v]) if v >= 0xC0 else bytes([v]) for v in raw)


def _decode(d):
    return pcx.decode_pcx(d, route="pil")


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "1"])
@pytest.mark.parametrize("shape", [(9, 13), (6, 16), (1, 1)])
def test_pcx_from_pil_equals_pil(mode, shape):
    im = Image.fromarray(page(shape, 3))
    im = im.quantize(200) if mode == "P" else im.convert(mode)
    read = assert_as_pil(pil_bytes(im, "PCX"), _decode, pcx.pcx_size)
    assert read != (mode == "RGB" and shape == (1, 1))  # PIL fails on its own 1x1 RGB


@pytest.mark.parametrize("planes", [2, 4])
@pytest.mark.parametrize("w", [3, 4, 9, 17])
@pytest.mark.parametrize("given", ["exact", "padded"])
def test_pcx_bit_planes_and_header_palette(planes, w, given):
    rng = np.random.default_rng(planes * w)
    exact = (w + 7) // 8
    stride = exact + exact % 2 if given == "padded" else exact
    rows = rng.integers(0, 256, (3, planes * stride), dtype=np.uint8)
    data = pcx_file(_literal(rows.tobytes()), w, 3, 1, planes, version=int(rng.choice([0, 2])),
                    stride=stride if given == "exact" else stride + 4,
                    colours=bytes(range(7, 55)))
    assert assert_as_pil(data, _decode, pcx.pcx_size)


@pytest.mark.parametrize("w", [1, 3, 4, 5, 8])
@pytest.mark.parametrize("given", ["exact", "padded"])
def test_pcx_rgb_planes_padded_as_pil_moves_them(w, given):
    """A padded RGB line whose length is a multiple of the width keeps its
    planes where PIL's decoder leaves them (shifted)."""
    rng = np.random.default_rng(w)
    stride = w if given == "exact" else w + w % 2
    rows = rng.integers(0, 256, (2, 3 * stride), dtype=np.uint8)
    data = pcx_file(_literal(rows.tobytes()), w, 2, 8, 3, stride=w if given == "exact" else 0)
    assert assert_as_pil(data + bytes(800), _decode)


def test_pcx_palettes_runs_and_the_window():
    gray = bytes([12]) + bytes(v for i in range(256) for v in (i, i, i))
    colours = bytes([12]) + bytes(range(256)) * 3
    body = bytes([0xC2, 7, 0xC2, 200, 1, 2, 0xC0, 9, 3, 4])
    for tail in (gray, colours, b"", bytes(100) + colours, bytes([11]) + colours[1:]):
        assert assert_as_pil(pcx_file(body, 4, 2, 8, 1, stride=4, tail=tail, x0=5, y0=9),
                             _decode, pcx.pcx_size)
    short_file = pcx_file(bytes([1, 2, 3, 4]), 2, 2, 8, 1, stride=2, tail=colours[:300])
    assert assert_as_pil(short_file, _decode)  # under 769 bytes: gray


@pytest.mark.parametrize("case", ["run_across_line", "bits_4", "bits_2", "version_2_8bit",
                                  "truncated", "empty_window", "planes_3_at_1_bit"])
def test_pcx_refusals_equal_pil(case):
    data = {
        "run_across_line": pcx_file(bytes([0xC3, 7, 9]) + bytes(900), 2, 2, 8, 1, stride=2),
        "bits_4": pcx_file(bytes(8), 2, 2, 4, 1),
        "bits_2": pcx_file(bytes(8), 2, 2, 2, 1),
        "version_2_8bit": pcx_file(bytes(8), 2, 2, 8, 1, version=2),
        "truncated": pcx_file(bytes(3), 2, 2, 8, 3, stride=2),
        "empty_window": pcx_file(bytes(8), 2, 2, 8, 1, x0=9)[:8] + struct.pack("<H", 3)
        + pcx_file(bytes(8), 2, 2, 8, 1)[10:],
        "planes_3_at_1_bit": pcx_file(bytes(8), 8, 2, 1, 3),
    }[case]
    assert not assert_as_pil(data)
    if case == "empty_window":  # PIL passes it on to its other readers
        assert not pcx.is_pcx(data)
    elif case != "truncated":
        with pytest.raises(ValueError, match="PCX"):
            _decode(data)


def test_pcx_read_image_equals_reference(tmp_path):
    im = Image.fromarray(page((19, 27), 4)).quantize(150)
    assert_read_image_equal(tmp_path, pil_bytes(im, "PCX"), "page.pcx")


# --- DCX (DcxImagePlugin): a directory of PCX pages, the first read


def dcx_file(pages, terminated=True) -> bytes:
    at = 4 + 4 * (len(pages) + terminated)
    offsets, blob = [], b""
    for p in pages:
        offsets.append(at + len(blob))
        blob += p
    return (struct.pack("<I", 987654321) + struct.pack(f"<{len(pages)}I", *offsets)
            + (b"\0\0\0\0" if terminated else b"") + blob)


def _dcx(d):
    return pcx.decode_dcx(d, route="pil")


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "1"])
def test_dcx_first_page_equals_pil(mode):
    a = Image.fromarray(page((9, 14), 30))
    a = a.quantize(50) if mode == "P" else a.convert(mode)
    b = Image.fromarray(page((5, 6), 31)).convert("RGB")
    data = dcx_file([pil_bytes(a, "PCX"), pil_bytes(b, "PCX")])
    assert assert_as_pil(data, _dcx, pcx.dcx_size)
    assert Image.open(io.BytesIO(data)).format == "DCX"


@pytest.mark.parametrize("case,opens", [("empty", False), ("unterminated", False),
                                        ("bad_page", False), ("unknown_mode", True)])
def test_dcx_refusals_and_files_passed_on(case, opens):
    good = pil_bytes(Image.fromarray(page((4, 4), 32)).convert("RGB"), "PCX")
    odd = bytearray(good)
    odd[65] = 2  # 8 bits in 2 planes: PCX fails on it
    data = {"empty": dcx_file([]), "unterminated": dcx_file([good], terminated=False)[:8],
            "bad_page": dcx_file([b"\x0b" + good[1:]]),
            "unknown_mode": dcx_file([bytes(odd)])}[case]
    assert not assert_as_pil(data)
    assert pcx.is_dcx(data) == opens


def test_dcx_read_image_equals_reference(tmp_path):
    data = dcx_file([pil_bytes(Image.fromarray(page((20, 31), 33)), "PCX")])
    assert_read_image_equal(tmp_path, data, "page.dcx")

"""PSD through ``tdnet_torch.data.psd`` against PIL's
``Image.open(...).convert("RGB")`` and ``.size``: hand-made files (PIL
has no PSD writer) of every colour mode PIL reads, raw and PackBits,
image resources and a layer section to step over, a run that passes a
row's end, and the files PIL refuses or passes on; cv2 refuses PSD
bodies."""

import struct

import numpy as np
import pytest

from tdnet_torch.data import psd
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal, page


def _decode(d):
    return psd.decode_psd(d, route="pil")


def packbits(row) -> bytes:
    out, i, b = bytearray(), 0, bytes(row)
    while i < len(b):
        j = i
        while j < len(b) and j - i < 128 and b[j] == b[i]:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i), b[i]])
            i = j
        else:
            k = i + 1
            while k < len(b) and k - i < 128 and not (k + 1 < len(b) and b[k] == b[k + 1]):
                k += 1
            out += bytes([k - i - 1]) + b[i:k]
            i = k
    return bytes(out)


def psd_file(kind, bits, channels, planes, w, h, compression=0, cmd=b"", res=b"",
             layers=b""):
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels, h, w, bits, kind)
    body = (struct.pack(">I", len(cmd)) + cmd + struct.pack(">I", len(res)) + res
            + struct.pack(">I", len(layers)) + layers)
    if compression == 0:
        image = struct.pack(">H", 0) + b"".join(p.tobytes() for p in planes)
    else:
        rows = [packbits(r) for p in planes for r in p]
        image = (struct.pack(">H", 1) + b"".join(struct.pack(">H", len(r)) for r in rows)
                 + b"".join(rows))
    return head + body + image


W, H = 13, 9
PX = page((H, W), 1, 4)
PALETTE = np.random.default_rng(0).integers(0, 256, 768, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("mode", ["rgb", "rgba", "rgb_5_channels", "gray", "cmyk", "lab",
                                  "indexed", "indexed_no_palette", "bitmap", "multichannel",
                                  "duotone"])
def test_psd_modes(mode, compression):
    bits = np.packbits(PX[:, :, 0] > 128, axis=1)
    kind, depth, channels, planes, cmd = {
        "rgb": (3, 8, 3, 3, b""), "rgba": (3, 8, 4, 4, b""), "rgb_5_channels": (3, 8, 5, 5, b""),
        "gray": (1, 8, 1, 1, b""), "cmyk": (4, 8, 4, 4, b""), "lab": (9, 8, 3, 3, b""),
        "indexed": (2, 8, 1, 1, PALETTE), "indexed_no_palette": (2, 8, 1, 1, b""),
        "bitmap": (0, 1, 1, 1, b""), "multichannel": (7, 8, 2, 2, b""),
        "duotone": (8, 8, 1, 1, PALETTE[:10])}[mode]
    planes = [bits] if mode == "bitmap" else [PX[:, :, i % 4] for i in range(planes)]
    data = psd_file(kind, depth, channels, planes, W, H, compression, cmd=cmd)
    assert assert_as_pil(data, _decode, psd.psd_size)


def test_psd_resources_layers_and_a_run_past_its_row():
    res = b"8BIM" + struct.pack(">H", 1005) + b"\x00\x00" + struct.pack(">I", 3) + b"abc\x00"
    res += b"8BIM" + struct.pack(">H", 1039) + b"\x03abc" + struct.pack(">I", 2) + b"xy"
    layers = struct.pack(">I", 0) + bytes(8)
    data = psd_file(3, 8, 3, [PX[:, :, i] for i in range(3)], W, H, 0, res=res, layers=layers)
    assert assert_as_pil(data, _decode, psd.psd_size)
    one = psd_file(1, 8, 1, [np.zeros((2, 4), np.uint8)], 4, 2, 0)
    data = (one[:-(2 + 8)] + struct.pack(">HHH", 1, 2, 2) + bytes([256 - 5, 7, 256 - 3, 9])
            + bytes(4))
    assert assert_as_pil(data, _decode, psd.psd_size)


@pytest.mark.parametrize("case,opens", [("few_channels", True), ("mode_5", False),
                                        ("16_bit", False), ("short_pixels", True),
                                        ("zip", True), ("short_counts", False),
                                        ("version_2", False), ("short_resources", False)])
def test_psd_refusals_and_files_passed_on(case, opens):
    rgb = psd_file(3, 8, 3, [PX[:, :, i] for i in range(3)], W, H, 0)
    zipped = bytearray(rgb)
    zipped[38:40] = b"\0\2"
    data = {"few_channels": psd_file(3, 8, 2, [PX[:, :, i] for i in range(2)], W, H),
            "mode_5": psd_file(5, 8, 3, [PX[:, :, i] for i in range(3)], W, H),
            "16_bit": psd_file(3, 16, 3, [PX[:, :, i] for i in range(3)], W, H),
            "short_pixels": rgb[:-5], "zip": bytes(zipped),
            "short_counts": psd_file(3, 8, 3, [PX[:, :, i] for i in range(3)], W, H, 1)[:50],
            "version_2": rgb[:5] + b"\2" + rgb[6:],
            "short_resources": psd_file(3, 8, 3, [], W, H, res=b"8BIM\0\1\5ab")[:44]}[case]
    assert not assert_as_pil(data)
    assert psd.is_psd(data) == opens


def test_psd_read_image_equals_reference(tmp_path):
    px = page((30, 22), 2, 4)
    data = psd_file(3, 8, 4, [px[:, :, i] for i in range(4)], 22, 30, 1)
    assert_read_image_equal(tmp_path, data, "page.psd")

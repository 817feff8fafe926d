"""MSP (Windows Paint) through ``tdnet_torch.data.msp`` against PIL's
``Image.open(...).convert("RGB")`` and ``.size``: version 1 from PIL's
writer, version 2 (``LinS``, PIL's ``MspDecoder``) by hand: runs and
copies, empty rows, rows that run into the next, and the files PIL
refuses or passes on; cv2 refuses MSP bodies."""

import struct

import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import msp
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal, pil_bytes


def _decode(d):
    return msp.decode_msp(d, route="pil")


def _bits(shape, seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 2, shape, dtype=np.uint8) * 255).convert("1")


@pytest.mark.parametrize("shape", [(3, 10), (9, 17), (1, 8), (5, 1)])
def test_msp_v1_from_pil_equals_pil(shape):
    assert assert_as_pil(pil_bytes(_bits(shape, 1), "MSP"), _decode, msp.msp_size)


def linsfile(w, h, rows, rowmap=None) -> bytes:
    """A version-2 file: header with its checksum, the row map, the rows."""
    head = bytearray(b"LinS" + struct.pack("<HH", w, h) + bytes(24))
    check = 0
    for v in struct.unpack("<16H", bytes(head)):
        check ^= v
    head[30:32] = struct.pack("<H", check)
    rowmap = [len(r) for r in rows] if rowmap is None else rowmap
    return bytes(head) + struct.pack(f"<{h}H", *rowmap) + b"".join(rows)


@pytest.mark.parametrize("case", ["runs", "copies", "empty_rows", "long_rows", "short_rows",
                                  "copy_cut_at_row_end"])
def test_msp_v2_rows(case):
    rows = {"runs": [b"\0\2\x0f", b"\0\1\xa0\1\x55"],
            "copies": [b"\2\x12\x34", b"\2\xff\0"],
            "empty_rows": [b"", b"\0\2\x81"],
            "long_rows": [b"\0\3\x0f", b"\1\x55"],
            "short_rows": [b"\1\x12", b"\3\x34\x56\x78"],
            "copy_cut_at_row_end": [b"\5\x12", b"\2\x34\x56"]}[case]
    data = linsfile(12, 2, rows)
    assert assert_as_pil(data, _decode, msp.msp_size) == (case != "copy_cut_at_row_end")


@pytest.mark.parametrize("case,opens", [("bad_checksum", False), ("short_header", False),
                                        ("zero_width", False), ("short_rowmap", True),
                                        ("short_row", True), ("run_cut", True),
                                        ("short_v1", True)])
def test_msp_refusals_and_files_passed_on(case, opens):
    good = linsfile(8, 2, [b"\0\1\x0f", b"\0\1\xf0"])
    bad = bytearray(good)
    bad[10] ^= 1
    data = {"bad_checksum": bytes(bad), "short_header": good[:20],
            "zero_width": linsfile(0, 2, [b"", b""]), "short_rowmap": good[:33],
            "short_row": good[:-1], "run_cut": linsfile(8, 1, [b"\0\1"]),
            "short_v1": pil_bytes(_bits((4, 16), 2), "MSP")[:-1]}[case]
    assert not assert_as_pil(data)
    assert msp.is_msp(data) == opens


def test_msp_read_image_equals_reference(tmp_path):
    assert_read_image_equal(tmp_path, pil_bytes(_bits((21, 30), 3), "MSP"), "page.msp")

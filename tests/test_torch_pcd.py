"""Photo CD through ``tdnet_torch.data.pcd`` against PIL's
``Image.open(...).convert("RGB")`` and ``.size`` on hand-made files (PIL
has no PCD writer): the base image's PhotoYCC through PIL's tables, each
orientation, and the files PIL refuses or passes on; cv2 refuses PCD
bodies. ``tools/make_photoycc_tables.py`` checks the tables on every
(y, cb, cr); here random samples cover them at the base image's size."""

import numpy as np
import pytest

from tdnet_torch.data import pcd
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal


def _decode(d):
    return pcd.decode_pcd(d, route="pil")


def pcd_file(orientation=0, seed=0, cut=0) -> bytes:
    data = bytearray(96 * 2048 + 3 * 768 * 256)
    data[2048:2052] = b"PCD_"
    data[2048 + 1538] = orientation
    data[96 * 2048:] = np.random.default_rng(seed).integers(0, 256, 3 * 768 * 256,
                                                            dtype=np.uint8).tobytes()
    return bytes(data[:len(data) - cut])


@pytest.mark.parametrize("orientation", [0, 1, 2, 3, 0x86])
def test_pcd_orientations(orientation):
    assert assert_as_pil(pcd_file(orientation, orientation), _decode, pcd.pcd_size)


def test_pcd_refusals_and_files_passed_on():
    assert not assert_as_pil(pcd_file(cut=1))
    assert pcd.is_pcd(pcd_file(cut=1))
    short = pcd_file()[:2048 + 1538]
    assert not pcd.is_pcd(short)
    assert_as_pil(short)


def test_pcd_read_image_equals_reference(tmp_path):
    assert_read_image_equal(tmp_path, pcd_file(1, 9), "page.pcd")

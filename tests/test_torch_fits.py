"""FITS through ``tdnet_torch.data.fits`` against PIL's
``Image.open(...).convert("RGB")`` and ``.size``: hand-made files (PIL
has no FITS writer) at every BITPIX PIL reads, one axis, an image in an
extension after an empty primary unit, PIL's ``fits_gzip`` route at each
depth, and the headers PIL refuses or passes on; cv2 refuses FITS
bodies."""

import gzip

import numpy as np
import pytest

from tdnet_torch.data import fits
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal


def _decode(d):
    return fits.decode_fits(d, route="pil")


def card(key, value=""):
    return (key.ljust(8).encode() + (b"= " + value.encode() if value else b"")).ljust(80)


def unit(*cards):
    body = b"".join(cards) + card("END")
    return body + b" " * (-len(body) % 2880)


def simple(bits, *axes, naxis=None):
    cards = [card("SIMPLE", "T"), card("BITPIX", str(bits)),
             card("NAXIS", str(len(axes) if naxis is None else naxis))]
    return unit(*cards, *(card(f"NAXIS{i + 1}", str(n)) for i, n in enumerate(axes)))


def samples(bits, shape, seed):
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bits]
    return (np.random.default_rng(seed).random(shape) * 600 - 100).astype(dt).tobytes()


@pytest.mark.parametrize("bits", [8, 16, 32, -32, -64])
@pytest.mark.parametrize("axes", [(7, 5), (7,)])
def test_fits_images(bits, axes):
    data = simple(bits, *axes) + samples(bits, axes[::-1], bits & 0xFF)
    data += b"\0" * (-len(data) % 2880)
    assert assert_as_pil(data, _decode, fits.fits_size)


def test_fits_image_in_an_extension():
    data = (simple(8, naxis=0) + unit(card("XTENSION", "'IMAGE   '"), card("BITPIX", "16"),
                                      card("NAXIS", "2"), card("NAXIS1", "7"),
                                      card("NAXIS2", "5")) + samples(16, (5, 7), 1) + bytes(30))
    assert assert_as_pil(data, _decode, fits.fits_size)


def gzipped(zbits, values, pad=0):
    table = unit(card("XTENSION", "'BINTABLE'"), card("BITPIX", "8"), card("NAXIS", "2"),
                 card("NAXIS1", "8"), card("NAXIS2", "1"), card("ZIMAGE", "T"),
                 card("ZCMPTYPE", "'GZIP_1  '"), card("ZBITPIX", str(zbits)),
                 card("ZNAXIS", "2"), card("ZNAXIS1", "7"), card("ZNAXIS2", "5"))
    return simple(8, naxis=0) + table + bytes(8) + gzip.compress(values) + bytes(pad)


@pytest.mark.parametrize("zbits,reads", [(8, True), (16, True), (32, True), (-32, False)])
def test_fits_gzip_route(zbits, reads):
    values = np.random.default_rng(2).integers(0, 400, 35).astype(">i4").tobytes()
    assert assert_as_pil(gzipped(zbits, values), _decode, fits.fits_size) == reads
    assert_as_pil(gzipped(zbits, values, pad=10), _decode)
    assert not assert_as_pil(gzipped(zbits, values[:-4]), _decode)


@pytest.mark.parametrize("case,opens", [("missing_card", False), ("not_an_integer", True),
                                        ("no_data", True), ("simple_false", False),
                                        ("no_image", True), ("bitpix_64", False),
                                        ("zero_size", False), ("short_pixels", True)])
def test_fits_refusals_and_files_passed_on(case, opens):
    """A file that ends inside its pixels is read from 80 bytes before its
    end (PIL takes the data's offset from the card it could not read
    whole): PIL reads it, from the header's padding."""
    data = {"missing_card": simple(8, 7, naxis=2) + bytes(100),
            "not_an_integer": unit(card("SIMPLE", "T"), card("BITPIX", "8"), card("NAXIS", "2"),
                                   card("NAXIS1", "x"), card("NAXIS2", "5")) + bytes(100),
            "no_data": simple(8, 7, 5),
            "simple_false": unit(card("SIMPLE", "F"), card("BITPIX", "8")) + bytes(100),
            "no_image": simple(8, naxis=0) + bytes(100),
            "bitpix_64": simple(64, 7, 5) + bytes(400),
            "zero_size": simple(8, 0, 5) + bytes(100),
            "short_pixels": simple(16, 7, 5) + bytes(69)}[case]
    assert assert_as_pil(data) == (case == "short_pixels")
    assert fits.is_fits(data) == opens


def test_fits_read_image_equals_reference(tmp_path):
    data = simple(16, 31, 22) + samples(16, (22, 31), 3) + bytes(100)
    assert_read_image_equal(tmp_path, data, "page.fits")

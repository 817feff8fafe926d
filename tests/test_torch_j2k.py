"""JPEG 2000 pages (``tdnet_torch/data/jp2.py`` with ``j2k.py``,
``j2k_t1.py`` and ``j2k_dwt.py``) against the reference's two decoders:
each case byte-equal to PIL's ``Image.open(...).convert("RGB")`` on the
``pil`` route (files, ``tdnet/data/image.py``) and to ``cv2.imdecode(...,
IMREAD_COLOR)[:, :, ::-1]`` on the ``cv2`` route (serve bodies,
``tdnet/bin/serve.py``), a refusal where the reference refuses, and
``image_size`` equal to PIL's ``.size``. The 9/7 path is held exactly too:
the port lifts in float32 in OpenJPEG's order, without fused
multiply-adds.

The fixtures (at most 64x80, from numpy seeds) come from PIL's and cv2's
writers, from OpenJPEG's own encoder through ``tools/j2k_write.py`` (the
code-block styles, POC, SOP/EPH, tile-parts, ROI, subsampling, signed
samples and other precisions), and from JP2 boxes written by hand
(palettes, channel definitions, colour spaces). A small fuzz cuts and
flips bytes of a codestream. The four full-size pages are left to the
card's pages phase (``tests/test_torch_pages.py`` ``SLOW_PAGES``)."""

import io
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import image as port_image
from tdnet_torch.data import jp2

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import j2k_write as jw  # noqa: E402


def _image(shape, seed, channels=3):
    """A smooth page-like image: blurred noise, uint8."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape + (channels,), dtype=np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 0).reshape(img.shape)


def _pil(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except (OSError, ValueError, SyntaxError, AssertionError, Image.DecompressionBombError):
        return None


def _cv2(data: bytes):
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[:, :, ::-1]


def _pil_size(data: bytes):
    try:
        return Image.open(io.BytesIO(data)).size
    except (OSError, ValueError, SyntaxError, AssertionError, Image.DecompressionBombError):
        return None


def _assert_routes(data: bytes, expect=None):
    """Both routes against their references; ``expect`` (pil readable, cv2
    readable) pins which of them read the case."""
    read = []
    for route, oracle in (("pil", _pil), ("cv2", _cv2)):
        want = oracle(data)
        read.append(want is not None)
        if want is None:
            with pytest.raises(ValueError):
                jp2.decode_jpeg2000(data, route=route)
            continue
        got = jp2.decode_jpeg2000(data, route=route)
        assert got.dtype == np.uint8 and got.shape == want.shape, (route, got.shape, want.shape)
        if not np.array_equal(got, want):
            diff = np.argwhere(got != want)
            pytest.fail(f"{route}: {len(diff)} samples differ, first at {diff[0].tolist()}")
    size = _pil_size(data)
    if size is None:
        with pytest.raises(ValueError):
            jp2.jpeg2000_size(data)
    else:
        assert jp2.jpeg2000_size(data) == size
    if expect is not None:
        assert tuple(read) == expect, f"references read {read}, the case expects {expect}"


def _pil_save(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


# --- PIL's writer

PIL_MODES = ["L", "LA", "RGB", "RGBA", "YCbCr", "CMYK", "I;16"]


@pytest.mark.parametrize("container", ["jp2", "j2k"])
@pytest.mark.parametrize("mode", PIL_MODES)
def test_pil_modes_by_both_routes(mode, container):
    """Every mode PIL writes, as a JP2 file and as a raw codestream: cv2
    refuses a codestream of 1 or 2 components (it assumes sRGB) and a CMYK
    JP2; 16-bit gray parts the routes (PIL clips I;16 to 255, cv2 keeps
    the high byte); PIL writes YCbCr as sYCC."""
    rgba = _image((37, 53), len(mode), 4)
    if mode == "I;16":
        im = Image.fromarray(rgba[:, :, 0].astype(np.uint16) * 257 + 3)
    else:
        im = Image.fromarray(rgba, "RGBA").convert(mode)
    _assert_routes(_pil_save(im, no_jp2=container == "j2k"))


PIL_OPTIONS = {
    "irreversible": dict(irreversible=True),
    "layers_rates": dict(quality_layers=[40, 20, 10]),
    "layers_rates_97": dict(irreversible=True, quality_layers=[60, 15, 3]),
    "layers_db": dict(quality_mode="dB", quality_layers=[20, 35], irreversible=True),
    "rlcp": dict(progression="RLCP", quality_layers=[20, 5]),
    "rpcl": dict(progression="RPCL", precinct_size=(16, 16)),
    "pcrl": dict(progression="PCRL", precinct_size=(32, 32)),
    "cprl": dict(progression="CPRL", precinct_size=(16, 16), num_resolutions=3),
    "tiles": dict(tile_size=(32, 32), num_resolutions=3),
    "tiles_offset": dict(tile_size=(24, 32), tile_offset=(3, 5), offset=(7, 9),
                         num_resolutions=3),
    "offset": dict(offset=(5, 3), tile_size=(128, 128)),
    "codeblocks": dict(codeblock_size=(16, 8)),
    "resolutions_1": dict(num_resolutions=1),
    "resolutions_2_97": dict(num_resolutions=2, irreversible=True),
    "plt_comment": dict(plt=True, comment="a page"),
    "no_mct_97": dict(mct=0, irreversible=True, quality_layers=[10]),
}


@pytest.mark.parametrize("case", sorted(PIL_OPTIONS))
def test_pil_writer_options_by_both_routes(case):
    """PIL's encoder options: the 9/7 (held exact), rate and distortion
    layers (code-blocks cut short, reconstructed half-way), the five
    progressions with precincts, tiles and image and tile offsets (cv2
    refuses an offset image), code-block sizes, resolutions, PLT and COM."""
    im = Image.fromarray(_image((61, 78), len(case)))
    _assert_routes(_pil_save(im, no_jp2=True, **PIL_OPTIONS[case]))


CV2_CASES = {
    "rgb": (3, 8, []), "gray": (1, 8, []), "rgb16": (3, 16, []), "bgra": (4, 8, []),
    "lossy": (3, 8, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 100]),
}


@pytest.mark.parametrize("case", sorted(CV2_CASES))
def test_cv2_writer_by_both_routes(case):
    """cv2's own JP2 writer (which wants 32 pixels a side): 8- and 16-bit,
    gray, BGR, BGRA, and lossy at a 1:10 rate."""
    channels, bits, params = CV2_CASES[case]
    img = _image((48, 64), len(case), channels)
    if bits == 16:
        img = img.astype(np.uint16) * 257 + 17
    ok, enc = cv2.imencode(".jp2", img if channels > 1 else img[:, :, 0], params)
    assert ok
    _assert_routes(enc.tobytes())


# --- OpenJPEG's encoder (tools/j2k_write.py)

OPENJPEG = {  # name: encode arguments
    "bypass": dict(mode=1), "reset": dict(mode=2), "termall": dict(mode=4),
    "termall_pterm": dict(mode=20, rates=[4]),
    "vsc": dict(mode=8), "pterm": dict(mode=16), "segsym": dict(mode=32),
    "all_styles": dict(mode=63, rates=[4]), "bypass_layers": dict(mode=1, rates=[20, 6, 2]),
    "sop_eph": dict(csty=6, layers=2), "poc": dict(pocs=[(0, 0, 1, 3, 3, "LRCP"),
                                                        (3, 0, 1, 6, 3, "RLCP")]),
    "poc_cprl": dict(pocs=[(0, 0, 2, 6, 1, "CPRL"), (0, 1, 2, 6, 3, "RPCL")], layers=2,
                     precincts=[(16, 16)] * 6),
    "tile_parts_r": dict(tile=(32, 32), levels=3, tile_parts="R"),
    "tile_parts_l": dict(layers=3, tile_parts="L"),
    "tile_parts_c": dict(tile=(32, 40), levels=3, tile_parts="C"),
    "roi_53": dict(roi=(0, 7)), "roi_97": dict(roi=(1, 5), irreversible=True, rates=[20]),
    "subsampled_420": dict(subsampling=[(1, 1), (2, 2), (2, 2)], mct=0),
    "subsampled_odd": dict(subsampling=[(1, 1), (2, 1), (1, 2)], mct=0, offset=(3, 2)),
    "subsampled_first": dict(subsampling=[(2, 2), (1, 1), (1, 1)], mct=0),
    "signed": dict(signed=True), "precision_4": dict(prec=4), "precision_7": dict(prec=7),
    "precision_10": dict(prec=10), "precision_12": dict(prec=12, irreversible=True),
    "precision_16": dict(prec=16), "gray_12_jp2": dict(prec=12, gray=True),
    "gray_16_jp2": dict(prec=16, gray=True), "five_components": dict(components=5),
    "levels_0": dict(levels=0), "levels_1_97": dict(levels=1, irreversible=True),
    "codeblock_4x64": dict(codeblock=(4, 64)),
}


@pytest.mark.parametrize("case", sorted(OPENJPEG))
def test_openjpeg_encoder_cases_by_both_routes(case):
    """What PIL's and cv2's writers cannot make: each code-block style
    (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM), POC, SOP and EPH,
    tile-parts by resolution, layer and component, the ROI max-shift,
    subsampled components (PIL reads them at ``x // dx``; cv2 refuses),
    signed samples and 4 to 16 bits (cv2 refuses signed and under 8), and
    five components (both refuse)."""
    kw = dict(OPENJPEG[case])
    prec = kw.get("prec", 8)
    gray = kw.pop("gray", False)
    components = kw.pop("components", 3)
    img = _image((40, 57), len(case), max(components, 3))[:, :, :components].astype(np.int64)
    img = (img * ((1 << prec) - 1)) // 255
    if kw.get("signed"):
        img -= 1 << (prec - 1)
    if gray:
        data = jw.encode(img[:, :, 0], jp2_file=True, color_space=2, **kw)
    else:
        data = jw.encode(img, **kw)
    _assert_routes(data)


def _codestream(mode="L", shape=(40, 64), seed=5, **kw) -> bytes:
    return _pil_save(Image.fromarray(_image(shape, seed)).convert(mode), no_jp2=True, **kw)


def _boxes():
    h, w = 40, 64
    gray, rgb = _codestream("L"), _codestream("RGB")
    rng = np.random.default_rng(11)
    palette = rng.integers(0, 256, (256, 3))
    dup = palette.copy()
    dup[10] = dup[3]
    ihdr1, ihdr3 = jw.ihdr(h, w, 1, 7), jw.ihdr(h, w, 3, 7)
    rgb_cmap = jw.cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    return {  # name: (file, (pil reads, cv2 reads))
        "gray_as_srgb": (jw.jp2(gray, [ihdr1, jw.colr(16)]), (False, False)),
        "gray_without_colr": (jw.jp2(gray, [ihdr1]), (True, False)),
        "rgb_icc": (jw.jp2(rgb, [ihdr3, jw.colr(icc=bytes(128))]), (True, True)),
        "rgb_as_gray": (jw.jp2(rgb, [ihdr3, jw.colr(17)]), (False, True)),
        "rgb_esycc": (jw.jp2(rgb, [ihdr3, jw.colr(24)]), (False, False)),
        "rgb_unknown_enumcs": (jw.jp2(rgb, [ihdr3, jw.colr(99)]), (True, True)),
        "rgb_two_colr": (jw.jp2(rgb, [ihdr3, jw.colr(16), jw.colr(17)]), (True, True)),
        "palette": (jw.jp2(gray, [ihdr1, jw.colr(16), jw.pclr(palette), rgb_cmap]),
                    (True, True)),
        "palette_repeated_colour": (jw.jp2(gray, [ihdr1, jw.colr(16), jw.pclr(dup[:200]),
                                                  rgb_cmap]), (True, True)),
        "palette_without_cmap": (jw.jp2(gray, [ihdr1, jw.colr(16), jw.pclr(palette)]),
                                 (True, False)),
        "cdef_bgr": (jw.jp2(rgb, [ihdr3, jw.colr(16),
                                  jw.cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)])]), (True, True)),
        "cdef_incomplete": (jw.jp2(rgb, [ihdr3, jw.colr(16), jw.cdef([(0, 0, 1)])]),
                            (True, False)),
        "sycc": (jw.jp2(jw.encode(_image((h, w), 3).astype(np.int64), mct=0),
                        [ihdr3, jw.colr(18)]), (True, True)),
        "cmyk": (jw.jp2(_codestream("RGBA"), [jw.ihdr(h, w, 4, 7), jw.colr(12)]),
                 (True, False)),
        "jpx_brand": (jw.jp2(rgb, [ihdr3, jw.colr(16)], brand=b"jpx "), (True, True)),
    }


BOXES = sorted(_boxes())


@pytest.fixture(scope="module")
def boxes():
    return _boxes()


@pytest.mark.parametrize("case", BOXES)
def test_jp2_boxes_by_both_routes(boxes, case):
    """JP2 headers written by hand around PIL's codestreams: colour spaces
    (PIL has no unpacker for gray called sRGB or RGB called gray, treats a
    missing, ICC or unknown ``colr`` as unspecified and refuses e-sYCC;
    cv2 takes anything but grey, sYCC and CMYK for sRGB), a palette through
    ``cmap`` (PIL's ``P`` mode: repeated colours share a slot, later slots
    are black; cv2's ``opj_jp2_apply_pclr``), a palette without ``cmap``
    (cv2 sees one component and refuses), channel definitions (cv2
    reorders by ``cdef``, PIL ignores it; an incomplete one fails on cv2's
    route), sYCC (PIL's and OpenCV's own YCbCr conversions), CMYK and the
    ``jpx`` brand."""
    data, expect = boxes[case]
    _assert_routes(data, expect)


def test_colour_conversions_equal_their_references():
    """PIL's ``ImagingConvertYCbCr2RGB`` tables and OpenCV's 8-bit
    ``COLOR_YUV2BGR`` on 2^18 random triples (the whole cube was held once,
    outside the suite)."""
    rng = np.random.default_rng(0)
    ycc = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
    want = np.asarray(Image.frombytes("YCbCr", (512, 512), ycc.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(jp2._pil_ycbcr_rgb(ycc), want)
    np.testing.assert_array_equal(jp2._yuv_bgr(ycc),
                                  cv2.cvtColor(ycc, cv2.COLOR_YUV2BGR)[:, :, ::-1])


# --- damaged codestreams


@pytest.fixture(scope="module")
def layered():
    return _codestream("RGB", quality_layers=[40, 10, 1])


@pytest.mark.parametrize("cut", [2, 1, 3, 40, 1000, 2500, 4000])
def test_truncated_codestreams_by_both_routes(layered, cut):
    """A codestream cut short: OpenJPEG wants a marker after the last
    tile-part, so losing only the EOC marker fails as a cut into the
    packets does, on both routes."""
    _assert_routes(layered[:len(layered) - cut], (False, False))


def test_flipped_packet_bytes_by_both_routes(layered):
    """30 single-bit flips in the first 200 bytes of packet data (headers
    and code-block data): each route reads what its reference reads, to
    the same pixels, and refuses what it refuses. OpenJPEG decodes most of
    them; a code-block given more zero bit-planes than its band has is
    read as empty."""
    sod = layered.find(b"\xff\x93") + 2
    rng = np.random.default_rng(3)
    for _ in range(30):
        pos = int(rng.integers(sod, min(sod + 200, len(layered) - 2)))
        data = bytearray(layered)
        data[pos] ^= 1 << int(rng.integers(0, 8))
        _assert_routes(bytes(data))


def test_decode_image_and_image_size_sniff_both_forms(tmp_path):
    """``decode_image`` and ``image_size`` tell a codestream and a JP2 file
    by their first bytes, whatever the file is called."""
    im = Image.fromarray(_image((30, 45), 9))
    for name, data in (("page.bin", _pil_save(im, no_jp2=True)), ("page.png", _pil_save(im))):
        (tmp_path / name).write_bytes(data)
        np.testing.assert_array_equal(port_image.decode_image(data, route="pil"), _pil(data))
        np.testing.assert_array_equal(port_image.decode_image(data, route="cv2"), _cv2(data))
        assert port_image.image_size(tmp_path / name) == (45, 30)
        np.testing.assert_array_equal(port_image.read_image_bgr(tmp_path / name),
                                      _pil(data)[:, :, ::-1].astype(np.float32))


# --- marker segments OpenJPEG's encoder does not write, made by hand


def _main_segments(cs: bytes):
    """{marker: (start, end)} of the main header's segments, and the first
    SOT's offset."""
    out, pos = {}, 2
    while cs[pos:pos + 2] != b"\xff\x90":
        length = int.from_bytes(cs[pos + 2:pos + 4], "big")
        out.setdefault(cs[pos:pos + 2], (pos, pos + 2 + length))
        pos += 2 + length
    return out, pos


def _segment(marker: int, body: bytes) -> bytes:
    return marker.to_bytes(2, "big") + (len(body) + 2).to_bytes(2, "big") + body


def _move(cs: bytes, seg: bytes, main: bool, drop=None) -> bytes:
    """``seg`` added to the main header (before the first SOT) or to the
    first tile-part's header (its Psot grown to hold it); ``drop`` (start,
    end) cut out of the codestream first."""
    if drop is not None:
        cut = cs[:drop[0]] + cs[drop[1]:]
        if drop[0] > _main_segments(cs)[1]:  # from the first tile-part: shrink its Psot
            sot = _main_segments(cs)[1]
            psot = int.from_bytes(cut[sot + 6:sot + 10], "big") - (drop[1] - drop[0])
            cut = cut[:sot + 6] + psot.to_bytes(4, "big") + cut[sot + 10:]
        cs = cut
    sot = _main_segments(cs)[1]
    if main:
        return cs[:sot] + seg + cs[sot:]
    psot = int.from_bytes(cs[sot + 6:sot + 10], "big") + len(seg)
    return cs[:sot + 6] + psot.to_bytes(4, "big") + cs[sot + 10:sot + 12] + seg + cs[sot + 12:]


def _second_part(cs: bytes) -> bytes:
    """The main header's COD and QCD copied into a tile's second
    tile-part header (its Psot grown to hold them)."""
    segs, _ = _main_segments(cs)
    extra = cs[slice(*segs[b"\xff\x52"])] + cs[slice(*segs[b"\xff\x5c"])]
    sot = [i for i in range(len(cs) - 1) if cs[i:i + 2] == b"\xff\x90"][1]
    psot = int.from_bytes(cs[sot + 6:sot + 10], "big") + len(extra)
    return cs[:sot + 6] + psot.to_bytes(4, "big") + cs[sot + 10:sot + 12] + extra + cs[sot + 12:]


def _hand_made():
    rgb = _image((40, 57), 21).astype(np.int64)
    plain = jw.encode(rgb, levels=3)
    segs, _ = _main_segments(plain)
    cod = plain[slice(*segs[b"\xff\x52"])][4:]
    qcd = plain[slice(*segs[b"\xff\x5c"])][4:]
    coc = _segment(0xFF53, bytes([1, cod[0] & 1]) + cod[5:])
    qcc = _segment(0xFF5D, bytes([2]) + qcd)
    roi = jw.encode(rgb, levels=3, roi=(1, 6))
    rgn = _main_segments(roi)[0][b"\xff\x5e"]
    poc = jw.encode(rgb, levels=3, pocs=[(0, 0, 1, 2, 3, "LRCP"), (2, 0, 1, 4, 3, "RLCP")])
    sot = _main_segments(poc)[1]
    at = poc.find(b"\xff\x5f", sot)
    poc_seg = (at, at + 2 + int.from_bytes(poc[at + 2:at + 4], "big"))
    return {
        "coc_main": _move(plain, coc, True), "coc_tile": _move(plain, coc, False),
        "cod_tile": _move(plain, _segment(0xFF52, cod), False),
        "qcd_tile": _move(plain, _segment(0xFF5C, qcd), False),
        "qcc_main": _move(plain, qcc, True), "qcc_tile": _move(plain, qcc, False),
        "rgn_tile": _move(roi, roi[slice(*rgn)], False, drop=rgn),
        "poc_main": _move(poc, poc[slice(*poc_seg)], True, drop=poc_seg),
        "cod_qcd_second_tile_part": _second_part(jw.encode(rgb, levels=3, tile_parts="R")),
        "crg": _move(plain, _segment(0xFF63, bytes(12)), True),
        "plm": _move(plain, _segment(0xFF57, bytes([0, 1, 5])), True),
    }


HAND_MADE = sorted(_hand_made())


@pytest.fixture(scope="module")
def hand_made():
    return _hand_made()


@pytest.mark.parametrize("case", HAND_MADE)
def test_hand_made_marker_segments_by_both_routes(hand_made, case):
    """Segments OpenJPEG's encoder leaves out, written by hand into its
    codestreams with the values it used, so the image stays the same: COC
    and QCC in the main and a tile-part header, COD, QCD and RGN in a
    tile-part header (COD and QCD in a tile's second tile-part too), POC in
    the main header, CRG and PLM (read and ignored). Both routes read each
    as their references do."""
    _assert_routes(hand_made[case], (True, True))


@pytest.mark.parametrize("marker", [0xFF60, 0xFF61])
def test_packed_packet_headers_are_refused(hand_made, marker):
    """PPM and PPT: neither PIL's, cv2's nor OpenJPEG's writer makes them,
    so the port refuses them by name on both routes rather than read what
    nothing checks."""
    plain = hand_made["crg"]
    data = _move(plain, _segment(marker, bytes([0]) + bytes(8)), marker == 0xFF60)
    for route in ("pil", "cv2"):
        with pytest.raises(ValueError, match="PPM/PPT"):
            jp2.decode_jpeg2000(data, route=route)


def _ends():
    tiled = jw.encode(_image((40, 57), 3).astype(np.int64), levels=3, tile=(32, 32))
    sots = [i for i in range(len(tiled) - 1) if tiled[i:i + 2] == b"\xff\x90"]
    eoc = tiled.rfind(b"\xff\xd9")

    def poke(at, value):
        data = bytearray(tiled)
        data[at] = value
        return bytes(data)

    jp = _pil_save(Image.fromarray(_image((40, 57), 4)), irreversible=True)
    box = jp.find(b"jp2c") - 4

    def jp2c_length(length):
        return jp[:box] + length.to_bytes(4, "big") + jp[box + 4:]

    return {  # name: (data, (pil reads, cv2 reads))
        "second_sot_broken": (poke(sots[1] + 1, 0xD6), (False, False)),
        "sot_length": (poke(sots[1] + 2, 0x23), (False, False)),
        "eoc_broken": (poke(eoc + 1, 0xD6), (False, True)),
        "eoc_turned_sot": (poke(eoc + 1, 0x90), (True, True)),
        "bytes_after_eoc": (tiled + b"junk", (True, True)),
        "one_byte_for_eoc": (tiled[:-2] + b"\x00", (False, False)),
        "two_bytes_for_eoc": (tiled[:-2] + b"\x00\x00", (False, True)),
        "bytes_before_eoc": (tiled[:-2] + bytes(4) + b"\xff\xd9", (False, False)),
        "last_tile_missing": (tiled[:sots[3]] + b"\xff\xd9", (True, True)),
        "jp2c_length_0": (jp2c_length(0), (True, True)),
        "jp2c_length_1": (jp2c_length(1), (False, False)),
        "jp2c_length_long": (jp2c_length(len(jp) + 1000), (True, True)),
        "jp2c_length_short": (jp2c_length(9), (True, True)),
    }


ENDS = sorted(_ends())


@pytest.fixture(scope="module")
def ends():
    return _ends()


@pytest.mark.parametrize("case", ENDS)
def test_codestream_ends_and_box_lengths_by_both_routes(ends, case):
    """Where a codestream or a JP2 file ends, as OpenJPEG reads it: after
    the last tile-part it wants EOC, an SOT or the end of the data; a stray
    marker in the last two bytes ends cv2's whole-image decode but fails
    PIL's tile-by-tile reader; an SOT segment must be 10 bytes; a missing
    tile stays black; the ``jp2c`` box runs to the end of the file whatever
    its length says (1 asks for a 64-bit length and breaks the
    codestream)."""
    data, expect = ends[case]
    _assert_routes(data, expect)


def test_flipped_header_bits_by_both_routes():
    """40 single-bit flips in the main and first tile-part headers of a
    codestream in tiles with SOP/EPH markers, and of a JP2 file: OpenJPEG's
    header rules (exact SIZ, COD, COC, QCD and QCC lengths, known Scod bits,
    unknown markers stepped over two bytes at a time, a component
    transform only over equal components, the ``ihdr`` size equal to the
    codestream's, a whole-image decode that stops once every tile is
    read) hold on both routes."""
    img = _image((40, 57), 9)
    bases = [jw.encode(img.astype(np.int64), levels=3, tile=(32, 32), tile_parts="R", csty=6),
             _pil_save(Image.fromarray(img), irreversible=True)]
    rng = np.random.default_rng(11)
    for i in range(40):
        base = bases[i % 2]
        start = base.find(b"\xff\x4f\xff\x51")
        pos = int(rng.integers(max(start - 60, 0), base.find(b"\xff\x93") + 2))
        data = bytearray(base)
        data[pos] ^= 1 << int(rng.integers(0, 8))
        _assert_routes(bytes(data))


def _poc() -> bytes:
    """Two POC volumes, resolutions 0-2 in LRCP and 3-5 in RLCP."""
    rgb = _image((40, 57), 13).astype(np.int64)
    return jw.encode(rgb, levels=3, pocs=[(0, 0, 1, 3, 3, "LRCP"), (3, 0, 1, 6, 3, "RLCP")])


def _headers():
    rgb = _image((40, 57), 13).astype(np.int64)
    plain = jw.encode(rgb, levels=3)
    segs, _ = _main_segments(plain)
    cod0, cod1 = segs[b"\xff\x52"]
    qcd0, qcd1 = segs[b"\xff\x5c"]
    irr = jw.encode(rgb, levels=3, irreversible=True)
    iq0, iq1 = _main_segments(irr)[0][b"\xff\x5c"]
    sub = jw.encode(rgb, subsampling=[(1, 1), (2, 2), (2, 2)], mct=0)
    sc0 = _main_segments(sub)[0][b"\xff\x52"][0]

    def poke(data, at, value):
        out = bytearray(data)
        out[at] = value
        return bytes(out)

    tiled = jw.encode(rgb, levels=3, tile=(32, 32))
    grid_broken = poke(tiled, 28, 0x10)  # YTsiz: two tiles, then tile-parts past them
    roi = jw.encode(rgb, levels=3, roi=(1, 6))
    rgn = _main_segments(roi)[0][b"\xff\x5e"][0]
    jp = _pil_save(Image.fromarray(rgb.astype(np.uint8)))
    ihdr = jp.find(b"ihdr") + 4
    return {  # name: (data, (pil reads, cv2 reads))
        "scod_unknown_bit": (poke(plain, cod0 + 4, plain[cod0 + 4] | 0x20), (False, False)),
        "cod_too_long": (plain[:cod0 + 3] + bytes([plain[cod0 + 3] + 1]) + plain[cod0 + 4:cod1]
                         + b"\x00" + plain[cod1:], (False, False)),
        "qcd_one_more_byte": (plain[:qcd0 + 3] + bytes([plain[qcd0 + 3] + 1])
                              + plain[qcd0 + 4:qcd1] + b"\x00" + plain[qcd1:], (True, True)),
        "qcd_odd_length_97": (irr[:iq0 + 3] + bytes([irr[iq0 + 3] + 1]) + irr[iq0 + 4:iq1]
                              + b"\x00" + irr[iq1:], (False, False)),
        "qcd_one_more_step_97": (irr[:iq0 + 3] + bytes([irr[iq0 + 3] + 2]) + irr[iq0 + 4:iq1]
                                 + b"\x00\x00" + irr[iq1:], (True, True)),
        "qcd_style_7": (poke(plain, qcd0 + 4, plain[qcd0 + 4] | 7), (True, True)),
        "levels_past_the_data": (poke(plain, cod0 + 9, 7), (True, True)),
        "rct_over_subsampled": (poke(sub, sc0 + 8, 1), (False, False)),
        "siz_component_count": (poke(plain, 41, 2), (False, False)),
        "unknown_marker": (_move(plain, _segment(0xFF6F, bytes(4)), True), (True, True)),
        "mct_marker_alone": (_move(plain, _segment(0xFF74, bytes(7)), True), (True, True)),
        "mct_marker_short": (_move(plain, _segment(0xFF74, bytes(6)), True), (False, False)),
        "tile_parts_past_the_grid": (grid_broken, (False, True)),
        "rgn_style_byte": (poke(roi, rgn + 5, 1), (True, True)),
        "poc_unknown_order_first": (poke(_poc(), _poc().find(b"\xff\x5f") + 10, 7), (True, True)),
        "ihdr_height": (poke(jp, ihdr + 3, jp[ihdr + 3] + 1), (False, False)),
    }


HEADERS = sorted(_headers())


@pytest.fixture(scope="module")
def headers():
    return _headers()


@pytest.mark.parametrize("case", HEADERS)
def test_damaged_headers_by_both_routes(headers, case):
    """Header damage of each kind the fuzz found, made by hand: an unknown
    Scod bit, a COD segment longer than its fields, a QCD segment one byte
    longer (another step size without quantization, half a one when
    expounded) or two (another step size), a quantization style past 2
    (read as expounded), more levels than the packets were made for (its
    bands past the step sizes given take zero ones; the packets misread
    happen to fit), RCT
    over subsampled components, a SIZ component count that does not match
    its length, an unknown marker and a lone Part 2 MCT segment (both
    passed over; an MCT too short for its first record refused),
    tile-parts past a damaged tile grid (cv2's whole-image decode stops
    once every tile is read; PIL's tile reader refuses), an RGN style byte
    (not read), a POC volume of an unknown order (no packets) and an
    ``ihdr`` height not the codestream's."""
    data, expect = headers[case]
    _assert_routes(data, expect)


def test_packet_walk_short_of_the_top_resolution_is_refused():
    """A POC volume of an unknown order that leaves a component's top
    resolutions without a packet: OpenJPEG then rebuilds the image only up
    to the highest resolution read (``resno_decoded``), which the port does
    not do, so it refuses the page by name on both routes (an unported case
    in ROADMAP A) where the references read it."""
    data = bytearray(_poc())
    data[data.find(b"\xff\x5f") + 17] = 7  # the second volume's order
    assert _pil(bytes(data)) is not None and _cv2(bytes(data)) is not None
    for route in ("pil", "cv2"):
        with pytest.raises(ValueError, match="resolution"):
            jp2.decode_jpeg2000(bytes(data), route=route)

"""tdnet_torch.data.jpeg and .bmp against the reference's two decoders:
each case byte-equal to PIL's ``Image.open(...).convert("RGB")`` on the
``pil`` route (files) and to ``cv2.imdecode(..., IMREAD_COLOR)[:, :, ::-1]``
on the ``cv2`` route (serve bodies). PIL and cv2 are oracles here only;
the port imports neither (the last test proves it in a subprocess)."""

import io
import re
import struct
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from tdnet_torch.data import bmp, jpeg
from tdnet_torch.data.image import image_size, read_image_bgr

ROOT = Path(__file__).resolve().parents[1]

# (name, PIL subsampling or a cv2 sampling flag); "gray" is one component
SAMPLINGS = [("444", 0), ("422", 1), ("420", 2),
             ("440", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440), ("gray", None)]
# 1x1 to 70x90, none a multiple of the 16x16 MCU but 16x16 itself
SIZES = [(1, 1), (2, 3), (3, 2), (7, 9), (9, 17), (16, 16), (17, 33), (33, 17), (67, 93)]
QUALITIES = [5, 50, 90, 100]


def _image(shape, seed, channels=3):
    """Random blurred pixels: noise alone is all high frequency."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape + (channels,), dtype=np.uint8)
    if min(shape) >= 5:
        img = cv2.GaussianBlur(img, (5, 5), 0).reshape(img.shape)
    return img


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if img.shape[2] == 1 else img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _cv2_jpeg(img, *params) -> bytes:
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]), list(params))
    assert ok
    return enc.tobytes()


def _encode(img, sampling, quality, **kw) -> bytes:
    if sampling is None:
        return _pil_jpeg(img[..., :1], quality=quality, **kw)
    if sampling > 2:
        return _cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling)
    return _pil_jpeg(img, quality=quality, subsampling=sampling, **kw)


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _cv2(data: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert bgr is not None
    return bgr[:, :, ::-1]


def _assert_both_routes(data: bytes, decode=jpeg.decode_jpeg):
    for route, oracle in (("pil", _pil), ("cv2", _cv2)):
        got, want = decode(data, route=route), oracle(data)
        assert got.dtype == np.uint8 and got.shape == want.shape, (route, got.shape, want.shape)
        if not np.array_equal(got, want):
            diff = np.argwhere(got != want)
            pytest.fail(f"{route}: {len(diff)} samples differ, first at {diff[0].tolist()}")


@pytest.mark.parametrize("shape", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("name,sampling", SAMPLINGS, ids=[s[0] for s in SAMPLINGS])
def test_jpeg_sampling_size_quality_equal_both_routes(name, sampling, shape):
    """Every sampling at sizes off the MCU grid (the upsamplers' edge rules
    and the dummy blocks) and qualities 5 to 100 (the IDCT's range limit)."""
    for q in QUALITIES:
        _assert_both_routes(_encode(_image(shape, q), sampling, q))


@pytest.mark.parametrize("case", ["dqt16", "optimize", "rst_blocks", "rst_rows",
                                  "cv2_rst", "gray_rst", "annex_k"])
def test_jpeg_tables_and_restart_intervals(case):
    """16-bit quantisation tables (an SOF1 frame), optimised Huffman tables,
    restart intervals from both encoders, and a file without DHT (libjpeg's
    Annex K tables, as Motion JPEG sends it)."""
    img = _image((45, 71), 3)
    if case == "dqt16":
        data = _pil_jpeg(img, qtables=[list(range(200, 264)), [300 + 3 * i for i in range(64)]])
        assert data[data.index(b"\xff\xdb") + 4] >> 4 == 1 and b"\xff\xc1" in data
    elif case == "optimize":
        data = _pil_jpeg(img, quality=80, optimize=True, subsampling=2)
    elif case == "rst_blocks":
        data = _pil_jpeg(img, quality=70, restart_marker_blocks=1, subsampling=2)
    elif case == "rst_rows":
        data = _pil_jpeg(img, quality=70, restart_marker_rows=1, subsampling=0)
    elif case == "cv2_rst":
        data = _cv2_jpeg(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)
    elif case == "gray_rst":
        data = _pil_jpeg(img[..., :1], quality=60, restart_marker_blocks=2)
    else:
        data = _strip(_pil_jpeg(img, quality=85), 0xC4)
        assert b"\xff\xc4" not in data
    if case.startswith(("rst", "cv2", "gray")):
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _assert_both_routes(data)


def _segments(data: bytes):
    """(marker, start, end) of each marker segment before the first scan."""
    pos = 2
    while data[pos] == 0xFF and data[pos + 1] != 0xDA:
        marker = data[pos + 1]
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        yield marker, pos, pos + 2 + n
        pos += 2 + n


def _strip(data: bytes, marker: int) -> bytes:
    for m, a, b in _segments(data):
        if m == marker:
            return _strip(data[:a] + data[b:], marker)
    return data


@pytest.mark.parametrize("case", ["adobe_rgb", "rgb_ids", "adobe_ycc", "jfif_rgb_ids"])
def test_jpeg_colour_space_guess(case):
    """jdapimin.c's guess: an Adobe marker's transform 0 means RGB, 1
    YCbCr; without JFIF or Adobe, component ids 'R', 'G', 'B' mean RGB;
    JFIF means YCbCr whatever the ids."""
    img = _image((23, 37), 5)
    data = _pil_jpeg(img, keep_rgb=True, quality=90)
    at = data.index(b"Adobe")
    assert data[at + 11] == 0 and b"JFIF" not in data
    if case == "rgb_ids":
        data = _strip(data, 0xEE)
    elif case == "adobe_ycc":
        data = data[:at + 11] + b"\x01" + data[at + 12:]
    elif case == "jfif_rgb_ids":
        jfif = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
        data = data[:2] + jfif + _strip(data, 0xEE)[2:]
    _assert_both_routes(data)


def _exif(orientation: int, big_endian: bool) -> bytes:
    end = ">" if big_endian else "<"
    ifd = struct.pack(end + "H", 2) + struct.pack(end + "HHI", 0x010F, 2, 4) + b"tdn\x00" \
        + struct.pack(end + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(end + "I", 0)
    return b"Exif\x00\x00" + (b"MM" if big_endian else b"II") + struct.pack(end + "HI", 42, 8) + ifd


@pytest.mark.parametrize("big_endian", [False, True], ids=["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation(orientation, big_endian):
    """The file route ignores EXIF orientation; the body route turns the
    page as cv2 does, for orientations 1-8 and both TIFF byte orders."""
    img = _image((19, 42), orientation)
    data = _pil_jpeg(img, quality=90, subsampling=2, exif=_exif(orientation, big_endian))
    assert jpeg.exif_orientation(data) == orientation
    _assert_both_routes(data)
    assert jpeg.jpeg_size(data) == Image.open(io.BytesIO(data)).size == (42, 19)


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 64), w=st.integers(1, 64), sampling=st.sampled_from(SAMPLINGS),
       quality=st.integers(1, 100), seed=st.integers(0, 2 ** 16))
def test_jpeg_random_images_equal_both_routes(h, w, sampling, quality, seed):
    data = _encode(_image((h, w), seed), sampling[1], quality)
    _assert_both_routes(data)
    assert jpeg.jpeg_size(data) == Image.open(io.BytesIO(data)).size


# --- a sequential encoder of the test's own: scans the two encoders above
# never write (non-interleaved, odd sampling factors), from coefficients


def _codes(counts, symbols):
    codes, code, k = {}, 0, 0
    for bits in range(1, 17):
        for _ in range(counts[bits - 1]):
            codes[symbols[k]] = (code, bits)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


class _Bits:
    def __init__(self):
        self.value, self.n = 0, 0

    def put(self, code, bits):
        self.value, self.n = (self.value << bits) | code, self.n + bits

    def flush(self) -> bytes:
        pad = -self.n % 8
        self.put((1 << pad) - 1, pad)
        out = self.value.to_bytes(self.n // 8, "big").replace(b"\xff", b"\xff\x00")
        self.value, self.n = 0, 0
        return out


def _put_block(bits, zz, pred, dc, ac):
    def size_bits(v):
        s = abs(v).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    s, extra = size_bits(int(zz[0]) - pred)
    bits.put(*dc[s])
    bits.put(extra, s)
    run = 0
    for k in range(1, 64):
        v = int(zz[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            bits.put(*ac[0xF0])
            run -= 16
        s, extra = size_bits(v)
        bits.put(*ac[(run << 4) | s])
        bits.put(extra, s)
        run = 0
    if run:
        bits.put(*ac[0x00])
    return int(zz[0])


def _app_marker(adobe=None) -> bytes:
    """JFIF, or an Adobe APP14 marker with the given colour transform."""
    if adobe is None:
        return b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    return b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([adobe])


# zigzag positions of the first row's AC terms (natural indices 1..7): a
# block with only these has no AC terms in its columns
_ROW0 = [1, 5, 6, 14, 15, 27, 28]


def _sequential_jpeg(rng, h, w, factors, interleaved, restart, extreme=False, adobe=None):
    """A JFIF baseline file of a component for each of the given (h, v)
    sampling factors (an Adobe marker with transform ``adobe`` in place of
    JFIF where given), random quantised coefficients (DC near the middle, a
    few AC, some past a run of 16 and some at position 63), the Annex K
    tables in DHT, one interleaved scan or one scan a component, and a
    restart marker every ``restart`` MCUs (0: none). ``extreme``: the
    largest coefficients the tables code and quantisers of 200-255, half
    the blocks with AC terms in their first row only, so that the inverse
    DCT's 16-bit products, sums and saturations all come into play."""
    from tdnet_torch.data.jpeg import _STD_TABLES

    dc_max, ac_max, q_lo = (1000, 1024, 200) if extreme else (60, 40, 1)
    max_h, max_v = max(f[0] for f in factors), max(f[1] for f in factors)
    mcus_x, mcus_y = -(-w // (8 * max_h)), -(-h // (8 * max_v))
    comps = []
    for ci, (fh, fv) in enumerate(factors):
        rows, cols = mcus_y * fv, mcus_x * fh
        zz = np.zeros((rows, cols, 64), np.int64)
        zz[..., 0] = rng.integers(-dc_max, dc_max, (rows, cols))
        for i in range(rows * cols * 2):
            k = rng.choice(_ROW0) if extreme and i % 2 else rng.integers(1, 64)
            zz[rng.integers(rows), rng.integers(cols), k] = \
                rng.choice([-1, 1]) * rng.integers(1, ac_max)
        zz[0, 0, 1:] = 0
        zz[0, 0, 20] = 3    # a run of 19 zeros: one ZRL
        zz[-1, -1, 63] = -2  # no EOB after the last coefficient
        comps.append(dict(id=ci + 1, fh=fh, fv=fv, zz=zz, tq=min(ci, 1), tables=min(ci, 1),
                          wb=-(-w * fh // (8 * max_h)), hb=-(-h * fv // (8 * max_v))))
    quant = [rng.integers(q_lo, 40 if q_lo == 1 else 256, 64),
             rng.integers(q_lo, 60 if q_lo == 1 else 256, 64)]
    out = [b"\xff\xd8", _app_marker(adobe)]
    for t, q in enumerate(quant):
        out.append(b"\xff\xdb\x00\x43" + bytes([t]) + bytes(q.astype(np.uint8)))
    out.append(b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * len(comps), 8, h, w, len(comps))
               + b"".join(
        bytes([c["id"], (c["fh"] << 4) | c["fv"], c["tq"]]) for c in comps))
    for (tc, th), (counts, symbols) in _STD_TABLES.items():
        out.append(b"\xff\xc4" + struct.pack(">H", 19 + len(symbols)) + bytes([(tc << 4) | th])
                   + counts + symbols)
    if restart:
        out.append(b"\xff\xdd\x00\x04" + struct.pack(">H", restart))
    codes = {key: _codes(*val) for key, val in _STD_TABLES.items()}
    scans = [comps] if interleaved else [[c] for c in comps]
    for scan in scans:
        out.append(b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(scan), len(scan)) + b"".join(
            bytes([c["id"], (c["tables"] << 4) | c["tables"]]) for c in scan) + b"\x00\x3f\x00")
        if len(scan) > 1:
            mcus = [[(c, my * c["fv"] + dy, mx * c["fh"] + dx) for c in scan
                     for dy in range(c["fv"]) for dx in range(c["fh"])]
                    for my in range(mcus_y) for mx in range(mcus_x)]
        else:
            c = scan[0]
            mcus = [[(c, by, bx)] for by in range(c["hb"]) for bx in range(c["wb"])]
        bits, preds, n_rst = _Bits(), {}, 0
        for i, mcu in enumerate(mcus):
            if restart and i and i % restart == 0:
                out.append(bits.flush() + bytes([0xFF, 0xD0 + n_rst % 8]))
                preds, n_rst = {}, n_rst + 1
            for c, by, bx in mcu:
                t = c["tables"]
                preds[c["id"]] = _put_block(bits, c["zz"][by, bx], preds.get(c["id"], 0),
                                            codes[(0, t)], codes[(1, t)])
        out.append(bits.flush())
    out.append(b"\xff\xd9")
    return b"".join(out)


SEQUENTIAL = [  # (h, w, sampling factors, interleaved, restart interval, extreme)
    (37, 45, ((2, 2), (1, 1), (1, 1)), False, 0, False),
    (37, 45, ((2, 2), (1, 1), (1, 1)), False, 3, False),
    (50, 27, ((1, 1), (2, 2), (1, 2)), True, 0, False),
    (19, 61, ((2, 1), (1, 2), (2, 2)), True, 2, False),
    (21, 33, ((1, 2), (2, 1), (1, 1)), False, 0, False),
    (5, 3, ((2, 2), (1, 1), (2, 1)), True, 1, False),
    (37, 45, ((2, 2), (1, 1), (1, 1)), True, 0, True),
    (29, 18, ((1, 1), (1, 2), (2, 1)), False, 2, True),
]


@pytest.mark.parametrize("case", range(len(SEQUENTIAL)))
def test_jpeg_non_interleaved_scans_and_odd_sampling(case):
    """Scans and sampling factors the encoders above never write, and
    coefficients far outside a real image's (libjpeg-turbo's SIMD inverse
    DCT, which both references run, wraps and saturates in 16 bits)."""
    h, w, factors, interleaved, restart, extreme = SEQUENTIAL[case]
    data = _sequential_jpeg(np.random.default_rng(case), h, w, factors, interleaved,
                            restart, extreme)
    _assert_both_routes(data)


@pytest.mark.parametrize("restart", [0, 4], ids=["no_rst", "rst4"])
@pytest.mark.parametrize("cut", [0.3, 0.8])
def test_jpeg_scan_that_runs_out_of_data(cut, restart):
    """200 bytes of entropy-coded data dropped, the EOI kept: libjpeg feeds
    zero bits to the MCU in progress and leaves the rest of the interval
    gray, and both references return that page."""
    img = _image((67, 93), 1)
    data = _pil_jpeg(img, quality=90, subsampling=2, restart_marker_blocks=restart)
    sos = data.index(b"\xff\xda")
    at = sos + 12 + int((len(data) - sos - 14) * cut)
    _assert_both_routes(data[:at] + data[at + 200:])


# --- progressive scans of the test's own (jcphuff.c's encoder): scripts
# the two encoders above never write, among them ones that leave
# coefficients unrefined, where libjpeg-turbo smooths blocks


def _size_bits(v):
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


# every DC size at 5 bits; every AC symbol but size 15 at 9 bits (the EOBn
# runs included)
_PDC = (bytes([0, 0, 0, 0, 16] + [0] * 11), bytes(range(16)))
_PAC_SYMBOLS = bytes(s for s in range(256) if s & 15 != 15)
_PAC = (bytes([0] * 8 + [len(_PAC_SYMBOLS)] + [0] * 7), _PAC_SYMBOLS)


class _ProgressiveScan:
    """The bits of one scan: DC first or refinement, AC first with EOB runs,
    AC refinement with its buffered correction bits."""

    def __init__(self, ss, se, ah, al):
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.bits, self.dc, self.ac = _Bits(), _codes(*_PDC), _codes(*_PAC)
        self.restart()

    def restart(self):
        self.preds, self.eobrun, self.be = {}, 0, []

    def _emit_eobrun(self):
        if self.eobrun:
            r = self.eobrun.bit_length() - 1
            self.bits.put(*self.ac[r << 4])
            self.bits.put(self.eobrun - (1 << r), r)
            self.eobrun = 0
        for b in self.be:
            self.bits.put(b, 1)
        self.be = []

    def block(self, cid, zz):
        ss, se, ah, al = self.ss, self.se, self.ah, self.al
        if ss == 0:
            v = int(zz[0]) >> al
            if ah:
                self.bits.put(v & 1, 1)
                return
            s, extra = _size_bits(v - self.preds.get(cid, 0))
            self.preds[cid] = v
            self.bits.put(*self.dc[s])
            self.bits.put(extra, s)
            return
        absv = [abs(int(zz[k])) >> al for k in range(64)]
        sign = [1 if zz[k] >= 0 else -1 for k in range(64)]
        if ah == 0:
            run = 0
            for k in range(ss, se + 1):
                if absv[k] == 0:
                    run += 1
                    continue
                self._emit_eobrun()
                while run > 15:
                    self.bits.put(*self.ac[0xF0])
                    run -= 16
                s, extra = _size_bits(sign[k] * absv[k])
                self.bits.put(*self.ac[(run << 4) | s])
                self.bits.put(extra, s)
                run = 0
            if run:
                self.eobrun += 1
                if self.eobrun == 0x7FFF:
                    self._emit_eobrun()
            return
        eob = max([k for k in range(ss, se + 1) if absv[k] == 1], default=0)
        run, br = 0, []
        for k in range(ss, se + 1):
            if absv[k] == 0:
                run += 1
                continue
            while run > 15 and k <= eob:
                self._emit_eobrun()
                self.bits.put(*self.ac[0xF0])
                run -= 16
                for b in br:
                    self.bits.put(b, 1)
                br = []
            if absv[k] > 1:
                br.append(absv[k] & 1)
                continue
            self._emit_eobrun()
            self.bits.put(*self.ac[(run << 4) | 1])
            self.bits.put(int(sign[k] > 0), 1)
            for b in br:
                self.bits.put(b, 1)
            br, run = [], 0
        if run or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == 0x7FFF or len(self.be) > 937:
                self._emit_eobrun()

    def flush(self) -> bytes:
        self._emit_eobrun()
        return self.bits.flush()


def _progressive_jpeg(rng, h, w, factors, script, restart=0, adobe=None, dc_field=False):
    """A progressive (SOF2) file of a component for each (h, v) sampling
    factors, its quantised coefficients random (a DC that varies smoothly
    over the page where ``dc_field``, else at random; AC terms of up to
    +-60 in the first ten positions, rarer ones above, a run past 16),
    coded by ``script``: (component indices, Ss, Se, Ah, Al) a scan."""
    max_h, max_v = max(f[0] for f in factors), max(f[1] for f in factors)
    mcus_x, mcus_y = -(-w // (8 * max_h)), -(-h // (8 * max_v))
    comps = []
    for ci, (fh, fv) in enumerate(factors):
        rows, cols = mcus_y * fv, mcus_x * fh
        zz = np.zeros((rows, cols, 64), np.int64)
        if dc_field:
            yy, xx = np.mgrid[0:rows, 0:cols]
            zz[..., 0] = np.rint(40 * np.sin(yy / 2.3 + ci) * np.cos(xx / 3.1)) \
                + rng.integers(-6, 7, (rows, cols))
        else:
            zz[..., 0] = rng.integers(-60, 60, (rows, cols))
        zz[..., 1:10] = rng.integers(-60, 61, (rows, cols, 9)) * (rng.random((rows, cols, 9)) < 0.4)
        for _ in range(rows * cols):
            zz[rng.integers(rows), rng.integers(cols), rng.integers(10, 64)] = \
                rng.choice([-1, 1]) * rng.integers(1, 30)
        zz[0, 0, 11:] = 0
        zz[0, 0, 30] = 3  # a run of 19 zeros: one ZRL
        comps.append(dict(id=ci + 1, fh=fh, fv=fv, zz=zz, tq=min(ci, 1),
                          wb=-(-w * fh // (8 * max_h)), hb=-(-h * fv // (8 * max_v))))
    quant = [rng.integers(1, 40, 64), rng.integers(1, 60, 64)]
    out = [b"\xff\xd8", _app_marker(adobe)]
    for t, q in enumerate(quant):
        out.append(b"\xff\xdb\x00\x43" + bytes([t]) + bytes(q.astype(np.uint8)))
    out.append(b"\xff\xc2" + struct.pack(">HBHHB", 8 + 3 * len(comps), 8, h, w, len(comps))
               + b"".join(bytes([c["id"], (c["fh"] << 4) | c["fv"], c["tq"]]) for c in comps))
    for tc, (counts, symbols) in ((0, _PDC), (1, _PAC)):
        out.append(b"\xff\xc4" + struct.pack(">H", 19 + len(symbols)) + bytes([tc << 4])
                   + counts + symbols)
    if restart:
        out.append(b"\xff\xdd\x00\x04" + struct.pack(">H", restart))
    for ids, ss, se, ah, al in script:
        scan = [comps[i] for i in ids]
        out.append(b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(scan), len(scan)) + b"".join(
            bytes([c["id"], 0]) for c in scan) + bytes([ss, se, (ah << 4) | al]))
        if len(scan) > 1:
            mcus = [[(c, my * c["fv"] + dy, mx * c["fh"] + dx) for c in scan
                     for dy in range(c["fv"]) for dx in range(c["fh"])]
                    for my in range(mcus_y) for mx in range(mcus_x)]
        else:
            c = scan[0]
            mcus = [[(c, by, bx)] for by in range(c["hb"]) for bx in range(c["wb"])]
        coder, n_rst = _ProgressiveScan(ss, se, ah, al), 0
        for i, mcu in enumerate(mcus):
            if restart and i and i % restart == 0:
                out.append(coder.flush() + bytes([0xFF, 0xD0 + n_rst % 8]))
                coder.restart()
                n_rst += 1
            for c, by, bx in mcu:
                coder.block(c["id"], c["zz"][by, bx])
        out.append(coder.flush())
    out.append(b"\xff\xd9")
    return b"".join(out)


SCRIPTS = {
    # libjpeg's jpeg_simple_progression for three components
    "simple": [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1),
               ([1], 1, 63, 0, 1), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
               ([0, 1, 2], 0, 0, 1, 0), ([2], 1, 63, 1, 0), ([1], 1, 63, 1, 0),
               ([0], 1, 63, 1, 0)],
    # a DC scan a component, spectral selection only
    "spectral": [([0], 0, 0, 0, 0), ([1], 0, 0, 0, 0), ([2], 0, 0, 0, 0)]
                + [([c], lo, hi, 0, 0) for c in range(3) for lo, hi in ((1, 2), (3, 9), (10, 63))],
    # two refinements of every band, Al 3 -> 2 -> 1 -> 0
    "deep": [([0, 1, 2], 0, 0, 0, 2), ([0, 1, 2], 0, 0, 2, 1), ([0, 1, 2], 0, 0, 1, 0)]
            + [([c], 1, 63, 0, 3) for c in range(3)]
            + [([c], 1, 63, a + 1, a) for a in (2, 1, 0) for c in range(3)],
    # block smoothing: AC bands 6-63 sent at Al 1 only (coefficients 6-9
    # unrefined, the five below known)
    "smooth_ac6": [([0, 1, 2], 0, 0, 0, 0)] + [([c], 1, 5, 0, 0) for c in range(3)]
                  + [([c], 6, 63, 0, 1) for c in range(3)],
    # every AC band at Al 1 only: the first five estimated where still zero,
    # the estimate capped at 1
    "smooth_ac1": [([0, 1, 2], 0, 0, 0, 0)] + [([c], 1, 63, 0, 1) for c in range(3)],
    # only the first two AC coefficients sent: the others never (Al -1)
    "smooth_two": [([0, 1, 2], 0, 0, 0, 1)] + [([c], 1, 2, 0, 0) for c in range(3)],
    # DC only, at Al 1: the DC interpolated and nine AC terms estimated
    "smooth_dc": [([0, 1, 2], 0, 0, 0, 1)],
}


PROGRESSIVE_SIZES = [(1, 1), (7, 9), (17, 33), (40, 57), (67, 93)]


@pytest.mark.parametrize("shape", PROGRESSIVE_SIZES, ids=[f"{h}x{w}" for h, w in PROGRESSIVE_SIZES])
@pytest.mark.parametrize("encoder", ["pil", "cv2"])
def test_jpeg_progressive_from_both_encoders(encoder, shape):
    """Progressive files as PIL (``progressive=True``) and cv2
    (``IMWRITE_JPEG_PROGRESSIVE``) write them, qualities 75 and 90, every
    sampling they offer (4:1:1 through cv2), sizes off the MCU grid."""
    img = _image(shape, sum(shape))
    for q in (75, 90):
        if encoder == "pil":
            files = [_pil_jpeg(img, quality=q, progressive=True, subsampling=sub)
                     for sub in (0, 2)]
            files.append(_pil_jpeg(img[..., :1], quality=q, progressive=True))
            files.append(_pil_jpeg(img, quality=q, progressive=True, restart_marker_blocks=3))
        else:
            files = [_cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR, f)
                     for f in (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)]
        for data in files:
            assert b"\xff\xc2" in data
            _assert_both_routes(data)
            assert jpeg.jpeg_size(data) == Image.open(io.BytesIO(data)).size


@pytest.mark.parametrize("shape", [(1, 1), (17, 33), (40, 57)], ids=["1x1", "17x33", "40x57"])
def test_jpeg_cmyk_and_411_equal_both_routes(shape):
    """CMYK as PIL writes it (Adobe transform 0), sequential and
    progressive, and 4:1:1 (h4v1, replicated) as cv2 writes it. The two
    routes' CMYK rules differ by 1 at most, and do differ."""
    img = _image(shape, 7)
    cmyk = Image.fromarray(img).convert("CMYK")
    parted = 0
    for kw in ({}, {"progressive": True}):
        buf = io.BytesIO()
        cmyk.save(buf, "JPEG", quality=90, **kw)
        data = buf.getvalue()
        _assert_both_routes(data)
        pil, cv = (jpeg.decode_jpeg(data, route=r).astype(int) for r in jpeg.ROUTES)
        assert np.abs(pil - cv).max() <= 1
        parted += int((pil != cv).any())
        assert jpeg.jpeg_size(data) == Image.open(io.BytesIO(data)).size
    assert shape == (1, 1) or parted == 2
    for q in (50, 95):
        data = _cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
        assert data[data.index(b"\xff\xc0") + 11] == 0x41  # Y sampled h4v1
        _assert_both_routes(data)


FOUR_AND_ODD = {  # name: (sampling factors, Adobe transform, progressive)
    "ycck": (((1, 1),) * 4, 2, False),
    "ycck_subsampled": (((2, 2), (1, 1), (1, 1), (2, 2)), 2, False),
    "ycck_progressive": (((2, 1), (1, 1), (1, 1), (2, 1)), 2, True),
    "cmyk_adobe0": (((2, 2), (1, 1), (1, 1), (2, 2)), 0, False),
    "cmyk_without_adobe": (((1, 1),) * 4, None, True),
    "h4v2": (((4, 2), (1, 1), (1, 1)), None, False),
    "h4v1_h2v1": (((4, 1), (2, 1), (1, 1)), None, False),
    "v4_v2": (((1, 4), (1, 2), (1, 1)), None, True),
    "h3v2": (((3, 2), (1, 1), (1, 1)), None, False),
}


@pytest.mark.parametrize("case", sorted(FOUR_AND_ODD))
def test_jpeg_four_components_and_large_sampling_factors(case):
    """Files of the test's own encoders: YCCK (Adobe transform 2, which no
    encoder here writes), CMYK with and without an Adobe marker, and
    factors above 2 (int_upsample's replication, and the fancy h2v1 and
    h1v2 for ratios of 2 between factors of 4 and 2)."""
    factors, adobe, progressive = FOUR_AND_ODD[case]
    n = len(factors)
    for h, w in ((37, 45), (5, 3)):
        rng = np.random.default_rng(len(case) + h)
        if progressive:
            script = [(list(range(n)), 0, 0, 0, 1)] + [([c], 1, 63, 0, 0) for c in range(n)] \
                + [(list(range(n)), 0, 0, 1, 0)]
            data = _progressive_jpeg(rng, h, w, factors, script, adobe=adobe)
        else:
            data = _sequential_jpeg(rng, h, w, factors, True, 0, adobe=adobe)
        _assert_both_routes(data)


GEOMETRIES = [  # (h, w, sampling factors, restart interval)
    (37, 45, ((2, 2), (1, 1), (1, 1)), 0),
    (20, 33, ((2, 2), (1, 1), (1, 1)), 2),  # two iMCU rows, the last one short
    (9, 70, ((2, 1), (1, 2), (1, 1)), 3),
    (23, 17, ((1, 2), (1, 1), (1, 1)), 0),
    (3, 5, ((1, 1), (1, 1), (1, 1)), 1),
]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_jpeg_progressive_scan_scripts_and_block_smoothing(name, monkeypatch):
    """Scan scripts of the test's own (spectral selection, successive
    approximation down from Al 3, restart intervals, non-interleaved DC)
    at sizes off the MCU grid; and scripts that leave some of the first
    nine AC coefficients unrefined, where libjpeg-turbo's block smoothing
    changes the output (shown by turning it off): with the last iMCU row
    short (20 rows at 4:2:0), its row window is not a plain clamp."""
    files = [_progressive_jpeg(np.random.default_rng(i), h, w, f, SCRIPTS[name], rst,
                               dc_field=True) for i, (h, w, f, rst) in enumerate(GEOMETRIES)]
    for data in files:
        _assert_both_routes(data)
    smooths = name in ("smooth_ac1", "smooth_two", "smooth_dc")
    monkeypatch.setattr(jpeg, "_smoothing", lambda frame: False)
    changed = [not np.array_equal(jpeg.decode_jpeg(d), _pil(d)) for d in files]
    assert any(changed) == smooths, changed


def _cut_scans(data: bytes, first_interval: bool):
    """Copies of a progressive file with one scan's data cut short: the
    second half of the scan (or of its first restart interval) dropped."""
    marker = re.compile(rb"\xff([^\x00])" if first_interval else rb"\xff([^\x00\xd0-\xd7])")
    for m in re.finditer(rb"\xff\xda", data):
        start = m.start() + 2 + struct.unpack(">H", data[m.start() + 2:m.start() + 4])[0]
        end = marker.search(data, start).start()
        yield data[:start + (end - start) // 2] + data[end:]


@pytest.mark.parametrize("restart", [0, 4], ids=["no_rst", "rst4"])
def test_jpeg_progressive_scan_that_runs_out_of_data(restart):
    """Each scan of a progressive file cut short in turn: the MCU that runs
    out reads zero bits and the rest of its interval keeps what earlier
    scans gave it, as libjpeg leaves it. cv2 decodes every copy; PIL
    raises on some (it checks libjpeg's warnings), and equals the port on
    the rest."""
    img = _image((45, 71), 3)
    files = [_pil_jpeg(img, quality=90, progressive=True, restart_marker_blocks=restart),
             _progressive_jpeg(np.random.default_rng(2), 45, 71, ((2, 2), (1, 1), (1, 1)),
                               SCRIPTS["deep"], restart)]
    for data in files:
        for cut in _cut_scans(data, first_interval=bool(restart)):
            np.testing.assert_array_equal(jpeg.decode_jpeg(cut, route="cv2"), _cv2(cut))
            try:
                want = _pil(cut)
            except OSError:
                continue
            np.testing.assert_array_equal(jpeg.decode_jpeg(cut, route="pil"), want)


# --- arithmetic coding and lossless JPEG, from encoders in tools/ (no
# encoder installed here writes either)

sys.path.insert(0, str(ROOT / "tools"))
from jpeg_arith import transcode  # noqa: E402
from jpeg_lossless import encode as _lossless  # noqa: E402

ARITH_SOURCES = {
    "420": lambda: _pil_jpeg(_image((40, 57), 11), quality=90),
    "444_q100": lambda: _pil_jpeg(_image((17, 33), 12), quality=100, subsampling=0),
    "422_odd": lambda: _pil_jpeg(_image((33, 17), 13), quality=95, subsampling=1),
    "411_cv2": lambda: _cv2_jpeg(_image((24, 70), 14), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
    "gray": lambda: _pil_jpeg(_image((40, 57), 15)[..., :1], quality=85),
    "cmyk": lambda: _jpeg_of(Image.fromarray(_image((24, 40), 16)).convert("CMYK"), 85),
    "progressive_src": lambda: _pil_jpeg(_image((40, 57), 17), quality=50, progressive=True),
}
ARITH_MODES = {
    "sequential": {}, "progressive": {"progressive": True}, "restart": {"restart": 3},
    "progressive_restart": {"progressive": True, "restart": 2},
    "dac": {"dac": {0: (2, 5), 1: (0, 0), 16: 2, 17: 40}},
}


def _jpeg_of(im: Image.Image, quality: int) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("mode", sorted(ARITH_MODES))
@pytest.mark.parametrize("source", sorted(ARITH_SOURCES))
def test_jpeg_arithmetic_transcodes_decode_as_their_originals(source, mode):
    """Arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive; DAC
    conditioning, restart intervals) transcoded from Huffman originals by
    tools/jpeg_arith.py: PIL and cv2 decode each to the bytes of their
    decode of the original (arithmetic coding is lossless over the
    coefficients: this holds the encoder, not the port), and the port's
    jdarith.c equals both routes."""
    original = ARITH_SOURCES[source]()
    data = transcode(original, **ARITH_MODES[mode])
    assert (b"\xff\xca" if "progressive" in mode else b"\xff\xc9") in data
    for oracle in (_pil, _cv2):
        np.testing.assert_array_equal(oracle(data), oracle(original))
    _assert_both_routes(data)


def test_jpeg_arithmetic_read_past_pil_first_block():
    """PIL hands libjpeg the file's first 65536 bytes, and libjpeg's
    arithmetic decoder cannot wait for more: an arithmetic-coded file whose
    decoder reads past them fails in PIL (cv2 reads it), and the port's
    pil route raises there. A comment segment moves the scan across the
    boundary byte by byte."""
    data = transcode(_pil_jpeg(_image((16, 24), 18), quality=90))
    outcomes = set()
    for length in range(65536 - len(data) - 8, 65536 - len(data) + 24):
        padded = data[:2] + b"\xff\xfe" + struct.pack(">H", length) + bytes(length - 2) + data[2:]
        np.testing.assert_array_equal(jpeg.decode_jpeg(padded, route="cv2"), _cv2(padded))
        try:
            want = _pil(padded)
        except OSError:
            outcomes.add("refused")
            with pytest.raises(ValueError, match="PIL feeds"):
                jpeg.decode_jpeg(padded, route="pil")
            continue
        outcomes.add("read")
        np.testing.assert_array_equal(jpeg.decode_jpeg(padded, route="pil"), want)
    assert outcomes == {"read", "refused"}


LOSSLESS = {  # name: (components, jpeg_lossless.encode arguments)
    "gray": (1, {}), "gray_pt2": (1, {"pt": 2}), "gray_rst": (1, {"restart_rows": 4}),
    "rgb": (3, {"rgb": True}), "rgb_pt3_rst": (3, {"rgb": True, "pt": 3, "restart_rows": 5}),
    "rgb_scans": (3, {"rgb": True, "interleaved": False}), "cmyk": (4, {"rgb": True}),
}


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("case", sorted(LOSSLESS))
def test_jpeg_lossless_by_each_route(case, predictor):
    """Lossless JPEG (SOF3) from tools/jpeg_lossless.py, predictors 1-7,
    point transforms, restart intervals, one scan or a scan a component:
    PIL decodes each to the source samples (their low Pt bits cleared;
    this holds the encoder), the port's jdpred.c undifferencing equals
    both routes. cv2 refuses gray (it asks libjpeg-turbo for BGR, which
    lossless mode does not convert to), and the port's cv2 route raises
    there."""
    n, kw = LOSSLESS[case]
    src = _image((23, 31), predictor, channels=4)[..., :n]
    data = _lossless(src, predictor, **kw)
    pt = kw.get("pt", 0)
    want = (src >> pt) << pt
    if n == 1:
        np.testing.assert_array_equal(_pil(data), np.repeat(want, 3, axis=2))
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="lossless gray"):
            jpeg.decode_jpeg(data, route="cv2")
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, route="pil"), _pil(data))
        return
    if n == 3:
        np.testing.assert_array_equal(_pil(data), want)
    _assert_both_routes(data)


LOSSLESS_SAMPLINGS = {
    "2x2,1x1,1x1": [(2, 2), (1, 1), (1, 1)], "2x1,1x1,1x1": [(2, 1), (1, 1), (1, 1)],
    "1x2,1x1,1x1": [(1, 2), (1, 1), (1, 1)], "1x1,2x2,2x2": [(1, 1), (2, 2), (2, 2)],
    "4x1,2x1,1x1": [(4, 1), (2, 1), (1, 1)],
}


@pytest.mark.parametrize("case", sorted(LOSSLESS_SAMPLINGS))
def test_jpeg_lossless_sampling_factors_by_each_route(case):
    """Lossless JPEG whose components are subsampled (tools/jpeg_lossless.py
    ``sampling=``), interleaved (MCUs of each component's h x v samples,
    edges padded, restart intervals) or a scan a component, at sizes the
    MCUs do and do not tile: libjpeg-turbo upsamples each component by
    replication (no fancy upsampling without a DCT), on both routes; with
    no JFIF or Adobe marker it takes the three components for RGB."""
    sampling = LOSSLESS_SAMPLINGS[case]
    rng = np.random.default_rng(len(case) + sum(h * v for h, v in sampling))
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    for h, w in ((20, 28), (21, 27), (3, 5)):
        planes = [rng.integers(0, 256, (-(-h * v // vmax), -(-w * s // hmax)), dtype=np.uint8)
                  for s, v in sampling]
        for interleaved, restart in ((True, 0), (True, 1), (False, 0)):
            kw = dict(rgb=True) if restart else dict(jfif=False)
            data = _lossless(planes, int(rng.integers(1, 8)), pt=int(rng.integers(0, 3)),
                             interleaved=interleaved, restart_rows=restart, sampling=sampling,
                             **kw)
            _assert_both_routes(data)


def test_jpeg_lossless_without_markers_is_rgb():
    """Three lossless components with no JFIF or Adobe marker are RGB to
    libjpeg-turbo 3 whatever their ids (1, 2, 3 among them, which lossy
    frames take for YCbCr); a JFIF marker or Adobe transform 1 makes them
    YCbCr, which both routes refuse in lossless mode."""
    img = _image((19, 23), 14)
    plain = _lossless(img, 3, jfif=False)
    _assert_both_routes(plain)
    np.testing.assert_array_equal(jpeg.decode_jpeg(plain, route="pil"), img)
    adobe1 = plain.replace(b"\xff\xd8", b"\xff\xd8\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00"
                           b"\x00\x01", 1)
    for data in (adobe1, _lossless(img, 3)):
        with pytest.raises(OSError):
            _pil(data)
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
        for route in jpeg.ROUTES:
            with pytest.raises(ValueError, match="lossless YCC"):
                jpeg.decode_jpeg(data, route=route)


@pytest.mark.parametrize("precision", [12, 16])
def test_jpeg_precisions_both_references_refuse(precision):
    """12-bit lossy frames (SOF0, SOF1, SOF2) and 12- and 16-bit lossless
    ones: the streams are valid at their precision (each an 8-bit file's
    data under the new precision), and both references refuse them (PIL
    cannot handle the layers; cv2 reads samples of up to 8 bits), as the
    port does; ``image_size`` raises as PIL's open does."""
    img = _image((16, 24), precision)
    files = [_lossless(img, 1, jfif=False), _lossless(img[:, :, 0], 4)]
    if precision == 12:
        for kw in ({}, {"progressive": True}):
            files.append(_pil_jpeg(img, quality=90, **kw))
        files.append(files[-2].replace(b"\xff\xc0", b"\xff\xc1", 1))
    for data in files:
        marker = re.search(rb"\xff[\xc0-\xc3]", data).start()
        bad = data[:marker + 4] + bytes([precision]) + data[marker + 5:]
        with pytest.raises(OSError):
            _pil(bad)
        assert cv2.imdecode(np.frombuffer(bad, np.uint8), cv2.IMREAD_COLOR) is None
        for route in jpeg.ROUTES:
            with pytest.raises(ValueError, match=f"{precision}-bit JPEG: both references"):
                jpeg.decode_jpeg(bad, route=route)
        with pytest.raises(ValueError, match="PIL cannot handle"):
            jpeg.jpeg_size(bad)


@pytest.mark.parametrize("precision", [2, 5, 7])
def test_jpeg_lossless_below_8_bits(precision):
    """Lossless frames of 2 to 7 bits (tools/jpeg_lossless.py
    ``precision=``; the first prediction 2^(P - Pt - 1)): cv2 reads their
    samples as they are, unscaled (gray refused as at 8 bits), and PIL
    cannot handle the layers."""
    rng = np.random.default_rng(precision)
    img = rng.integers(0, 1 << precision, (9, 13, 3), dtype=np.uint8)
    for pt, kw in ((0, dict(rgb=True)), (1, dict(jfif=False, restart_rows=2))):
        data = _lossless(img, int(rng.integers(1, 8)), pt=pt, precision=precision, **kw)
        np.testing.assert_array_equal(_cv2(data), (img >> pt) << pt)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, route="cv2"), _cv2(data))
        with pytest.raises(OSError):
            _pil(data)
        with pytest.raises(ValueError, match="PIL cannot handle"):
            jpeg.decode_jpeg(data, route="pil")
    gray = _lossless(img[:, :, 0], 2, precision=precision)
    assert cv2.imdecode(np.frombuffer(gray, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="lossless gray"):
        jpeg.decode_jpeg(gray, route="cv2")


def _with_marker(data: bytes, old: bytes, new: bytes) -> bytes:
    assert old in data
    return data.replace(old, new, 1)


def test_jpeg_cases_that_raise():
    """What the port does not read raises on both routes, each message
    naming the case, and both references fail on each (PIL raises, cv2
    returns None): 12-bit samples, DNL, fractional sampling ratios, bad
    progressive scans, cut files, hierarchical and lossless arithmetic-
    coded frames (SOF5, SOF13, SOF11), lossless YCbCr (libjpeg-turbo
    converts no colour in lossless mode). A Huffman scan under an SOF9
    marker, once among them, decodes as arithmetic-coded data now, as
    libjpeg-turbo decodes it, on both routes."""
    img = _image((24, 40), 9)
    base = _pil_jpeg(img, quality=80)
    rng = np.random.default_rng(0)
    lossless = _lossless(img[:, :, 0])
    cases = {
        "12-bit": base.replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c", 1),
        "DNL": base.replace(b"\xff\xc0\x00\x11\x08\x00\x18", b"\xff\xc0\x00\x11\x08\x00\x00", 1),
        "whole ratios": _sequential_jpeg(rng, 21, 30, ((3, 1), (2, 1), (1, 1)), True, 0),
        "bad progressive JPEG scan": _progressive_jpeg(  # Al not Ah - 1
            rng, 21, 30, ((1, 1),) * 3, [([0, 1, 2], 0, 0, 0, 2), ([0, 1, 2], 0, 0, 2, 0)]),
        "AC scan over 3 components": _progressive_jpeg(
            rng, 21, 30, ((1, 1),) * 3, [([0, 1, 2], 0, 0, 0, 0), ([0, 1, 2], 1, 5, 0, 0)]),
        "truncated": base[:len(base) // 2],
        "EOI": base[:-2],
        "SOF5": _with_marker(base, b"\xff\xc0", b"\xff\xc5"),
        "SOF13": _with_marker(base, b"\xff\xc0", b"\xff\xcd"),
        "SOF11": _with_marker(lossless, b"\xff\xc3", b"\xff\xcb"),
        "lossless YCC": _lossless(img),
    }
    cases["over 3 components"] = cases.pop("AC scan over 3 components")
    for match, data in cases.items():
        assert data != base
        for route in jpeg.ROUTES:
            with pytest.raises(ValueError, match=match):
                jpeg.decode_jpeg(data, route=route)
        with pytest.raises(OSError):
            _pil(data)
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    assert jpeg.jpeg_size(cases["whole ratios"]) == (30, 21)
    with pytest.raises(ValueError, match="route"):
        jpeg.decode_jpeg(base, route="tf")
    _assert_both_routes(_with_marker(base, b"\xff\xc0", b"\xff\xc9"))


def test_full_page_fixtures_equal_their_digests():
    """tests/golden/jpeg (tools/make_jpeg_pages.py): the four full-size
    table pages decode by both routes to the SHA-256 the references gave,
    and their sizes read from the headers."""
    import hashlib
    import json

    golden = ROOT / "tests" / "golden" / "jpeg"
    digests = json.loads((golden / "digests.json").read_text())
    assert len(digests) == 4
    for name, info in digests.items():
        data = (golden / name).read_bytes()
        rgb = jpeg.decode_jpeg(data, route="pil")
        bgr = np.ascontiguousarray(jpeg.decode_jpeg(data, route="cv2")[:, :, ::-1])
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == info["pil_rgb_sha256"], name
        assert hashlib.sha256(bgr.tobytes()).hexdigest() == info["cv2_bgr_sha256"], name
        assert list(bgr.shape) == info["cv2_shape"]
        assert list(jpeg.jpeg_size(data)) == list(image_size(golden / name)) == info["size"]


# --- BMP


def _bmp(pixels, bits, *, palette=None, compression=0, masks=None, top_down=False,
         header=40) -> bytes:
    """A BMP of the test's own: pixels are (H, W) indices or 16-bit words,
    or (H, W, 3|4) BGR(A) bytes."""
    h, w = pixels.shape[:2]
    if bits < 8:
        per = 8 // bits
        idx = np.zeros((h, -(-w // per) * per), np.uint8)
        idx[:, :w] = pixels
        idx = idx.reshape(h, -1, per)
        raw = np.zeros(idx.shape[:2], np.uint8)
        for j in range(per):
            raw |= idx[:, :, j] << (8 - bits * (j + 1))
    elif bits == 16:
        raw = pixels.astype("<u2").view(np.uint8).reshape(h, -1)
    else:
        raw = pixels.astype(np.uint8).reshape(h, -1)
    stride = ((w * bits + 31) >> 5) * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :raw.shape[1]] = raw
    body = (rows if top_down else rows[::-1]).tobytes()
    if header == 12:
        info = struct.pack("<IhhHH", 12, w, h, 1, bits)
        pal = b"" if palette is None else bytes(palette[:, ::-1].astype(np.uint8).reshape(-1))
    else:
        n = 0 if palette is None else len(palette)
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(body), 2835, 2835, n, 0)
        info += struct.pack("<III", *masks) if masks and header == 40 else b""
        if header > 40:
            extra = struct.pack("<IIII", *(masks or (0, 0, 0)), 0)
            info += (extra + bytes(header - 56))[:header - 40]
        pal = b"" if palette is None else b"".join(
            bytes([b, g, r, 0]) for r, g, b in palette.astype(np.uint8))
    offset = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + pal + body


def _pil_bmp(img, mode) -> bytes:
    buf = io.BytesIO()
    src = Image.fromarray(img)
    src = src.convert("RGBA") if mode == "RGBA" else src.convert(mode)
    src.save(buf, "BMP")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L", "1"])
@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (19, 37)], ids=["1x1", "5x3", "19x37"])
def test_bmp_pil_modes_equal_both_routes(mode, shape):
    """The BMPs PIL writes: 24-bit, 32-bit BGRA, 8-bit palette and gray,
    1-bit."""
    data = _pil_bmp(_image(shape, len(mode)), mode)
    _assert_both_routes(data, bmp.decode_bmp)
    assert bmp.bmp_size(data) == Image.open(io.BytesIO(data)).size


BMP_CASES = {
    "4bit": dict(bits=4, palette=16),
    "1bit_colours": dict(bits=1, palette=2),
    "8bit_short_palette": dict(bits=8, palette=200),
    "24bit_top_down": dict(bits=24, top_down=True),
    "24bit_v5_header": dict(bits=24, header=124),
    "24bit_os2_core": dict(bits=24, header=12),
    "8bit_os2_core": dict(bits=8, palette=256, header=12),
    "32bit_bitfields": dict(bits=32, compression=3, masks=(0xFF0000, 0xFF00, 0xFF)),
    "16bit_555": dict(bits=16),
    "16bit_bitfields_565": dict(bits=16, compression=3, masks=(0xF800, 0x07E0, 0x001F)),
    "16bit_bitfields_555_top_down": dict(bits=16, compression=3,
                                         masks=(0x7C00, 0x03E0, 0x001F), top_down=True),
}


@pytest.mark.parametrize("case", sorted(BMP_CASES))
def test_bmp_layouts_equal_both_routes(case):
    """Layouts PIL does not write: 4-bit, short palettes, top-down rows,
    the V5 and OS/2 headers, BI_BITFIELDS, and 16 bits, where the routes
    part (PIL scales 5 bits by 255 / 31, cv2 shifts)."""
    kw = dict(BMP_CASES[case])
    rng = np.random.default_rng(len(case))
    h, w, bits = 13, 27, kw["bits"]
    n = kw.pop("palette", None)
    if n:
        kw["palette"] = rng.integers(0, 256, (n, 3))
        px = rng.integers(0, n, (h, w))
    elif bits == 16:
        px = rng.integers(0, 1 << 16, (h, w))
    else:
        px = rng.integers(0, 256, (h, w, bits // 8))
    data = _bmp(px, **kw)
    _assert_both_routes(data, bmp.decode_bmp)
    if bits == 16:
        assert not np.array_equal(bmp.decode_bmp(data, "pil"), bmp.decode_bmp(data, "cv2"))


def test_bmp_cases_that_raise():
    px = np.zeros((4, 4), np.int64)
    rle8 = _bmp(px, 8, palette=np.zeros((256, 3)), compression=1)
    for match, data in (("ends before", rle8[:-16] + b"\x04\x01"),
                        ("BI_RLE8 BMP at 4 bits", _bmp(px, 4, palette=np.zeros((16, 3)),
                                                       compression=1)),
                        ("bitfields", _bmp(px, 16, compression=3, masks=(0xF00, 0xF0, 0xF))),
                        ("truncated", _bmp(px[..., None].repeat(3, 2), 24)[:-10])):
        for route in bmp.ROUTES:
            with pytest.raises(ValueError, match=match):
                bmp.decode_bmp(data, route=route)


def test_read_image_sniffs_content_and_image_size_reads_headers(tmp_path):
    """read_image_bgr decodes by content whatever the extension (a PNG
    named .jpg, a JPEG named .png), as PIL does; image_size reads each
    format's header as PIL's .size; TIFF, GIF, WebP and JPEG 2000 pages
    read, and so do the formats only PIL reads (a DIB here) and AVIF."""
    img = _image((21, 34), 11)
    files = {"png.jpg": None, "jpeg.png": _pil_jpeg(img, quality=85),
             "bmp.dat": _pil_bmp(img, "RGB")}
    Image.fromarray(img).save(tmp_path / "png.jpg", format="PNG")
    for name, data in files.items():
        if data is not None:
            (tmp_path / name).write_bytes(data)
        want = np.asarray(Image.open(tmp_path / name).convert("RGB"))[:, :, ::-1]
        got = read_image_bgr(tmp_path / name)
        assert got.dtype == np.float32 and np.array_equal(got, want), name
        assert image_size(tmp_path / name) == Image.open(tmp_path / name).size == (34, 21)
    Image.fromarray(img).save(tmp_path / "page.avif")  # AVIF: data/avif.py
    want = np.asarray(Image.open(tmp_path / "page.avif").convert("RGB"))[:, :, ::-1]
    np.testing.assert_array_equal(read_image_bgr(tmp_path / "page.avif"), want)
    assert image_size(tmp_path / "page.avif") == Image.open(tmp_path / "page.avif").size
    Image.fromarray(img).save(tmp_path / "page.jp2")  # JPEG 2000: data/jp2.py
    want = np.asarray(Image.open(tmp_path / "page.jp2").convert("RGB"))[:, :, ::-1]
    np.testing.assert_array_equal(read_image_bgr(tmp_path / "page.jp2"), want)
    assert image_size(tmp_path / "page.jp2") == (34, 21)
    Image.fromarray(img).save(tmp_path / "page.webp")  # WebP: data/webp.py
    want = np.asarray(Image.open(tmp_path / "page.webp").convert("RGB"))[:, :, ::-1]
    np.testing.assert_array_equal(read_image_bgr(tmp_path / "page.webp"), want)
    assert image_size(tmp_path / "page.webp") == (34, 21)
    Image.fromarray(img).save(tmp_path / "page.gif")  # GIF: data/gif.py
    want = np.asarray(Image.open(tmp_path / "page.gif").convert("RGB"))[:, :, ::-1]
    np.testing.assert_array_equal(read_image_bgr(tmp_path / "page.gif"), want)
    assert image_size(tmp_path / "page.gif") == (34, 21)
    Image.fromarray(img).save(tmp_path / "page.dib")  # DIB: data/bmp.py
    want = np.asarray(Image.open(tmp_path / "page.dib").convert("RGB"))[:, :, ::-1]
    np.testing.assert_array_equal(read_image_bgr(tmp_path / "page.dib"), want)
    assert image_size(tmp_path / "page.dib") == (34, 21)
    Image.fromarray(img).save(tmp_path / "page.tif")  # TIFF: data/tiff.py
    want = np.asarray(Image.open(tmp_path / "page.tif").convert("RGB"))[:, :, ::-1]
    np.testing.assert_array_equal(read_image_bgr(tmp_path / "page.tif"), want)
    assert image_size(tmp_path / "page.tif") == (34, 21)


def test_no_fallback_decoder(tmp_path):
    """With PIL, cv2, jax and tdnet poisoned in sys.modules, read_image_bgr
    still decodes a JPEG (sequential, progressive, arithmetic-coded and
    lossless), a BMP (raw and RLE8), TIFF pages (LZW with a predictor,
    CCITT G4, JPEG, YCbCr, CIE L*a*b*), a PPM, a gray PFM, a GIF, a
    byte-encoded Sun raster, WebP pages (lossy, lossless, lossy with alpha),
    an APNG, JPEG 2000 pages (a 9/7 JP2 file and a 5/3 codestream) and the
    pages of PIL's DIB, XBM, MSP, SPIDER and BLP writers, to the pixels PIL
    gives."""
    img = _image((30, 41), 12)
    page = Image.fromarray(img)
    rle = bytes([3, 1, 3, 2, 0, 0, 2, 3, 4, 0, 0, 0, 6, 1, 0, 0, 0, 1])
    files = {
        "a.jpg": _pil_jpeg(img, quality=90, subsampling=2),
        "p.jpg": _pil_jpeg(img, quality=90, progressive=True),
        "b.bmp": _pil_bmp(img, "RGB"),
        "r.bmp": _bmp(np.zeros((3, 6), np.int64), 8, palette=np.arange(12).reshape(4, 3) * 20,
                      compression=1)[:-24] + rle,
    }
    for name, kw in (("l.tif", dict(compression="tiff_lzw", tiffinfo={317: 2})),
                     ("g.tif", dict(compression="group4")), ("j.tif", dict(compression="jpeg")),
                     ("y.tif", dict(compression="tiff_lzw"))):
        buf = io.BytesIO()
        im = {"g.tif": page.convert("1"), "y.tif": page.convert("YCbCr")}.get(name, page)
        im.save(buf, "TIFF", **kw)
        files[name] = buf.getvalue()
    for name, fmt in (("p.ppm", "PPM"), ("g.gif", "GIF")):
        buf = io.BytesIO()
        page.save(buf, fmt)
        files[name] = buf.getvalue()
    for name, im, kw in (("y.webp", page, dict(quality=80)), ("l.webp", page, dict(lossless=True)),
                         ("a.webp", page.convert("RGBA"), dict(quality=70))):
        if name == "a.webp":
            im.putalpha(Image.fromarray(img[..., 0]))
        buf = io.BytesIO()
        im.save(buf, "WEBP", **kw)
        files[name] = buf.getvalue()
    files["ar.jpg"] = transcode(files["a.jpg"], progressive=True)
    files["ll.jpg"] = _lossless(img, 5, rgb=True)
    buf = io.BytesIO()
    page.save(buf, "PNG", save_all=True, default_image=True,
              append_images=[Image.fromarray(img[::-1]), Image.fromarray(img[:, ::-1])])
    files["an.png"] = buf.getvalue()
    buf = io.BytesIO()
    page.convert("LAB").save(buf, "TIFF", compression="tiff_lzw")
    files["lab.tif"] = buf.getvalue()
    gray = img[..., 0].astype(np.float32) + np.float32(0.5)
    files["g.pfm"] = b"Pf\n41 30\n-1.0\n" + gray[::-1].astype("<f4").tobytes()
    cmap = bytes(range(0, 256, 16)) * 3
    files["s.ras"] = struct.pack(">8I", 0x59A66A95, 3, 2, 8, 7, 2, 1, 48) + cmap + bytes(
        [0x80, 2, 7, 9, 0x80, 0, 4])
    for name, kw in (("i.jp2", dict(irreversible=True, quality_layers=[20])),
                     ("r.j2k", dict(no_jp2=True))):
        buf = io.BytesIO()
        page.save(buf, "JPEG2000", **kw)
        files[name] = buf.getvalue()
    for name, im, fmt in (("d.dib", page, "DIB"), ("x.xbm", page.convert("1"), "XBM"),
                          ("m.msp", page.convert("1"), "MSP"),
                          ("s.spi", page.convert("F"), "SPIDER"),
                          ("b.blp", page.quantize(60), "BLP")):
        buf = io.BytesIO()
        im.save(buf, fmt)
        files[name] = buf.getvalue()
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        np.save(tmp_path / (name + ".npy"), _pil(data)[:, :, ::-1])
    code = f"""
import sys
for name in ("PIL", "PIL.Image", "cv2", "jax", "jaxlib", "tdnet"):
    sys.modules[name] = None
import numpy as np
from tdnet_torch.data.image import read_image_bgr
for name in {sorted(files)!r}:
    got = read_image_bgr({str(tmp_path)!r} + "/" + name)
    want = np.load({str(tmp_path)!r} + "/" + name + ".npy")
    assert np.array_equal(got, want), name
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr

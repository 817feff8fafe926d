"""The port's AV1 decoder (``tdnet_torch/data/av1*.py``) against libaom
3.14.1, the AV1 library bundled beside cv2 here, and dav1d, which Pillow's
libavif links in: the generated tables against a fresh extraction
(``tools/make_av1_tables.py``), the inverse transforms and the
filter-intra predictor against libaom's own C functions, whole frames
plane by plane against ``aom_codec_decode`` and dav1d
(``tools/av1_ref.py``, before any colour conversion), and damaged streams
refused where libaom refuses them (``strict``) and where dav1d does."""

import ctypes
import io
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

import av1_ref  # noqa: E402
import make_av1_tables  # noqa: E402
from tdnet_torch.data import av1, av1_obu, av1_predict, av1_transform, avif  # noqa: E402

TX_W = (4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64)
TX_H = (4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16)


def _page(h=136, w=200, seed=0, noise=0):
    """A small table page: light paper, ruled lines, dark strokes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    page = np.repeat((244 - 6 * yy / h - 3 * xx / w)[:, :, None], 3, 2)
    for y in range(12, h - 8, 18):
        page[y, 8:w - 8] = 60
        for x in range(14, w - 30, 36):
            n = int(rng.integers(8, 28))
            page[y + 5:y + 11, x:x + n] = 45
    page[:, w // 3, :] = (90, 120, 160)
    if noise:
        page = page + rng.integers(-noise, noise + 1, page.shape)
    return np.clip(page, 0, 255).astype(np.uint8)


def _avif(img, **kw):
    b = io.BytesIO()
    Image.fromarray(img).save(b, "AVIF", **kw)
    return b.getvalue()


def _payload(data):
    c = avif.parse(data)
    return c.payload(data, c.items[c.primary])


def _lib():
    lib = make_av1_tables.Library(make_av1_tables.find_library())
    _, base = lib._loaded()
    av1_ref.decode_obus(_payload(_avif(_page(16, 16))))  # libaom's RTCD set up
    ctypes.CFUNCTYPE(None)(base + lib.syms["av1_rtcd"][0])()
    return lib, base


def test_tables_module_equals_a_fresh_extraction():
    """tools/make_av1_tables.py regenerates av1_tables.py byte for byte;
    every table it reads has its symbol's size (the tool asserts it)."""
    text = make_av1_tables.render(make_av1_tables.Library(make_av1_tables.find_library()))
    with open(make_av1_tables.OUT) as f:
        assert f.read() == text


def test_inverse_transforms_equal_libaom():
    """Every 1-D inverse transform against libaom's C ``av1_idct*`` /
    ``av1_iadst*``, and the 2-D process of every size and type (shifts,
    clamps, rectangular scaling, flips) against ``av1_inv_txfm2d_add_*_c``
    on sparse random coefficients, and DCT_DCT blocks of a DC alone (the
    decoder's shortcut)."""
    lib, base = _lib()
    rng = np.random.default_rng(1)
    stage = (ctypes.c_int8 * 32)()
    one_d = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int8,
                             ctypes.c_void_p)
    for name, kind, n in [("av1_idct4", 0, 2), ("av1_idct8", 0, 3), ("av1_idct16", 0, 4),
                          ("av1_idct32", 0, 5), ("av1_idct64", 0, 6), ("av1_iadst4", 1, 2),
                          ("av1_iadst8", 1, 3), ("av1_iadst16", 1, 4)]:
        f = one_d(base + lib.syms[name][0])
        for _ in range(40):
            x = rng.integers(-3000, 3000, 1 << n).astype(np.int32)
            x[rng.random(1 << n) < 0.5] = 0
            out = np.zeros(1 << n, np.int32)
            f(x.ctypes.data, out.ctypes.data, 12, ctypes.addressof(stage))
            t = [np.array([v], np.int64) for v in x]
            av1_transform._apply(kind, t, n, False)
            assert [int(v[0]) for v in t] == out.tolist(), name
    two_d = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int)
    for tx in range(19):
        w, h = TX_W[tx], TX_H[tx]
        f = two_d(base + lib.syms[f"av1_inv_txfm2d_add_{w}x{h}_c"][0])
        types = [0] if max(w, h) == 64 else (range(16) if max(w, h) <= 16 else [0, 9])
        for k, tt in enumerate([0, *types]):
            bw, bh = min(w, 32), min(h, 32)
            co = np.zeros((bh, bw), np.int32)
            if k == 0:  # a DC alone
                co[0, 0] = rng.integers(-20000, 20000)
            for _ in range(int(rng.integers(1, 6)) if k else 0):
                co[rng.integers(0, min(bh, 8)), rng.integers(0, min(bw, 8))] = rng.integers(
                    -2000, 2000)
            px = rng.integers(60, 200, (h, w)).astype(np.uint16)
            out = px.copy()
            inp = np.zeros(w * h, np.int32)
            inp[:bw * bh] = co.T.reshape(-1)  # libaom's column-major order
            f(inp.ctypes.data, out.ctypes.data, w, tt, 8)
            full = np.zeros((h, w), np.int64)
            full[:bh, :bw] = co
            res = av1_transform.inverse_transform_2d(full, tt, w.bit_length() - 1,
                                                     h.bit_length() - 1, tx, False)
            if tt in av1_transform.FLIP_UD:
                res = res[::-1]
            if tt in av1_transform.FLIP_LR:
                res = res[:, ::-1]
            np.testing.assert_array_equal(np.clip(px.astype(np.int64) + res, 0, 255), out)


def test_filter_intra_equals_libaom():
    """The recursive filter-intra predictor, every mode and allowed size,
    against ``av1_filter_intra_predictor_c`` on random edges."""
    lib, base = _lib()
    f = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int)(
        base + lib.syms["av1_filter_intra_predictor_c"][0])
    rng = np.random.default_rng(2)
    for tx in (0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 13, 14, 15, 16):
        w, h = TX_W[tx], TX_H[tx]
        for mode in range(5):
            above = rng.integers(0, 256, 80).astype(np.uint8)
            left = rng.integers(0, 256, 80).astype(np.uint8)
            out = np.zeros((h, w), np.uint8)
            f(out.ctypes.data, w, tx, above.ctypes.data + 16, left.ctypes.data + 16, mode)
            cur = np.zeros((h + 1, w + 1), np.int32)
            cur[0, 1:], cur[1:, 0], cur[0, 0] = above[16:16 + w], left[16:16 + h], above[15]
            av1_predict.predict_intra(cur, 1, 1, True, True, False, False, 0,
                                      w.bit_length() - 1, h.bit_length() - 1, 999, 999, 0, mode)
            np.testing.assert_array_equal(cur[1:, 1:], out)


# encoded streams: (name, page, save arguments); each exercises tools of its own
STREAMS = {
    "pil_default": lambda: _avif(_page(200, 264)),  # palette, intra block copy, filter intra
    "cv2_default": lambda: cv2.imencode(".avif", _page(seed=1, noise=12)[:, :, ::-1].copy())[
        1].tobytes(),  # quantizer matrices, delta q, deblocking, CDEF
    "restoration_422": lambda: _avif(_page(seed=2, noise=20), quality=30, speed=1,
                                     subsampling="4:2:2", advanced={
                                         "enable-restoration": "1", "enable-intrabc": "0",
                                         "enable-palette": "0"}),
    "lossless_444_sb128": lambda: _avif(_page(seed=3), quality=100, subsampling="4:4:4",
                                        advanced={"sb-size": "128"}),
    "tiles_400_deltalf": lambda: _avif(_page(200, 264, seed=4, noise=8), quality=50,
                                       subsampling="4:0:0", tile_rows=1, tile_cols=1, advanced={
                                           "deltaq-mode": "3", "delta-lf-mode": "1"}),
}


# what each stream must exercise, read from its headers
TOOLS = {
    "pil_default": lambda s, h: h.allow_intrabc and h.allow_screen_content_tools,
    "cv2_default": lambda s, h: h.using_qmatrix and h.enable_cdef and h.delta_q_present
    and h.lf_level[0],
    "restoration_422": lambda s, h: h.lr_type[0] and (s.ss_x, s.ss_y) == (1, 0),
    "lossless_444_sb128": lambda s, h: h.coded_lossless and s.use_128 and not s.ss_x,
    "tiles_400_deltalf": lambda s, h: h.tile_cols * h.tile_rows == 4 and s.mono
    and h.delta_lf_present,
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_planes_equal_libaom(name):
    """Each stream's Y, U and V planes equal libaom's and dav1d's decodes;
    its headers show the tools it was made to exercise."""
    payload = _payload(STREAMS[name]())
    frame = av1_obu.parse_obus(payload)
    assert TOOLS[name](frame.seq, frame.hdr)
    got = av1.decode_frame(payload).planes
    for want in (av1_ref.decode_obus(payload), av1_ref.decode_obus_dav1d(payload)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_damaged_streams_are_refused_where_libaom_refuses():
    """Bit flips in the headers and in the tile data, and cuts of the
    payload: where libaom refuses the stream, the strict decoder raises;
    where libaom decodes it, the port's planes are its planes (or the port
    refuses a 10-bit stream by name); and the same of the lenient decoder
    (no trailing, alignment or padding bits checked) against dav1d, on the
    same streams and on 4:2:2 screen content (whose vertical partitions
    4:2:2 forbids)."""
    rng = np.random.default_rng(5)
    payload = _payload(_avif(_page(64, 96, seed=6, noise=10), quality=40))
    screen = _payload(_avif(_page(48, 76, seed=7), quality=50, subsampling="4:2:2",
                            advanced={"tune-content": "screen"}))
    agree = 0
    for k in range(64):
        p = bytearray(payload if k < 48 else screen)
        if k % 3 == 0:
            i = int(rng.integers(0, 24))
            p[i] ^= 1 << int(rng.integers(0, 8))
        elif k % 3 == 1:
            del p[int(rng.integers(8, len(p))):]
        else:
            i = int(rng.integers(24, len(p)))
            p[i] ^= 1 << int(rng.integers(0, 8))
        for strict, ref in ((True, av1_ref.decode_obus), (False, av1_ref.decode_obus_dav1d)):
            want = ref(bytes(p))
            try:
                got = av1.decode_frame(bytes(p), strict=strict).planes
            except ValueError as e:
                assert want is None or "10-bit" in str(e), (k, strict, str(e))
                agree += want is None
                continue
            assert want is not None, (k, strict)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            agree += 1
    assert agree >= 110

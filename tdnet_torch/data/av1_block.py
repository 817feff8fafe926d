"""The block syntax of an AV1 intra frame and its reconstruction
(specification sections 5.11 and 7.10-7.12), tile by tile: partitions of
64x64 and 128x128 superblocks; per block the segment id, skip, CDEF index,
delta q and delta lf, the intra modes with their angle deltas, chroma from
luma, palettes with their colour cache and colour-index maps, filter intra,
the intra block copy (its vector from the reference-vector stack), the
transform sizes (intra depth and the inter split of intra-copy blocks),
transform types, coefficients and their contexts, dequantisation (with
quantizer matrices) and the inverse transform; loop-restoration unit
coefficients as each superblock meets them.
"""

from __future__ import annotations

import numpy as np

from tdnet_torch.data import av1_predict as P
from tdnet_torch.data import av1_tables as T
from tdnet_torch.data.av1_obu import RESTORE_NONE, RESTORE_SGRPROJ, RESTORE_WIENER, SEG_LVL_SKIP
from tdnet_torch.data.av1_symbol import SymbolDecoder, cdf_lists, copy_cdfs
from tdnet_torch.data.av1_transform import FLIP_LR, FLIP_UD, inverse_transform_2d

__all__ = ["FrameState", "decode_tile", "default_cdfs"]

# block sizes
BLOCK_W = (4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64)
BLOCK_H = (4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16)
N_BLOCK = len(BLOCK_W)
BLOCK_OF = {(BLOCK_W[b], BLOCK_H[b]): b for b in range(N_BLOCK)}
BLOCK_4X4, BLOCK_8X8, BLOCK_64X64, BLOCK_128X128 = 0, 3, 12, 15
W4 = tuple(w >> 2 for w in BLOCK_W)
H4 = tuple(h >> 2 for h in BLOCK_H)
W_LOG2 = tuple(w.bit_length() - 3 for w in BLOCK_W)  # Mi_Width_Log2
H_LOG2 = tuple(h.bit_length() - 3 for h in BLOCK_H)
# transform sizes
TX_W = (4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64)
TX_H = (4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16)
TX_OF = {(TX_W[t], TX_H[t]): t for t in range(19)}
TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64 = 0, 1, 2, 3, 4
TX_16X32, TX_32X16, TX_16X64, TX_64X16 = 9, 10, 17, 18
TX_W_LOG2 = tuple(w.bit_length() - 1 for w in TX_W)
TX_H_LOG2 = tuple(h.bit_length() - 1 for h in TX_H)
TX_SQR = tuple(TX_OF[(min(TX_W[t], TX_H[t]),) * 2] for t in range(19))
TX_SQR_UP = tuple(TX_OF[(max(TX_W[t], TX_H[t]),) * 2] for t in range(19))
SPLIT_TX = (0, 0, 1, 2, 3, 0, 0, 1, 1, 2, 2, 3, 3, 5, 6, 7, 8, 9, 10)
MAX_TX_RECT = tuple(TX_OF[(min(BLOCK_W[b], 64), min(BLOCK_H[b], 64))] for b in range(N_BLOCK))


def _depth(t):
    d = 0
    while t != TX_4X4:
        t = SPLIT_TX[t]
        d += 1
    return d


MAX_TX_DEPTH = tuple(_depth(MAX_TX_RECT[b]) for b in range(N_BLOCK))
# partitions
(PART_NONE, PART_HORZ, PART_VERT, PART_SPLIT, PART_HORZ_A, PART_HORZ_B, PART_VERT_A,
 PART_VERT_B, PART_HORZ_4, PART_VERT_4) = range(10)


def _subsize(p, b):
    s = BLOCK_W[b]
    shape = {PART_NONE: (s, s), PART_HORZ: (s, s // 2), PART_HORZ_A: (s, s // 2),
             PART_HORZ_B: (s, s // 2), PART_VERT: (s // 2, s), PART_VERT_A: (s // 2, s),
             PART_VERT_B: (s // 2, s), PART_SPLIT: (s // 2, s // 2), PART_HORZ_4: (s, s // 4),
             PART_VERT_4: (s // 4, s)}[p]
    return BLOCK_OF.get(shape, -1)


SUBSIZE = {(p, b): _subsize(p, b) for p in range(10) for b in (3, 6, 9, 12, 15)}
# transform types and sets
(DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST,
 ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST,
 H_FLIPADST) = range(16)
INTRA_SET = {1: (IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST),
             2: (IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST)}
INTER_SET = {1: (IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST, DCT_DCT, ADST_DCT,
                 DCT_ADST, FLIPADST_DCT, DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST,
                 ADST_FLIPADST, FLIPADST_ADST),
             2: (IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST,
                 ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST),
             3: (IDTX, DCT_DCT)}
MODE_TO_TXFM = (DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST, DCT_ADST,
                ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT)
FILTER_INTRA_DIR = (P.DC_PRED, P.V_PRED, P.H_PRED, P.D157_PRED, P.DC_PRED)
INTRA_MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)
TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2
TX_CLASS = tuple(TX_CLASS_VERT if t in (V_DCT, V_ADST, V_FLIPADST) else
                 TX_CLASS_HORIZ if t in (H_DCT, H_ADST, H_FLIPADST) else TX_CLASS_2D
                 for t in range(16))
SIG_REF_OFFSETS = (((0, 1), (1, 0), (1, 1), (0, 2), (2, 0)),
                   ((0, 1), (1, 0), (0, 2), (0, 3), (0, 4)),
                   ((0, 1), (1, 0), (2, 0), (3, 0), (4, 0)))
MAG_REF_OFFSETS = (((0, 1), (1, 0), (1, 1)), ((0, 1), (1, 0), (0, 2)),
                   ((0, 1), (1, 0), (2, 0)))
PALETTE_COLOR_CONTEXT = tuple(int(v) for v in T.PALETTE_COLOR_CONTEXT)
WIENER_MIN, WIENER_MAX, WIENER_K = (-5, -23, -17), (10, 8, 46), (1, 2, 3)
WIENER_MID = (3, -7, 15)
SGR_XQD_MIN, SGR_XQD_MAX, SGR_XQD_MID = (-96, -32), (31, 95), (-32, 31)
DC_Q = [int(v) for v in T.DC_QLOOKUP]
AC_Q = [int(v) for v in T.AC_QLOOKUP]
SGR_R = [(int(a[0]), int(a[1])) for a in T.SGR_PARAMS]
REF_CAT_LEVEL = 640


def _plane_size(b, ss_x, ss_y):
    return BLOCK_OF.get((max(4, BLOCK_W[b] >> ss_x), max(4, BLOCK_H[b] >> ss_y)), -1)


def _uv_tx_size(b, ss_x, ss_y):
    t = MAX_TX_RECT[_plane_size(b, ss_x, ss_y)]
    if TX_W[t] == 64 or TX_H[t] == 64:
        if TX_W[t] == 16:
            return TX_16X32
        if TX_H[t] == 16:
            return TX_32X16
        return TX_32X32
    return t


def _scan(t, tx_type):
    if t == TX_16X64:
        return T.SCAN_DEFAULT[TX_16X32]
    if t == TX_64X16:
        return T.SCAN_DEFAULT[TX_32X16]
    if TX_SQR_UP[t] == TX_64X64:
        return T.SCAN_DEFAULT[TX_32X32]
    if tx_type == IDTX:
        return T.SCAN_DEFAULT[t]
    if tx_type in (V_DCT, V_ADST, V_FLIPADST):
        return T.SCAN_MROW[t]
    if tx_type in (H_DCT, H_ADST, H_FLIPADST):
        return T.SCAN_MCOL[t]
    return T.SCAN_DEFAULT[t]


_SCANS = {}


def scan_list(t, tx_type):
    key = (t, tx_type)
    s = _SCANS.get(key)
    if s is None:
        s = _SCANS[key] = [int(v) for v in _scan(t, tx_type)]
    return s


def default_cdfs(base_q_idx: int) -> dict:
    """The frame's initial CDFs, as nested lists (coefficient CDFs by the
    base q index)."""
    q = 0 if base_q_idx <= 20 else 1 if base_q_idx <= 60 else 2 if base_q_idx <= 120 else 3
    c = {
        "txb_skip": cdf_lists(T.TXB_SKIP[q]), "eob_extra": cdf_lists(T.EOB_EXTRA[q]),
        "dc_sign": cdf_lists(T.DC_SIGN[q]), "coeff_base_eob": cdf_lists(T.COEFF_BASE_EOB[q]),
        "coeff_base": cdf_lists(T.COEFF_BASE[q]), "coeff_br": cdf_lists(T.COEFF_BR[q]),
        "eob_pt": [cdf_lists(getattr(T, f"EOB_PT_{16 << k}")[q]) for k in range(7)],
        "kf_y_mode": cdf_lists(T.CDF_KF_Y_MODE),
        "uv_mode": [cdf_lists(T.CDF_UV_MODE[0], 13), cdf_lists(T.CDF_UV_MODE[1], 14)],
        "angle_delta": cdf_lists(T.CDF_ANGLE_DELTA), "intrabc": cdf_lists(T.CDF_INTRABC),
        "skip": cdf_lists(T.CDF_SKIP_TXFM),
        "segment_id": cdf_lists(T.CDF_SPATIAL_SEGMENT_ID),
        "filter_intra": cdf_lists(T.CDF_FILTER_INTRA),
        "filter_intra_mode": cdf_lists(T.CDF_FILTER_INTRA_MODE),
        "switchable_restore": cdf_lists(T.CDF_SWITCHABLE_RESTORE),
        "wiener_restore": cdf_lists(T.CDF_WIENER_RESTORE),
        "sgrproj_restore": cdf_lists(T.CDF_SGRPROJ_RESTORE),
        "palette_y_size": cdf_lists(T.CDF_PALETTE_Y_SIZE),
        "palette_uv_size": cdf_lists(T.CDF_PALETTE_UV_SIZE),
        "palette_y_mode": cdf_lists(T.CDF_PALETTE_Y_MODE),
        "palette_uv_mode": cdf_lists(T.CDF_PALETTE_UV_MODE),
        "palette_y_color": [cdf_lists(T.CDF_PALETTE_Y_COLOR_INDEX[n], n + 2) for n in range(7)],
        "palette_uv_color": [cdf_lists(T.CDF_PALETTE_UV_COLOR_INDEX[n], n + 2)
                             for n in range(7)],
        "delta_q": cdf_lists(T.CDF_DELTA_Q), "delta_lf": cdf_lists(T.CDF_DELTA_LF),
        "delta_lf_multi": cdf_lists(T.CDF_DELTA_LF_MULTI),
        "cfl_sign": cdf_lists(T.CDF_CFL_SIGN), "cfl_alpha": cdf_lists(T.CDF_CFL_ALPHA),
        "txfm_split": cdf_lists(T.CDF_TXFM_PARTITION),
    }
    c["partition"] = [cdf_lists(T.CDF_PARTITION[k], 4 if k < 4 else 8 if k >= 16 else 10)
                      for k in range(20)]
    c["tx_size"] = [cdf_lists(T.CDF_TX_SIZE[k], 2 if k == 0 else 3) for k in range(4)]
    c["intra_tx"] = {s: [[cdf_lists(T.CDF_INTRA_EXT_TX[s][z][m], len(INTRA_SET[s]))
                          for m in range(13)] for z in range(4)] for s in (1, 2)}
    c["inter_tx"] = {s: [cdf_lists(T.CDF_INTER_EXT_TX[s][z], len(INTER_SET[s]))
                         for z in range(4)] for s in (1, 2, 3)}
    nmv = [int(v) for v in T.CDF_NDVC]
    comp = []
    for k in range(2):
        o = 5 + 69 * k
        # nmv_component: classes[12], class0_fp[2][5], fp[5], sign[3],
        # class0_hp[3], hp[3], class0[3], bits[10][3]
        comp.append({"classes": nmv[o:o + 12], "sign": nmv[o + 27:o + 30],
                     "class0": nmv[o + 36:o + 39],
                     "bits": [nmv[o + 39 + 3 * i:o + 42 + 3 * i] for i in range(10)]})
    c["dv_joint"] = nmv[0:5]
    c["dv_comp"] = comp
    return c


class FrameState:
    """The frame being decoded: headers, planes (int32, padded to whole
    superblocks) and the per-4x4 block information the syntax reads back."""

    def __init__(self, frame):
        s, h = frame.seq, frame.hdr
        self.seq, self.hdr = s, h
        self.ss_x, self.ss_y = s.ss_x, s.ss_y
        self.num_planes = s.num_planes
        sb4 = 32 if s.use_128 else 16
        rows4 = ((h.mi_rows + sb4 - 1) // sb4) * sb4 + sb4
        cols4 = ((h.mi_cols + sb4 - 1) // sb4) * sb4 + sb4
        self.rows4, self.cols4 = rows4, cols4
        self.planes = [np.zeros((rows4 * 4, cols4 * 4), np.int32)]
        for _ in range(1, s.num_planes):
            self.planes.append(np.zeros(((rows4 * 4) >> s.ss_y, (cols4 * 4) >> s.ss_x), np.int32))
        z = lambda dt=np.int32: np.zeros((rows4, cols4), dt)  # noqa: E731
        self.mi_size = z(np.int8)
        self.y_mode = z(np.int8)
        self.uv_mode = z(np.int8)
        self.is_inter = z(np.int8)
        self.skip = z(np.int8)
        self.inter_tx = z(np.int8)
        self.seg_id = z(np.int8)
        self.pal_y = z(np.int8)
        self.pal_uv = z(np.int8)
        self.decoded = z(np.bool_)
        self.mv_row = z()
        self.mv_col = z()
        self.tx_type = z(np.int8)
        self.delta_lf = np.zeros((4, rows4, cols4), np.int8)
        self.pal_colors_y = {}
        self.pal_colors_u = {}
        # loop-filter transform sizes per plane, in that plane's 4x4 units
        self.lf_tx = [np.zeros((rows4, cols4), np.int8) for _ in range(s.num_planes)]
        self.cdef_idx = np.full((rows4, cols4), -1, np.int8)
        sizes = h.lr_size
        self.lr_units = []
        for p in range(s.num_planes):
            sx = s.ss_x if p else 0
            sy = s.ss_y if p else 0
            u = sizes[p]
            rows = max((((h.height + sy) >> sy) + (u >> 1)) // u, 1)
            cols = max((((h.width + sx) >> sx) + (u >> 1)) // u, 1)
            self.lr_units.append((rows, cols))
        self.lr_type = [np.zeros(ru, np.int8) for ru in self.lr_units]
        self.lr_wiener = [np.zeros(ru + (2, 3), np.int32) for ru in self.lr_units]
        self.lr_sgr_set = [np.zeros(ru, np.int8) for ru in self.lr_units]
        self.lr_sgr_xqd = [np.zeros(ru + (2,), np.int32) for ru in self.lr_units]


class _Ctx:
    """The decoding state of one tile."""


def decode_tile(fs: FrameState, tile_row: int, tile_col: int, data: bytes, start: int,
                end: int, cdfs: dict, strict: bool = True) -> None:
    """One tile into ``fs``; ``strict``: libaom's ``exit_symbol`` check of
    the tile's padding, else dav1d's looser check that the symbols stay
    within the tile."""
    h = fs.hdr
    t = _Ctx()
    t.fs, t.h, t.s = fs, h, fs.seq
    t.sd = SymbolDecoder(data, start, end, bool(h.disable_cdf_update))
    t.cdf = copy_cdfs(cdfs)
    t.row_start, t.row_end = h.tile_row_starts[tile_row], h.tile_row_starts[tile_row + 1]
    t.col_start, t.col_end = h.tile_col_starts[tile_col], h.tile_col_starts[tile_col + 1]
    t.current_q = h.base_q_idx
    t.delta_lf = [0, 0, 0, 0]
    t.ref_lr_wiener = [[list(WIENER_MID), list(WIENER_MID)] for _ in range(3)]
    t.ref_sgr_xqd = [list(SGR_XQD_MID) for _ in range(3)]
    ncols = fs.cols4
    t.above_level = [[0] * ncols for _ in range(3)]
    t.above_dc = [[0] * ncols for _ in range(3)]
    sb = BLOCK_128X128 if t.s.use_128 else BLOCK_64X64
    sb4 = W4[sb]
    for r in range(t.row_start, t.row_end, sb4):
        t.left_level = [[0] * fs.rows4 for _ in range(3)]
        t.left_dc = [[0] * fs.rows4 for _ in range(3)]
        for c in range(t.col_start, t.col_end, sb4):
            t.read_deltas = h.delta_q_present
            fs.cdef_idx[r:r + sb4, c:c + sb4] = -1
            _clear_block_decoded(t, r, c, sb4)
            _read_lr(t, r, c, sb)
            _partition(t, r, c, sb)
        if t.sd.overread():  # dav1d's check after each row; libaom's exit check fails too
            raise ValueError("AV1 tile data damaged: its symbols run past the tile")
    if strict and not t.sd.exit_ok():
        raise ValueError("AV1 tile data damaged: its symbols do not end where the tile does")


def _clear_block_decoded(t, r, c, sb4):
    """BlockDecoded of each plane for the superblock at (r, c): index
    [y + 1, x + 1] for the spec's [y][x], y and x from -1."""
    t.bdec = []
    for plane in range(t.s.num_planes):
        sx = t.s.ss_x if plane else 0
        sy = t.s.ss_y if plane else 0
        n = sb4 >> sx if sx else sb4
        m = sb4 >> sy if sy else sb4
        a = np.zeros((m + 3, n + 3), np.bool_)
        wide = (t.col_end - c) >> sx
        high = (t.row_end - r) >> sy
        a[0, :max(0, min(wide, n + 1) + 1)] = True
        a[:max(0, min(high, m + 1) + 1), 0] = True
        a[m + 1, 0] = False
        t.bdec.append(a)


def _inside(t, r, c):
    return t.col_start <= c < t.col_end and t.row_start <= r < t.row_end


def _partition(t, r, c, b):
    h = t.h
    if r >= h.mi_rows or c >= h.mi_cols:
        return
    fs = t.fs
    avail_u = _inside(t, r - 1, c)
    avail_l = _inside(t, r, c - 1)
    n4 = W4[b]
    half = n4 >> 1
    quarter = half >> 1
    has_rows = (r + half) < h.mi_rows
    has_cols = (c + half) < h.mi_cols
    if b < BLOCK_8X8:
        p = PART_NONE
    else:
        bsl = W_LOG2[b]
        above = avail_u and W_LOG2[fs.mi_size[r - 1, c]] < bsl
        left = avail_l and H_LOG2[fs.mi_size[r, c - 1]] < bsl
        ctx = left * 2 + above
        cdf = t.cdf["partition"][(bsl - 1) * 4 + ctx]
        if has_rows and has_cols:
            p = t.sd.symbol(cdf)
        elif has_cols:
            p = PART_SPLIT if t.sd.cdf2(_gather(cdf, b, True)) else PART_HORZ
        elif has_rows:
            p = PART_SPLIT if t.sd.cdf2(_gather(cdf, b, False)) else PART_VERT
        else:
            p = PART_SPLIT
    sub = SUBSIZE[(p, b)] if b >= BLOCK_8X8 else b
    if t.s.ss_x and not t.s.ss_y and BLOCK_H[sub] > BLOCK_W[sub]:
        # the spec's Subsampled_Size has no 4:2:2 chroma block for it
        raise ValueError("AV1 partition into blocks that 4:2:2 chroma cannot take")
    split = SUBSIZE[(PART_SPLIT, b)] if b >= BLOCK_8X8 else b
    if p == PART_NONE:
        _block(t, r, c, sub)
    elif p == PART_HORZ:
        _block(t, r, c, sub)
        if has_rows:
            _block(t, r + half, c, sub)
    elif p == PART_VERT:
        _block(t, r, c, sub)
        if has_cols:
            _block(t, r, c + half, sub)
    elif p == PART_SPLIT:
        _partition(t, r, c, sub)
        _partition(t, r, c + half, sub)
        _partition(t, r + half, c, sub)
        _partition(t, r + half, c + half, sub)
    elif p == PART_HORZ_A:
        _block(t, r, c, split)
        _block(t, r, c + half, split)
        _block(t, r + half, c, sub)
    elif p == PART_HORZ_B:
        _block(t, r, c, sub)
        _block(t, r + half, c, split)
        _block(t, r + half, c + half, split)
    elif p == PART_VERT_A:
        _block(t, r, c, split)
        _block(t, r + half, c, split)
        _block(t, r, c + half, sub)
    elif p == PART_VERT_B:
        _block(t, r, c, sub)
        _block(t, r, c + half, split)
        _block(t, r + half, c + half, split)
    elif p == PART_HORZ_4:
        for i in range(4):
            if i < 3 or r + quarter * 3 < h.mi_rows:
                _block(t, r + quarter * i, c, sub)
    else:
        for i in range(4):
            if i < 3 or c + quarter * 3 < h.mi_cols:
                _block(t, r, c + quarter * i, sub)


def _gather(cdf, b, vert_alike):
    """libaom's partition_gather_vert_alike / _horz_alike: the inverted
    CDF of SPLIT against the rest, from a 10-symbol (or 8 at 128x128)
    partition CDF."""
    def prob(e):
        return (cdf[e - 1] if e > 0 else 32768) - cdf[e]
    if vert_alike:
        parts = [PART_VERT, PART_SPLIT, PART_HORZ_A, PART_VERT_A, PART_VERT_B]
        if b != BLOCK_128X128:
            parts.append(PART_VERT_4)
    else:
        parts = [PART_HORZ, PART_SPLIT, PART_HORZ_A, PART_HORZ_B, PART_VERT_A]
        if b != BLOCK_128X128:
            parts.append(PART_HORZ_4)
    v = 32768
    for e in parts:
        v -= prob(e)
    return 32768 - v


def _block(t, r, c, b):
    fs, h, s = t.fs, t.h, t.s
    bw4, bh4 = W4[b], H4[b]
    ss_x, ss_y = s.ss_x, s.ss_y
    if bh4 == 1 and ss_y and (r & 1) == 0:
        has_chroma = False
    elif bw4 == 1 and ss_x and (c & 1) == 0:
        has_chroma = False
    else:
        has_chroma = s.num_planes > 1
    t.r, t.c, t.b = r, c, b
    t.has_chroma = has_chroma
    t.avail_u = _inside(t, r - 1, c)
    t.avail_l = _inside(t, r, c - 1)
    t.avail_u_chroma, t.avail_l_chroma = t.avail_u, t.avail_l
    if has_chroma:
        if ss_y and bh4 == 1:
            t.avail_u_chroma = _inside(t, r - 2, c)
        if ss_x and bw4 == 1:
            t.avail_l_chroma = _inside(t, r, c - 2)
    else:
        t.avail_u_chroma = t.avail_l_chroma = False
    _mode_info(t)
    _palette_tokens(t)
    _block_tx_size(t)
    if t.skip:
        _reset_block_context(t, bw4, bh4)
    rr, cc = slice(r, r + bh4), slice(c, c + bw4)
    fs.y_mode[rr, cc] = t.y_mode
    fs.uv_mode[rr, cc] = t.uv_mode
    fs.is_inter[rr, cc] = t.use_intrabc
    fs.skip[rr, cc] = t.skip
    fs.mi_size[rr, cc] = b
    fs.seg_id[rr, cc] = t.segment_id
    fs.pal_y[rr, cc] = t.pal_size_y
    fs.pal_uv[rr, cc] = t.pal_size_uv
    fs.decoded[rr, cc] = True
    if t.pal_size_y or t.pal_size_uv:
        for y in range(r, min(r + bh4, fs.rows4)):
            for x in range(c, min(c + bw4, fs.cols4)):
                fs.pal_colors_y[(y, x)] = t.pal_colors_y
                fs.pal_colors_u[(y, x)] = t.pal_colors_u
    for i in range(4):
        fs.delta_lf[i, rr, cc] = t.delta_lf[i]
    if t.use_intrabc:
        fs.mv_row[rr, cc] = t.mv[0]
        fs.mv_col[rr, cc] = t.mv[1]
        _predict_intrabc_block(t)
    _residual(t)


def _mode_info(t):
    fs, h = t.fs, t.h
    sd, cdf = t.sd, t.cdf
    t.skip = 0
    if h.seg_id_pre_skip:
        _intra_segment_id(t)
    # read_skip
    if h.seg_id_pre_skip and h.feature_enabled[t.segment_id][SEG_LVL_SKIP]:
        t.skip = 1
    else:
        ctx = 0
        if t.avail_u:
            ctx += fs.skip[t.r - 1, t.c]
        if t.avail_l:
            ctx += fs.skip[t.r, t.c - 1]
        t.skip = sd.symbol(cdf["skip"][ctx])
    if not h.seg_id_pre_skip:
        _intra_segment_id(t)
    t.lossless = h.lossless[t.segment_id]
    _read_cdef(t)
    _read_delta_qindex(t)
    _read_delta_lf(t)
    t.read_deltas = 0
    t.use_intrabc = sd.symbol(cdf["intrabc"]) if h.allow_intrabc else 0
    t.pal_size_y = t.pal_size_uv = 0
    t.pal_colors_y = t.pal_colors_u = t.pal_colors_v = None
    t.filter_intra_mode = -1
    t.angle_y = t.angle_uv = 0
    t.cfl_u = t.cfl_v = 0
    if t.use_intrabc:
        t.y_mode = P.DC_PRED
        t.uv_mode = P.DC_PRED
        _intrabc_mv(t)
        return
    b = t.b
    above = fs.y_mode[t.r - 1, t.c] if t.avail_u else P.DC_PRED
    left = fs.y_mode[t.r, t.c - 1] if t.avail_l else P.DC_PRED
    t.y_mode = sd.symbol(cdf["kf_y_mode"][INTRA_MODE_CONTEXT[above]][INTRA_MODE_CONTEXT[left]])
    if b >= BLOCK_8X8 and P.is_directional(t.y_mode):
        t.angle_y = sd.symbol(cdf["angle_delta"][t.y_mode - P.V_PRED]) - 3
    t.uv_mode = P.DC_PRED
    if t.has_chroma:
        if t.lossless and _plane_size(b, t.s.ss_x, t.s.ss_y) == BLOCK_4X4:
            cfl_allowed = True
        elif not t.lossless and max(BLOCK_W[b], BLOCK_H[b]) <= 32:
            cfl_allowed = True
        else:
            cfl_allowed = False
        t.uv_mode = sd.symbol(cdf["uv_mode"][int(cfl_allowed)][t.y_mode])
        if t.uv_mode == P.UV_CFL_PRED:
            signs = sd.symbol(cdf["cfl_sign"])
            sign_u, sign_v = (signs + 1) // 3, (signs + 1) % 3
            if sign_u:
                a = sd.symbol(cdf["cfl_alpha"][(sign_u - 1) * 3 + sign_v]) + 1
                t.cfl_u = -a if sign_u == 1 else a
            if sign_v:
                a = sd.symbol(cdf["cfl_alpha"][(sign_v - 1) * 3 + sign_u]) + 1
                t.cfl_v = -a if sign_v == 1 else a
        if b >= BLOCK_8X8 and P.is_directional(t.uv_mode):
            t.angle_uv = sd.symbol(cdf["angle_delta"][t.uv_mode - P.V_PRED]) - 3
    if (b >= BLOCK_8X8 and BLOCK_W[b] <= 64 and BLOCK_H[b] <= 64
            and h.allow_screen_content_tools):
        _palette_mode_info(t)
    if (t.s.enable_filter_intra and t.y_mode == P.DC_PRED and t.pal_size_y == 0
            and max(BLOCK_W[b], BLOCK_H[b]) <= 32):
        if sd.symbol(cdf["filter_intra"][b]):
            t.filter_intra_mode = sd.symbol(cdf["filter_intra_mode"])


def _intra_segment_id(t):
    h, fs = t.h, t.fs
    if not h.segmentation_enabled:
        t.segment_id = 0
        return
    r, c = t.r, t.c
    prev_ul = fs.seg_id[r - 1, c - 1] if (t.avail_u and t.avail_l) else -1
    prev_u = fs.seg_id[r - 1, c] if t.avail_u else -1
    prev_l = fs.seg_id[r, c - 1] if t.avail_l else -1
    if prev_u == -1:
        pred = 0 if prev_l == -1 else prev_l
    elif prev_l == -1:
        pred = prev_u
    else:
        pred = prev_u if prev_ul == prev_u else prev_l
    if t.skip:
        t.segment_id = int(pred)
        return
    if prev_ul < 0:
        ctx = 0
    elif prev_ul == prev_u and prev_ul == prev_l:
        ctx = 2
    elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
        ctx = 1
    else:
        ctx = 0
    v = t.sd.symbol(t.cdf["segment_id"][ctx])
    mx = h.last_active_seg_id + 1
    pred = int(pred)
    if not pred:
        seg = v
    elif pred >= mx - 1:
        seg = mx - v - 1
    elif 2 * pred < mx:
        if v <= 2 * pred:
            seg = pred + ((v + 1) >> 1) if v & 1 else pred - (v >> 1)
        else:
            seg = v
    else:
        if v <= 2 * (mx - pred - 1):
            seg = pred + ((v + 1) >> 1) if v & 1 else pred - (v >> 1)
        else:
            seg = mx - (v + 1)
    t.segment_id = max(0, min(h.last_active_seg_id, seg))


def _read_cdef(t):
    h, fs = t.h, t.fs
    if t.skip or h.coded_lossless or not h.enable_cdef or h.allow_intrabc:
        return
    r, c = t.r & ~15, t.c & ~15
    if fs.cdef_idx[r, c] == -1:
        v = t.sd.literal(h.cdef_bits)
        w4, h4 = W4[t.b], H4[t.b]
        for y in range(r, r + h4, 16):
            for x in range(c, c + w4, 16):
                fs.cdef_idx[y, x] = v


def _sb_size(t):
    return BLOCK_128X128 if t.s.use_128 else BLOCK_64X64


def _read_delta_qindex(t):
    if t.b == _sb_size(t) and t.skip:
        return
    if t.read_deltas:
        sd = t.sd
        a = sd.symbol(t.cdf["delta_q"])
        if a == 3:
            n = sd.literal(3) + 1
            a = sd.literal(n) + (1 << n) + 1
        if a:
            v = -a if sd.literal(1) else a
            t.current_q = max(1, min(255, t.current_q + (v << t.h.delta_q_res)))


def _read_delta_lf(t):
    h = t.h
    if t.b == _sb_size(t) and t.skip:
        return
    if t.read_deltas and h.delta_lf_present:
        sd = t.sd
        count = 1
        if h.delta_lf_multi:
            count = 4 if t.s.num_planes > 1 else 2
        for i in range(count):
            cdf = t.cdf["delta_lf_multi"][i] if h.delta_lf_multi else t.cdf["delta_lf"]
            a = sd.symbol(cdf)
            if a == 3:
                n = sd.literal(3) + 1
                a = sd.literal(n) + (1 << n) + 1
            if a:
                v = -a if sd.literal(1) else a
                t.delta_lf[i] = max(-63, min(63, t.delta_lf[i] + (v << h.delta_lf_res)))


def _palette_cache(t, plane):
    fs = t.fs
    r, c = t.r, t.c
    above_n = left_n = 0
    sizes = fs.pal_y if plane == 0 else fs.pal_uv
    colors = fs.pal_colors_y if plane == 0 else fs.pal_colors_u
    if (r * 4) % 64 and t.avail_u:
        above_n = int(sizes[r - 1, c])
    if t.avail_l:
        left_n = int(sizes[r, c - 1])
    above = colors[(r - 1, c)] if above_n else []
    left = colors[(r, c - 1)] if left_n else []
    ai = li = 0
    cache = []
    while ai < above_n and li < left_n:
        ac, lc = above[ai], left[li]
        if lc < ac:
            if not cache or lc != cache[-1]:
                cache.append(lc)
            li += 1
        else:
            if not cache or ac != cache[-1]:
                cache.append(ac)
            ai += 1
            if lc == ac:
                li += 1
    for v in above[ai:above_n]:
        if not cache or v != cache[-1]:
            cache.append(v)
    for v in left[li:left_n]:
        if not cache or v != cache[-1]:
            cache.append(v)
    return cache


def _ceil_log2(x):
    return 0 if x < 2 else (x - 1).bit_length()


def _palette_colors(t, n, plane, delta_plus):
    sd = t.sd
    cache = _palette_cache(t, plane)
    colors = []
    for v in cache:
        if len(colors) >= n:
            break
        if sd.literal(1):
            colors.append(v)
    if len(colors) < n:
        colors.append(sd.literal(8))
    if len(colors) < n:
        bits = 5 + sd.literal(2)
        while len(colors) < n:
            d = sd.literal(bits) + delta_plus
            v = min(255, colors[-1] + d)
            colors.append(v)
            rng = 256 - v - delta_plus
            bits = min(bits, _ceil_log2(rng))
    return sorted(colors)


def _palette_mode_info(t):
    fs, sd, cdf = t.fs, t.sd, t.cdf
    b = t.b
    bctx = W_LOG2[b] + H_LOG2[b] - 2
    if t.y_mode == P.DC_PRED:
        ctx = 0
        if t.avail_u and fs.pal_y[t.r - 1, t.c] > 0:
            ctx += 1
        if t.avail_l and fs.pal_y[t.r, t.c - 1] > 0:
            ctx += 1
        if sd.symbol(cdf["palette_y_mode"][bctx][ctx]):
            t.pal_size_y = sd.symbol(cdf["palette_y_size"][bctx]) + 2
            t.pal_colors_y = _palette_colors(t, t.pal_size_y, 0, 1)
    if t.has_chroma and t.uv_mode == P.DC_PRED:
        if sd.symbol(cdf["palette_uv_mode"][int(t.pal_size_y > 0)]):
            n = sd.symbol(cdf["palette_uv_size"][bctx]) + 2
            t.pal_size_uv = n
            t.pal_colors_u = _palette_colors(t, n, 1, 0)
            if sd.literal(1):  # delta_encode_palette_colors_v
                bits = 4 + sd.literal(2)
                v = [sd.literal(8)]
                for _ in range(1, n):
                    d = sd.literal(bits)
                    if d and sd.literal(1):
                        d = -d
                    x = v[-1] + d
                    if x < 0:
                        x += 256
                    if x >= 256:
                        x -= 256
                    v.append(max(0, min(255, x)))
                t.pal_colors_v = v
            else:
                t.pal_colors_v = [sd.literal(8) for _ in range(n)]


def _color_map(t, n, bw, bh, onw, onh, cdfs):
    sd = t.sd
    m = np.zeros((bh, bw), np.int64)
    rows = [[0] * onw for _ in range(onh)]
    rows[0][0] = sd.ns(n)
    for i in range(1, onh + onw - 1):
        for j in range(min(i, onw - 1), max(0, i - onh + 1) - 1, -1):
            r, c = i - j, j
            scores = [0] * 8
            order = list(range(8))
            if c > 0:
                scores[rows[r][c - 1]] += 2
            if r > 0 and c > 0:
                scores[rows[r - 1][c - 1]] += 1
            if r > 0:
                scores[rows[r - 1][c]] += 2
            for k in range(3):
                best, bi = scores[k], k
                for q in range(k + 1, n):
                    if scores[q] > best:
                        best, bi = scores[q], q
                if bi != k:
                    o = order[bi]
                    for q in range(bi, k, -1):
                        scores[q] = scores[q - 1]
                        order[q] = order[q - 1]
                    scores[k] = best
                    order[k] = o
            ctx = PALETTE_COLOR_CONTEXT[scores[0] + scores[1] * 2 + scores[2] * 2]
            rows[r][c] = order[sd.symbol(cdfs[n - 2][ctx])]
    m[:onh, :onw] = rows
    m[:onh, onw:] = m[:onh, onw - 1:onw]
    m[onh:, :] = m[onh - 1:onh, :]
    return m


def _palette_tokens(t):
    h = t.h
    b = t.b
    bh, bw = BLOCK_H[b], BLOCK_W[b]
    onh = min(bh, (h.mi_rows - t.r) * 4)
    onw = min(bw, (h.mi_cols - t.c) * 4)
    t.map_y = t.map_uv = None
    if t.pal_size_y:
        t.map_y = _color_map(t, t.pal_size_y, bw, bh, onw, onh, t.cdf["palette_y_color"])
    if t.pal_size_uv:
        ss_x, ss_y = t.s.ss_x, t.s.ss_y
        bh, bw, onh, onw = bh >> ss_y, bw >> ss_x, onh >> ss_y, onw >> ss_x
        if bw < 4:
            bw += 2
            onw += 2
        if bh < 4:
            bh += 2
            onh += 2
        t.map_uv = _color_map(t, t.pal_size_uv, bw, bh, onw, onh, t.cdf["palette_uv_color"])


def _above_tx_width(t, r, c):
    fs = t.fs
    if r == t.r:
        if not t.avail_u:
            return 64
        if fs.skip[r - 1, c] and fs.is_inter[r - 1, c]:
            return BLOCK_W[fs.mi_size[r - 1, c]]
    return TX_W[fs.inter_tx[r - 1, c]]


def _left_tx_height(t, r, c):
    fs = t.fs
    if c == t.c:
        if not t.avail_l:
            return 64
        if fs.skip[r, c - 1] and fs.is_inter[r, c - 1]:
            return BLOCK_H[fs.mi_size[r, c - 1]]
    return TX_H[fs.inter_tx[r, c - 1]]


def _block_tx_size(t):
    h, fs = t.h, t.fs
    b = t.b
    bw4, bh4 = W4[b], H4[b]
    rr, cc = slice(t.r, t.r + bh4), slice(t.c, t.c + bw4)
    if (h.tx_mode_select and b > BLOCK_4X4 and t.use_intrabc and not t.skip
            and not t.lossless):
        max_tx = MAX_TX_RECT[b]
        tw4, th4 = TX_W[max_tx] >> 2, TX_H[max_tx] >> 2
        for row in range(t.r, t.r + bh4, th4):
            for col in range(t.c, t.c + bw4, tw4):
                _var_tx_size(t, row, col, max_tx, 0)
        return
    # read_tx_size(allowSelect = !skip || !is_inter)
    if t.lossless:
        t.tx_size = TX_4X4
    else:
        t.tx_size = MAX_TX_RECT[b]
        if (b > BLOCK_4X4 and (not t.skip or not t.use_intrabc) and h.tx_mode_select):
            max_w, max_h = TX_W[t.tx_size], TX_H[t.tx_size]
            if t.avail_u and fs.is_inter[t.r - 1, t.c]:
                above_w = BLOCK_W[fs.mi_size[t.r - 1, t.c]]
            elif t.avail_u:
                above_w = _above_tx_width(t, t.r, t.c)
            else:
                above_w = 0
            if t.avail_l and fs.is_inter[t.r, t.c - 1]:
                left_h = BLOCK_H[fs.mi_size[t.r, t.c - 1]]
            elif t.avail_l:
                left_h = _left_tx_height(t, t.r, t.c)
            else:
                left_h = 0
            ctx = (above_w >= max_w) + (left_h >= max_h)
            depth = t.sd.symbol(t.cdf["tx_size"][MAX_TX_DEPTH[b] - 1][ctx])
            for _ in range(depth):
                t.tx_size = SPLIT_TX[t.tx_size]
    fs.inter_tx[rr, cc] = t.tx_size


def _var_tx_size(t, row, col, tx, depth):
    h, fs = t.h, t.fs
    if row >= h.mi_rows or col >= h.mi_cols:
        return
    if tx == TX_4X4 or depth == 2:
        split = 0
    else:
        above = _above_tx_width(t, row, col) < TX_W[tx]
        left = _left_tx_height(t, row, col) < TX_H[tx]
        size = min(64, max(BLOCK_W[t.b], BLOCK_H[t.b]))
        max_sz = TX_OF[(size, size)]
        ctx = (TX_SQR_UP[tx] != max_sz) * 3 + (TX_64X64 - max_sz) * 6 + above + left
        split = t.sd.symbol(t.cdf["txfm_split"][ctx])
    w4, h4 = TX_W[tx] >> 2, TX_H[tx] >> 2
    if split:
        sub = SPLIT_TX[tx]
        sw, sh = TX_W[sub] >> 2, TX_H[sub] >> 2
        for i in range(0, h4, sh):
            for j in range(0, w4, sw):
                _var_tx_size(t, row + i, col + j, sub, depth + 1)
    else:
        fs.inter_tx[row:row + h4, col:col + w4] = tx
        t.tx_size = tx


def _reset_block_context(t, bw4, bh4):
    for plane in range(1 + 2 * t.has_chroma):
        sx = t.s.ss_x if plane else 0
        sy = t.s.ss_y if plane else 0
        a0, a1 = t.c >> sx, (t.c + bw4) >> sx
        l0, l1 = t.r >> sy, (t.r + bh4) >> sy
        al, ad = t.above_level[plane], t.above_dc[plane]
        for i in range(a0, a1):
            al[i] = 0
            ad[i] = 0
        ll, ld = t.left_level[plane], t.left_dc[plane]
        for i in range(l0, l1):
            ll[i] = 0
            ld[i] = 0


# --- the intra block copy's vector


def _intrabc_mv(t):
    fs, h = t.fs, t.h
    b = t.b
    bw4, bh4 = W4[b], H4[b]
    t.stack = []  # [mv_row, mv_col, weight]
    t.new_mv_count = 0
    t.found_match = 0
    _scan_row(t, -1)
    found_above = t.found_match
    t.found_match = 0
    _scan_col(t, -1)
    found_left = t.found_match
    t.found_match = 0
    if max(bw4, bh4) <= 16:
        _scan_point(t, -1, bw4)
    if t.found_match:
        found_above = 1
    num_nearest = len(t.stack)
    for e in t.stack:
        e[2] += REF_CAT_LEVEL
    t.found_match = 0
    _scan_point(t, -1, -1)
    t.found_match = 0
    _scan_row(t, -3)
    t.found_match = 0
    _scan_col(t, -3)
    t.found_match = 0
    if bh4 > 1:
        _scan_row(t, -5)
    t.found_match = 0
    if bw4 > 1:
        _scan_col(t, -5)
    _sort(t.stack, 0, num_nearest)
    _sort(t.stack, num_nearest, len(t.stack))
    stack = [[e[0], e[1]] for e in t.stack]
    while len(stack) < 2:
        stack.append([0, 0])
    # clamp
    top = -((t.r * 4) * 8)
    bottom = ((h.mi_rows - bh4 - t.r) * 4) * 8
    left = -((t.c * 4) * 8)
    right = ((h.mi_cols - bw4 - t.c) * 4) * 8
    for e in stack[:len(t.stack)]:
        e[0] = max(top - (128 + bh4 * 32), min(bottom + 128 + bh4 * 32, e[0]))
        e[1] = max(left - (128 + bw4 * 32), min(right + 128 + bw4 * 32, e[1]))
    pred = stack[0]
    if pred == [0, 0]:
        pred = stack[1]
    if pred == [0, 0]:
        sb4 = H4[_sb_size(t)]
        if t.r - sb4 < t.row_start:
            pred = [0, -(sb4 * 4 + 256) * 8]
        else:
            pred = [-(sb4 * 4 * 8), 0]
    # read_mv with MV_INTRABC_CONTEXT
    sd, cdf = t.sd, t.cdf
    joint = sd.symbol(cdf["dv_joint"])
    diff = [0, 0]
    if joint in (2, 3):
        diff[0] = _mv_component(t, 0)
    if joint in (1, 3):
        diff[1] = _mv_component(t, 1)
    t.mv = [pred[0] + diff[0], pred[1] + diff[1]]
    t.mv = [(t.mv[0] >> 3) * 8, (t.mv[1] >> 3) * 8]


def _mv_component(t, comp):
    sd = t.sd
    c = t.cdf["dv_comp"][comp]
    sign = sd.symbol(c["sign"])
    cls = sd.symbol(c["classes"])
    if cls == 0:
        mag = ((sd.symbol(c["class0"]) << 3) | (3 << 1) | 1) + 1
    else:
        d = 0
        for i in range(cls):
            d |= sd.symbol(c["bits"][i]) << i
        mag = (2 << (cls + 2)) + ((d << 3) | (3 << 1) | 1) + 1
    return -mag if sign else mag


def _sort(stack, start, end):
    while end > start:
        new_end = start
        for idx in range(start + 1, end):
            if stack[idx - 1][2] < stack[idx][2]:
                stack[idx - 1], stack[idx] = stack[idx], stack[idx - 1]
                new_end = idx
        end = new_end


def _add_candidate(t, r, c, weight):
    fs = t.fs
    if not fs.is_inter[r, c]:
        return
    mv = (int(fs.mv_row[r, c]), int(fs.mv_col[r, c]))
    mv = tuple(((abs(v) + 3) >> 3 << 3) * (1 if v > 0 else -1) for v in mv)
    t.found_match = 1
    for e in t.stack:
        if e[0] == mv[0] and e[1] == mv[1]:
            e[2] += weight
            return
    if len(t.stack) < 8:
        t.stack.append([mv[0], mv[1], weight])


def _scan_row(t, delta_row):
    fs, h = t.fs, t.h
    bw4 = W4[t.b]
    end4 = min(bw4, h.mi_cols - t.c, 16)
    delta_col = 0
    step16 = bw4 >= 16
    if abs(delta_row) > 1:
        delta_row += t.r & 1
        delta_col = 1 - (t.c & 1)
    i = 0
    while i < end4:
        r, c = t.r + delta_row, t.c + delta_col + i
        if not _inside(t, r, c):
            break
        n = min(bw4, W4[fs.mi_size[r, c]])
        if abs(delta_row) > 1:
            n = max(2, n)
        if step16:
            n = max(4, n)
        _add_candidate(t, r, c, n * 2)
        i += n


def _scan_col(t, delta_col):
    fs, h = t.fs, t.h
    bh4 = H4[t.b]
    end4 = min(bh4, h.mi_rows - t.r, 16)
    delta_row = 0
    step16 = bh4 >= 16
    if abs(delta_col) > 1:
        delta_row = 1 - (t.r & 1)
        delta_col += t.c & 1
    i = 0
    while i < end4:
        r, c = t.r + delta_row + i, t.c + delta_col
        if not _inside(t, r, c):
            break
        n = min(bh4, H4[fs.mi_size[r, c]])
        if abs(delta_col) > 1:
            n = max(2, n)
        if step16:
            n = max(4, n)
        _add_candidate(t, r, c, n * 2)
        i += n


def _scan_point(t, delta_row, delta_col):
    r, c = t.r + delta_row, t.c + delta_col
    if _inside(t, r, c) and t.fs.decoded[r, c]:
        _add_candidate(t, r, c, 4)


def _predict_intrabc_block(t):
    fs, h, s = t.fs, t.h, t.s
    b = t.b
    for plane in range(1 + 2 * t.has_chroma):
        sx = s.ss_x if plane else 0
        sy = s.ss_y if plane else 0
        psz = _plane_size(b, sx, sy)
        w, hh = W4[psz] * 4, H4[psz] * 4
        x = (t.c >> sx) * 4
        y = (t.r >> sy) * 4
        last_x = ((h.width + sx) >> sx) - 1
        last_y = ((h.height + sy) >> sy) - 1
        P.predict_intrabc(fs.planes[plane], x, y, w, hh, t.mv[0], t.mv[1], sx, sy, last_x,
                          last_y)


# --- residual


def _residual(t):
    h, s = t.h, t.s
    b = t.b
    wchunks = max(1, BLOCK_W[b] >> 6)
    hchunks = max(1, BLOCK_H[b] >> 6)
    for cy in range(hchunks):
        for cx in range(wchunks):
            r_chunk = t.r + (cy << 4)
            c_chunk = t.c + (cx << 4)
            for plane in range(1 + 2 * t.has_chroma):
                sx = s.ss_x if plane else 0
                sy = s.ss_y if plane else 0
                if t.lossless:
                    tx = TX_4X4
                elif plane == 0:
                    tx = t.tx_size
                else:
                    tx = _uv_tx_size(b, sx, sy)
                step_x, step_y = TX_W[tx] >> 2, TX_H[tx] >> 2
                psz = _plane_size(b, sx, sy)
                n4w, n4h = W4[psz], H4[psz]
                if t.use_intrabc and not t.lossless and plane == 0:
                    _transform_tree(t, (c_chunk >> sx) * 4, (r_chunk >> sy) * 4, n4w * 4, n4h * 4)
                else:
                    base_x = (t.c >> sx) * 4
                    base_y = (t.r >> sy) * 4
                    for y in range(0, min(n4h, 16 >> sy), step_y):
                        for x in range(0, min(n4w, 16 >> sx), step_x):
                            _transform_block(t, plane, base_x, base_y, tx,
                                             x + ((cx << 4) >> sx), y + ((cy << 4) >> sy))


def _transform_tree(t, x0, y0, w, h):
    hdr, fs = t.h, t.fs
    if x0 >= hdr.mi_cols * 4 or y0 >= hdr.mi_rows * 4:
        return
    tx = int(fs.inter_tx[y0 >> 2, x0 >> 2])
    if w <= TX_W[tx] and h <= TX_H[tx]:
        _transform_block(t, 0, x0, y0, tx, 0, 0)
    elif w > h:
        _transform_tree(t, x0, y0, w // 2, h)
        _transform_tree(t, x0 + w // 2, y0, w // 2, h)
    elif w < h:
        _transform_tree(t, x0, y0, w, h // 2)
        _transform_tree(t, x0, y0 + h // 2, w, h // 2)
    else:
        _transform_tree(t, x0, y0, w // 2, h // 2)
        _transform_tree(t, x0 + w // 2, y0, w // 2, h // 2)
        _transform_tree(t, x0, y0 + h // 2, w // 2, h // 2)
        _transform_tree(t, x0 + w // 2, y0 + h // 2, w // 2, h // 2)


def _transform_block(t, plane, base_x, base_y, tx, x, y):
    fs, h, s = t.fs, t.h, t.s
    start_x = base_x + 4 * x
    start_y = base_y + 4 * y
    sx = s.ss_x if plane else 0
    sy = s.ss_y if plane else 0
    max_x = (h.mi_cols * 4) >> sx
    max_y = (h.mi_rows * 4) >> sy
    if start_x >= max_x or start_y >= max_y:
        return
    cur = fs.planes[plane]
    step_x, step_y = TX_W[tx] >> 2, TX_H[tx] >> 2
    sb_mask = (32 if s.use_128 else 16) - 1
    sbr = ((((start_y << sy) >> 2) & sb_mask) >> sy)  # BlockDecoded row of the block, less 1
    sbc = ((((start_x << sx) >> 2) & sb_mask) >> sx)
    bdec = t.bdec[plane]
    if not t.use_intrabc:
        if (plane == 0 and t.pal_size_y) or (plane and t.pal_size_uv):
            w, hh = TX_W[tx], TX_H[tx]
            pal = t.pal_colors_y if plane == 0 else (t.pal_colors_u if plane == 1
                                                     else t.pal_colors_v)
            m = t.map_y if plane == 0 else t.map_uv
            cur[start_y:start_y + hh, start_x:start_x + w] = np.asarray(pal, np.int32)[
                m[y * 4:y * 4 + hh, x * 4:x * 4 + w]]
        else:
            is_cfl = plane and t.uv_mode == P.UV_CFL_PRED
            if plane == 0:
                mode = t.y_mode
            else:
                mode = P.DC_PRED if is_cfl else t.uv_mode
            have_left = (t.avail_l if plane == 0 else t.avail_l_chroma) or x > 0
            have_above = (t.avail_u if plane == 0 else t.avail_u_chroma) or y > 0
            have_ar = bool(bdec[sbr, sbc + step_x + 1])
            have_bl = bool(bdec[sbr + step_y + 1, sbc])
            fi = t.filter_intra_mode if plane == 0 else -1
            ftype = _filter_type(t, plane) if s.enable_intra_edge_filter else 0
            P.predict_intra(cur, start_x, start_y, have_left, have_above, have_ar, have_bl, mode,
                            TX_W_LOG2[tx], TX_H_LOG2[tx], max_x - 1, max_y - 1,
                            t.angle_y if plane == 0 else t.angle_uv, fi,
                            bool(s.enable_intra_edge_filter), ftype)
            if is_cfl:
                P.predict_cfl(cur, fs.planes[0], start_x, start_y, TX_W[tx], TX_H[tx], sx, sy,
                              t.max_luma_w, t.max_luma_h, t.cfl_u if plane == 1 else t.cfl_v)
        if plane == 0:
            t.max_luma_w = start_x + step_x * 4
            t.max_luma_h = start_y + step_y * 4
    if not t.skip:
        eob = _coeffs(t, plane, start_x, start_y, tx)
        if eob > 0:
            _reconstruct(t, plane, start_x, start_y, tx)
    else:
        if plane == 0:
            fs.tx_type[start_y >> 2:(start_y >> 2) + step_y,
                       start_x >> 2:(start_x >> 2) + step_x] = DCT_DCT
    fs.lf_tx[plane][start_y >> 2:(start_y >> 2) + step_y,
                    start_x >> 2:(start_x >> 2) + step_x] = tx
    bdec[sbr + 1:sbr + 1 + step_y, sbc + 1:sbc + 1 + step_x] = True


def _filter_type(t, plane):
    fs, s = t.fs, t.s
    above_smooth = left_smooth = False
    if (t.avail_u if plane == 0 else t.avail_u_chroma):
        r, c = t.r - 1, t.c
        if plane:
            if s.ss_x and not (t.c & 1):
                c += 1
            if s.ss_y and (t.r & 1):
                r -= 1
        above_smooth = _is_smooth(fs, r, c, plane)
    if (t.avail_l if plane == 0 else t.avail_l_chroma):
        r, c = t.r, t.c - 1
        if plane:
            if s.ss_x and (t.c & 1):
                c -= 1
            if s.ss_y and not (t.r & 1):
                r += 1
        left_smooth = _is_smooth(fs, r, c, plane)
    return int(above_smooth or left_smooth)


def _is_smooth(fs, r, c, plane):
    if plane == 0:
        mode = fs.y_mode[r, c]
    else:
        if fs.is_inter[r, c]:
            return False
        mode = fs.uv_mode[r, c]
    return mode in (P.SMOOTH_PRED, P.SMOOTH_V_PRED, P.SMOOTH_H_PRED)


def _tx_set(t, tx):
    sqr, up = TX_SQR[tx], TX_SQR_UP[tx]
    if up > TX_32X32:
        return 0
    if t.use_intrabc:
        if t.h.reduced_tx_set or up == TX_32X32:
            return 3
        if sqr == TX_16X16:
            return 2
        return 1
    if up == TX_32X32:
        return 0
    if t.h.reduced_tx_set or sqr == TX_16X16:
        return 2
    return 1


def _compute_tx_type(t, plane, tx, x4, y4):
    fs = t.fs
    if t.lossless or TX_SQR_UP[tx] > TX_32X32:
        return DCT_DCT
    tset = _tx_set(t, tx)
    if plane == 0:
        return int(fs.tx_type[y4, x4])
    if t.use_intrabc:
        lx = max(t.c, x4 << t.s.ss_x)
        ly = max(t.r, y4 << t.s.ss_y)
        tt = int(fs.tx_type[ly, lx])
        allowed = INTER_SET[tset] if tset else (DCT_DCT,)
        return tt if tt in allowed else DCT_DCT
    tt = MODE_TO_TXFM[t.uv_mode]
    allowed = INTRA_SET[tset] if tset else (DCT_DCT,)
    return tt if tt in allowed else DCT_DCT


def _coeffs(t, plane, start_x, start_y, tx):
    fs, h, s = t.fs, t.h, t.s
    sd, cdf = t.sd, t.cdf
    x4, y4 = start_x >> 2, start_y >> 2
    w4, h4 = TX_W[tx] >> 2, TX_H[tx] >> 2
    tx_ctx = (TX_SQR[tx] + TX_SQR_UP[tx] + 1) >> 1
    ptype = int(plane > 0)
    sx = s.ss_x if plane else 0
    sy = s.ss_y if plane else 0
    max_x4 = h.mi_cols >> sx
    max_y4 = h.mi_rows >> sy
    w, hh = TX_W[tx], TX_H[tx]
    al, ad = t.above_level[plane], t.above_dc[plane]
    ll, ld = t.left_level[plane], t.left_dc[plane]
    # all_zero context
    if plane == 0:
        top = left = 0
        for k in range(w4):
            if x4 + k < max_x4:
                top = max(top, al[x4 + k])
        for k in range(h4):
            if y4 + k < max_y4:
                left = max(left, ll[y4 + k])
        top, left = min(top, 255), min(left, 255)
        b = t.b
        if BLOCK_W[b] == w and BLOCK_H[b] == hh:
            ctx = 0
        elif top == 0 and left == 0:
            ctx = 1
        elif top == 0 or left == 0:
            ctx = 2 + (max(top, left) > 3)
        elif max(top, left) <= 3:
            ctx = 4
        elif min(top, left) <= 3:
            ctx = 5
        else:
            ctx = 6
    else:
        above = left = 0
        for i in range(w4):
            if x4 + i < max_x4:
                above |= al[x4 + i] | ad[x4 + i]
        for i in range(h4):
            if y4 + i < max_y4:
                left |= ll[y4 + i] | ld[y4 + i]
        ctx = (above != 0) + (left != 0) + 7
        psz = _plane_size(t.b, sx, sy)
        if BLOCK_W[psz] * BLOCK_H[psz] > w * hh:
            ctx += 3
    all_zero = sd.symbol(cdf["txb_skip"][tx_ctx][ctx])
    eob = 0
    cul_level = 0
    dc_category = 0
    t.quant = None
    if all_zero:
        if plane == 0:
            fs.tx_type[y4:y4 + h4, x4:x4 + w4] = DCT_DCT
    else:
        if plane == 0:
            _transform_type(t, x4, y4, tx)
        t.plane_tx_type = _compute_tx_type(t, plane, tx, x4, y4)
        tx_type = t.plane_tx_type
        tx_class = TX_CLASS[tx_type]
        scan = scan_list(tx, tx_type)
        multisize = min(TX_W_LOG2[tx], 5) + min(TX_H_LOG2[tx], 5) - 4
        eob_pt = sd.symbol(cdf["eob_pt"][multisize][ptype][0 if tx_class == TX_CLASS_2D
                                                           else 1]) + 1
        eob = eob_pt if eob_pt < 2 else (1 << (eob_pt - 2)) + 1
        shift = eob_pt - 3
        if shift >= 0:
            if sd.symbol(cdf["eob_extra"][tx_ctx][ptype][eob_pt - 3]):
                eob += 1 << shift
            for i in range(1, max(0, eob_pt - 2)):
                shift = max(0, eob_pt - 2) - 1 - i
                if sd.literal(1):
                    eob += 1 << shift
        bw = min(w, 32)
        bwl = bw.bit_length() - 1
        bh = min(hh, 32)
        quant = [0] * (bw * bh)
        base_cdf = cdf["coeff_base"][tx_ctx][ptype]
        br_cdf = cdf["coeff_br"][min(tx_ctx, TX_32X32)][ptype]
        offsets = T.COEFF_BASE_CTX_OFFSET[tx]
        sig_ref = SIG_REF_OFFSETS[tx_class]
        mag_ref = MAG_REF_OFFSETS[tx_class]
        area = bh << bwl
        for ci in range(eob - 1, -1, -1):
            pos = scan[ci]
            row, col = pos >> bwl, pos & (bw - 1)
            if ci == eob - 1:
                if ci == 0:
                    ectx = 0
                elif ci <= area // 8:
                    ectx = 1
                elif ci <= area // 4:
                    ectx = 2
                else:
                    ectx = 3
                level = sd.symbol(cdf["coeff_base_eob"][tx_ctx][ptype][ectx]) + 1
            else:
                mag = 0
                for dr, dc in sig_ref:
                    rr, cc = row + dr, col + dc
                    if rr < bh and cc < bw:
                        q = quant[(rr << bwl) + cc]
                        mag += q if q < 3 else 3
                bctx = min((mag + 1) >> 1, 4)
                if tx_class == TX_CLASS_2D:
                    if pos == 0:
                        bctx = 0
                    else:
                        bctx += int(offsets[min(row, 4), min(col, 4)])
                else:
                    idx = row if tx_class == TX_CLASS_VERT else col
                    bctx += (26, 31, 36)[min(idx, 2)]
                level = sd.symbol(base_cdf[bctx])
            if level > 2:
                mag = 0
                for dr, dc in mag_ref:
                    rr, cc = row + dr, col + dc
                    if rr < bh and cc < bw:
                        q = quant[(rr << bwl) + cc]
                        mag += q if q < 15 else 15
                mag = min((mag + 1) >> 1, 6)
                if pos == 0:
                    rctx = mag
                elif tx_class == TX_CLASS_2D:
                    rctx = mag + 7 if (row < 2 and col < 2) else mag + 14
                elif tx_class == TX_CLASS_HORIZ:
                    rctx = mag + 7 if col == 0 else mag + 14
                else:
                    rctx = mag + 7 if row == 0 else mag + 14
                bcdf = br_cdf[rctx]
                for _ in range(4):
                    k = sd.symbol(bcdf)
                    level += k
                    if k < 3:
                        break
            quant[pos] = level
        signs = [0] * len(quant)
        for ci in range(eob):
            pos = scan[ci]
            level = quant[pos]
            if level:
                if ci == 0:
                    dsign = 0
                    for k in range(w4):
                        if x4 + k < max_x4:
                            v = ad[x4 + k]
                            dsign += -1 if v == 1 else (1 if v == 2 else 0)
                    for k in range(h4):
                        if y4 + k < max_y4:
                            v = ld[y4 + k]
                            dsign += -1 if v == 1 else (1 if v == 2 else 0)
                    dctx = 1 if dsign < 0 else (2 if dsign > 0 else 0)
                    sign = sd.symbol(cdf["dc_sign"][ptype][dctx])
                else:
                    sign = sd.literal(1)
                if level > 14:
                    length = 0
                    while True:
                        length += 1
                        if sd.bool():
                            break
                        if length > 20:
                            raise ValueError("AV1 Golomb code of more than 20 bits")
                    x = 1
                    for _ in range(length - 1):
                        x = (x << 1) | sd.bool()
                    level += x - 1
                if pos == 0:
                    dc_category = 1 if sign else 2
                level &= 0xFFFFF
                cul_level += level
                quant[pos] = level
                signs[pos] = sign
        cul_level = min(63, cul_level)
        t.quant = (quant, signs, bw, bh)
    for i in range(w4):
        al[x4 + i] = cul_level
        ad[x4 + i] = dc_category
    for i in range(h4):
        ll[y4 + i] = cul_level
        ld[y4 + i] = dc_category
    return eob


def _transform_type(t, x4, y4, tx):
    fs, h = t.fs, t.h
    tset = _tx_set(t, tx)
    q = h.qindex(t.segment_id, h.base_q_idx) if h.segmentation_enabled else h.base_q_idx
    tt = DCT_DCT
    if tset > 0 and q > 0:
        if t.use_intrabc:
            sym = t.sd.symbol(t.cdf["inter_tx"][tset][TX_SQR[tx]])
            tt = INTER_SET[tset][sym]
        else:
            d = FILTER_INTRA_DIR[t.filter_intra_mode] if t.filter_intra_mode >= 0 else t.y_mode
            sym = t.sd.symbol(t.cdf["intra_tx"][tset][TX_SQR[tx]][d])
            tt = INTRA_SET[tset][sym]
    fs.tx_type[y4:y4 + (TX_H[tx] >> 2), x4:x4 + (TX_W[tx] >> 2)] = tt


def _reconstruct(t, plane, x, y, tx):
    h = t.h
    quant, signs, bw, bh = t.quant
    qindex = h.qindex(t.segment_id, t.current_q if h.delta_q_present else h.base_q_idx)
    if plane == 0:
        dcq = DC_Q[max(0, min(255, qindex + h.delta_q_y_dc))]
        acq = AC_Q[max(0, min(255, qindex))]
        qm_level = h.qm_y
    elif plane == 1:
        dcq = DC_Q[max(0, min(255, qindex + h.delta_q_u_dc))]
        acq = AC_Q[max(0, min(255, qindex + h.delta_q_u_ac))]
        qm_level = h.qm_u
    else:
        dcq = DC_Q[max(0, min(255, qindex + h.delta_q_v_dc))]
        acq = AC_Q[max(0, min(255, qindex + h.delta_q_v_ac))]
        qm_level = h.qm_v
    tx_type = t.plane_tx_type
    area = TX_W[tx] * TX_H[tx]
    dq_shift = (area > 256) + (area > 1024)
    lev = np.asarray(quant, np.int64).reshape(bh, bw)
    q = np.full((bh, bw), acq, np.int64)
    q[0, 0] = dcq
    if (h.using_qmatrix and not t.lossless and qm_level < 15 and tx_type < IDTX):
        off = int(T.QM_OFFSET[tx])
        m = T.QM_INVERSE[qm_level, int(plane > 0), off:off + bw * bh].astype(np.int64)
        q = (q * m.reshape(bh, bw) + 16) >> 5
    dq = ((lev * q) & 0xFFFFFF) >> dq_shift
    dq = np.where(np.asarray(signs, np.bool_).reshape(bh, bw), -dq, dq)
    dq = np.clip(dq, -(1 << 15), (1 << 15) - 1)
    w, hh = TX_W[tx], TX_H[tx]
    coeffs = np.zeros((hh, w), np.int64)
    coeffs[:bh, :bw] = dq
    res = inverse_transform_2d(coeffs, tx_type, TX_W_LOG2[tx], TX_H_LOG2[tx], tx, t.lossless)
    if tx_type in FLIP_UD:
        res = res[::-1]
    if tx_type in FLIP_LR:
        res = res[:, ::-1]
    cur = t.fs.planes[plane]
    blk = cur[y:y + hh, x:x + w]
    cur[y:y + hh, x:x + w] = np.clip(blk + res, 0, 255)


# --- loop restoration units


def _read_lr(t, r, c, b):
    fs, h = t.fs, t.h
    if h.allow_intrabc:
        return
    w, hh = W4[b], H4[b]
    for plane in range(t.s.num_planes):
        if h.lr_type[plane] == RESTORE_NONE:
            continue
        sx = t.s.ss_x if plane else 0
        sy = t.s.ss_y if plane else 0
        u = h.lr_size[plane]
        rows, cols = fs.lr_units[plane]
        r0 = (r * (4 >> sy) + u - 1) // u
        r1 = min(rows, ((r + hh) * (4 >> sy) + u - 1) // u)
        c0 = (c * (4 >> sx) + u - 1) // u
        c1 = min(cols, ((c + w) * (4 >> sx) + u - 1) // u)
        for ur in range(r0, r1):
            for uc in range(c0, c1):
                _read_lr_unit(t, plane, ur, uc)


def _subexp(t, num, k):
    sd = t.sd
    i = mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num <= mk + 3 * a:
            return sd.ns(num - mk) + mk
        if sd.literal(1):
            i += 1
            mk += a
        else:
            return sd.literal(b2) + mk


def _recenter(r, v):
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _signed_subexp(t, low, high, k, ref):
    mx = high - low
    r = ref - low
    v = _subexp(t, mx, k)
    if (r << 1) <= mx:
        x = _recenter(r, v)
    else:
        x = mx - 1 - _recenter(mx - 1 - r, v)
    return x + low


def _read_lr_unit(t, plane, ur, uc):
    fs, h = t.fs, t.h
    sd, cdf = t.sd, t.cdf
    ftype = h.lr_type[plane]
    if ftype == RESTORE_WIENER:
        rtype = RESTORE_WIENER if sd.symbol(cdf["wiener_restore"]) else RESTORE_NONE
    elif ftype == RESTORE_SGRPROJ:
        rtype = RESTORE_SGRPROJ if sd.symbol(cdf["sgrproj_restore"]) else RESTORE_NONE
    else:
        rtype = (RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ)[
            sd.symbol(cdf["switchable_restore"])]
    fs.lr_type[plane][ur, uc] = rtype
    if rtype == RESTORE_WIENER:
        for p in range(2):
            first = 1 if plane else 0
            if plane:
                fs.lr_wiener[plane][ur, uc, p, 0] = 0
            for j in range(first, 3):
                v = _signed_subexp(t, WIENER_MIN[j], WIENER_MAX[j] + 1, WIENER_K[j],
                                   t.ref_lr_wiener[plane][p][j])
                fs.lr_wiener[plane][ur, uc, p, j] = v
                t.ref_lr_wiener[plane][p][j] = v
    elif rtype == RESTORE_SGRPROJ:
        st = sd.literal(4)
        fs.lr_sgr_set[plane][ur, uc] = st
        for i in range(2):
            radius = SGR_R[st][i]
            lo, hi = SGR_XQD_MIN[i], SGR_XQD_MAX[i]
            if radius:
                v = _signed_subexp(t, lo, hi + 1, 4, t.ref_sgr_xqd[plane][i])
            else:
                v = 0
                if i == 1:
                    v = max(lo, min(hi, (1 << 7) - t.ref_sgr_xqd[plane][0]))
            fs.lr_sgr_xqd[plane][ur, uc, i] = v
            t.ref_sgr_xqd[plane][i] = v

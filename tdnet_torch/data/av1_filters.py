"""The AV1 in-loop filters at 8 bits (specification sections 7.14-7.17),
in the order the specification runs them over a frame: deblocking (4-, 6-,
8- and 14-tap filters, levels from the frame, segment and delta-lf values),
CDEF (direction search, primary and secondary taps, the skip rule of 8x8
blocks) and loop restoration (Wiener and self-guided filters in 64-row
stripes whose boundary rows come from the deblocked, pre-CDEF frame).

Each is vectorised in numpy: deblocking over every edge of one direction
of a plane at once (AV1's filters of one direction never touch each
other's samples), CDEF over every 8x8 block at once, loop restoration
over each stripe of each restoration unit.
"""

from __future__ import annotations

import numpy as np

from tdnet_torch.data import av1_tables as T
from tdnet_torch.data.av1_obu import RESTORE_NONE, RESTORE_WIENER

__all__ = ["loop_filter", "cdef", "loop_restoration"]

_BLOCK_W = np.array((4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 4, 16, 8, 32,
                     16, 64))
_BLOCK_H = np.array((4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64, 128, 16, 4, 32, 8,
                     64, 16))
_TX_W = np.array((4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64))
_TX_H = np.array((4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16))


# --- deblocking


def _levels(fs, plane, pas, rows, cols):
    """The filter level of the blocks at mi (rows, cols) for this plane
    and direction (spec 7.14.4)."""
    h = fs.hdr
    i = pas if plane == 0 else plane + 1
    seg = fs.seg_id[rows, cols].astype(np.int64)
    if h.delta_lf_present:
        d = fs.delta_lf[i if h.delta_lf_multi else 0][rows, cols].astype(np.int64)
    else:
        d = np.zeros(rows.shape, np.int64)
    lvl = np.clip(d + h.lf_level[i], 0, 63)
    feat = np.array([h.feature_data[s][1 + i] if h.feature_enabled[s][1 + i] else 0
                     for s in range(8)], np.int64)
    on = np.array([h.feature_enabled[s][1 + i] for s in range(8)], np.bool_)
    lvl = np.where(on[seg], np.clip(lvl + feat[seg], 0, 63), lvl)
    if h.lf_delta_enabled:
        lvl = np.clip(lvl + (h.lf_ref_deltas[0] << (lvl >> 5)), 0, 63)
    return lvl


def _narrow(v, hev):
    def c4(x):
        return np.clip(x, -128, 127)
    p1, p0, q0, q1 = v[:, 5] - 128, v[:, 6] - 128, v[:, 7] - 128, v[:, 8] - 128
    f = np.where(hev, c4(p1 - q1), 0)
    f = c4(f + 3 * (q0 - p0))
    f1 = c4(f + 4) >> 3
    f2 = c4(f + 3) >> 3
    out = v.copy()
    out[:, 7] = c4(q0 - f1) + 128
    out[:, 6] = c4(p0 + f2) + 128
    f = (f1 + 1) >> 1
    out[:, 8] = np.where(hev, v[:, 8], c4(q1 - f) + 128)
    out[:, 5] = np.where(hev, v[:, 5], c4(p1 + f) + 128)
    return out


def _wide(v, log2size, chroma):
    n = 6 if log2size == 4 else (2 if chroma else 3)
    n2 = 0 if (log2size == 3 and not chroma) else 1
    out = v.copy()
    for i in range(-n, n):
        t = np.zeros(v.shape[0], np.int64)
        for j in range(-n, n + 1):
            p = min(max(i + j, -(n + 1)), n)
            t += v[:, 7 + p] * (2 if abs(j) <= n2 else 1)
        out[:, 7 + i] = (t + (1 << (log2size - 1))) >> log2size
    return out


def _filter_lines(v, size, chroma, limit, blimit, thresh):
    """Deblock lines of 14 samples (p6..p0, q0..q6) with per-line limits."""
    a = np.abs
    p = [v[:, 6 - k] for k in range(7)]
    q = [v[:, 7 + k] for k in range(7)]
    hev = (a(p[1] - p[0]) > thresh) | (a(q[1] - q[0]) > thresh)
    flen = 4 if size == 4 else (6 if chroma else (8 if size == 8 else 16))
    mask = (a(p[1] - p[0]) > limit) | (a(q[1] - q[0]) > limit)
    mask |= a(p[0] - q[0]) * 2 + a(p[1] - q[1]) // 2 > blimit
    if flen >= 6:
        mask |= (a(p[2] - p[1]) > limit) | (a(q[2] - q[1]) > limit)
    if flen >= 8:
        mask |= (a(p[3] - p[2]) > limit) | (a(q[3] - q[2]) > limit)
    do = ~mask
    out = v.copy()
    if size == 4:
        flat = np.zeros(len(v), np.bool_)
    else:
        m = (a(p[1] - p[0]) > 1) | (a(q[1] - q[0]) > 1) | (a(p[2] - p[0]) > 1) | (a(q[2] - q[0]) > 1)
        if flen >= 8:
            m |= (a(p[3] - p[0]) > 1) | (a(q[3] - q[0]) > 1)
        flat = ~m
    if size >= 16:
        m = np.zeros(len(v), np.bool_)
        for k in (4, 5, 6):
            m |= (a(p[k] - p[0]) > 1) | (a(q[k] - q[0]) > 1)
        flat2 = ~m
    else:
        flat2 = np.zeros(len(v), np.bool_)
    narrow = do & ~flat
    if narrow.any():
        out[narrow] = _narrow(v[narrow], hev[narrow])
    wide8 = do & flat & ~flat2
    if wide8.any():
        out[wide8] = _wide(v[wide8], 3, chroma)
    wide16 = do & flat & flat2
    if wide16.any():
        out[wide16] = _wide(v[wide16], 4, chroma)
    return out


def _deblock_pass(fs, plane, pas):
    h = fs.hdr
    sx = fs.ss_x if plane else 0
    sy = fs.ss_y if plane else 0
    rows4, cols4 = h.mi_rows >> sy, h.mi_cols >> sx
    ur, uc = np.meshgrid(np.arange(rows4), np.arange(cols4), indexing="ij")
    ur, uc = ur.ravel(), uc.ravel()
    lx, ly = (uc << sx) * 4, (ur << sy) * 4  # luma position of the unit
    on = (lx < h.width) & (ly < h.height) & ((lx > 0) if pas == 0 else (ly > 0))
    ur, uc = ur[on], uc[on]
    mr, mc = (ur << sy) | sy, (uc << sx) | sx
    tx = fs.lf_tx[plane][ur, uc].astype(np.int64)
    size = fs.mi_size[mr, mc].astype(np.int64)
    if pas == 0:
        pur, puc = ur, uc - 1
        dim_tx, dim_blk = _TX_W, _BLOCK_W
        coord = uc * 4
    else:
        pur, puc = ur - 1, uc
        dim_tx, dim_blk = _TX_H, _BLOCK_H
        coord = ur * 4
    plane_blk = np.array([_plane_block(b, sx, sy) for b in range(22)])
    tx_edge = coord % dim_tx[tx] == 0
    pm_r, pm_c = (pur << sy) | sy, (puc << sx) | sx
    ptx = fs.lf_tx[plane][pur, puc].astype(np.int64)
    skip = fs.skip[mr, mc].astype(np.bool_)
    inter = fs.is_inter[mr, mc].astype(np.bool_)
    blk_edge = coord % dim_blk[plane_blk[size]] == 0
    apply = tx_edge & (blk_edge | ~skip | ~inter)
    base = np.minimum(dim_tx[ptx], dim_tx[tx])
    fsize = np.minimum(8 if plane else 16, base)
    lvl = _levels(fs, plane, pas, mr, mc)
    plvl = _levels(fs, plane, pas, pm_r, pm_c)
    lvl = np.where(lvl == 0, plvl, lvl)
    apply &= lvl > 0
    ur, uc, lvl, fsize = ur[apply], uc[apply], lvl[apply], fsize[apply]
    if not len(ur):
        return
    sharp = h.lf_sharpness
    shift = 2 if sharp > 4 else (1 if sharp > 0 else 0)
    if sharp > 0:
        limit = np.clip(lvl >> shift, 1, 9 - sharp)
    else:
        limit = np.maximum(1, lvl >> shift)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    cur = fs.planes[plane]
    k = np.arange(-7, 7)
    for size_v in (4, 8, 16):
        sel = fsize == size_v
        if not sel.any():
            continue
        y0, x0 = ur[sel] * 4, uc[sel] * 4
        i = np.arange(4)
        if pas == 0:
            yy = (y0[:, None] + i[None, :]).ravel()
            xx = np.repeat(x0, 4)
            rr = np.repeat(yy[:, None], 14, 1)
            cc = xx[:, None] + k[None, :]
        else:
            xx = (x0[:, None] + i[None, :]).ravel()
            yy = np.repeat(y0, 4)
            rr = yy[:, None] + k[None, :]
            cc = np.repeat(xx[:, None], 14, 1)
        rr_c = np.clip(rr, 0, cur.shape[0] - 1)
        cc_c = np.clip(cc, 0, cur.shape[1] - 1)
        v = cur[rr_c, cc_c].astype(np.int64)
        rep = lambda a: np.repeat(a[sel], 4)  # noqa: E731
        out = _filter_lines(v, size_v, bool(plane), rep(limit), rep(blimit), rep(thresh))
        # the samples each filter length may modify: p1..q1, p2..q2, p5..q5
        lo, hi = (1, 13) if size_v == 16 and not plane else (
            (4, 10) if size_v >= 8 and not plane else (5, 9))
        cur[rr_c[:, lo:hi], cc_c[:, lo:hi]] = out[:, lo:hi]


def _plane_block(b, sx, sy):
    w = max(4, int(_BLOCK_W[b]) >> sx)
    hh = max(4, int(_BLOCK_H[b]) >> sy)
    for i in range(22):
        if _BLOCK_W[i] == w and _BLOCK_H[i] == hh:
            return i
    return b


def loop_filter(fs) -> None:
    """Deblock the frame in place: each plane's vertical edges, then its
    horizontal ones."""
    h = fs.hdr
    if not (h.lf_level[0] or h.lf_level[1]):
        return
    for plane in range(fs.num_planes):
        if plane and not h.lf_level[plane + 1]:
            continue
        for pas in (0, 1):
            _deblock_pass(fs, plane, pas)


# --- CDEF

# libaom's cdef_directions_padded: offsets dy * 144 + dx in its padded
# buffer for directions -2..9; (dy, dx) of directions 0..7, taps k = 0, 1
_CDEF_DIRS = tuple(tuple((int(round(v / 144)), int(v - 144 * round(v / 144))) for v in row)
                   for row in T.CDEF_DIRECTIONS_PADDED[2:10])
_UV_DIR = {(0, 0): tuple(range(8)), (1, 1): tuple(range(8)),
           (1, 0): (7, 0, 2, 4, 5, 6, 6, 6), (0, 1): (1, 2, 2, 2, 3, 4, 6, 0)}
_DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)
_PRI_TAPS = tuple(tuple(int(v) for v in r) for r in T.CDEF_PRI_TAPS)
_SEC_TAPS = tuple(int(v) for v in T.CDEF_SEC_TAPS)


def _directions(blocks):
    """Direction and variance of each (N, 8, 8) luma block (spec 7.15.2)."""
    x = blocks.astype(np.int64) - 128
    n = len(x)
    partial = np.zeros((8, n, 15), np.int64)
    i = np.arange(8)[:, None]
    j = np.arange(8)[None, :]
    idx = [i + j, i + j // 2, np.broadcast_to(i, (8, 8)), 3 + i - j // 2, 7 + i - j,
           3 - i // 2 + j, np.broadcast_to(j, (8, 8)), i // 2 + j]
    flat = x.reshape(n, 64)
    for d in range(8):
        ix = np.broadcast_to(idx[d], (8, 8)).ravel()
        for k in range(15):
            sel = ix == k
            if sel.any():
                partial[d, :, k] = flat[:, sel].sum(1)
    cost = np.zeros((8, n), np.int64)
    cost[2] = (partial[2, :, :8] ** 2).sum(1) * _DIV_TABLE[8]
    cost[6] = (partial[6, :, :8] ** 2).sum(1) * _DIV_TABLE[8]
    for k in range(7):
        cost[0] += (partial[0, :, k] ** 2 + partial[0, :, 14 - k] ** 2) * _DIV_TABLE[k + 1]
        cost[4] += (partial[4, :, k] ** 2 + partial[4, :, 14 - k] ** 2) * _DIV_TABLE[k + 1]
    cost[0] += partial[0, :, 7] ** 2 * _DIV_TABLE[8]
    cost[4] += partial[4, :, 7] ** 2 * _DIV_TABLE[8]
    for d in (1, 3, 5, 7):
        for k in range(5):
            cost[d] += partial[d, :, 3 + k] ** 2
        cost[d] *= _DIV_TABLE[8]
        for k in range(3):
            cost[d] += (partial[d, :, k] ** 2 + partial[d, :, 10 - k] ** 2) * _DIV_TABLE[2 * k + 2]
    best = np.zeros(n, np.int64)
    best_cost = np.zeros(n, np.int64)
    for d in range(8):
        better = cost[d] > best_cost
        best = np.where(better, d, best)
        best_cost = np.where(better, cost[d], best_cost)
    opp = cost[(best + 4) & 7, np.arange(n)]
    return best, (best_cost - opp) >> 10


def _floor_log2(a):
    out = np.zeros(a.shape, np.int64)
    pos = a > 0
    out[pos] = np.floor(np.log2(a[pos])).astype(np.int64)
    # guard float rounding at exact powers of two
    too_big = pos & ((1 << out) > a)
    out[too_big] -= 1
    return out


def _constrain(diff, threshold, damping):
    adj = np.maximum(0, damping - _floor_log2(threshold))
    mag = np.minimum(np.abs(diff), np.maximum(0, threshold - (np.abs(diff) >> adj)))
    return np.where(threshold == 0, 0, np.sign(diff) * mag)


def _cdef_plane(fs, plane, by, bx, pri, sec, dirs, damping, src):
    sx = fs.ss_x if plane else 0
    sy = fs.ss_y if plane else 0
    h = fs.hdr
    bw, bh = 8 >> sx, 8 >> sy
    H, W = (h.mi_rows * 4) >> sy, (h.mi_cols * 4) >> sx
    pad = 3
    big = np.full((H + 2 * pad, W + 2 * pad), -1, np.int64)
    big[pad:pad + H, pad:pad + W] = src[:H, :W]
    avail = np.zeros(big.shape, np.bool_)
    avail[pad:pad + H, pad:pad + W] = True
    y0 = (by * 8) >> sy
    x0 = (bx * 8) >> sx
    ii = np.arange(bh)[None, :, None]
    jj = np.arange(bw)[None, None, :]
    ys = y0[:, None, None] + ii + pad
    xs = x0[:, None, None] + jj + pad
    x = big[ys, xs]
    tot = np.zeros(x.shape, np.int64)
    mx = x.copy()
    mn = x.copy()
    pri_b = pri[:, None, None]
    sec_b = sec[:, None, None]
    damp = damping
    taps_sel = (pri & 1)  # 8-bit: (priStr >> 0) & 1
    dirs_arr = np.array(_CDEF_DIRS)  # [dir][k][(dy, dx)]
    for k in range(2):
        ptap = np.where(taps_sel == 0, _PRI_TAPS[0][k], _PRI_TAPS[1][k])[:, None, None]
        stap = _SEC_TAPS[k]
        for sign in (-1, 1):
            d = dirs_arr[dirs, k]
            py = ys + sign * d[:, 0][:, None, None]
            px = xs + sign * d[:, 1][:, None, None]
            p = big[py, px]
            ok = avail[py, px]
            tot += np.where(ok, ptap * _constrain(p - x, pri_b, damp), 0)
            mx = np.where(ok, np.maximum(mx, p), mx)
            mn = np.where(ok, np.minimum(mn, p), mn)
            for off in (-2, 2):
                d2 = dirs_arr[(dirs + off) & 7, k]
                qy = ys + sign * d2[:, 0][:, None, None]
                qx = xs + sign * d2[:, 1][:, None, None]
                s = big[qy, qx]
                ok2 = avail[qy, qx]
                tot += np.where(ok2, stap * _constrain(s - x, sec_b, damp), 0)
                mx = np.where(ok2, np.maximum(mx, s), mx)
                mn = np.where(ok2, np.minimum(mn, s), mn)
    out = np.clip(x + ((8 + tot - (tot < 0)) >> 4), mn, mx)
    return y0, x0, out


def cdef(fs) -> None:
    """CDEF over the deblocked frame in place (reading the pre-CDEF
    frame); keeps that frame as ``fs.pre_cdef`` for loop restoration."""
    h = fs.hdr
    fs.pre_cdef = [p.copy() for p in fs.planes]
    if not h.enable_cdef:
        return
    by, bx = np.meshgrid(np.arange(0, h.mi_rows, 2), np.arange(0, h.mi_cols, 2), indexing="ij")
    by, bx = by.ravel() // 2, bx.ravel() // 2  # 8x8 block coordinates
    mr, mc = by * 2, bx * 2
    idx = fs.cdef_idx[(mr // 16) * 16, (mc // 16) * 16].astype(np.int64)
    skip = (fs.skip[mr, mc] & fs.skip[mr + 1, mc] & fs.skip[mr, mc + 1]
            & fs.skip[mr + 1, mc + 1]).astype(np.bool_)
    keep = (idx != -1) & ~skip
    by, bx, idx = by[keep], bx[keep], idx[keep]
    if not len(by):
        return
    luma = fs.pre_cdef[0]
    blocks = luma[(by * 8)[:, None, None] + np.arange(8)[None, :, None],
                  (bx * 8)[:, None, None] + np.arange(8)[None, None, :]]
    ydir, var = _directions(blocks)
    ypri = np.array(h.cdef_y_pri, np.int64)[idx]
    ysec = np.array(h.cdef_y_sec, np.int64)[idx]
    uvpri = np.array(h.cdef_uv_pri, np.int64)[idx]
    uvsec = np.array(h.cdef_uv_sec, np.int64)[idx]
    dirs = np.where(ypri == 0, 0, ydir)
    vs = np.where(var >> 6 > 0, np.minimum(_floor_log2(np.maximum(var >> 6, 1)), 12), 0)
    pri = np.where(var > 0, (ypri * (4 + vs) + 8) >> 4, 0)
    y0, x0, out = _cdef_plane(fs, 0, by, bx, pri, ysec, dirs, h.cdef_damping, fs.pre_cdef[0])
    _scatter(fs.planes[0], y0, x0, out)
    if fs.num_planes > 1:
        uvmap = np.array(_UV_DIR[(fs.ss_x, fs.ss_y)])
        udirs = np.where(uvpri == 0, 0, uvmap[ydir])
        for p in (1, 2):
            y0, x0, out = _cdef_plane(fs, p, by, bx, uvpri, uvsec, udirs, h.cdef_damping - 1,
                                      fs.pre_cdef[p])
            _scatter(fs.planes[p], y0, x0, out)


def _scatter(plane, y0, x0, out):
    n, bh, bw = out.shape
    plane[y0[:, None, None] + np.arange(bh)[None, :, None],
          x0[:, None, None] + np.arange(bw)[None, None, :]] = out


# --- loop restoration


def _box_sum(a, r):
    """Sums of a over (2r+1)^2 windows: a is padded by r on each side."""
    c = np.zeros((a.shape[0] + 1, a.shape[1] + 1), np.int64)
    c[1:, 1:] = a.cumsum(0).cumsum(1)
    k = 2 * r + 1
    return c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]


def _source(fs, plane, y0, y1, x0, x1, stripe_start, stripe_end, pad):
    """get_source_sample over rows y0-pad..y1+pad, cols x0-pad..x1+pad."""
    h = fs.hdr
    sx = fs.ss_x if plane else 0
    sy = fs.ss_y if plane else 0
    end_x = ((h.width + sx) >> sx) - 1
    end_y = ((h.height + sy) >> sy) - 1
    ys = np.clip(np.arange(y0 - pad, y1 + pad), 0, end_y)
    xs = np.clip(np.arange(x0 - pad, x1 + pad), 0, end_x)
    above = ys < stripe_start
    below = ys > stripe_end
    ys_pre = np.where(above, np.maximum(stripe_start - 2, ys), np.minimum(stripe_end + 2, ys))
    cdefd = fs.planes_cdef[plane][ys[:, None], xs[None, :]].astype(np.int64)
    pre = fs.pre_cdef[plane][ys_pre[:, None], xs[None, :]].astype(np.int64)
    return np.where((above | below)[:, None], pre, cdefd)


def _wiener(src, coeffs, hh, ww):
    def taps(c):
        f = [c[0], c[1], c[2], 128 - 2 * (c[0] + c[1] + c[2]), c[2], c[1], c[0]]
        return [int(v) for v in f]
    vf, hf = taps(coeffs[0]), taps(coeffs[1])
    inter = np.zeros((hh + 6, ww), np.int64)
    for t in range(7):
        inter += hf[t] * src[:, t:t + ww]
    inter = np.clip((inter + 4) >> 3, -2048, 8191 - 2048)
    out = np.zeros((hh, ww), np.int64)
    for t in range(7):
        out += vf[t] * inter[t:t + hh]
    return np.clip((out + 1024) >> 11, 0, 255)


def _sgr_pass(src, hh, ww, r, s, ys_abs, pas):
    """The box filter of one pass (radius r, scale s) on src, which is
    padded by 3 on each side; returns F (hh, ww)."""
    # A and B at rows -1..hh, cols -1..ww
    win = src[3 - 1 - r:3 + hh + 1 + r, 3 - 1 - r:3 + ww + 1 + r]
    n = (2 * r + 1) ** 2
    a = _box_sum(win * win, r)
    b = _box_sum(win, r)
    p = np.maximum(0, a * n - b * b)
    z = (p * s + (1 << 19)) >> 20
    a2 = T.X_BY_XPLUS1.astype(np.int64)[np.minimum(z, 255)]
    one_over_n = int(T.ONE_BY_X[n - 1])
    b2 = (256 - a2) * b * one_over_n
    B = (b2 + (1 << 11)) >> 12
    A = a2
    c = src[3:3 + hh, 3:3 + ww]
    if pas == 0:
        odd = (ys_abs & 1).astype(np.bool_)[:, None]
        ae = 6 * (A[0:hh, 1:ww + 1] + A[2:hh + 2, 1:ww + 1]) + 5 * (
            A[0:hh, 0:ww] + A[0:hh, 2:ww + 2] + A[2:hh + 2, 0:ww] + A[2:hh + 2, 2:ww + 2])
        be = 6 * (B[0:hh, 1:ww + 1] + B[2:hh + 2, 1:ww + 1]) + 5 * (
            B[0:hh, 0:ww] + B[0:hh, 2:ww + 2] + B[2:hh + 2, 0:ww] + B[2:hh + 2, 2:ww + 2])
        ao = 6 * A[1:hh + 1, 1:ww + 1] + 5 * (A[1:hh + 1, 0:ww] + A[1:hh + 1, 2:ww + 2])
        bo = 6 * B[1:hh + 1, 1:ww + 1] + 5 * (B[1:hh + 1, 0:ww] + B[1:hh + 1, 2:ww + 2])
        ve = ae * c + be
        vo = ao * c + bo
        return np.where(odd, (vo + (1 << 7)) >> 8, (ve + (1 << 8)) >> 9)
    cross = (A[1:hh + 1, 1:ww + 1] + A[0:hh, 1:ww + 1] + A[2:hh + 2, 1:ww + 1]
             + A[1:hh + 1, 0:ww] + A[1:hh + 1, 2:ww + 2])
    diag = A[0:hh, 0:ww] + A[0:hh, 2:ww + 2] + A[2:hh + 2, 0:ww] + A[2:hh + 2, 2:ww + 2]
    crossb = (B[1:hh + 1, 1:ww + 1] + B[0:hh, 1:ww + 1] + B[2:hh + 2, 1:ww + 1]
              + B[1:hh + 1, 0:ww] + B[1:hh + 1, 2:ww + 2])
    diagb = B[0:hh, 0:ww] + B[0:hh, 2:ww + 2] + B[2:hh + 2, 0:ww] + B[2:hh + 2, 2:ww + 2]
    v = (4 * cross + 3 * diag) * c + 4 * crossb + 3 * diagb
    return (v + (1 << 8)) >> 9


def _sgr(src, hh, ww, st, xqd, ys_abs):
    r0, r1, s0, s1 = (int(v) for v in T.SGR_PARAMS[st])
    c = src[3:3 + hh, 3:3 + ww]
    u = c << 4
    w0, w1 = int(xqd[0]), int(xqd[1])
    w2 = 128 - w0 - w1
    v = w1 * u
    v = v + (w0 * _sgr_pass(src, hh, ww, r0, s0, ys_abs, 0) if r0 else w0 * u)
    v = v + (w2 * _sgr_pass(src, hh, ww, r1, s1, ys_abs, 1) if r1 else w2 * u)
    return np.clip((v + (1 << 10)) >> 11, 0, 255)


def loop_restoration(fs) -> None:
    """Loop restoration over the CDEF output in place."""
    h = fs.hdr
    if not h.uses_lr:
        return
    fs.planes_cdef = [p.copy() for p in fs.planes]
    for plane in range(fs.num_planes):
        if h.lr_type[plane] == RESTORE_NONE:
            continue
        sx = fs.ss_x if plane else 0
        sy = fs.ss_y if plane else 0
        end_x = ((h.width + sx) >> sx) - 1
        end_y = ((h.height + sy) >> sy) - 1
        unit = h.lr_size[plane]
        urows, ucols = fs.lr_units[plane]
        off = 8 >> sy
        sh = 64 >> sy
        stripe = 0
        while True:
            s0 = stripe * sh - off
            s1 = s0 + sh - 1
            if s0 > end_y:
                break
            y0, y1 = max(0, s0), min(end_y, s1) + 1
            ur = min(urows - 1, (y0 + off) // unit)
            for uc in range(ucols):
                rtype = int(fs.lr_type[plane][ur, uc])
                if rtype == RESTORE_NONE:
                    continue
                x0 = uc * unit
                x1 = end_x + 1 if uc == ucols - 1 else min(end_x + 1, (uc + 1) * unit)
                if x0 >= x1:
                    continue
                src = _source(fs, plane, y0, y1, x0, x1, s0, s1, 3)
                hh, ww = y1 - y0, x1 - x0
                if rtype == RESTORE_WIENER:
                    out = _wiener(src, fs.lr_wiener[plane][ur, uc], hh, ww)
                else:
                    out = _sgr(src, hh, ww, int(fs.lr_sgr_set[plane][ur, uc]),
                               fs.lr_sgr_xqd[plane][ur, uc], np.arange(y0, y1))
                fs.planes[plane][y0:y1, x0:x1] = out
            stripe += 1
    del fs.planes_cdef

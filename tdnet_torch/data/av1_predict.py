"""AV1 intra prediction at 8 bits (specification section 7.11.2), vectorised
in numpy over one transform block: the edge preparation with its
availability rules, DC, directional prediction (corner and edge filters,
edge upsampling, ``dr_intra_derivative``), smooth, smooth-V and smooth-H,
Paeth and the recursive filter-intra modes; chroma from luma (7.11.5),
palette prediction (7.11.4) and the intra block copy (7.11.3 with the
bilinear filter of ``use_intrabc``).
"""

from __future__ import annotations

import numpy as np

from tdnet_torch.data import av1_tables as T

__all__ = ["predict_intra", "predict_cfl", "predict_intrabc", "DC_PRED", "V_PRED", "H_PRED",
           "D45_PRED", "D135_PRED", "D113_PRED", "D157_PRED", "D203_PRED", "D67_PRED",
           "SMOOTH_PRED", "SMOOTH_V_PRED", "SMOOTH_H_PRED", "PAETH_PRED", "UV_CFL_PRED"]

(DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED,
 SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED) = range(14)
MODE_TO_ANGLE = [int(v) for v in T.MODE_TO_ANGLE]
DR_DERIVATIVE = [int(v) for v in T.DR_INTRA_DERIVATIVE]
_SMOOTH_OFFSET = {4: 0, 8: 4, 16: 12, 32: 28, 64: 60}
_SMOOTH = {n: T.SMOOTH_WEIGHTS[o:o + n].astype(np.int64) for n, o in _SMOOTH_OFFSET.items()}
_EDGE_KERNEL = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))
_FILTER_TAPS = T.FILTER_INTRA_TAPS.astype(np.int64)  # [mode][output k][tap 0-6]
_PAD = 16  # room before index -1 of an edge array


def is_directional(mode: int) -> bool:
    return V_PRED <= mode <= D67_PRED


def _edge_strength(w, h, filter_type, delta):
    d = abs(delta)
    blk = w + h
    s = 0
    if filter_type == 0:
        if blk <= 8:
            if d >= 56:
                s = 1
        elif blk <= 16:
            if d >= 40:
                s = 1
        elif blk <= 24:
            if d >= 8:
                s = 1
            if d >= 16:
                s = 2
            if d >= 32:
                s = 3
        elif blk <= 32:
            if d >= 1:
                s = 1
            if d >= 4:
                s = 2
            if d >= 32:
                s = 3
        else:
            if d >= 1:
                s = 3
    else:
        if blk <= 8:
            if d >= 40:
                s = 1
            if d >= 64:
                s = 2
        elif blk <= 16:
            if d >= 20:
                s = 1
            if d >= 48:
                s = 2
        elif blk <= 24:
            if d >= 4:
                s = 3
        else:
            if d >= 1:
                s = 3
    return s


def _use_upsample(w, h, filter_type, delta):
    d = abs(delta)
    blk = w + h
    if d <= 0 or d >= 40:
        return 0
    return int(blk <= 16) if filter_type == 0 else int(blk <= 8)


def _edge_filter(edge, sz, strength):
    """Filter edge[-1 .. sz - 2] (array index _PAD - 1 ...) in place."""
    if strength == 0:
        return
    src = edge[_PAD - 1:_PAD - 1 + sz].copy()
    k = _EDGE_KERNEL[strength - 1]
    idx = np.arange(1, sz)
    s = np.zeros(sz - 1, np.int64)
    for j in range(5):
        s += k[j] * src[np.clip(idx - 2 + j, 0, sz - 1)]
    edge[_PAD:_PAD + sz - 1] = (s + 8) >> 4


def _upsample(edge, num_px):
    """Upsample edge[-1 .. num_px - 1] to edge[-2 .. 2 * num_px - 2]."""
    buf = edge
    dup = np.empty(num_px + 3, np.int64)
    dup[0] = buf[_PAD - 1]
    dup[1:num_px + 2] = buf[_PAD - 1:_PAD + num_px]
    dup[num_px + 2] = buf[_PAD + num_px - 1]
    out = np.empty(2 * num_px + 1, np.int64)  # indices -2 .. 2 * num_px - 2
    out[0] = dup[0]
    i = np.arange(num_px)
    s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
    s = np.clip((s + 8) >> 4, 0, 255)
    out[1 + 2 * i] = s
    out[2 + 2 * i] = dup[i + 2]
    buf[_PAD - 2:_PAD - 2 + 2 * num_px + 1] = out


def predict_intra(cur: np.ndarray, x: int, y: int, have_left: bool, have_above: bool,
                  have_above_right: bool, have_below_left: bool, mode: int, log2w: int,
                  log2h: int, max_x: int, max_y: int, angle_delta: int = 0,
                  filter_intra_mode: int = -1, edge_filter: bool = True,
                  filter_type: int = 0) -> None:
    """Predict the w x h block at (x, y) of plane ``cur`` in place."""
    w, h = 1 << log2w, 1 << log2h
    n = w + h
    above = np.zeros(_PAD + 2 * n + 8, np.int64)
    left = np.zeros(_PAD + 2 * n + 8, np.int64)
    if not have_above and have_left:
        above[_PAD - 1:_PAD + n] = cur[y, x - 1]
    elif not have_above and not have_left:
        above[_PAD - 1:_PAD + n] = 127
    else:
        limit = min(max_x, x + (2 * w if have_above_right else w) - 1)
        row = cur[y - 1]
        cols = np.minimum(limit, x + np.arange(n))
        above[_PAD:_PAD + n] = row[cols]
    if not have_left and have_above:
        left[_PAD - 1:_PAD + n] = cur[y - 1, x]
    elif not have_left and not have_above:
        left[_PAD - 1:_PAD + n] = 129
    else:
        limit = min(max_y, y + (2 * h if have_below_left else h) - 1)
        rows = np.minimum(limit, y + np.arange(n))
        left[_PAD:_PAD + n] = cur[rows, x - 1]
    if have_above and have_left:
        corner = cur[y - 1, x - 1]
    elif have_above:
        corner = cur[y - 1, x]
    elif have_left:
        corner = cur[y, x - 1]
    else:
        corner = 128
    above[_PAD - 1] = corner
    left[_PAD - 1] = corner
    if filter_intra_mode >= 0:
        pred = _filter_intra(above, left, w, h, filter_intra_mode)
    elif is_directional(mode):
        pred = _directional(above, left, w, h, MODE_TO_ANGLE[mode] + angle_delta * 3,
                            have_above, have_left, edge_filter, filter_type,
                            max_x - x + 1, max_y - y + 1)
    elif mode == SMOOTH_PRED:
        wy = _SMOOTH[h][:, None]
        wx = _SMOOTH[w][None, :]
        a = above[_PAD:_PAD + w][None, :]
        lc = left[_PAD:_PAD + h][:, None]
        s = (wy * a + (256 - wy) * left[_PAD + h - 1] + wx * lc
             + (256 - wx) * above[_PAD + w - 1])
        pred = (s + 256) >> 9
    elif mode == SMOOTH_V_PRED:
        wy = _SMOOTH[h][:, None]
        s = wy * above[_PAD:_PAD + w][None, :] + (256 - wy) * left[_PAD + h - 1]
        pred = (s + 128) >> 8
    elif mode == SMOOTH_H_PRED:
        wx = _SMOOTH[w][None, :]
        s = wx * left[_PAD:_PAD + h][:, None] + (256 - wx) * above[_PAD + w - 1]
        pred = (s + 128) >> 8
    elif mode == DC_PRED:
        if have_above and have_left:
            s = int(above[_PAD:_PAD + w].sum() + left[_PAD:_PAD + h].sum())
            avg = (s + ((w + h) >> 1)) // (w + h)
        elif have_left:
            avg = (int(left[_PAD:_PAD + h].sum()) + (h >> 1)) >> log2h
        elif have_above:
            avg = (int(above[_PAD:_PAD + w].sum()) + (w >> 1)) >> log2w
        else:
            avg = 128
        pred = np.full((h, w), avg, np.int64)
    else:  # PAETH_PRED
        a = above[_PAD:_PAD + w][None, :]
        lc = left[_PAD:_PAD + h][:, None]
        base = a + lc - corner
        p_left = np.abs(base - lc)
        p_top = np.abs(base - a)
        p_tl = np.abs(base - corner)
        pred = np.where((p_left <= p_top) & (p_left <= p_tl), lc,
                        np.where(p_top <= p_tl, a, corner))
    cur[y:y + h, x:x + w] = pred


def _directional(above, left, w, h, angle, have_above, have_left, edge_filter, filter_type,
                 avail_w, avail_h):
    up_above = up_left = 0
    if edge_filter:
        if angle != 90 and angle != 180:
            if 90 < angle < 180 and (w + h) >= 24:
                v = (int(left[_PAD]) * 5 + int(above[_PAD - 1]) * 6 + int(above[_PAD]) * 5
                     + 8) >> 4
                above[_PAD - 1] = left[_PAD - 1] = v
            if have_above:
                strength = _edge_strength(w, h, filter_type, angle - 90)
                num = min(w, avail_w) + (h if angle < 90 else 0) + 1
                _edge_filter(above, num, strength)
            if have_left:
                strength = _edge_strength(w, h, filter_type, angle - 180)
                num = min(h, avail_h) + (w if angle > 180 else 0) + 1
                _edge_filter(left, num, strength)
        up_above = _use_upsample(w, h, filter_type, angle - 90)
        if up_above:
            _upsample(above, w + (h if angle < 90 else 0))
        up_left = _use_upsample(w, h, filter_type, angle - 180)
        if up_left:
            _upsample(left, h + (w if angle > 180 else 0))
    i = np.arange(h, dtype=np.int64)[:, None]
    j = np.arange(w, dtype=np.int64)[None, :]
    if angle == 90:
        return np.broadcast_to(above[_PAD:_PAD + w][None, :], (h, w))
    if angle == 180:
        return np.broadcast_to(left[_PAD:_PAD + h][:, None], (h, w))
    if angle < 90:
        dx = DR_DERIVATIVE[angle]
        idx = (i + 1) * dx
        base = (idx >> (6 - up_above)) + (j << up_above)
        shift = ((idx << up_above) >> 1) & 0x1F
        max_base = (w + h - 1) << up_above
        b = np.minimum(base, max_base)
        v = (above[_PAD + b] * (32 - shift) + above[_PAD + np.minimum(b + 1, max_base)] * shift
             + 16) >> 5
        return np.where(base < max_base, v, above[_PAD + max_base])
    if angle < 180:
        dx = DR_DERIVATIVE[180 - angle]
        dy = DR_DERIVATIVE[angle - 90]
        idx = (j << 6) - (i + 1) * dx
        base = idx >> (6 - up_above)
        shift = ((idx << up_above) >> 1) & 0x1F
        use_above = base >= -(1 << up_above)
        b = np.maximum(base, -2)
        va = (above[_PAD + b] * (32 - shift) + above[_PAD + b + 1] * shift + 16) >> 5
        idy = (i << 6) - (j + 1) * dy
        base_l = idy >> (6 - up_left)
        shift_l = ((idy << up_left) >> 1) & 0x1F
        bl = np.clip(base_l, -2, left.size - _PAD - 2)
        vl = (left[_PAD + bl] * (32 - shift_l) + left[_PAD + bl + 1] * shift_l + 16) >> 5
        return np.where(use_above, va, vl)
    dy = DR_DERIVATIVE[270 - angle]
    idx = (j + 1) * dy
    base = (idx >> (6 - up_left)) + (i << up_left)
    shift = ((idx << up_left) >> 1) & 0x1F
    max_base = (w + h - 1) << up_left
    b = np.minimum(base, max_base)
    v = (left[_PAD + b] * (32 - shift) + left[_PAD + np.minimum(b + 1, max_base)] * shift
         + 16) >> 5
    return np.where(base < max_base, v, left[_PAD + max_base])


def _filter_intra(above, left, w, h, mode):
    pred = np.zeros((h, w), np.int64)
    taps = _FILTER_TAPS[mode][:, :7]
    for i2 in range(h >> 1):
        r = i2 << 1
        for j4 in range(w >> 2):
            c = j4 << 2
            if i2 == 0:
                top = above[_PAD - 1 + c:_PAD + c + 4]
            elif j4 == 0:
                top = np.concatenate(([left[_PAD + r - 1]], pred[r - 1, c:c + 4]))
            else:
                top = pred[r - 1, c - 1:c + 4]
            if j4 == 0:
                side = left[_PAD + r:_PAD + r + 2]
            else:
                side = pred[r:r + 2, c - 1]
            p = np.concatenate((top, side))
            out = taps @ p
            out = np.where(out < 0, -((-out + 8) >> 4), (out + 8) >> 4)
            pred[r:r + 2, c:c + 4] = np.clip(out, 0, 255).reshape(2, 4)
    return pred


def predict_cfl(cur_c: np.ndarray, luma: np.ndarray, x: int, y: int, w: int, h: int,
                ss_x: int, ss_y: int, max_luma_w: int, max_luma_h: int, alpha: int) -> None:
    """Chroma from luma on the DC prediction already in ``cur_c``."""
    cy = np.minimum(y + np.arange(h), (max_luma_h >> ss_y) - 1)
    cx = np.minimum(x + np.arange(w), (max_luma_w >> ss_x) - 1)
    ly = (cy << ss_y)[:, None]
    lx = (cx << ss_x)[None, :]
    lum = luma[ly, lx].astype(np.int64)
    if ss_x:
        lum = lum + luma[ly, lx + 1]
    if ss_y:
        lum = lum + luma[ly + 1, lx]
        if ss_x:
            lum = lum + luma[ly + 1, lx + 1]
    lum = lum << (3 - ss_x - ss_y)
    n = (w * h).bit_length() - 1
    avg = (int(lum.sum()) + (1 << (n - 1))) >> n
    d = alpha * (lum - avg)
    scaled = np.where(d < 0, -((-d + 32) >> 6), (d + 32) >> 6)
    dc = cur_c[y:y + h, x:x + w].astype(np.int64)
    cur_c[y:y + h, x:x + w] = np.clip(dc + scaled, 0, 255)


def predict_intrabc(cur: np.ndarray, x: int, y: int, w: int, h: int, mv_row: int,
                    mv_col: int, ss_x: int, ss_y: int, last_x: int, last_y: int) -> None:
    """The intra block copy of a w x h plane block at (x, y): the vector in
    1/8 luma pixels, positions in 1/16 of the plane, the bilinear filter
    (two taps in 1/16 steps) on each axis with the 2-D rounding of
    8-bit prediction (round 3, then 11)."""
    pos_x = (x << 4) + ((2 * mv_col) >> ss_x)
    pos_y = (y << 4) + ((2 * mv_row) >> ss_y)
    fx, fy = pos_x & 15, pos_y & 15
    x0, y0 = pos_x >> 4, pos_y >> 4
    rows = np.clip(y0 + np.arange(h + 1), 0, last_y)
    cols = np.clip(x0 + np.arange(w + 1), 0, last_x)
    src = cur[rows[:, None], cols[None, :]].astype(np.int64)
    inter = ((128 - fx * 8) * src[:, :w] + fx * 8 * src[:, 1:w + 1] + 4) >> 3
    pred = ((128 - fy * 8) * inter[:h] + fy * 8 * inter[1:h + 1] + 1024) >> 11
    cur[y:y + h, x:x + w] = np.clip(pred, 0, 255)

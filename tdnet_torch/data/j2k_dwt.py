"""JPEG 2000 reconstruction after tier 1 (ISO/IEC 15444-1 Annex E, F and
G), as OpenJPEG 2.5 does it (``t1.c``'s hand-over, ``dwt.c``, ``mct.c``,
``tcd.c``), in numpy:

- dequantisation: a reversible code-block's values are halved with C's
  truncation toward zero (``tmp / 2``: tier 1 keeps one bit below the
  last decoded bit-plane); an irreversible one's are multiplied in float32
  by half the step size ``(1 + mant / 2048) * 2^(prec - expn)`` (OpenJPEG
  drops the sub-band gain, ``BUG_WEIRD_TWO_INVK``);
- the inverse 5/3 in integers and the inverse 9/7 in float32, rows first
  then columns at each level, by lifting with symmetric extension. The
  9/7 scales the low samples by K and the high ones by OpenJPEG's
  ``two_invK`` (1.625732422), then lifts with delta, gamma, beta and alpha,
  each step ``x + (left + right) * c`` rounded to float32 three times (no
  fused multiply-add); one-sample signals are left as they are, except a
  lone high 5/3 sample, halved;
- the inverse RCT in integers and the inverse ICT in float32
  (``r = y + v * 1.402``, ``g = y - u * 0.34413 - v * 0.71414``,
  ``b = y + u * 1.772``);
- the DC level shift and clamp of ``opj_tcd_dc_level_shift_decode``:
  irreversible samples rounded by ``lrintf`` (half to even) first.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["dequantize", "inverse_transform", "inverse_mct", "dc_shift"]

_F = np.float32
_K, _TWO_INV_K = _F(1.230174105), _F(1.625732422)
_ALPHA, _BETA, _GAMMA, _DELTA = _F(-1.586134342), _F(-0.052980118), _F(0.882911075), \
    _F(0.443506852)


def dequantize(coeffs: np.ndarray, reversible: bool, step: Tuple[int, int],
               prec: int) -> np.ndarray:
    """A band's tier-1 values -> int32 (reversible) or float32."""
    if reversible:
        return (np.sign(coeffs) * (np.abs(coeffs) >> 1)).astype(np.int32)
    expn, mant = step
    stepsize = _F((1.0 + mant / 2048.0) * 2.0 ** (prec - expn))
    return coeffs.astype(_F) * (_F(0.5) * stepsize)


def _mirror(y: np.ndarray) -> np.ndarray:
    """Pad the last axis by one sample each side, symmetrically."""
    return np.concatenate([y[..., 1:2], y, y[..., -2:-1]], axis=-1)


def _lift53(y: np.ndarray, cas: int) -> np.ndarray:
    n = y.shape[-1]
    if n == 1:
        if cas:
            return (np.sign(y) * (np.abs(y) >> 1)).astype(y.dtype)
        return y
    y = y.copy()
    lo, hi = slice(cas, None, 2), slice(1 - cas, None, 2)
    p = _mirror(y)
    y[..., lo] -= (p[..., cas:n:2] + p[..., cas + 2:n + 2:2] + 2) >> 2
    p = _mirror(y)
    y[..., hi] += (p[..., 1 - cas:n:2] + p[..., 3 - cas:n + 2:2]) >> 1
    return y


def _lift97(y: np.ndarray, cas: int) -> np.ndarray:
    n = y.shape[-1]
    if n == 1:
        return y
    y = y.copy()
    lo, hi = slice(cas, None, 2), slice(1 - cas, None, 2)
    y[..., lo] *= _K
    y[..., hi] *= _TWO_INV_K
    for target, c in ((cas, -_DELTA), (1 - cas, -_GAMMA), (cas, -_BETA), (1 - cas, -_ALPHA)):
        p = _mirror(y)
        t = p[..., target:n:2] + p[..., target + 2:n + 2:2]
        t *= c
        y[..., target::2] += t
    return y


def _interleave(low: np.ndarray, high: np.ndarray, cas: int, axis: int) -> np.ndarray:
    low, high = np.moveaxis(low, axis, -1), np.moveaxis(high, axis, -1)
    n = low.shape[-1] + high.shape[-1]
    out = np.empty(low.shape[:-1] + (n,), low.dtype)
    out[..., cas::2] = low
    out[..., 1 - cas::2] = high
    return out


def inverse_transform(bands: Sequence[Tuple[object, List[np.ndarray]]],
                      reversible: bool) -> np.ndarray:
    """The tile-component's samples from its bands: ``bands[r]`` is
    (resolution r with its x0/y0, [LL] at r = 0 or [HL, LH, HH])."""
    lift = _lift53 if reversible else _lift97
    ll = bands[0][1][0]
    for res, (hl, lh, hh) in bands[1:]:
        cas_h, cas_v = res.x0 & 1, res.y0 & 1
        rows_lo = ll.shape[0]
        top = lift(_interleave(ll, hl, cas_h, 1), cas_h) if ll.size or hl.size else \
            np.zeros((rows_lo, ll.shape[1] + hl.shape[1]), ll.dtype)
        bottom = lift(_interleave(lh, hh, cas_h, 1), cas_h) if lh.size or hh.size else \
            np.zeros((lh.shape[0], lh.shape[1] + hh.shape[1]), ll.dtype)
        cols = _interleave(top, bottom, cas_v, 0)  # (width, height)
        ll = np.ascontiguousarray(lift(cols, cas_v).T) if cols.size else cols.T
    return ll


def inverse_mct(planes: List[np.ndarray], reversible: bool) -> List[np.ndarray]:
    """RCT (reversible) or ICT over the first three components."""
    y, u, v = planes
    if reversible:
        g = y - ((u + v) >> 2)
        return [v + g, g, u + g]
    r = y + v * _F(1.402)
    g = (y - u * _F(0.34413)) - v * _F(0.71414)
    b = y + u * _F(1.772)
    return [r, g, b]


def dc_shift(plane: np.ndarray, prec: int, sgnd: bool, reversible: bool) -> np.ndarray:
    """DC level shift and clamp to the component's range -> int32."""
    lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
    dc = 0 if sgnd else 1 << (prec - 1)
    if reversible:
        v = plane.astype(np.int64) + dc
    else:
        f = plane.astype(_F)
        big, small = f > _F(2147483647.0), f < _F(-2147483648.0)
        v = np.rint(np.where(big | small, 0, f)).astype(np.int64) + dc
        v = np.where(big, hi, np.where(small, lo, v))
    return np.clip(v, lo, hi).astype(np.int32)

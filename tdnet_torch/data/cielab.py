"""CIE L*a*b* -> RGB in numpy, by the two conversions the reference's
decoders run on a CIE L*a*b* TIFF (photometric 8), each equal byte for
byte to its original on every 8-bit input (the whole 256**3 cube was held
against both):

- :func:`lcms_rgb` is PIL's ``convert("RGB")`` of a ``LAB`` image: a
  LittleCMS 2 transform from the built-in Lab D50 (v2) profile to the
  built-in sRGB profile, ``TYPE_Lab_8`` to 8-bit RGB, perceptual intent.
  LittleCMS samples the pipeline (Lab -> XYZ against D50, the inverse of
  sRGB's Bradford-adapted colorant matrix, sRGB's inverse tone curve) into
  a 33x33x33 16-bit CLUT and evaluates it by tetrahedral interpolation in
  fixed point; each step here is its code's (``cmsopt.c``, ``cmsintrp.c``,
  ``cmslut.c``, ``cmsgamma.c``, ``cmspcs.c``, ``cmsmtrx.c``), floats and
  doubles where it has them. LittleCMS's 8-bit a* and b* are offset by
  128; the caller says what bytes PIL hands it.
- :func:`libtiff_rgb` is libtiff 4.7's ``TIFFRGBAImage`` conversion that
  cv2 reads 8- and 16-bit pages through (``tif_color.c``:
  ``TIFFCIELab16ToXYZ`` against the ``WhitePoint`` tag, D50 by default,
  then ``TIFFXYZToRGB`` with the sRGB display and its 1500-step gamma
  table), in float32 as the C code computes it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lcms_rgb", "libtiff_rgb", "D50_WHITE_POINT"]

_F = np.float32

# ---- LittleCMS (PIL) ----

_MAGIC = 103079215104.0  # 1.5 * 2**36: _cmsQuickFloor's double trick (16.16 rounding)
_D50 = (0.9642, 1.0, 0.8249)
_MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0
_SRGB_CURVE = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)
_GRID = 33  # _cmsReasonableGridpointsByColorspace for 3 channels
_CLUT = None


def _quick_saturate_word(d: np.ndarray) -> np.ndarray:
    d = np.asarray(d, np.float64) + 0.5
    floor = np.floor((d + _MAGIC) - _MAGIC)
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor)).astype(np.int64)


def _inverse(a):
    """``_cmsMAT3inverse``: cofactors over the determinant, in doubles."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _per(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)]
            for i in range(3)]


def _eval(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def _srgb_to_xyz_d50():
    """``cmsCreate_sRGBProfile``'s colorants: Rec. 709 primaries scaled to
    the D65 white (``_cmsBuildRGB2XYZtransferMatrix``), then adapted to
    D50 by Bradford (``_cmsAdaptationMatrix``)."""
    wx, wy = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    primaries = [[xr, xg, xb], [yr, yg, yb], [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]
    coef = _eval(_inverse(primaries), [wx / wy, 1.0, (1 - wx - wy) / wy])
    rgb = [[coef[j] * primaries[i][j] for j in range(3)] for i in range(3)]
    bradford = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                [0.0389, -0.0685, 1.0296]]
    src = _eval(bradford, [wx / wy * 1.0, 1.0, (1 - wx - wy) / wy * 1.0])
    dst = _eval(bradford, list(_D50))
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0],
            [0.0, 0.0, dst[2] / src[2]]]
    adapt = _per(_inverse(bradford), _per(cone, bradford))
    return _per(adapt, rgb)


def _pipeline(w: np.ndarray) -> np.ndarray:
    """The transform's float pipeline on (N, 3) 16-bit Lab (v4 encoding)
    -> (N, 3) 16-bit RGB, as ``cmsPipelineEval16`` runs it."""
    x = w.astype(_F) / _F(65535.0)
    lab_l = x[:, 0].astype(np.float64) * 100.0
    lab_a = x[:, 1].astype(np.float64) * 255.0 - 128.0
    lab_b = x[:, 2].astype(np.float64) * 255.0 - 128.0
    fy = (lab_l + 16.0) / 116.0

    def f_1(t):
        return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)

    xyz = [(f_1(t) * white / _MAX_ENCODEABLE_XYZ).astype(_F)
           for t, white in ((fy + 0.002 * lab_a, _D50[0]), (fy, _D50[1]),
                            (fy - 0.005 * lab_b, _D50[2]))]
    inv = _inverse(_srgb_to_xyz_d50())
    g, a, b, d, e = _SRGB_CURVE
    disc = (a * e + b) ** g
    out = np.empty((len(w), 3), np.int64)
    for i in range(3):
        v = np.zeros(len(w))
        for j in range(3):
            v = v + xyz[j].astype(np.float64) * (inv[i][j] * _MAX_ENCODEABLE_XYZ)
        r = v.astype(_F).astype(np.float64)
        with np.errstate(invalid="ignore"):
            high = (np.power(np.where(r >= disc, r, 1.0), 1.0 / g) - b) / a
        curve = np.where(r >= disc, high, r / d).astype(_F)
        out[:, i] = _quick_saturate_word(curve.astype(np.float64) * 65535.0)
    return out


def _clut() -> np.ndarray:
    global _CLUT
    if _CLUT is None:
        nodes = _quick_saturate_word(np.arange(_GRID) * 65535.0 / (_GRID - 1))
        grid = np.stack(np.meshgrid(nodes, nodes, nodes, indexing="ij"), -1).reshape(-1, 3)
        _CLUT = _pipeline(grid).reshape(_GRID, _GRID, _GRID, 3)
    return _CLUT


def _tetrahedral(table: np.ndarray, w: np.ndarray) -> np.ndarray:
    """``TetrahedralInterp16`` on (N, 3) 16-bit inputs."""
    def fixed(v):
        v = v * (_GRID - 1)
        return v + (v + 0x7FFF) // 0xFFFF

    f = [fixed(w[:, k]) for k in range(3)]
    i0 = [v >> 16 for v in f]
    rx, ry, rz = (v & 0xFFFF for v in f)
    x1, y1, z1 = (np.where(w[:, k] == 0xFFFF, 0, 1) for k in range(3))

    def at(dx, dy, dz):
        return table[i0[0] + dx, i0[1] + dy, i0[2] + dz]

    c0 = at(0, 0, 0)
    c100, c010, c001 = at(x1, 0, 0), at(0, y1, 0), at(0, 0, z1)
    c110, c101, c011, c111 = at(x1, y1, 0), at(x1, 0, z1), at(0, y1, z1), at(x1, y1, z1)
    xy, yz, xz, zx = rx >= ry, ry >= rz, rx >= rz, rz >= rx
    cases = (
        (xy & yz, c100 - c0, c110 - c100, c111 - c110),
        (xy & ~yz & zx, c101 - c001, c111 - c101, c001 - c0),
        (xy & ~yz & ~zx, c100 - c0, c111 - c101, c101 - c100),
        (~xy & xz, c110 - c010, c010 - c0, c111 - c110),
        (~xy & ~xz & yz, c111 - c011, c010 - c0, c011 - c010),
        (~xy & ~xz & ~yz, c111 - c011, c011 - c001, c001 - c0),
    )
    out = np.zeros_like(c0)
    for mask, d1, d2, d3 in cases:
        rest = d1 * rx[:, None] + d2 * ry[:, None] + d3 * rz[:, None] + 0x8001
        out = np.where(mask[:, None], c0 + ((rest + (rest >> 16)) >> 16), out)
    return out


def lcms_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 L*, a*, b* in LittleCMS's 8-bit encoding (a* and b*
    offset by 128) -> uint8 RGB, as PIL's ``convert("RGB")`` of a ``LAB``
    image holding those bytes gives it."""
    shape = lab.shape
    flat = lab.reshape(-1, 3).astype(np.int64)
    table = _clut()
    out = np.empty(flat.shape, np.uint8)
    for s in range(0, len(flat), 1 << 16):
        rgb16 = _tetrahedral(table, flat[s:s + (1 << 16)] * 257)
        out[s:s + (1 << 16)] = (rgb16 * 65281 + 8388608) >> 24  # FROM_16_TO_8
    return out.reshape(shape)


# ---- libtiff (cv2) ----

_D50_X0, _D50_Y0, _D50_Z0 = _F(96.4250), _F(100.0), _F(82.4680)
D50_WHITE_POINT = (_D50_X0 / (_D50_X0 + _D50_Y0 + _D50_Z0),
                   _D50_Y0 / (_D50_X0 + _D50_Y0 + _D50_Z0))  # libtiff's default WhitePoint
_RANGE = 1500
_SRGB_DISPLAY = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                          [0.0556, -0.2040, 1.0570]], _F)
_GAMMA_TABLE = None


def _gamma_table() -> np.ndarray:
    global _GAMMA_TABLE
    if _GAMMA_TABLE is None:
        gamma = 1.0 / float(_F(2.4))
        ramp = np.power(np.arange(_RANGE + 1) / _RANGE, gamma).astype(_F)
        _GAMMA_TABLE = (_F(255) * ramp).astype(_F)
    return _GAMMA_TABLE


def libtiff_rgb(lab: np.ndarray, bits: int, white_point=D50_WHITE_POINT) -> np.ndarray:
    """(..., 3) L*, a*, b* samples as a TIFF stores them (8 or 16 bits,
    a* and b* signed) -> uint8 RGB, as libtiff's RGBA interface gives
    it."""
    wx, wy = _F(white_point[0]), _F(white_point[1])
    if wy == 0:
        raise ValueError("CIE L*a*b* TIFF: invalid WhitePoint")
    y0 = _F(100.0)
    x0 = wx / wy * y0
    z0 = (_F(1.0) - wx - wy) / wy * y0
    v = lab.astype(np.int64)
    top = 1 << bits
    l16 = v[..., 0] * 257 if bits == 8 else v[..., 0]
    a = np.where(v[..., 1] >= top // 2, v[..., 1] - top, v[..., 1])
    b = np.where(v[..., 2] >= top // 2, v[..., 2] - top, v[..., 2])
    if bits == 8:
        a, b = a * 256, b * 256
    L = l16.astype(_F) * _F(100.0) / _F(65535.0)
    low = L < _F(8.856)
    y_low = (L * y0) / _F(903.292)
    cby = np.where(low, _F(7.787) * (y_low / y0) + _F(16.0) / _F(116.0),
                   (L + _F(16.0)) / _F(116.0)).astype(_F)
    Y = np.where(low, y_low, y0 * cby * cby * cby).astype(_F)

    def f_1(t, white):
        return np.where(t < _F(0.2069), white * (t - _F(0.13793)) / _F(7.787),
                        white * t * t * t).astype(_F)

    X = f_1(a.astype(_F) / _F(256.0) / _F(500.0) + cby, x0)
    Z = f_1(cby - b.astype(_F) / _F(256.0) / _F(200.0), z0)
    step = (_F(100.0) - _F(1.0)) / _F(_RANGE)
    table = _gamma_table()
    out = np.empty(lab.shape[:-1] + (3,), np.uint8)
    for k in range(3):
        m = _SRGB_DISPLAY[k]
        lum = np.minimum(np.maximum(m[0] * X + m[1] * Y + m[2] * Z, _F(1.0)), _F(100.0))
        i = np.minimum(((lum - _F(1.0)) / step).astype(np.int64), _RANGE)
        out[..., k] = np.minimum((table[i].astype(np.float64) + 0.5).astype(np.int64), 255)
    return out

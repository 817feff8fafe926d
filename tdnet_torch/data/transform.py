"""Affine augmentation on the host, the counterpart of
``tdnet/data/transform.py``, without cv2 (the GPU machine has none).

Transforms are 3x3 homogeneous matrices composed as rotation @ translation
@ shear @ scaling @ flip, the translation relative to the image size and
the whole transform moved to the image centre (``random_transform``,
``adjust_transform_for_image``). Boxes map through ``transform_aabb`` (the
four corners transformed, then their enclosing box). The matrix code is the
reference's, so a seeded ``RandomState`` gives the same matrices and boxes
bit for bit.

``apply_transform`` is the reference's ``cv2.warpAffine`` in numpy: every
output pixel samples the source through the inverse matrix (inverted as
cv2 inverts it) with cv2's kernels and the four fill modes. cv2 5.0 warps
float images by two routes, and the port follows each:

- ``nearest``, ``linear`` and ``cubic`` (A = -0.75, 4x4 taps) sample at the
  exact source coordinate, which the port computes in float64 and cv2 in
  float32. Nearest rounds the coordinate half up, as cv2 does, and picks
  cv2's pixel except where the coordinate lies within ~1e-6 of a half
  pixel; linear and cubic agree with cv2 within ~5e-3 and ~7e-3 on 0-255
  float images. Quantising linear's coordinate to cv2's 1/32 pixel takes it 5.0
  away from cv2 5.0, so this route is not quantised.
- ``lanczos4`` (8x8 taps, normalised to sum 1) goes through cv2's older
  remap: the source coordinate in 10-bit fixed point, rounded to 1/32 of a
  pixel (``INTER_BITS`` 5), and the coefficients from a table of the 32
  fractions. The port does the same and agrees within ~2e-4.
- ``area`` is ``linear``: ``warpAffine`` takes ``INTER_AREA`` as linear
  (``tests/test_torch_transform.py`` holds them equal).

Each kernel's taps outside the image read the fill mode's pixel; the
constant fill takes ``cval`` for the first channel and 0 for the others, as
cv2 does with a scalar border value. Integer images are warped in float32
and rounded (cv2 interpolates them in fixed point: at most 1 apart).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_PRNG = np.random.RandomState()

__all__ = [
    "DEFAULT_PRNG",
    "rotation",
    "translation",
    "shear",
    "scaling",
    "random_flip",
    "change_transform_origin",
    "random_transform",
    "random_transform_generator",
    "adjust_transform_for_image",
    "transform_aabb",
    "TransformParameters",
    "apply_transform",
]


def rotation(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def translation(t) -> np.ndarray:
    return np.array([[1, 0, t[0]], [0, 1, t[1]], [0, 0, 1]], dtype=np.float64)


def shear(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, -s, 0], [0, c, 0], [0, 0, 1]], dtype=np.float64)


def scaling(f) -> np.ndarray:
    return np.array([[f[0], 0, 0], [0, f[1], 0], [0, 0, 1]], dtype=np.float64)


def _uniform_vector(lo, hi, prng) -> np.ndarray:
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    return prng.uniform(lo, hi)


def random_flip(flip_x_chance: float, flip_y_chance: float, prng=DEFAULT_PRNG) -> np.ndarray:
    fx = prng.uniform(0, 1) < flip_x_chance
    fy = prng.uniform(0, 1) < flip_y_chance
    return scaling((-1 if fx else 1, -1 if fy else 1))


def change_transform_origin(transform: np.ndarray, center) -> np.ndarray:
    center = np.asarray(center, np.float64)
    return np.linalg.multi_dot([translation(center), transform, translation(-center)])


def random_transform(
    min_rotation: float = 0,
    max_rotation: float = 0,
    min_translation=(0, 0),
    max_translation=(0, 0),
    min_shear: float = 0,
    max_shear: float = 0,
    min_scaling=(1, 1),
    max_scaling=(1, 1),
    flip_x_chance: float = 0,
    flip_y_chance: float = 0,
    prng=DEFAULT_PRNG,
) -> np.ndarray:
    return np.linalg.multi_dot([
        rotation(prng.uniform(min_rotation, max_rotation)),
        translation(_uniform_vector(min_translation, max_translation, prng)),
        shear(prng.uniform(min_shear, max_shear)),
        scaling(_uniform_vector(min_scaling, max_scaling, prng)),
        random_flip(flip_x_chance, flip_y_chance, prng),
    ])


def random_transform_generator(prng=None, **kwargs):
    """An endless stream of random transforms."""
    if prng is None:
        prng = np.random.RandomState()
    while True:
        yield random_transform(prng=prng, **kwargs)


def adjust_transform_for_image(transform: np.ndarray, image: np.ndarray,
                               relative_translation: bool = True) -> np.ndarray:
    """Scale a relative translation by the image size and move the
    transform's origin to the image centre."""
    height, width = image.shape[:2]
    result = transform.copy()
    if relative_translation:
        result[0:2, 2] *= [width, height]
    return change_transform_origin(result, (0.5 * width, 0.5 * height))


def transform_aabb(transform: np.ndarray, aabb) -> np.ndarray:
    """Transform an axis-aligned box -> the box enclosing its corners."""
    x1, y1, x2, y2 = aabb
    points = transform.dot(np.array(
        [[x1, x2, x1, x2], [y1, y2, y2, y1], [1, 1, 1, 1]], dtype=np.float64))
    min_corner = points.min(axis=1)
    max_corner = points.max(axis=1)
    return np.array([min_corner[0], min_corner[1], max_corner[0], max_corner[1]])


@dataclass
class TransformParameters:
    """The warp's parameters (the reference's names)."""

    fill_mode: str = "nearest"
    interpolation: str = "linear"
    cval: float = 0.0
    relative_translation: bool = True


_FILL_MODES = ("constant", "nearest", "reflect", "wrap")
# cv2's warpAffine takes INTER_AREA as linear
_INTERPOLATIONS = ("nearest", "linear", "area", "cubic", "lanczos4")


def _invert_affine(matrix: np.ndarray) -> np.ndarray:
    """The 2x3 inverse of an affine matrix, in cv2's arithmetic
    (``invertAffineTransform``)."""
    m = np.asarray(matrix, np.float64)[:2]
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def _border(i: np.ndarray, n: int, mode: str):
    """Source indices under a fill mode -> (indices in range, mask of the
    indices that take the constant fill, or None)."""
    if mode == "constant":
        return np.clip(i, 0, n - 1), (i < 0) | (i >= n)
    if mode == "nearest":
        return np.clip(i, 0, n - 1), None
    if mode == "wrap":
        return np.mod(i, n), None
    if n == 1:  # reflect (cv2's BORDER_REFLECT_101)
        return np.zeros_like(i), None
    j = np.mod(i, 2 * (n - 1))
    return np.where(j >= n, 2 * (n - 1) - j, j), None


# cv2's INTER_BITS (1/32 pixel) and the fixed point of warpAffine's
# coordinates (AB_BITS 10), for the route that quantises (lanczos4)
_INTER_BITS = 5
_AB_BITS = 10


def _cubic_coeffs(t: np.ndarray) -> np.ndarray:
    """cv2's ``interpolateCubic`` (A = -0.75) at fractions t -> (..., 4),
    in t's dtype."""
    a = t.dtype.type(-0.75)
    one = t.dtype.type(1)
    c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + 1
    c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    return np.stack([c0, c1, c2, one - c0 - c1 - c2], -1)


def _linear_coeffs(t: np.ndarray) -> np.ndarray:
    return np.stack([1 - t, t], -1)


def _lanczos4_table() -> np.ndarray:
    """cv2's ``interpolateLanczos4`` at the 32 fractions k/32 -> (32, 8)
    float32: sin(pi d / 4) sin(pi d) / (pi d / 4)^2 in float64 from the
    phase identities cv2 uses, 1e30 at d == 0, normalised to sum 1 in
    float32."""
    s45 = 0.70710678118654752440084436210485
    cs = ((1, 0), (-s45, -s45), (0, 1), (s45, -s45),
          (-1, 0), (s45, s45), (0, -1), (-s45, s45))
    x = np.arange(1 << _INTER_BITS, dtype=np.float32) / np.float32(1 << _INTER_BITS)
    y0 = -(x.astype(np.float64) + 3) * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    table = np.empty((x.size, 8), np.float32)
    for i, (a, b) in enumerate(cs):
        d = (x + np.float32(3 - i)).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            c = (a * s0 + b * c0) / (d * np.pi * 0.25) ** 2
        table[:, i] = np.where(np.abs(d) >= 1e-6, c, 1e30)
    total = np.zeros(x.size, np.float32)
    for i in range(8):
        total += table[:, i]
    return table * (np.float32(1) / total)[:, None]


def _fixed_point_coords(inv: np.ndarray, h: int, w: int):
    """cv2 ``warpAffine``'s source coordinates in 1/32 pixel: each term in
    10-bit fixed point (``saturate_cast<int>``, ties to even), shifted down
    with rounding -> (integer pixel, fraction index) for x and y."""
    scale = float(1 << _AB_BITS)
    half = 1 << (_AB_BITS - _INTER_BITS - 1)
    xs, ys = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    out = []
    for row in inv:
        per_x = np.rint(row[0] * xs * scale).astype(np.int64)
        per_y = np.rint((row[1] * ys + row[2]) * scale).astype(np.int64) + half
        q = (per_y[:, None] + per_x[None, :]) >> (_AB_BITS - _INTER_BITS)
        out.append((q >> _INTER_BITS, q & ((1 << _INTER_BITS) - 1)))
    return out


def apply_transform(matrix: np.ndarray, image: np.ndarray,
                    params: TransformParameters) -> np.ndarray:
    """Warp an (H, W) or (H, W, C) image by an affine matrix; the output
    has the input's size and dtype (integer outputs are rounded and
    saturated)."""
    if params.fill_mode not in _FILL_MODES:
        raise KeyError(params.fill_mode)
    if params.interpolation not in _INTERPOLATIONS:
        raise KeyError(params.interpolation)
    h, w = image.shape[:2]
    src = image.reshape(h * w, -1)
    work = np.float64 if image.dtype == np.float64 else np.float32
    fill = np.zeros(src.shape[1], np.float64)
    fill[0] = params.cval  # cv2's Scalar(cval): the first channel only
    inv = _invert_affine(matrix)

    def sample(iy, ix):
        iy, out_y = _border(iy, h, params.fill_mode)
        ix, out_x = _border(ix, w, params.fill_mode)
        v = src[(iy * w + ix).ravel()].astype(work)
        if out_y is not None:
            v[(out_y | out_x).ravel()] = fill.astype(work)
        return v

    if params.interpolation == "lanczos4":
        (x0, fx), (y0, fy) = _fixed_point_coords(inv, h, w)
        table = _lanczos4_table().astype(work)
        cx, cy = table[fx.ravel()], table[fy.ravel()]
    else:
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
        sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
        if params.interpolation == "nearest":
            out = sample(np.floor(sy + 0.5).astype(np.int64),
                         np.floor(sx + 0.5).astype(np.int64))
            return _cast(out, image)
        x0, y0 = np.floor(sx), np.floor(sy)
        coeffs = _cubic_coeffs if params.interpolation == "cubic" else _linear_coeffs
        cx = coeffs((sx - x0).astype(work).ravel())
        cy = coeffs((sy - y0).astype(work).ravel())
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    # separable: each row of taps weighted by x, then the rows by y
    taps = cx.shape[-1]
    x0, y0 = x0 - (taps // 2 - 1), y0 - (taps // 2 - 1)
    out = None
    for i in range(taps):
        row = None
        for j in range(taps):
            term = cx[:, j:j + 1] * sample(y0 + i, x0 + j)
            row = term if row is None else row + term
        out = cy[:, i:i + 1] * row if out is None else out + cy[:, i:i + 1] * row
    return _cast(out, image)


def _cast(out: np.ndarray, image: np.ndarray) -> np.ndarray:
    """Sampled (H*W, C) -> the image's shape and dtype, integers rounded
    and saturated."""
    if np.issubdtype(image.dtype, np.integer):
        info = np.iinfo(image.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(image.dtype).reshape(image.shape)

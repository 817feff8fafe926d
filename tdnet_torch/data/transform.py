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
cv2 inverts it), with linear or nearest interpolation and the four fill
modes, at source coordinates computed in float64. Nearest rounds the
coordinate half up, as cv2 does, and picks cv2's pixel except where the
coordinate lies within ~1e-6 of a half pixel (cv2's float32 coordinate
lands on the half); linear agrees with cv2 within ~5e-3 on 0-255 float
images (``tests/test_torch_transform.py``). The constant fill takes ``cval`` for
the first channel and 0 for the others, as cv2 does with a scalar border
value. ``cubic``, ``area`` and ``lanczos4`` raise (ROADMAP A11.1).
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


def apply_transform(matrix: np.ndarray, image: np.ndarray,
                    params: TransformParameters) -> np.ndarray:
    """Warp an (H, W) or (H, W, C) image by an affine matrix; the output
    has the input's size and dtype (integer outputs are rounded and
    saturated)."""
    if params.fill_mode not in _FILL_MODES:
        raise KeyError(params.fill_mode)
    if params.interpolation not in ("linear", "nearest"):
        raise NotImplementedError(
            f"interpolation {params.interpolation!r} is not ported yet (ROADMAP "
            "A11.1); the port warps with 'linear' or 'nearest'")
    h, w = image.shape[:2]
    src = image.reshape(h * w, -1)
    work = np.float64 if image.dtype == np.float64 else np.float32
    fill = np.zeros(src.shape[1], np.float64)
    fill[0] = params.cval  # cv2's Scalar(cval): the first channel only
    inv = _invert_affine(matrix)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]

    def sample(iy, ix):
        iy, out_y = _border(iy, h, params.fill_mode)
        ix, out_x = _border(ix, w, params.fill_mode)
        v = src[(iy * w + ix).ravel()].astype(work)
        if out_y is not None:
            v[(out_y | out_x).ravel()] = fill.astype(work)
        return v

    if params.interpolation == "nearest":
        out = sample(np.floor(sy + 0.5).astype(np.int64), np.floor(sx + 0.5).astype(np.int64))
    else:
        x0, y0 = np.floor(sx), np.floor(sy)
        fx = (sx - x0).astype(work).reshape(-1, 1)
        fy = (sy - y0).astype(work).reshape(-1, 1)
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
        top = (1 - fx) * sample(y0, x0) + fx * sample(y0, x0 + 1)
        bottom = (1 - fx) * sample(y0 + 1, x0) + fx * sample(y0 + 1, x0 + 1)
        out = (1 - fy) * top + fy * bottom
    if np.issubdtype(image.dtype, np.integer):
        info = np.iinfo(image.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(image.dtype).reshape(image.shape)

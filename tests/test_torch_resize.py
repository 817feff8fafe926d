"""The port's host resize (``tdnet_torch.data.image.resize_image``, numpy
only) against the reference's (``tdnet.data.image.resize_image``, cv2
INTER_LINEAR): byte for byte on uint8 pages (cv2's fixed-point route) and
bit for bit on float32 pages (cv2's IPP route). Pages come from numpy
seeds; both sides get the same array."""

import numpy as np
import pytest

from tdnet.data.image import resize_image as ref_resize
from tdnet_torch.data.image import resize_image

# (H, W) page shapes: 1/scale from 0.0375 to 3.1 under the 800/1333 rule
PAGE_SHAPES = [(850, 1400), (1100, 850), (1650, 1275), (3000, 500), (40, 30),
               (3508, 2480), (1024, 768), (777, 1333), (600, 450),
               (2200, 1700), (100, 3000)]
# non-binary scales: 1/scale 3.1, 2.2506, 0.96, 0.0375
FLOAT_SHAPES = [(3508, 2480), (3000, 500), (1024, 768), (40, 30)]


def _page(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, shape + (3,)).astype(dtype)


@pytest.mark.parametrize("shape", PAGE_SHAPES)
def test_resize_uint8_equals_cv2_bytes(shape):
    img = _page(shape, np.uint8, sum(shape))
    want, want_scale = ref_resize(img)
    got, scale = resize_image(img)
    assert scale == want_scale
    assert got.dtype == np.uint8 and want.dtype == np.uint8
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", FLOAT_SHAPES)
@pytest.mark.parametrize("data", ["integral", "uniform"])
def test_resize_float32_equals_cv2(shape, data):
    """Integral values (decoded pages) and arbitrary floats (normalized
    pages, as the host-normalize route resizes them)."""
    rng = np.random.RandomState(sum(shape))
    if data == "integral":
        img = rng.randint(0, 256, shape + (3,)).astype(np.float32)
    else:
        img = rng.uniform(-124.0, 152.0, shape + (3,)).astype(np.float32)
    want, want_scale = ref_resize(img)
    got, scale = resize_image(img)
    assert scale == want_scale
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_resize_small_sides_and_identity():
    """Sizes of the test canvases (64x96 buckets), and scale 1.0 returns
    the very input, whatever its dtype."""
    for shape, sides in [((70, 100), (64, 96)), ((30, 40), (64, 96)),
                         ((200, 130), (64, 96))]:
        for dtype in (np.uint8, np.float32):
            img = _page(shape, dtype, 7)
            want, _ = ref_resize(img, *sides)
            got, _ = resize_image(img, *sides)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    for dtype in (np.uint8, np.float32):
        img = _page((800, 1200), dtype, 3)
        got, scale = resize_image(img)
        assert scale == 1.0 and got is img


def test_resize_uint8_callers_clip_is_identity():
    """The callers' ``np.clip(x, 0, 255).astype(np.uint8)`` keeps a uint8
    resize as it is."""
    img = _page((850, 1400), np.uint8, 11)
    got, _ = resize_image(img)
    assert np.array_equal(np.clip(got, 0, 255).astype(np.uint8), got)

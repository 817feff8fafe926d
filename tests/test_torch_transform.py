"""The port's affine augmentation (``tdnet_torch/data/transform.py``) and
the loader's ``random_transform`` against the reference's
(``tdnet/data/transform.py``, whose warp is ``cv2.warpAffine``): matrices
and boxes exactly equal from the same seeded ``RandomState``, the warp
within WARP_ATOL for every fill mode, and the loader's batches."""

import numpy as np
import pytest

from tdnet_torch.data import transform as port
from tdnet_torch.data.generator import BatchLoader, LoaderConfig

# The largest difference from cv2 5.0's warpAffine (linear) on 0-255
# float32 uniform noise at 120x160, over these tests' matrices and the four
# fill modes: 5.0e-3 (cv2 rounds its source coordinates in float32; the
# port computes them in float64). Nearest picks another pixel only where
# the source coordinate lies within TIE_PX of a half pixel, which cv2's
# float32 coordinate rounds onto the half.
WARP_ATOL = 1e-2
TIE_PX = 1e-4
# cubic: 6.6e-3 (the same float32 coordinates). lanczos4 goes through cv2's
# remap at 1/32 pixel, which the port copies: 1.8e-4 (float32 sums in
# another order).
LANCZOS4_ATOL = 1e-3

# the loader's --random-transform ranges (tdnet/data/generator.py)
RANGES = dict(min_rotation=-0.1, max_rotation=0.1, min_translation=(-0.1, -0.1),
              max_translation=(0.1, 0.1), min_shear=-0.1, max_shear=0.1,
              min_scaling=(0.9, 0.9), max_scaling=(1.1, 1.1), flip_x_chance=0.5)
SIDES = dict(min_side=64, max_side=96)


def _matrices(n, seed, **ranges):
    from tdnet.data import transform as ref

    got = port.random_transform_generator(prng=np.random.RandomState(seed), **ranges)
    want = ref.random_transform_generator(prng=np.random.RandomState(seed), **ranges)
    return [(next(got), next(want)) for _ in range(n)]


@pytest.mark.parametrize("ranges", [RANGES, dict(RANGES, flip_y_chance=0.5, min_rotation=-3,
                                                 max_rotation=3)],
                         ids=["loader", "wide"])
def test_matrices_and_boxes_equal_reference(ranges):
    from tdnet.data import transform as ref

    rng = np.random.RandomState(2)
    image = np.zeros((90, 130, 3), np.float32)
    for got, want in _matrices(50, 7, **ranges):
        np.testing.assert_array_equal(got, want)
        for relative in (True, False):
            t = port.adjust_transform_for_image(got, image, relative)
            t_ref = ref.adjust_transform_for_image(want, image, relative)
            np.testing.assert_array_equal(t, t_ref)
        xy = rng.uniform(0, 100, 2)
        box = np.concatenate([xy, xy + rng.uniform(1, 40, 2)])
        np.testing.assert_array_equal(port.transform_aabb(t, box), ref.transform_aabb(t_ref, box))


@pytest.mark.parametrize("interpolation", ["linear", "nearest", "cubic", "lanczos4"])
@pytest.mark.parametrize("fill_mode", ["constant", "nearest", "reflect", "wrap"])
def test_warp_equals_cv2(fill_mode, interpolation):
    """Float32 noise in 0-255 (RGB and gray), three matrices a seed: linear
    and cubic within WARP_ATOL of cv2, lanczos4 within LANCZOS4_ATOL;
    nearest equal but at half-pixel ties. The constant fill takes cval for
    the first channel only, as cv2 does."""
    from tdnet.data import transform as ref

    rng = np.random.RandomState(3)
    images = [rng.uniform(0, 255, (120, 160, 3)).astype(np.float32),
              rng.uniform(0, 255, (120, 160)).astype(np.float32)]
    worst, ties = 0.0, 0
    for seed in range(2):
        for got_t, _ in _matrices(3, 11 + seed, **RANGES):
            for image in images:
                t = port.adjust_transform_for_image(got_t, image)
                got = port.apply_transform(t, image, port.TransformParameters(
                    fill_mode=fill_mode, interpolation=interpolation, cval=7.0))
                want = ref.apply_transform(t, image, ref.TransformParameters(
                    fill_mode=fill_mode, interpolation=interpolation, cval=7.0))
                assert got.dtype == want.dtype and got.shape == want.shape
                if interpolation != "nearest":
                    worst = max(worst, float(np.abs(got - want).max()))
                    continue
                differ = (got != want).reshape(120, 160, -1).any(-1)
                inv = port._invert_affine(t)
                ys, xs = np.mgrid[0:120, 0:160]
                near_half = np.zeros_like(differ)
                for row in inv:
                    frac = (row[0] * xs + row[1] * ys + row[2]) % 1.0
                    near_half |= np.abs(frac - 0.5) < TIE_PX
                assert not (differ & ~near_half).any()
                ties += int(differ.sum())
    assert worst <= (LANCZOS4_ATOL if interpolation == "lanczos4" else WARP_ATOL), worst
    assert ties <= 8, ties


@pytest.mark.parametrize("fill_mode", ["constant", "nearest", "reflect", "wrap"])
def test_area_is_linear(fill_mode):
    """cv2's warpAffine takes INTER_AREA as INTER_LINEAR: equal there, and
    equal in the port, on float and uint8 pages."""
    from tdnet.data import transform as ref

    rng = np.random.RandomState(6)
    for image in (rng.uniform(0, 255, (60, 80, 3)).astype(np.float32),
                  rng.randint(0, 256, (60, 80)).astype(np.uint8)):
        for got_t, _ in _matrices(2, 13, **RANGES):
            t = port.adjust_transform_for_image(got_t, image)
            kw = dict(fill_mode=fill_mode, cval=5.0)
            np.testing.assert_array_equal(
                port.apply_transform(t, image, port.TransformParameters(interpolation="area", **kw)),
                port.apply_transform(t, image, port.TransformParameters(interpolation="linear", **kw)))
            np.testing.assert_array_equal(
                ref.apply_transform(t, image, ref.TransformParameters(interpolation="area", **kw)),
                ref.apply_transform(t, image, ref.TransformParameters(interpolation="linear", **kw)))


def test_warp_of_integer_images_and_unported_modes():
    """uint8 images round and saturate (cv2 interpolates them in fixed
    point: at most 1 apart on a few pixels) with every interpolation; a
    name cv2 has no flag for raises KeyError, as the reference's lookup
    does (every mode of the reference is ported now)."""
    from tdnet.data import transform as ref

    image = np.random.RandomState(4).randint(0, 256, (60, 80, 3)).astype(np.uint8)
    t = port.adjust_transform_for_image(_matrices(1, 5, **RANGES)[0][0], image)
    for interpolation in ("linear", "nearest", "area", "cubic", "lanczos4"):
        got = port.apply_transform(t, image, port.TransformParameters(interpolation=interpolation))
        want = ref.apply_transform(t, image, ref.TransformParameters(interpolation=interpolation))
        assert got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= (255 if interpolation == "nearest" else 1), interpolation
        assert (diff > 0).mean() < 0.01, interpolation
    for mod in (port, ref):
        with pytest.raises(KeyError):
            mod.apply_transform(t, image, mod.TransformParameters(interpolation="bicubic"))


class FloatPages:
    """Float32 BGR pages (as ``read_image_bgr`` returns them) sized so the
    resize scale is 1.0, with boxes that the warp moves and clips."""

    def __init__(self, n, seed=0):
        rng = np.random.RandomState(seed)
        shapes = [(64, 96), (96, 64), (64, 80)]
        self.pages, self.boxes = [], []
        for i in range(n):
            h, w = shapes[i % len(shapes)]
            self.pages.append(rng.uniform(0, 255, (h, w, 3)).astype(np.float32))
            k = rng.randint(1, 4)
            xy = rng.uniform(0, min(h, w) / 2, (k, 2))
            self.boxes.append(np.concatenate([xy, xy + rng.uniform(4, 30, (k, 2))], 1))

    def size(self):
        return len(self.pages)

    def load_image(self, i):
        return self.pages[i].copy()

    def load_annotations(self, i):
        return {"bboxes": self.boxes[i].copy(), "labels": np.arange(len(self.boxes[i])) % 2}

    def image_aspect_ratio(self, i):
        h, w = self.pages[i].shape[:2]
        return w / h

    def num_classes(self):
        return 2


@pytest.mark.parametrize("device_normalize", [False, True])
def test_loader_random_transform_equals_reference(device_normalize):
    """Two epochs of 5 pages at batch 2: the same indices, boxes, labels,
    masks, sizes and scales exactly; images within WARP_ATOL on the host
    normalize route. On the uint8 route the warped float page is rounded,
    so a difference near .5 can flip a byte: at most 1 apart, on under 1%
    of the bytes."""
    from tdnet.data.generator import BatchLoader as RefLoader
    from tdnet.data.generator import LoaderConfig as RefConfig

    ds = FloatPages(5)
    kw = dict(batch_size=2, seed=3, random_transform=True,
              device_normalize=device_normalize, **SIDES)
    ref = RefLoader(ds, RefConfig(process_index=0, process_count=1, **kw))
    loader = BatchLoader(ds, LoaderConfig(**kw))
    want = [b for _ in range(2) for b in ref.epoch()]
    got = [b for _ in range(2) for b in loader.epoch()]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            if k != "images":
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        if device_normalize:
            diff = np.abs(g["images"].astype(int) - w["images"])
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01
        else:
            np.testing.assert_allclose(g["images"], w["images"], rtol=0, atol=WARP_ATOL)
    assert any(not np.array_equal(g["gt_boxes"], u["gt_boxes"]) for g, u in zip(
        got, BatchLoader(ds, LoaderConfig(**dict(kw, random_transform=False))).epoch()))


def test_skip_epochs_replays_the_transform_stream():
    """skip_epochs(2) then epoch() is the unbroken loader's third epoch,
    pixels included; worker threads draw the same transforms."""
    ds = FloatPages(5, seed=1)
    kw = dict(batch_size=2, seed=4, random_transform=True, **SIDES)
    unbroken = BatchLoader(ds, LoaderConfig(**kw))
    want = [list(unbroken.epoch()) for _ in range(3)][2]
    resumed = BatchLoader(ds, LoaderConfig(**kw))
    resumed.skip_epochs(2)
    threaded = BatchLoader(ds, LoaderConfig(workers=3, **kw))
    threaded.skip_epochs(2)
    try:
        for loader in (resumed, threaded):
            got = list(loader.epoch())
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    finally:
        threaded.close()

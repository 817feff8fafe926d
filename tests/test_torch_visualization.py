"""The port's drawing (``tdnet_torch/utils/visualization.py``, numpy only)
against the reference's (``tdnet/utils/visualization.py``, cv2): boxes at
thickness 1 and 2 (``cv2.rectangle`` with ``LINE_AA``), captions
(``cv2.putText``), and ``draw_detections`` / ``draw_annotations``, pixel
for pixel, over hypothesis cases of backgrounds, colours, box sides from 0
to 300 px, boxes clipped at every border and captions of printable ASCII
at every border. A control: the band the port drew before (a hard fill
without cv2's anti-aliased edges and round corners) differs from cv2."""

import string

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tdnet.utils import visualization as ref
from tdnet_torch.utils import visualization as port

SETTINGS = settings(max_examples=150, deadline=None, derandomize=True, database=None)
PRINTABLE = string.printable[:95]  # digits, letters, punctuation, space


def _background(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


colors = st.tuples(*[st.integers(0, 255)] * 3)


@st.composite
def boxed_images(draw):
    """An image and an integer box with sides 0 to 300 px, placed anywhere
    from wholly inside to past any border (degenerate and reversed
    corners too)."""
    h, w = draw(st.integers(1, 320)), draw(st.integers(1, 320))
    bw, bh = draw(st.integers(0, 300)), draw(st.integers(0, 300))
    x1 = draw(st.integers(-bw - 5, w + 5))
    y1 = draw(st.integers(-bh - 5, h + 5))
    box = [x1, y1, x1 + bw, y1 + bh]
    if draw(st.booleans()):  # reversed corners: x2 < x1 or y2 < y1
        box = [box[2], box[1], box[0], box[3]] if draw(st.booleans()) else \
            [box[0], box[3], box[2], box[1]]
    return _background(draw(st.integers(0, 2**32 - 1)), h, w), box


@pytest.mark.parametrize("thickness", [1, 2])
@SETTINGS
@given(case=boxed_images(), color=colors, frac=st.floats(0, 0.999))
def test_draw_box_equals_cv2(thickness, case, color, frac):
    image, box = case
    box = [v + frac for v in box]  # the drawers cast to int
    want, got = image.copy(), image.copy()
    ref.draw_box(want, box, color, thickness=thickness)
    port.draw_box(got, box, color, thickness=thickness)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thickness", [1, 2, 3, 4])
def test_draw_box_at_every_border(thickness):
    """A 40x30 box walked across each border of a 64x48 image, one pixel at
    a time, in a colour per step."""
    h, w = 48, 64
    image = _background(7, h, w)
    rng = np.random.default_rng(thickness)
    for x in range(-45, w + 5, 1):
        for y in (-35, -2, 0, 9, h - 31, h - 1, h + 2):
            color = tuple(int(c) for c in rng.integers(0, 256, 3))
            want, got = image.copy(), image.copy()
            ref.draw_box(want, (x, y, x + 40, y + 30), color, thickness=thickness)
            port.draw_box(got, (x, y, x + 40, y + 30), color, thickness=thickness)
            np.testing.assert_array_equal(got, want)


@SETTINGS
@given(seed=st.integers(0, 2**32 - 1), h=st.integers(1, 60), w=st.integers(1, 60),
       ends=st.lists(st.integers(-20 << 16, 80 << 16), min_size=4, max_size=4), color=colors)
def test_anti_aliased_line_equals_cv2_at_every_slope(seed, h, w, ends, color):
    """The primitive under draw_box, cv2's LineAA, between 16-bit
    fixed-point ends (cv2.line with shift 16): every slope, sub-pixel ends
    and clipping, beyond the axis-aligned and diagonal lines boxes draw."""
    import cv2

    image = _background(seed, h, w)
    want, got = image.copy(), image.copy()
    cv2.line(want, tuple(ends[:2]), tuple(ends[2:]), color, 1, cv2.LINE_AA, 16)
    port._line_aa(got, *ends, np.array(color))
    np.testing.assert_array_equal(got, want)


@st.composite
def captioned_images(draw):
    h, w = draw(st.integers(1, 80)), draw(st.integers(1, 160))
    text = draw(st.text(alphabet=PRINTABLE, min_size=0, max_size=14))
    x = draw(st.integers(-10 * len(text) - 20, w + 5))
    y = draw(st.integers(-10, h + 30))  # the caption sits 10 px above y
    return _background(draw(st.integers(0, 2**32 - 1)), h, w), (x, y, x + 5, y + 5), text


@SETTINGS
@given(case=captioned_images())
def test_draw_caption_equals_cv2(case):
    image, box, text = case
    want, got = image.copy(), image.copy()
    ref.draw_caption(want, box, text)
    port.draw_caption(got, box, text)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thickness", [1, 2])
def test_put_text_every_glyph_at_every_border(thickness):
    """Each printable character alone, its origin walked over a 20x24
    image's borders (glyphs left of the pen, descenders, origins right of
    the image), in white and in a colour."""
    import cv2

    h, w = 20, 24
    image = _background(11, h, w)
    for ch in PRINTABLE:
        for x in range(-14, w + 3, 2):
            for y in (-1, 3, 12, h - 2, h + 3, h + 14):
                for color in ((255, 255, 255), (30, 200, 90)):
                    want, got = image.copy(), image.copy()
                    cv2.putText(want, ch, (x, y), cv2.FONT_HERSHEY_PLAIN, 1, color, thickness)
                    port.put_text(got, ch, (x, y), color, thickness)
                    np.testing.assert_array_equal(got, want, err_msg=f"{ch!r} at {(x, y)}")


def test_put_text_outside_the_glyph_table_raises():
    image = np.zeros((20, 40, 3), np.uint8)
    with pytest.raises(ValueError, match="printable ASCII"):
        port.put_text(image, "tablé", (0, 15), (0, 0, 0))
    with pytest.raises(ValueError, match="thickness"):
        port.put_text(image, "x", (0, 15), (0, 0, 0), 3)


def _detections(seed, n, h, w):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, [w, h], (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 200, (n, 2))], axis=1)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[: n // 4] = scores[n // 4]  # tied scores
    labels = rng.integers(0, 25, n)  # past the 20-colour table too
    return boxes, scores, labels


NAMES = {0: "table", 1: "figure", 2: "Table_2", 3: "x"}


@pytest.mark.parametrize("color,names,threshold", [
    (None, None, 0.5), ((0, 0, 255), NAMES, 0.3), (None, NAMES, 0.0)])
@pytest.mark.filterwarnings("ignore:label .* has no defined color")
def test_draw_detections_equals_reference(color, names, threshold):
    h, w = 240, 320
    boxes, scores, labels = _detections(3, 40, h, w)
    name = (lambda label: names.get(label, str(label))) if names else None
    want, got = _background(1, h, w), _background(1, h, w)
    ref.draw_detections(want, boxes, scores, labels, color=color, label_to_name=name,
                        score_threshold=threshold)
    port.draw_detections(got, boxes, scores, labels, color=color, label_to_name=name,
                         score_threshold=threshold)
    np.testing.assert_array_equal(got, want)
    assert (got != _background(1, h, w)).any()


@pytest.mark.parametrize("color,names", [((0, 255, 0), None), (None, NAMES)])
@pytest.mark.filterwarnings("ignore:label .* has no defined color")
def test_draw_annotations_equals_reference(color, names):
    """Caption first, then the box, as the reference orders them."""
    h, w = 200, 260
    boxes, _, labels = _detections(5, 25, h, w)
    ann = {"bboxes": boxes, "labels": labels}
    name = (lambda label: names.get(label, str(label))) if names else None
    want, got = _background(2, h, w), _background(2, h, w)
    ref.draw_annotations(want, ann, color=color, label_to_name=name)
    port.draw_annotations(got, ann, color=color, label_to_name=name)
    np.testing.assert_array_equal(got, want)


def _band_box(image, box, color, thickness=2):
    """The port's draw_box before the repair: the pixels within
    thickness // 2 of the box's edge lines set to the colour."""
    x1, y1, x2, y2 = (int(v) for v in np.asarray(box).astype(int))
    h, w = image.shape[:2]
    r = max(thickness, 1) // 2
    for ya, yb, xa, xb in ((y1 - r, y1 + r, x1 - r, x2 + r), (y2 - r, y2 + r, x1 - r, x2 + r),
                           (y1 - r, y2 + r, x1 - r, x1 + r), (y1 - r, y2 + r, x2 - r, x2 + r)):
        ya, yb, xa, xb = max(ya, 0), min(yb, h - 1), max(xa, 0), min(xb, w - 1)
        if ya <= yb and xa <= xb:
            image[ya:yb + 1, xa:xb + 1] = color


@pytest.mark.parametrize("box", [(10, 10, 50, 40), (0, 0, 63, 47), (5.7, 3.2, 30.9, 20.1),
                                 (-5, 10, 30, 60)])
def test_control_band_drawing_differs_from_cv2(box):
    """The control that must fail: the pre-repair band is not cv2's
    rectangle (134 to 276 pixels off, by up to 86 to 141 levels, at the
    boxes the fault was logged with), while the repaired drawer is."""
    image = _background(0, 48, 64)
    want, band, got = image.copy(), image.copy(), image.copy()
    ref.draw_box(want, box, (0, 255, 0))
    _band_box(band, box, (0, 255, 0))
    port.draw_box(got, box, (0, 255, 0))
    differ = (band != want).any(axis=2)
    assert differ.sum() > 100
    assert np.abs(band.astype(int) - want).max() > 80
    np.testing.assert_array_equal(got, want)

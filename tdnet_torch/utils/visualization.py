"""Drawing detections on BGR uint8 images in numpy, the counterpart of
``tdnet/utils/visualization.py`` (which draws with cv2).

:func:`draw_box` draws the rectangle ``cv2.rectangle`` draws with an
integer box and a thickness t: the band of pixels within t // 2 of the
box's edge lines, clipped to the image (cv2's anti-aliased corners are
not reproduced). Captions (``cv2.putText``) are left out: the port has no
font renderer (ROADMAP A14)."""

from __future__ import annotations

import numpy as np

from tdnet_torch.utils.colors import label_color

__all__ = ["draw_box", "draw_detections"]


def draw_box(image: np.ndarray, box, color, thickness: int = 2) -> None:
    """Draw the outline of an (x1, y1, x2, y2) box in place."""
    x1, y1, x2, y2 = (int(v) for v in np.asarray(box).astype(int))
    h, w = image.shape[:2]
    r = max(thickness, 1) // 2

    def fill(ya, yb, xa, xb):
        ya, yb = max(ya, 0), min(yb, h - 1)
        xa, xb = max(xa, 0), min(xb, w - 1)
        if ya <= yb and xa <= xb:
            image[ya:yb + 1, xa:xb + 1] = color

    fill(y1 - r, y1 + r, x1 - r, x2 + r)  # top
    fill(y2 - r, y2 + r, x1 - r, x2 + r)  # bottom
    fill(y1 - r, y2 + r, x1 - r, x1 + r)  # left
    fill(y1 - r, y2 + r, x2 - r, x2 + r)  # right


def draw_detections(image: np.ndarray, boxes, scores, labels,
                    score_threshold: float = 0.5) -> None:
    """Draw the boxes of detections scoring above score_threshold (the
    reference's default 0.5 for predict), each in its label's colour."""
    for i in np.where(np.asarray(scores) > score_threshold)[0]:
        draw_box(image, boxes[i, :], color=label_color(int(labels[i])))

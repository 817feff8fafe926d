"""Deterministic per-class colours, the counterpart of
``tdnet/utils/colors.py``."""

from __future__ import annotations

import warnings

_COLORS = [
    (31, 0, 255), (0, 159, 255), (255, 95, 0), (255, 19, 0), (255, 0, 0),
    (255, 38, 0), (0, 255, 25), (255, 0, 133), (255, 172, 0), (108, 0, 255),
    (0, 82, 255), (0, 255, 6), (255, 0, 152), (223, 0, 255), (12, 0, 255),
    (0, 255, 178), (108, 255, 0), (184, 0, 255), (255, 0, 76), (146, 255, 0),
]


def label_color(label: int):
    """BGR colour tuple for a class label."""
    if 0 <= label < len(_COLORS):
        return _COLORS[label]
    warnings.warn(f"label {label} has no defined color; returning default")
    return (0, 255, 0)

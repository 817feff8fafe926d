"""Drawing boxes and captions on BGR uint8 images in numpy, the
counterpart of ``tdnet/utils/visualization.py`` (which draws with cv2),
equal to it pixel for pixel.

Boxes. ``cv2.rectangle(img, p1, p2, color, t, cv2.LINE_AA)`` draws a
closed polyline of four sides. A side of thickness 1 is one anti-aliased
line; a thicker side is a filled quadrilateral whose edges are
anti-aliased lines, plus a filled round cap (a diamond for t < 5) at the
side's end. Every anti-aliased line blends the colour into each pixel it
passes, twice, with an alpha from cv2's filter tables, and pixels where
primitives meet are blended once per primitive. So :func:`draw_box`
replays cv2's primitives in cv2's order and integer arithmetic (OpenCV's
``drawing.cpp``: ``LineAA``, ``FillConvexPoly``, ``ThickLine``,
``EllipseEx``, in 16-bit fixed point).

Captions. cv2 5 renders ``putText``'s Hershey fonts with an embedded
TrueType font: each glyph is an anti-aliased alpha mask drawn at an
integer pen position, composited glyph by glyph as
``(c * a + v * (255 - a) + 127) // 255``, and nothing is drawn when the
text's origin lies right of the image. ``hershey_glyphs.npz`` holds the
masks, offsets and advances of the printable ASCII glyphs of
``FONT_HERSHEY_PLAIN`` at scale 1 and thickness 1 and 2, made from cv2 by
``tools/make_hershey_glyphs.py``; other characters raise."""

from __future__ import annotations

import math
import os

import numpy as np

from tdnet_torch.utils.colors import label_color

__all__ = ["draw_box", "draw_caption", "draw_detections", "draw_annotations",
           "put_text"]

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# drawing.cpp's anti-aliasing filter and slope correction.
_FILTER = np.array([
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252,
    254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202,
    194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75,
    68, 62, 56, 50, 45, 40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8,
    7, 5, 5], np.int64)
_SLOPE_CORR = (181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192,
               194, 196, 198, 201, 203, 206, 209, 211, 214, 218, 221, 224,
               227, 231, 235, 238, 242, 246, 250, 254)


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _clip_line(width: int, height: int, x1, y1, x2, y2):
    """cv2's ``clipLine`` on a width x height canvas: the segment's part
    inside it, or None."""
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _blend_twice(image, ys, xs, alpha, color) -> None:
    """``LineAA``'s put-point: v += ((c - v) * a + 127) >> 8, twice."""
    v = image[ys, xs].astype(np.int64)
    a = alpha[:, None]
    v += ((color - v) * a + 127) >> 8
    v += ((color - v) * a + 127) >> 8
    image[ys, xs] = v.astype(np.uint8)


def _line_aa(image, x1, y1, x2, y2, color) -> None:
    """cv2's ``LineAA`` between two 16-bit fixed-point points."""
    h, w = image.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    horizontal = abs(dx) > abs(dy)
    if not horizontal:  # walk along y: swap the axes, swap them back below
        x1, y1, x2, y2, dx, dy = y1, x1, y2, x2, dy, dx
    if dx < 0:
        x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
    step = _cdiv(dy * XY_ONE, abs(dx) | 1)
    x2 += XY_ONE
    ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
    j = -(x1 & (XY_ONE - 1))
    y1 += ((step * j) >> XY_SHIFT) + (XY_ONE >> 1)
    slope = (step >> (XY_SHIFT - 5)) & 0x3F
    slope ^= 0x3F if step < 0 else 0
    i = (x1 >> (XY_SHIFT - 7)) & 0x78
    j = (x2 >> (XY_SHIFT - 7)) & 0x78
    slope = 0x100 if slope & 0x20 else _SLOPE_CORR[slope]

    t0 = slope << 7
    t1 = ((0x78 - i) | 4) * slope
    t2 = (j | 4) * slope
    ep = np.zeros(9, np.int64)
    ep[8] = slope
    ep[1] = ep[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF
    ep[2] = (t1 >> 8) & 0x1FF
    ep[4] = ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF
    ep[5] = ((t1 + t0) >> 8) & 0x1FF
    ep[6] = (t2 >> 8) & 0x1FF
    ep[7] = ((t2 + t0) >> 8) & 0x1FF

    k = np.arange(ecount + 1, dtype=np.int64)
    major = (x1 >> XY_SHIFT) + k
    minor_fp = y1 + k * step
    sc, ec = k, ecount - k
    ep_corr = ep[(((sc >= 2) + 1) & (sc | 2)) * 3 + (((ec >= 2) + 1) & (ec | 2))]
    dist = (minor_fp >> (XY_SHIFT - 5)) & 31
    minor = (minor_fp >> XY_SHIFT) - 1
    major_size, minor_size = (w, h) if horizontal else (h, w)
    majors, minors, alphas = [], [], []
    for off, taps in ((0, dist + 32), (1, dist), (2, 63 - dist)):
        m = minor + off
        keep = (major >= 0) & (major < major_size) & (m >= 0) & (m < minor_size)
        majors.append(major[keep])
        minors.append(m[keep])
        alphas.append(((ep_corr * _FILTER[taps]) >> 8)[keep] & 0xFF)
    major, minor, alpha = (np.concatenate(v) for v in (majors, minors, alphas))
    xs, ys = (major, minor) if horizontal else (minor, major)
    _blend_twice(image, ys, xs, alpha, color)


def _fill_convex_poly_aa(image, pts, color) -> None:
    """cv2's ``FillConvexPoly`` with ``LINE_AA`` on 16-bit fixed-point
    vertices: the anti-aliased edges, then the spans strictly inside."""
    h, w = image.shape[:2]
    n = len(pts)
    px, py = pts[-1]
    for qx, qy in pts:
        _line_aa(image, px, py, qx, qy, color)
        px, py = qx, qy
    if n < 3:
        return
    delta = XY_ONE >> 1
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + delta) >> XY_SHIFT, (max(xs) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys) + delta) >> XY_SHIFT, (max(ys) + delta) >> XY_SHIFT
    if xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # edge state: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    edges = n
    y = ymin
    while True:
        if y < ymax or y == ymin:
            for e in edge:
                if y >= e[4]:
                    idx0 = e[0]
                    idx = idx0 + e[1]
                    if idx >= n:
                        idx -= n
                    while True:
                        edges -= 1
                        if edges < 0:
                            break
                        ty = (pts[idx][1] + delta) >> XY_SHIFT
                        if ty > y:
                            xs0, xe0 = pts[idx0][0], pts[idx][0]
                            e[4] = ty
                            e[3] = _cdiv((xe0 - xs0) * 2 + (ty - y), 2 * (ty - y))
                            e[2] = xs0
                            e[0] = idx
                            break
                        idx0 = idx
                        idx += e[1]
                        if idx >= n:
                            idx -= n
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0][2] > edge[1][2] else (edge[0], edge[1])
            xx1 = (left[2] + XY_ONE - 1) >> XY_SHIFT
            xx2 = right[2] >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                image[y, max(xx1, 0):min(xx2, w - 1) + 1] = color
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _round_cap(image, cx, cy, radius, color) -> None:
    """``EllipseEx`` filled at a fixed-point centre, the cap of a thick
    anti-aliased line. For radii under 3 px (thickness < 5) cv2 draws the
    polygon of the circle's points at 90-degree steps: a diamond whose last
    vertex repeats its first."""
    r = radius
    _fill_convex_poly_aa(image, [(cx + r, cy), (cx, cy + r), (cx - r, cy),
                                 (cx, cy - r), (cx + r, cy)], color)


def _thick_line_aa(image, p0, p1, color, thickness: int, cap_end: bool) -> None:
    """cv2's ``ThickLine`` with ``LINE_AA`` between integer points, with
    the round cap at p1 that a closed polyline draws."""
    x0, y0 = p0[0] << XY_SHIFT, p0[1] << XY_SHIFT
    x1, y1 = p1[0] << XY_SHIFT, p1[1] << XY_SHIFT
    if thickness <= 1:
        _line_aa(image, x0, y0, x1, y1, color)
        return
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = round(dy * r), round(dx * r)
        _fill_convex_poly_aa(image, [(x0 + ox, y0 + oy), (x0 - ox, y0 - oy),
                                     (x1 - ox, y1 - oy), (x1 + ox, y1 + oy)], color)
    if cap_end:
        _round_cap(image, x1, y1, half, color)


def _as_color(image: np.ndarray, color) -> np.ndarray:
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 BGR image, got "
                         f"{image.dtype} {image.shape}")
    c = np.broadcast_to(np.asarray(color, np.float64).reshape(-1)[:3], (3,))
    return np.clip(np.rint(c), 0, 255).astype(np.int64)


def draw_box(image: np.ndarray, box, color, thickness: int = 2) -> None:
    """Draw the outline of an (x1, y1, x2, y2) box in place, as
    ``cv2.rectangle(..., thickness, cv2.LINE_AA)`` on the box cast to int."""
    if not 1 <= thickness <= 4:
        raise ValueError(f"thickness {thickness} not supported (1 to 4)")
    c = _as_color(image, color)
    x1, y1, x2, y2 = (int(v) for v in np.asarray(box).astype(int)[:4])
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    p0 = corners[-1]
    for p in corners:
        _thick_line_aa(image, p0, p, c, thickness, cap_end=True)
        p0 = p


_GLYPHS = None


def _glyphs():
    global _GLYPHS
    if _GLYPHS is None:
        path = os.path.join(os.path.dirname(__file__), "hershey_glyphs.npz")
        with np.load(path) as z:
            _GLYPHS = {k: z[k] for k in z.files}
    return _GLYPHS


def put_text(image: np.ndarray, text: str, org, color, thickness: int = 1) -> None:
    """``cv2.putText(image, text, org, cv2.FONT_HERSHEY_PLAIN, 1, color,
    thickness)`` for printable ASCII text and thickness 1 or 2."""
    if thickness not in (1, 2):
        raise ValueError(f"thickness {thickness} not supported (1 or 2)")
    c = _as_color(image, color)
    g = _glyphs()
    first = int(g["first"])
    advance, offset, shape, start = (g[f"{k}{thickness}"] for k in
                                     ("advance", "offset", "shape", "start"))
    alpha = g[f"alpha{thickness}"]
    codes = [ord(ch) - first for ch in text]
    bad = [ch for ch, k in zip(text, codes) if not 0 <= k < len(advance)]
    if bad:
        raise ValueError(f"no glyph for {bad[0]!r}: captions are drawn for "
                         "printable ASCII only")
    h, w = image.shape[:2]
    x, oy = int(org[0]), int(org[1])
    if x >= w:
        return
    for k in codes:
        gh, gw = (int(v) for v in shape[k])
        if gh:
            top, left = oy + int(offset[k, 0]), x + int(offset[k, 1])
            ya, yb = max(top, 0), min(top + gh, h)
            xa, xb = max(left, 0), min(left + gw, w)
            if ya < yb and xa < xb:
                s = int(start[k])
                a = alpha[s:s + gh * gw].reshape(gh, gw)
                a = a[ya - top:yb - top, xa - left:xb - left].astype(np.int64)[..., None]
                v = image[ya:yb, xa:xb].astype(np.int64)
                image[ya:yb, xa:xb] = ((c * a + v * (255 - a) + 127) // 255).astype(np.uint8)
        x += int(advance[k])


def draw_caption(image: np.ndarray, box, caption: str) -> None:
    """Write a caption above a box: black at thickness 2, then white at
    thickness 1, at (x1, y1 - 10)."""
    b = np.asarray(box).astype(int)
    org = (int(b[0]), int(b[1]) - 10)
    put_text(image, caption, org, (0, 0, 0), 2)
    put_text(image, caption, org, (255, 255, 255), 1)


def draw_detections(image: np.ndarray, boxes, scores, labels, color=None,
                    label_to_name=None, score_threshold: float = 0.5) -> None:
    """Draw the detections scoring above score_threshold (the reference's
    default 0.5 for predict): each box in its label's colour (or
    ``color``), then its caption "<name> <score>"."""
    for i in np.where(np.asarray(scores) > score_threshold)[0]:
        label = int(labels[i])
        c = color if color is not None else label_color(label)
        draw_box(image, boxes[i, :], color=c)
        name = label_to_name(label) if label_to_name else str(label)
        draw_caption(image, boxes[i, :], f"{name} {float(scores[i]):.2f}")


def draw_annotations(image: np.ndarray, annotations: dict, color=(0, 255, 0),
                     label_to_name=None) -> None:
    """Draw ground-truth boxes ({'bboxes': (M, 4), 'labels': (M,)}): each
    caption, then its box."""
    for i in range(annotations["bboxes"].shape[0]):
        label = int(annotations["labels"][i])
        c = color if color is not None else label_color(label)
        name = label_to_name(label) if label_to_name else str(label)
        draw_caption(image, annotations["bboxes"][i], name)
        draw_box(image, annotations["bboxes"][i], color=c)

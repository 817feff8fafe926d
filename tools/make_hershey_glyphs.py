"""Regenerate tdnet_torch/utils/hershey_glyphs.npz: the glyphs that
``cv2.putText(img, text, org, cv2.FONT_HERSHEY_PLAIN, 1, color, t)``
draws for the printable ASCII characters at thickness 1 and 2, which the
port's ``utils/visualization.put_text`` composites without cv2.

cv2 5 renders the Hershey font faces with an embedded TrueType font: each
glyph is an anti-aliased alpha mask placed at an integer pen position and
composited onto the image glyph by glyph. For each character and
thickness this script stores the mask drawn in white on black (the
alpha), its offset from the pen position, and the pen's advance, measured
as the offset at which the next glyph lands. It then checks the table
against cv2 on random strings, backgrounds and colours, and at the
borders.

Run from the repo root:  python tools/make_hershey_glyphs.py
"""

import os
import sys

import cv2
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(__file__), "..", "tdnet_torch", "utils",
                   "hershey_glyphs.npz")
FIRST, LAST = 32, 126
PAD = 48
FONT = cv2.FONT_HERSHEY_PLAIN


def render(text, thickness, shape, org):
    img = np.zeros(shape, np.uint8)
    cv2.putText(img, text, org, FONT, 1, 255, thickness)
    return img


def glyph(ch, thickness):
    """(dy, dx, alpha) of one character drawn at the pen (PAD, PAD)."""
    m = render(ch, thickness, (2 * PAD, 2 * PAD), (PAD, PAD))
    ys, xs = np.nonzero(m)
    if not len(ys):
        return 0, 0, np.zeros((0, 0), np.uint8)
    y0, x0 = ys.min(), xs.min()
    return y0 - PAD, x0 - PAD, m[y0:ys.max() + 1, x0:xs.max() + 1]


def over(v, a):
    """Composite white at alpha a onto v."""
    return (255 * a + v * (255 - a) + 127) // 255


def advance(ch, thickness, masks):
    """The pen offset at which an 'H' after ch lands."""
    want = render(ch + "H", thickness, (2 * PAD, 4 * PAD), (PAD, PAD)).astype(np.int64)
    dy_h, dx_h, h = masks["H"]
    found = []
    for adv in range(0, 40):
        img = np.zeros_like(want)
        dy, dx, g = masks[ch]
        img[PAD + dy:PAD + dy + g.shape[0], PAD + dx:PAD + dx + g.shape[1]] = g
        sl = img[PAD + dy_h:PAD + dy_h + h.shape[0],
                 PAD + adv + dx_h:PAD + adv + dx_h + h.shape[1]]
        sl[...] = over(sl, h.astype(np.int64))
        if np.array_equal(img, want):
            found.append(adv)
    if len(found) != 1:
        raise SystemExit(f"no single advance for {ch!r} at thickness "
                         f"{thickness}: {found}")
    return found[0]


def check(n_cases=4000):
    from tdnet_torch.utils import visualization

    visualization._GLYPHS = None
    rng = np.random.default_rng(0)
    chars = [chr(c) for c in range(FIRST, LAST + 1)]
    for i in range(n_cases):
        h, w = int(rng.integers(1, 60)), int(rng.integers(1, 120))
        text = "".join(rng.choice(chars, int(rng.integers(1, 10))))
        t = int(rng.integers(1, 3))
        org = (int(rng.integers(-60, w + 5)), int(rng.integers(-20, h + 25)))
        bg = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        want = bg.copy()
        cv2.putText(want, text, org, FONT, 1, color, t)
        got = bg.copy()
        visualization.put_text(got, text, org, color, t)
        if not np.array_equal(got, want):
            raise SystemExit(f"table differs from cv2: {text!r} t={t} org={org} "
                             f"image {h}x{w}")
    print(f"checked {n_cases} random captions against cv2 {cv2.__version__}")


def main():
    arrays = {"first": np.int64(FIRST)}
    for t in (1, 2):
        masks = {chr(c): glyph(chr(c), t) for c in range(FIRST, LAST + 1)}
        chars = [chr(c) for c in range(FIRST, LAST + 1)]
        arrays[f"advance{t}"] = np.array([advance(c, t, masks) for c in chars], np.int16)
        arrays[f"offset{t}"] = np.array([masks[c][:2] for c in chars], np.int16)
        arrays[f"shape{t}"] = np.array([masks[c][2].shape for c in chars], np.int16)
        sizes = [masks[c][2].size for c in chars]
        arrays[f"start{t}"] = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
        arrays[f"alpha{t}"] = np.concatenate([masks[c][2].ravel() for c in chars]).astype(np.uint8)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {os.path.normpath(OUT)} ({os.path.getsize(OUT)} bytes)")
    check()


if __name__ == "__main__":
    main()

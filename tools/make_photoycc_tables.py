"""Recover the tables of PIL's PhotoYCC unpacker (``YCC;P`` -> ``RGB``,
which its ``pcd`` decoder uses) by probing it, and write them to
``tdnet_torch/data/photoycc.py`` for ``data/pcd.py``.

PIL converts each pixel as ``R = clip(L[y] + CR[cr])``, ``G = clip(L[y] +
GB[cb] + GR[cr])`` and ``B = clip(L[y] + CB[cb])``, clipped to 0..255.
Every (y, cr) pair whose R lies strictly inside 0..255 gives one equation
``L[y] + CR[cr] = R``; with ``CR[137] = 0`` they chain to both tables.
B then gives CB, and G (with cb 156, taking ``GB[156] = 0``) GR, then
GB. The tables are checked against PIL on all
2^24 (y, cb, cr) triples before they are written. Run from the repo root
(PIL here only):  python tools/make_photoycc_tables.py
"""

import os

import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(__file__), "..", "tdnet_torch", "data", "photoycc.py")


def pil_ycc(y, cb, cr) -> np.ndarray:
    """PIL's RGB of the PhotoYCC triples (flat arrays)."""
    raw = np.stack([y, cb, cr], 1).astype(np.uint8).tobytes()
    n = len(y)
    im = Image.new("RGB", (n, 1))
    decoder = Image._getdecoder("RGB", "raw", "YCC;P", ())
    decoder.setimage(im.im, (0, 0, n, 1))
    decoder.decode(raw)
    return np.asarray(im)[0].astype(np.int64)


def chain(m, fixed_col, fixed_value):
    """Solve row[i] + col[j] = m[i, j] over the entries inside (0, 255),
    with col[fixed_col] = fixed_value, by walking the bipartite graph."""
    rows, cols = np.full(256, np.nan), np.full(256, np.nan)
    cols[fixed_col] = fixed_value
    inside = (m > 0) & (m < 255)
    changed = True
    while changed:
        changed = False
        for j in np.flatnonzero(~np.isnan(cols)):
            for i in np.flatnonzero(inside[:, j] & np.isnan(rows)):
                rows[i] = m[i, j] - cols[j]
                changed = True
        for i in np.flatnonzero(~np.isnan(rows)):
            for j in np.flatnonzero(inside[i, :] & np.isnan(cols)):
                cols[j] = m[i, j] - rows[i]
                changed = True
    assert not np.isnan(rows).any() and not np.isnan(cols).any()
    return rows.astype(np.int64), cols.astype(np.int64)


def main():
    a = np.arange(256)
    yy, cc = np.meshgrid(a, a, indexing="ij")
    flat_y, flat_c = yy.ravel(), cc.ravel()
    r = pil_ycc(flat_y, np.full(65536, 156), flat_c)[:, 0].reshape(256, 256)
    L, CR = chain(r, 137, 0)
    def given_l(m, extra=0):
        """The column table of m[y, j] = L[y] + col[j] (+ extra), from the
        entries inside (0, 255), which must agree."""
        inside = (m > 0) & (m < 255)
        diff = m - L[:, None] - extra
        col = np.empty(256, np.int64)
        for j in range(256):
            values = np.unique(diff[inside[:, j], j])
            assert len(values) == 1, (j, values)
            col[j] = values[0]
        return col

    CB = given_l(pil_ycc(flat_y, flat_c, np.full(65536, 137))[:, 2].reshape(256, 256))
    GR = given_l(pil_ycc(flat_y, np.full(65536, 156), flat_c)[:, 1].reshape(256, 256))
    GB = given_l(pil_ycc(flat_y, flat_c, np.full(65536, 137))[:, 1].reshape(256, 256),
                 GR[137])
    tables = {"L": L, "CR": CR, "CB": CB, "GR": GR, "GB": GB}
    # every triple against PIL
    for y0 in range(0, 256, 16):
        y, cb, cr = np.meshgrid(np.arange(y0, y0 + 16), a, a, indexing="ij")
        y, cb, cr = y.ravel(), cb.ravel(), cr.ravel()
        want = pil_ycc(y, cb, cr)
        got = np.stack([L[y] + CR[cr], L[y] + GB[cb] + GR[cr], L[y] + CB[cb]], 1).clip(0, 255)
        assert np.array_equal(got, want), y0
    with open(OUT, "w") as f:
        f.write('"""The tables of PIL\'s PhotoYCC to RGB conversion (its ``YCC;P``\n'
                "unpacker), recovered by ``tools/make_photoycc_tables.py`` and checked\n"
                "there against PIL on every (y, cb, cr): ``R = clip(L[y] + CR[cr])``,\n"
                "``G = clip(L[y] + GB[cb] + GR[cr])``, ``B = clip(L[y] + CB[cb])``.\"\"\"\n\n")
        for name, t in tables.items():
            f.write(f"{name} = (\n")
            vals = [str(int(v)) for v in t]
            for i in range(0, 256, 16):
                f.write("    " + ", ".join(vals[i:i + 16]) + ",\n")
            f.write(")\n")
    print("wrote", OUT)


if __name__ == "__main__":
    main()

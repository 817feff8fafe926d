"""Regenerate tests/golden/jpeg/: four synthetic table pages encoded as
JPEG at full page size, and ``digests.json``, which holds for each file the
SHA-256 of the two reference decodes the port must equal byte for byte:

- ``pil_rgb_sha256``: ``np.asarray(Image.open(path).convert("RGB"))``
  (the reference's file route, ``tdnet/data/image.py``);
- ``cv2_bgr_sha256``: ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` (the
  reference's serve-body route, ``tdnet/bin/serve.py``), which applies the
  EXIF orientation;

and the table boxes drawn, (x1, y1, x2, y2) in the file's pixel grid (as
PIL reads it). The pages come from a seed; only the encoders differ:

- ``page_420_q90.jpg``: 1100x850 (width x height), 4:2:0, quality 90 (PIL);
- ``page_444_q75_rst.jpg``: 850x1100, 4:4:4, quality 75, a restart marker
  every 5 MCUs (cv2's encoder);
- ``page_gray_opt.jpg``: 1100x850 grayscale, quality 85, optimised Huffman
  tables (PIL);
- ``page_420_exif6.jpg``: a 1100x850 page stored turned to 850x1100, 4:2:0,
  quality 85, EXIF orientation 6 (PIL): the cv2 route turns it upright.

The GPU machine has neither PIL nor cv2, so the files are made here and
committed. Run from the repo root:  python tools/make_jpeg_pages.py
"""

import hashlib
import io
import json
import os

import cv2
import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden", "jpeg")
SEED = 0
LANDSCAPE, PORTRAIT = (850, 1100), (1100, 850)  # (height, width)


def table_page(rng, shape):
    """An (H, W, 3) uint8 RGB page: off-white paper with a gentle shade,
    2-3 ruled tables (a tinted header row, text-like strokes in the cells)
    and lines of body text between them; the tables' boxes."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    page = 246 - 6 * (yy / h) - 3 * (xx / w)
    page = np.repeat(page[:, :, None], 3, axis=2)
    page[..., 2] -= 4  # a warm paper
    boxes = []
    top = int(rng.integers(40, 90))
    while top < h - 160 and len(boxes) < 3:
        for _ in range(int(rng.integers(2, 5))):  # body text above the table
            y = top + 4
            x = int(rng.integers(50, 80))
            while x < w - 120:
                n = int(rng.integers(15, 70))
                page[y:y + 7, x:x + n] = 45
                x += n + int(rng.integers(6, 12))
            top += 16
        th = int(rng.integers(120, min(360, h - top - 40)))
        x0 = int(rng.integers(40, 120))
        x1 = w - int(rng.integers(40, 120))
        y0, y1 = top + 10, top + 10 + th
        row_h = int(rng.integers(20, 32))
        cols = np.sort(rng.choice(np.arange(x0 + 60, x1 - 60), int(rng.integers(2, 6)),
                                  replace=False))
        page[y0:y0 + row_h, x0:x1] = (205, 222, 240)  # header row
        for y in range(y0, y1, row_h):
            page[y:y + 1, x0:x1] = 60
            for cx0, cx1 in zip(np.r_[x0, cols], np.r_[cols, x1]):
                n = int(rng.integers(12, max(13, cx1 - cx0 - 12)))
                page[y + row_h // 2 - 3:y + row_h // 2 + 3, cx0 + 6:cx0 + 6 + n] = 30
        page[y1 - 1:y1, x0:x1] = 60
        page[y0:y1, [x0, x1 - 1]] = 60
        page[y0:y1, cols] = 60
        boxes.append([x0, y0, x1, y1])
        top = y1 + int(rng.integers(30, 80))
    return np.clip(np.rint(page), 0, 255).astype(np.uint8), boxes


def turned_ccw(page, boxes):
    """The page and its boxes turned 90 degrees counter-clockwise, which
    EXIF orientation 6 turns back."""
    w = page.shape[1]
    return (np.ascontiguousarray(np.rot90(page, 1)),
            [[y0, w - x1, y1, w - x0] for x0, y0, x1, y1 in boxes])


def pil_jpeg(rgb, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", **kw)
    return buf.getvalue()


def main():
    rng = np.random.default_rng(SEED)
    os.makedirs(OUT, exist_ok=True)
    files = {}
    page, boxes = table_page(rng, LANDSCAPE)
    files["page_420_q90.jpg"] = (pil_jpeg(page, quality=90, subsampling=2), boxes)
    page, boxes = table_page(rng, PORTRAIT)
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(page[:, :, ::-1]), [
        cv2.IMWRITE_JPEG_QUALITY, 75,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
        cv2.IMWRITE_JPEG_RST_INTERVAL, 5])
    assert ok
    files["page_444_q75_rst.jpg"] = (enc.tobytes(), boxes)
    page, boxes = table_page(rng, LANDSCAPE)
    gray = np.asarray(Image.fromarray(page).convert("L"))
    files["page_gray_opt.jpg"] = (pil_jpeg(gray, quality=85, optimize=True), boxes)
    page, boxes = turned_ccw(*table_page(rng, LANDSCAPE))
    exif = Image.Exif()
    exif[0x0112] = 6
    files["page_420_exif6.jpg"] = (pil_jpeg(page, quality=85, subsampling=2,
                                            exif=exif.tobytes()), boxes)

    digests = {}
    for name, (data, boxes) in files.items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        digests[name] = {
            "bytes": len(data),
            "size": list(Image.open(io.BytesIO(data)).size),
            "cv2_shape": list(bgr.shape),
            "pil_rgb_sha256": hashlib.sha256(pil.tobytes()).hexdigest(),
            "cv2_bgr_sha256": hashlib.sha256(bgr.tobytes()).hexdigest(),
            "boxes": [[int(v) for v in b] for b in boxes],
        }
        print(name, len(data), "bytes", digests[name]["size"], bgr.shape)
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")
    print("total", sum(d["bytes"] for d in digests.values()), "bytes")


if __name__ == "__main__":
    main()

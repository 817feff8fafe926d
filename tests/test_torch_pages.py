"""The page formats of ``data/jpeg.py``, ``data/bmp.py``, ``data/tiff.py``,
``data/pnm.py`` and ``data/gif.py`` through the whole slice on the CPU: a
CSV of a progressive JPEG, a CMYK JPEG, an RLE8 BMP, two TIFFs (CCITT G4,
LZW with a predictor), a binary PPM, a GIF, a YCbCr LZW TIFF, an
arithmetic-coded JPEG, a JPEG 2000 file (9/7, two layers), a DIB, a PSD
and an ICNS through the
reference's and the port's ``BatchLoader`` (equal batches), then the port's ``Predictor`` and the
reference's on the decoded pages with the variables
``tdnet_torch/weights.py`` carries over (equal detections, at
``tests/test_torch_predictor.py``'s tolerances); and the golden full-size
pages' digests (``tools/make_pages.py``)."""

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tdnet_torch.data import image as port_image

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "pages"
sys.path.insert(0, str(ROOT / "tools"))
from jpeg_arith import transcode  # noqa: E402
from tests.test_torch_icns import element, icns_file  # noqa: E402
from tests.test_torch_psd import psd_file  # noqa: E402


def _page(shape, seed):
    """A light page with dark rectangles ("tables") and a colour band."""
    rng = np.random.default_rng(seed)
    h, w = shape
    page = np.full((h, w, 3), 236, np.uint8)
    page[:, :, 2] = 228
    boxes = []
    for _ in range(2):
        x0, y0 = int(rng.integers(2, w // 2)), int(rng.integers(2, h // 2))
        x1, y1 = int(rng.integers(x0 + 8, w - 1)), int(rng.integers(y0 + 8, h - 1))
        page[y0:y1, x0:x1] = rng.integers(20, 120, 3)
        page[y0:y1:4, x0:x1] = 250
        boxes.append((x0, y0, x1, y1))
    return page, boxes


def _rle8(rgb) -> bytes:
    """An 8-bit BI_RLE8 BMP: encoded runs, an end of line a row, an end of
    bitmap."""
    h, w = rgb.shape[:2]
    colours, index = np.unique(rgb.reshape(-1, 3), axis=0, return_inverse=True)
    index = index.reshape(h, w)
    stream = bytearray()
    for r, row in enumerate(index[::-1].tolist()):
        x = 0
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            stream += bytes([run, row[x]])
            x += run
        stream += b"\x00\x01" if r == h - 1 else b"\x00\x00"
    palette = b"".join(bytes([b, g, r, 0]) for r, g, b in colours)
    offset = 54 + len(palette)
    return (b"BM" + struct.pack("<IHHI", offset + len(stream), 0, 0, offset)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 1, len(stream), 2835, 2835,
                          len(colours), 0) + palette + bytes(stream))


def _save(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def csv_pages(tmp_path_factory):
    """annotations.csv and classes.csv over thirteen pages, one a format:
    among them three that only PIL reads, a DIB from PIL's writer, a
    PackBits PSD by hand and an ICNS of a PNG icon."""
    root = tmp_path_factory.mktemp("pages")
    shapes = [(64, 96), (96, 64), (70, 100), (64, 96), (100, 70), (64, 96), (96, 64),
              (70, 100), (64, 96), (96, 64), (70, 100), (64, 96), (128, 128)]
    makers = {
        "progressive.jpg": lambda im: _save(im, "JPEG", quality=90, progressive=True),
        "cmyk.jpg": lambda im: _save(im.convert("CMYK"), "JPEG", quality=90),
        "rle8.bmp": lambda im: _rle8(np.asarray(im)),
        "g4.tif": lambda im: _save(im.convert("L").point(lambda v: 255 * (v > 160)).convert("1"),
                                   "TIFF", compression="group4"),
        "lzw.tif": lambda im: _save(im, "TIFF", compression="tiff_lzw", tiffinfo={317: 2}),
        "page.ppm": lambda im: _save(im, "PPM"),
        "page.gif": lambda im: _save(im.convert("P", palette=Image.Palette.ADAPTIVE), "GIF"),
        "ycc_lzw.tif": lambda im: _save(im.convert("YCbCr"), "TIFF", compression="tiff_lzw"),
        "arith.jpg": lambda im: transcode(_save(im, "JPEG", quality=85), progressive=True),
        "page.jp2": lambda im: _save(im, "JPEG2000", irreversible=True, quality_layers=[20, 5]),
        "page.dib": lambda im: _save(im.quantize(200), "DIB"),
        "page.psd": lambda im: psd_file(3, 8, 3, [np.asarray(im)[:, :, c] for c in range(3)],
                                        *im.size, compression=1),
        "page.icns": lambda im: icns_file(element(b"ic07", _save(im, "PNG"))),
    }
    rows = []
    for i, ((name, make), shape) in enumerate(zip(makers.items(), shapes)):
        page, boxes = _page(shape, i)
        (root / name).write_bytes(make(Image.fromarray(page)))
        rows += [f"{root / name},{x0},{y0},{x1},{y1},table" for x0, y0, x1, y1 in boxes]
    (root / "annotations.csv").write_text("\n".join(rows) + "\n")
    (root / "classes.csv").write_text("table,0\n")
    return root, sorted(makers)


def test_pages_decode_as_the_reference_reads_them(csv_pages):
    """Each page read by the port's read_image_bgr equals the reference's
    tdnet.data.image.read_image_bgr (PIL), and image_size PIL's size."""
    from tdnet.data.image import read_image_bgr as ref_read

    root, names = csv_pages
    for name in names:
        np.testing.assert_array_equal(port_image.read_image_bgr(root / name),
                                      ref_read(str(root / name)), err_msg=name)
        assert port_image.image_size(root / name) == Image.open(root / name).size


def test_batch_loader_over_the_pages_equals_reference(csv_pages):
    """The port's BatchLoader over the CSV gives batches bit-equal to
    tdnet's over the reference dataset, for two shuffled epochs, with host
    and device normalisation."""
    from tdnet.data.csv_dataset import CSVDataset as RefDataset
    from tdnet.data.generator import BatchLoader as RefLoader
    from tdnet.data.generator import LoaderConfig as RefConfig

    from tdnet_torch.data.csv_dataset import CSVDataset
    from tdnet_torch.data.generator import BatchLoader, LoaderConfig

    root, _ = csv_pages
    ann, classes = str(root / "annotations.csv"), str(root / "classes.csv")
    for device_normalize in (False, True):
        kw = dict(batch_size=2, seed=5, min_side=48, max_side=80,
                  device_normalize=device_normalize)
        ref = RefLoader(RefDataset(ann, classes), RefConfig(process_index=0, process_count=1, **kw))
        port = BatchLoader(CSVDataset(ann, classes), LoaderConfig(**kw))
        assert port.steps_per_epoch() == ref.steps_per_epoch()
        want = [b for _ in range(2) for b in ref.epoch()]
        got = [b for _ in range(2) for b in port.epoch()]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_predictor_over_the_pages_matches_reference(csv_pages):
    """The port's Predictor (CPU, f32, uint8 pages through the fused stem's
    plain version) on the pages as the port reads them vs tdnet's
    Predictor (its fused stem's plain version) on the pages as the
    reference reads them,
    ResNet-50 variables from tdnet_torch.weights.random_variables with the
    class head spread as in tests/test_torch_predictor.py: labels exact,
    scores rtol/atol 1e-3, boxes rtol 1e-3 + 0.5 px, on detections clear
    of the threshold."""
    import jax
    import jax.numpy as jnp
    import torch

    from tdnet.data.image import read_image_bgr as ref_read
    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
    from tdnet.train.predictor import Predictor as JaxPredictor

    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.predictor import Predictor
    from tdnet_torch.weights import random_variables

    torch.set_num_threads(1)
    root, names = csv_pages
    v = random_variables(1, "resnet50", seed=0)
    v["params"]["classification_submodel"]["head"]["kernel"] *= 30.0
    v["params"]["classification_submodel"]["head"]["bias"][:] = -2.0
    kw = dict(min_side=64, max_side=96, buckets=[(64, 128), (128, 64)], score_threshold=0.05)
    ref = JaxPredictor(FlaxRetinaNet(num_classes=1, dtype=jnp.float32),
                       jax.tree.map(jnp.asarray, v), fused_stem=True, use_pallas=False,
                       device_preprocess=True, batch_size=8, **kw)
    port = Predictor(RetinaNet(1), v, device="cpu", device_preprocess=True, fused_stem=True, **kw)
    want = ref.predict_batch([ref_read(str(root / n)) for n in names])
    got = port.predict_batch([port_image.read_image_bgr(root / n) for n in names])
    n_compared = 0
    for (rb, rs, rl), (gb, gs, gl) in zip(want, got):
        clear = rs > 0.06
        n_compared += int(clear.sum())
        np.testing.assert_array_equal(gl[clear], rl[clear])
        np.testing.assert_allclose(gs[clear], rs[clear], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(gb[clear], rb[clear], rtol=1e-3, atol=0.5)
    assert n_compared > 100
    jax.clear_caches()


# the golden pages whose decode in Python takes a second or more a route:
# chip_smoke.py's pages phase checks them at full size
SLOW_PAGES = ("arith_seq.jpg", "arith_prog.jpg", "arith_big.jpg", "lossless.jpg",
              "vp8l_rgb.webp", "vp8_q80.webp", "vp8x_alpha.webp", "vp8x_exif6.webp",
              "vp8_simple4.webp", "apng_default.png", "j2k_97.jp2", "j2k_rpcl.j2k",
              "j2k_cv2.jp2", "j2k_gray16.jp2", "avif_pil.avif", "avif_cv2.avif",
              "avif_444_q100.avif")


def test_golden_pages_equal_their_digests():
    """tests/golden/pages (tools/make_pages.py): the full-size pages decode
    by both routes to the SHA-256 the references gave (the CMYK page's
    routes apart), a route the reference refuses raises (the RLE Sun
    raster, the gray PFM and the 12-bit JPEG on cv2's; the HDR page and
    the 12-bit JPEG on PIL's), and their sizes read from the headers (or
    ``image_size`` raising where PIL cannot open the file). The file lists
    all 68 pages; this test decodes the cheap ones, the eight of earlier
    slices, ycc_lzw.tif, page.pbm, page.gif, rle.ras, vp8l_palette.webp,
    exif6.png, lab.tif, jpeg12.jpg, gray.pfm, page.hdr, the ten pages only
    PIL reads of slice 22 (32-bit TIFF, TGA, PCX, SGI, ICO, DDS, QOI and
    IM) and the twenty of slice 23 (DIB, CUR, DCX, MSP, XBM, SPIDER, ICNS,
    BLP, PSD, XPM, FITS, GBR, FTEX, PIXAR, McIDAS, IMT, XV thumbnail, FLC,
    Photo CD and IPTC), each of these refused on cv2's route, and three of
    the six AVIF pages (the restored low-quality, 4:0:0 tiled and BT.709
    limited-range ones), and leaves the arithmetic-coded and lossless
    JPEGs, the other WebP pages, the APNG, the four JPEG 2000 pages and the
    full-size and lossless AVIF pages (SLOW_PAGES) to the card's pages
    phase, which decodes them all."""
    digests = json.loads((GOLDEN / "digests.json").read_text())
    assert len(digests) == 68
    for name, info in digests.items():
        if info["size"] is None:
            with pytest.raises(ValueError):
                port_image.image_size(GOLDEN / name)
        else:
            assert list(port_image.image_size(GOLDEN / name)) == info["size"]
        if name in SLOW_PAGES:
            continue
        data = (GOLDEN / name).read_bytes()
        decoded = {}
        for route in ("pil", "cv2"):
            if route in info.get("refused", {}):
                with pytest.raises(ValueError):
                    port_image.decode_image(data, route=route)
                continue
            decoded[route] = port_image.decode_image(data, route=route)
        if "pil" in decoded:
            rgb = decoded["pil"]
            assert hashlib.sha256(rgb.tobytes()).hexdigest() == info["pil_rgb_sha256"], name
        if "cv2" in decoded:
            bgr = np.ascontiguousarray(decoded["cv2"][:, :, ::-1])
            assert hashlib.sha256(bgr.tobytes()).hexdigest() == info["cv2_bgr_sha256"], name
            assert list(bgr.shape) == info["cv2_shape"]
        if len(decoded) == 2:
            assert np.array_equal(rgb, bgr[:, :, ::-1]) == info["routes_equal"], name


def test_bf16_train_cli_on_the_cpu_stays_finite(tmp_path):
    """The train CLI in bf16 on the CPU at a 64x96 canvas, ``train pascal``
    over the full-size JPEG pages of tests/golden/jpeg, in a fresh process
    on one thread: oneDNN's bfloat16 convolution returned NaN logits at FPN
    P6 in the first two steps there (every one of four seeds), where the
    reference's ``tdnet.bin.train --bf16`` stays finite; the port now
    computes CPU bf16 convolutions in float32 and rounds them, as XLA's CPU
    backend does."""
    import os
    import subprocess
    import sys

    jpegs = ROOT / "tests" / "golden" / "jpeg"
    digests = json.loads((jpegs / "digests.json").read_text())
    voc = tmp_path / "VOC2007"
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (voc / d).mkdir(parents=True)
    stems = []
    for name, info in sorted(digests.items()):
        (voc / "JPEGImages" / name).write_bytes((jpegs / name).read_bytes())
        objects = "".join("<object><name>diningtable</name><bndbox>" + "".join(
            f"<{k}>{v + 1}</{k}>" for k, v in zip(("xmin", "ymin", "xmax", "ymax"), b))
            + "</bndbox></object>" for b in info["boxes"])
        stems.append(Path(name).stem)
        (voc / "Annotations" / f"{stems[-1]}.xml").write_text(
            f"<annotation><filename>{name}</filename>{objects}</annotation>")
    for subset in ("trainval", "test"):
        (voc / "ImageSets" / "Main" / f"{subset}.txt").write_text("\n".join(stems) + "\n")
    metrics = tmp_path / "metrics.jsonl"
    argv = ["--bf16", "--batch-size", "2", "--epochs", "1", "--steps", "2", "--log-every", "1",
            "--no-snapshots", "--seed", "0", "--metrics-path", str(metrics),
            "--device-normalize", "--image-min-side", "64", "--image-max-side", "96",
            "--device", "cpu", "pascal", str(voc)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "tdnet_torch.bin.train", *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    losses = [json.loads(x)["loss"] for x in metrics.read_text().splitlines() if '"step"' in x]
    assert len(losses) == 2 and np.isfinite(losses).all(), losses

"""The port's inference CLIs and their host-side modules against tdnet's:
PNG decoding (``tdnet_torch/data/png.py`` vs PIL), the CSV dataset, the
anchor config, ``compute_overlap`` and ``evaluate``, and the ``predict``
and ``evaluate`` CLIs with ``--device cpu`` on a tiny ``.tdn`` bundle."""

import io
import json
import struct
import zlib

import numpy as np
import pytest
import torch

from tdnet_torch.data import png
from tdnet_torch.data.image import image_size, read_image_bgr, write_image_bgr

torch.set_num_threads(1)  # tier-1 runs several xdist workers


@pytest.fixture(scope="module", autouse=True)
def _release_memory():
    """The tier-1 workers run hundreds of tests each and their memory adds
    up: drop this module's JAX executables and trim the C heap that its
    ResNet-50 weights and bundles leave behind."""
    yield
    import ctypes
    import gc

    import jax

    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: nothing to trim
        pass


def _save_pil(tmp_path, name, array, mode=None, **kw):
    from PIL import Image

    path = tmp_path / name
    Image.fromarray(array, mode).save(path, **kw)
    return path


@pytest.mark.parametrize("mode,shape", [
    ("RGB", (37, 53, 3)), ("RGB", (1, 1, 3)), ("RGBA", (20, 31, 4)),
    ("L", (17, 23)), ("LA", (9, 11, 2))])
def test_png_decode_equals_pil(tmp_path, mode, shape):
    """Odd sizes, every 8-bit colour type; smooth content so PIL's encoder
    picks Sub, Up, Average and Paeth rows."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = (xx * 3 + yy * 5)[..., None] if len(shape) == 3 else xx * 3 + yy * 5
    a = ((base + rng.randint(0, 4, shape)) % 256).astype(np.uint8)
    from tdnet.data.image import read_image_bgr as ref

    path = _save_pil(tmp_path, f"{mode}.png", a, mode)
    got, want = read_image_bgr(path), ref(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert image_size(path) == (shape[1], shape[0])


@pytest.mark.parametrize("colors", [2, 4, 16, 256])
def test_png_palette_and_low_bit_depths_equal_pil(tmp_path, colors):
    """Palette pages at 1, 2, 4 and 8 bits (PIL picks the depth from the
    palette size) and a 1-bit gray page."""
    from PIL import Image

    from tdnet.data.image import read_image_bgr as ref

    rng = np.random.RandomState(colors)
    img = Image.fromarray(rng.randint(0, 256, (29, 45, 3)).astype(np.uint8)).quantize(colors)
    path = tmp_path / "p.png"
    img.save(path)
    np.testing.assert_array_equal(read_image_bgr(path), ref(path))
    bw = _save_pil(tmp_path, "bw.png", rng.uniform(size=(13, 19)) > 0.5)
    np.testing.assert_array_equal(read_image_bgr(bw), ref(bw))


# Adam7 passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _filter_rows(rows, ftypes, bpp):
    """The PNG spec's forward filters, written out: row r of ``rows``
    (bytes, (h, stride)) filtered by ftypes[r], each row led by its type."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for r in range(rows.shape[0]):
        cur = rows[r].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) // 2, paeth][ftypes[r]]
        out.append(ftypes[r])
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


def _sample_bytes(samples, depth):
    """(h, w, c) samples -> (h, stride) bytes: big-endian at 16 bits,
    packed from the high bit below 8."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = np.unpackbits(samples.astype(np.uint8).reshape(h, w * c, 1), axis=2)
    return np.packbits(bits[:, :, 8 - depth:].reshape(h, -1), axis=1)


def _png_bytes(samples, color, depth, interlace=False, palette=None, ftypes=None):
    """A PNG of any colour type and depth, flat or Adam7, written here
    independently of the port. Filters are ``ftypes`` (row by row, flat
    pages only) or drawn at random for each row of each pass."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    rng = np.random.RandomState(h * w + depth)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    body = b""
    for y0, x0, dy, dx in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            f = ftypes if ftypes is not None else rng.randint(0, 5, sub.shape[0])
            body += _filter_rows(_sample_bytes(sub, depth), f, bpp)

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    plte = b"" if palette is None else chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (png.SIGNATURE + chunk(b"IHDR", ihdr) + plte
            + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


def _filtered_png(rows, ftypes, bpp=3):
    """An RGB PNG whose row r uses filter ftypes[r]."""
    return _png_bytes(rows.reshape(rows.shape[0], -1, bpp), 2, 8, ftypes=ftypes)


def test_png_every_filter_type_and_encoder_round_trip():
    rng = np.random.RandomState(1)
    image = rng.randint(0, 256, (40, 33, 3)).astype(np.uint8)
    rows = image.reshape(40, -1)
    for ftypes in (rng.randint(0, 5, 40), rng.randint(0, 3, 40), np.full(40, 4)):
        np.testing.assert_array_equal(png.decode_png(_filtered_png(rows, ftypes)), image)
    from PIL import Image

    for a in (image, image[..., 0], np.dstack([image, image[..., :1]])):
        data = png.encode_png(a)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), a)


def test_unsupported_images_raise(tmp_path):
    """A file that PIL opens and cannot load (a BUFR stub) raises, naming
    PIL's failure (AVIF, GIF, WebP and JPEG 2000, once the examples of a
    format the port did not read, read since the port gained their
    decoders: an AVIF page reads as PIL reads it); a .npy page is read as
    BGR float32; a page written by write_image_bgr reads back."""
    from PIL import Image

    rng = np.random.RandomState(2)
    a = rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
    path = _save_pil(tmp_path, "a.avif", a)
    np.testing.assert_array_equal(
        read_image_bgr(path), np.asarray(Image.open(path).convert("RGB"))[:, :, ::-1])
    (tmp_path / "b.bufr").write_bytes(b"BUFR" + bytes(60))
    with pytest.raises(ValueError, match="cannot find loader for this BUFR file"):
        read_image_bgr(tmp_path / "b.bufr")
    np.save(tmp_path / "page.npy", a)
    got = read_image_bgr(tmp_path / "page.npy")
    assert got.dtype == np.float32 and np.array_equal(got, a)
    write_image_bgr(tmp_path / "w.png", a)
    np.testing.assert_array_equal(read_image_bgr(tmp_path / "w.png"), a)


# (colour type, bit depth): every pair the PNG format allows
PNG_TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
_SAMPLES_A_PIXEL = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _random_png(color, depth, interlace, shape, seed=0):
    """A page of uniform random samples over the depth's whole range (so
    16-bit gray crosses 255 and every high byte occurs)."""
    rng = np.random.RandomState(seed)
    samples = rng.randint(0, 1 << depth, shape + (_SAMPLES_A_PIXEL[color],))
    palette = rng.randint(0, 256, (1 << depth, 3)) if color == 3 else None
    return _png_bytes(samples, color, depth, interlace, palette)


@pytest.mark.parametrize("interlace", [False, True], ids=["flat", "adam7"])
@pytest.mark.parametrize("color,depth", PNG_TYPES,
                         ids=[f"type{c}-{d}bit" for c, d in PNG_TYPES])
@pytest.mark.parametrize("route", ["file", "serve"])
def test_png_decode_equals_reference_route(tmp_path, route, color, depth, interlace):
    """Every colour type at every depth, flat and Adam7, at 37x53 (every
    Adam7 pass partial), against the reference decoder of each route:
    files through tdnet's read_image_bgr (PIL ``convert("RGB")``, which
    clips 16-bit gray to 255 and keeps the high byte of the other 16-bit
    types) and serve bodies through ``cv2.imdecode(IMREAD_COLOR)`` as
    tdnet/bin/serve.py calls it (the high byte of every 16-bit type)."""
    data = _random_png(color, depth, interlace, (37, 53))
    if route == "file":
        from tdnet.data.image import read_image_bgr as ref

        path = tmp_path / "page.png"
        path.write_bytes(data)
        got, want = read_image_bgr(path), ref(path)
        assert got.dtype == want.dtype == np.float32
    else:
        import cv2

        from tdnet_torch.bin.serve import _decode_body

        got = _decode_body(data, "image/png", keep_u8=True)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (3, 2), (5, 6)])
def test_png_adam7_with_empty_passes_equals_pil(tmp_path, shape):
    """Pages smaller than the 8x8 Adam7 tile, where some passes hold no
    pixels and so no bytes: 16-bit RGBA and 2-bit gray against PIL."""
    from tdnet.data.image import read_image_bgr as ref

    for color, depth in ((6, 16), (0, 2)):
        path = tmp_path / f"t{color}.png"
        path.write_bytes(_random_png(color, depth, True, shape, seed=sum(shape)))
        np.testing.assert_array_equal(read_image_bgr(path), ref(path))


def test_png_sixteen_bit_rules_differ_only_for_gray():
    """The two routes' 16-bit rules: equal except on gray, where the file
    route clips and the serve route keeps the high byte; an unknown rule
    raises."""
    for color in (0, 2, 4, 6):
        data = _random_png(color, 16, False, (7, 9), seed=color)
        same = np.array_equal(png.decode_png(data, route="pil"),
                              png.decode_png(data, route="cv2"))
        assert same == (color != 0)
    with pytest.raises(ValueError, match="route"):
        png.decode_png(data, route="libpng")


CSV_ROWS = ["page0.png,5,6,40,30,table", "page0.png,50,10,90,60,figure",
            "page1.png,,,,,", "page2.png,1,2,3,4,table"]


@pytest.fixture
def csv_dataset(tmp_path):
    rng = np.random.RandomState(3)
    for i in range(3):
        _save_pil(tmp_path, f"page{i}.png",
                  rng.randint(0, 256, (70 + i, 100 - i, 3)).astype(np.uint8))
    (tmp_path / "annotations.csv").write_text("\n".join(CSV_ROWS) + "\n")
    (tmp_path / "classes.csv").write_text("table,0\nfigure,1\n")
    return tmp_path


def test_csv_dataset_classes_and_config_equal_reference(csv_dataset, tmp_path):
    import csv

    from tdnet.data.csv_dataset import CSVDataset as RefDataset
    from tdnet.data.csv_dataset import read_annotations as ref_read_annotations
    from tdnet.data.csv_dataset import read_classes as ref_read_classes
    from tdnet.utils.config import parse_anchor_parameters as ref_parse
    from tdnet.utils.config import read_config_file as ref_read_config
    from tdnet_torch.data.csv_dataset import CSVDataset, read_annotations, read_classes
    from tdnet_torch.utils.config import parse_anchor_parameters, read_config_file

    d = csv_dataset
    got = CSVDataset(str(d / "annotations.csv"), str(d / "classes.csv"))
    want = RefDataset(str(d / "annotations.csv"), str(d / "classes.csv"))
    assert got.classes == want.classes and got.image_names == want.image_names
    assert (got.size(), got.num_classes(), got.max_annotations()) == \
        (want.size(), want.num_classes(), want.max_annotations())
    for i in range(got.size()):
        assert got.image_aspect_ratio(i) == want.image_aspect_ratio(i)
        np.testing.assert_array_equal(got.load_image(i), want.load_image(i))
        for key in ("labels", "bboxes"):
            g, w = got.load_annotations(i)[key], want.load_annotations(i)[key]
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got.label_to_name(1) == "figure" and got.has_label(0) and not got.has_label(2)

    for bad in (["table,0", "table,1"], ["table,x"], ["table"]):
        with pytest.raises(ValueError) as e_got:
            read_classes(csv.reader(bad))
        with pytest.raises(ValueError) as e_want:
            ref_read_classes(csv.reader(bad))
        assert str(e_got.value) == str(e_want.value)
    for bad in (["a.png,5,6,4,30,table"], ["a.png,1,2,3,4,chair"], ["a.png,x,2,3,4,table"],
                ["a.png,1,2"]):
        with pytest.raises(ValueError) as e_got:
            read_annotations(csv.reader(bad), {"table": 0})
        with pytest.raises(ValueError) as e_want:
            ref_read_annotations(csv.reader(bad), {"table": 0})
        assert str(e_got.value) == str(e_want.value)

    cfg = tmp_path / "anchors.ini"
    cfg.write_text("[anchor_parameters]\nsizes = 16 32 64 128 256\n"
                   "ratios = 0.25 1 4\nscales = 1 1.5\n")
    got_a, want_a = parse_anchor_parameters(read_config_file(str(cfg))), \
        ref_parse(ref_read_config(str(cfg)))
    assert (got_a.sizes, got_a.strides, got_a.ratios, got_a.scales) == \
        (want_a.sizes, want_a.strides, want_a.ratios, want_a.scales)
    cfg.write_text("[anchor_parameters]\nsizes = 16 32\n")
    with pytest.raises(ValueError, match="equal length"):
        parse_anchor_parameters(read_config_file(str(cfg)))
    cfg.write_text("[anchor_parameters]\nbogus = 1\n")
    with pytest.raises(ValueError, match="unknown"):
        read_config_file(str(cfg))


def test_compute_overlap_equals_native():
    """Equal to tdnet.native's numpy version exactly, and to its C++
    library exactly on integer boxes (GT and page coordinates) and within
    1 ulp on fractional ones (g++ may contract the union's multiply-add)."""
    from tdnet.native import _compute_overlap_np, compute_overlap as ref
    from tdnet_torch.utils.eval import compute_overlap

    rng = np.random.RandomState(4)

    def boxes(n, integer):
        xy = rng.uniform(0, 100, (n, 2))
        wh = rng.uniform(-5, 60, (n, 2))  # some empty and inverted boxes
        b = np.concatenate([xy, xy + wh], 1)
        return np.round(b) if integer else b

    for integer in (True, False):
        a, b = boxes(300, integer), boxes(40, integer)
        got = compute_overlap(a, b)
        np.testing.assert_array_equal(got, _compute_overlap_np(a, b))
        if integer:
            np.testing.assert_array_equal(got, ref(a, b))
        else:
            np.testing.assert_allclose(got, ref(a, b), rtol=0, atol=4.5e-16)
    assert compute_overlap(np.zeros((0, 4)), b).shape == (0, 40)


class _StubPredictor:
    """Fixed detections per image: the GT boxes jittered, plus false
    positives, with scores that tie across images."""

    def __init__(self, dataset, batch_size):
        self.batch_size = batch_size
        rng = np.random.RandomState(5)
        self.out = {}
        for i in range(dataset.size()):
            ann = dataset.load_annotations(i)
            n = len(ann["labels"])
            boxes = np.concatenate([ann["bboxes"] + rng.normal(0, 3, (n, 4)),
                                    rng.uniform(0, 90, (4, 4)).cumsum(1)], 0)
            scores = np.concatenate([rng.choice([0.9, 0.6, 0.3], n),
                                     rng.choice([0.8, 0.04, 0.5], 4)])
            labels = np.concatenate([ann["labels"], rng.randint(0, 2, 4)])
            self.out[i] = (boxes, scores, labels)
        self.dataset = dataset
        self.calls = []

    def _lookup(self, image):
        for i in range(self.dataset.size()):
            if np.array_equal(image, self.dataset.load_image(i)):
                return self.out[i]
        raise KeyError

    def __call__(self, image):
        self.calls.append(1)
        return self._lookup(image)

    def predict_batch(self, images):
        self.calls.append(len(images))
        return [self._lookup(im) for im in images]


@pytest.mark.parametrize("batch_size", [1, 2])
def test_evaluate_equals_reference_exactly(csv_dataset, batch_size):
    from tdnet.data.csv_dataset import CSVDataset as RefDataset
    from tdnet.utils.eval import evaluate as ref_evaluate
    from tdnet_torch.data.csv_dataset import CSVDataset
    from tdnet_torch.utils.eval import evaluate

    d = csv_dataset
    ours = CSVDataset(str(d / "annotations.csv"), str(d / "classes.csv"))
    theirs = RefDataset(str(d / "annotations.csv"), str(d / "classes.csv"))
    for kw in (dict(), dict(iou_threshold=0.3, score_threshold=0.2, max_detections=3)):
        stub = _StubPredictor(ours, batch_size)
        got = evaluate(ours, stub, **kw)
        want = ref_evaluate(theirs, _StubPredictor(theirs, batch_size), **kw)
        assert got == want
        assert stub.calls == ([2, 1] if batch_size == 2 else [1, 1, 1])
    assert 0 < got[0][0] < 1 and got[0][1] == 2


@pytest.fixture(scope="module")
def tiny_bundle(tmp_path_factory):
    """A ResNet-50 RetinaNet .tdn with min_side = max_side = 64 (the class
    head spread as in tests/test_torch_predictor.py), 3 PNG pages of 80x80
    (resized to the 64x64 bucket) and a CSV dataset over them."""
    from tdnet_torch.models.io import save_model
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.weights import random_variables

    root = tmp_path_factory.mktemp("cli")
    v = random_variables(1, "resnet50", seed=0)
    v["params"]["classification_submodel"]["head"]["kernel"] *= 30.0
    v["params"]["classification_submodel"]["head"]["bias"][:] = -2.0
    save_model(str(root / "model.tdn"), RetinaNet(1), v,
               inference_config={"min_side": 64, "max_side": 64})
    rng = np.random.RandomState(6)
    rows = []
    for i in range(3):
        page = np.full((80, 80, 3), 235, np.uint8)
        x0, y0 = rng.randint(2, 30, 2)
        page[y0:y0 + 40, x0:x0 + 45] = rng.randint(0, 256, (40, 45, 3))
        write_image_bgr(root / f"page{i}.png", page)
        rows.append(f"page{i}.png,{x0},{y0},{x0 + 45},{y0 + 40},table")
    (root / "annotations.csv").write_text("\n".join(rows) + "\n")
    (root / "classes.csv").write_text("table,0\n")
    return root


def _jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_predict_and_evaluate_clis_on_cpu(tiny_bundle, tmp_path, capsys):
    """tdnet_torch.bin.predict --device cpu writes the JSONL of
    tdnet.bin.predict on the same bundle and pages: the same number of
    detections above the threshold, each matched by label, score (rtol /
    atol 1e-3) and box (1e-3 + 0.5 px), test_torch_predictor.py's
    tolerance; the annotated copies exist. tdnet_torch.bin.evaluate prints
    the reference's lines, for the bundle and for a checkpoint directory."""
    from tdnet.bin import predict as ref_predict
    from tdnet_torch.bin import evaluate, predict

    pages = [str(tiny_bundle / f"page{i}.png") for i in range(3)]
    model = str(tiny_bundle / "model.tdn")
    thr = "0.3"
    assert predict.main([model, *pages, "--output-dir", str(tmp_path / "port"),
                         "--score-threshold", thr, "--device", "cpu"]) == 0
    assert ref_predict.main([model, *pages, "--output-dir", str(tmp_path / "ref"),
                             "--score-threshold", thr]) == 0
    got, want = _jsonl(tmp_path / "port" / "detections.jsonl"), \
        _jsonl(tmp_path / "ref" / "detections.jsonl")
    n = 0
    for g, w in zip(got, want, strict=True):
        assert g["image"] == w["image"]
        assert len(g["detections"]) == len(w["detections"])
        for det in g["detections"]:
            ok = [c for c in w["detections"] if c["label"] == det["label"]
                  and abs(c["score"] - det["score"]) <= 1e-3 + 1e-3 * c["score"]
                  and np.all(np.abs(np.subtract(c["box"], det["box"]))
                             <= 0.5 + 1e-3 * np.abs(c["box"]))]
            assert ok, det
            n += 1
    assert n > 10
    for i in range(3):
        drawn = read_image_bgr(tmp_path / "port" / f"det_page{i}.png")
        assert drawn.shape == (80, 80, 3)

    capsys.readouterr()
    csv_args = ["csv", str(tiny_bundle / "annotations.csv"), str(tiny_bundle / "classes.csv")]
    size = ["--image-min-side", "64", "--image-max-side", "64", "--device", "cpu"]
    assert evaluate.main([*size, *csv_args, model]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("3 instances of class table with average precision: ")
    assert lines[1].startswith("mAP using the weighted average of precisions among classes: ")
    assert lines[2].startswith("mAP: ")

    from tdnet_torch.models.io import load_model
    from tdnet_torch.train.checkpoint import Checkpointer
    from tdnet_torch.train.step import create_optimizer, create_train_state

    net, variables, _ = load_model(model)
    state = create_train_state(net, variables, device="cpu",
                               optimizer=create_optimizer(1e-4, 1.0))
    Checkpointer(str(tmp_path / "ckpt")).save(0, state)
    assert evaluate.main([*size, *csv_args[:3], str(tmp_path / "ckpt")]) == 0
    assert capsys.readouterr().out.splitlines() == lines


def test_cli_options_the_port_does_not_run_yet(tiny_bundle, tmp_path, capsys):
    """A malformed --distributed exits with its usage, and one process is
    the plain run (two ranks: tests/test_torch_parallel.py); the other
    datasets are ported (a missing COCO root raises as in the reference); a
    keras .h5 model (ported) evaluates as the .tdn of the same weights
    does."""
    from tdnet_torch.bin import evaluate, predict
    from tdnet_torch.compat.keras_import import export_random_keras_weights
    from tdnet_torch.models.io import load_model

    csv_args = ["csv", str(tiny_bundle / "annotations.csv"), str(tiny_bundle / "classes.csv")]
    model = str(tiny_bundle / "model.tdn")
    cpu = ["--device", "cpu"]
    with pytest.raises(SystemExit, match="coordinator:port,num_processes,process_id"):
        evaluate.main([*cpu, "--distributed", "x:1,2", *csv_args, model])
    with pytest.raises(FileNotFoundError):  # .h5 is ported: as h5py, a missing file
        evaluate.main([*cpu, *csv_args, "weights.h5"])
    with pytest.raises(FileNotFoundError, match="instances_train2017.json"):
        evaluate.main([*cpu, "coco", "/nowhere", model])
    for main, argv in ((predict.main, [model, "p.png"]), (evaluate.main, [*csv_args, model])):
        with pytest.raises(SystemExit):  # --no-pallas on CUDA: argparse error
            main(["--no-pallas", *argv])
    export_random_keras_weights(str(tmp_path / "model.h5"), load_model(model)[1])
    size = ["--image-min-side", "64", "--image-max-side", "64", *cpu]
    capsys.readouterr()
    assert evaluate.main([*size, *csv_args, model]) == 0
    want = capsys.readouterr().out.splitlines()
    assert evaluate.main([*size, "--distributed", "127.0.0.1:1,1,0", *csv_args, model]) == 0
    assert capsys.readouterr().out.splitlines() == want
    assert evaluate.main([*size, *csv_args, str(tmp_path / "model.h5")]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith("keras h5 import: matched ")
    assert got[1:] == want

"""The table workflow's tools on the port against the reference's, on the
CPU: ``utils/coco_eval.py`` exactly equal to ``tdnet.utils.coco_eval``;
``bin/csv_from_xml`` byte-equal; ``bin/convert_model`` bundles read through
``tdnet.models.io.load_model`` (the reference's reader) with the
checkpoint's weights and the reference's inference settings;
``bin/export_keras`` ``.h5`` files dataset for dataset the reference's;
``bin/debug`` PNGs pixel-equal to ``tdnet.bin.debug``'s; ``predict
--labels`` pages equal to the reference's drawing of the port's JSONL; and
the port's ``evaluate --coco`` and ``train --coco-evaluation`` output in
the reference's format, at 64x96 with ResNet-50."""

import ctypes
import gc
import json
import os
import shutil

import numpy as np
import pytest
import torch

from tdnet_torch.data.image import read_image_bgr, write_image_bgr
from tdnet_torch.models.io import save_model
from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.weights import random_variables, variables_from_torch_state

torch.set_num_threads(1)  # tier-1 runs several xdist workers


@pytest.fixture(scope="module", autouse=True)
def _release_memory():
    """Trim the C heap that this module's ResNet-50 trees leave behind."""
    yield
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: nothing to trim
        pass


# ---------------------------------------------------------------- COCO eval


class _FakeDataset:
    """Images 0..n-1 with given ground truth; an image's pixels carry its
    index so that the predictor stub can look its detections up."""

    def __init__(self, gts, num_classes, names, areas=None):
        self.gts, self.n_cls, self.names, self.areas = gts, num_classes, names, areas

    def size(self):
        return len(self.gts)

    def num_classes(self):
        return self.n_cls

    def has_label(self, label):
        return 0 <= label < self.n_cls

    def label_to_name(self, label):
        return self.names[label]

    def load_image(self, i):
        return np.full((2, 2, 3), i, np.float32)

    def load_annotations(self, i):
        boxes, labels = self.gts[i]
        ann = {"bboxes": np.asarray(boxes, np.float64).reshape(-1, 4),
               "labels": np.asarray(labels, np.int64)}
        if self.areas is not None:
            ann["areas"] = np.asarray(self.areas[i], np.float64)
        return ann


class _Replay:
    def __init__(self, dets):
        self.dets = dets

    def __call__(self, image):
        return self.dets[int(image[0, 0, 0])]


def _coco_case(seed, n_images=7, with_areas=False):
    """Jittered copies of the ground truth at all sizes (small, medium and
    large boxes), false positives, tied scores, an empty image, an image
    with detections and no ground truth, and class 2 with no ground truth
    but detections."""
    rng = np.random.default_rng(seed)
    gts, dets, areas = [], [], []
    for i in range(n_images):
        if i == 0:
            gts.append(([], []))
            dets.append((np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64)))
            areas.append([])
            continue
        m = 0 if i == 1 else int(rng.integers(1, 6))
        xy = rng.uniform(0, 400, (m, 2))
        wh = rng.choice([12.0, 50.0, 140.0], (m, 1)) * rng.uniform(0.7, 1.4, (m, 2))
        boxes = np.concatenate([xy, xy + wh], axis=1)
        labels = rng.integers(0, 2, m)
        gts.append((boxes, labels))
        areas.append(((wh[:, 0] * wh[:, 1]) * rng.uniform(0.5, 1.2, m)).tolist())
        jitter = boxes + rng.normal(0, 0.08, boxes.shape) * np.tile(wh, 2)
        fp_xy = rng.uniform(0, 400, (3, 2))
        fps = np.concatenate([fp_xy, fp_xy + rng.uniform(10, 120, (3, 2))], axis=1)
        d_boxes = np.concatenate([jitter, jitter[: m // 2] + 3.0, fps])
        d_labels = np.concatenate([labels, labels[: m // 2], [0, 1, 2]])
        d_scores = rng.choice([0.9, 0.7, 0.7, 0.4, 0.2], len(d_boxes))
        dets.append((d_boxes, d_scores, d_labels))
    return gts, dets, (areas if with_areas else None)


@pytest.mark.parametrize("with_areas", [False, True])
@pytest.mark.parametrize("kw", [{}, {"score_threshold": 0.3, "max_detections": 4}])
def test_coco_eval_equals_reference_exactly(with_areas, kw):
    from tdnet.utils import coco_eval as ref
    from tdnet_torch.utils import coco_eval as port

    gts, dets, areas = _coco_case(1, with_areas=with_areas)
    ds = _FakeDataset(gts, 3, ["table", "figure", "chart"], areas)
    got = port.evaluate_coco(ds, _Replay(dets), **kw)
    want = ref.evaluate_coco(ds, _Replay(dets), **kw)
    assert list(got) == list(want)
    assert got == want  # exact, key for key
    assert port.summarize_coco(got) == ref.summarize_coco(want)
    assert "AP_chart" not in got and 0 < got["AP"] < 1


def test_coco_eval_without_detections_and_sharded():
    from tdnet.utils import coco_eval as ref
    from tdnet_torch.utils import coco_eval as port

    gts, dets, _ = _coco_case(2, n_images=3)
    none = [(np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64))] * 3
    ds = _FakeDataset(gts, 2, ["table", "figure"])
    got = port.evaluate_coco(ds, _Replay(none))
    assert got == ref.evaluate_coco(ds, _Replay(none))
    assert port.summarize_coco(got) == ref.summarize_coco(got)
    empty = _FakeDataset([([], [])] * 2, 1, ["table"])
    assert port.evaluate_coco(empty, _Replay(none)) == ref.evaluate_coco(empty, _Replay(none))
    # without a process group the sharded form is one process's, as in the
    # reference (two ranks: tests/test_torch_parallel.py)
    assert (port.evaluate_coco(ds, _Replay(dets), shard=True)
            == ref.evaluate_coco(ds, _Replay(dets), shard=True))


# ------------------------------------------------------------- csv_from_xml


def _voc(path, objects):
    body = "".join(
        f"<object><name>{name}</name>"
        + ("" if box is None else "<bndbox>" + "".join(
            f"<{k}>{v}</{k}>" for k, v in zip(("xmin", "ymin", "xmax", "ymax"), box))
            + "</bndbox>")
        + "</object>" for name, box in objects)
    path.write_text(f"<annotation><filename>x</filename>{body}</annotation>")


@pytest.fixture(scope="module")
def xml_tree(tmp_path_factory):
    """Pages of every listed extension, one without XML (a negative), one
    whose XML keeps nothing, float and degenerate boxes, mixed-case names,
    an object without a box, a non-image file."""
    root = tmp_path_factory.mktemp("xml")
    pages, xml = root / "pages", root / "xml"
    pages.mkdir()
    xml.mkdir()
    rng = np.random.default_rng(0)
    for i, ext in enumerate([".png", ".jpg", ".JPEG", ".bmp", ".tif", ".tiff", ".png",
                             ".png", ".png", ".png"]):
        (pages / f"p{i:02d}{ext}").write_bytes(b"x")
        if i == 3:
            continue  # no XML: a negative
        objects = []
        for _ in range(int(rng.integers(0, 4))):
            x, y = (int(v) for v in rng.integers(0, 500, 2))
            objects.append((str(rng.choice(["table", " Table ", "figure", "TABLE"])),
                            (x + 0.4, y, x + int(rng.integers(1, 200)), y + 37.6)))
        if i == 5:
            objects = [("table", (10, 10, 10, 40)), ("figure", None)]  # nothing kept
        if i == 6:
            objects.append(("table", (90, 80, 30, 120)))  # x2 < x1: dropped
        _voc(xml / f"p{i:02d}.xml", objects)
    (pages / "notes.txt").write_text("not an image")
    return root


@pytest.mark.parametrize("flags", [[], ["--val-split", "0.3", "--seed", "4"],
                                   ["--classes", "table", "--val-split", "0.5"],
                                   ["--class-name", "tab"]])
def test_csv_from_xml_equals_reference(xml_tree, tmp_path, capsys, flags):
    from tdnet.bin import csv_from_xml as ref
    from tdnet_torch.bin import csv_from_xml as port

    argv = [str(xml_tree / "pages"), "--xml-dir", str(xml_tree / "xml"), *flags]
    assert ref.main([*argv, "--out-dir", str(tmp_path / "ref")]) == 0
    want = capsys.readouterr().out.replace(str(tmp_path / "ref"), "OUT")
    assert port.main([*argv, "--out-dir", str(tmp_path / "port")]) == 0
    got = capsys.readouterr().out.replace(str(tmp_path / "port"), "OUT")
    assert got == want
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert ("val_annotations.csv" in names) == ("--val-split" in flags)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


# ------------------------------------------------------------ convert_model


def _checkpoint(directory, backbone, steps, num_classes=1, num_anchors=9):
    """The port's checkpoints of one model at each step, its weights
    changed between them; returns each step's variables."""
    from tdnet_torch.train.checkpoint import Checkpointer
    from tdnet_torch.train.step import create_optimizer, create_train_state

    net = RetinaNet(num_classes, backbone, num_anchors=num_anchors)
    variables = random_variables(num_classes, backbone, seed=5, num_anchors=num_anchors)
    state = create_train_state(net, variables, device="cpu",
                               optimizer=create_optimizer(1e-5, 1e-3))
    ckpt, saved = Checkpointer(str(directory)), {}
    for step in steps:
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(0.01 * step)
        ckpt.save(step, state)
        saved[step] = variables_from_torch_state(
            {k: v.clone() for k, v in state.model.state_dict().items()})
    return saved


def _reference_inference(argv, monkeypatch):
    """What tdnet.bin.convert_model passes to save_model for ``argv``: its
    checkpoint reader and model init stubbed (no orbax snapshot)."""
    from tdnet.bin import convert_model as ref
    from tdnet.models import backbone as registry

    seen = {}

    class Model:
        def init(self, *a):
            return {"params": {}, "batch_stats": {}}

    class Backbone:
        def __init__(self, name):
            self.preprocess_mode = registry(name).preprocess_mode

        def retinanet(self, *a, **k):
            return Model()

    class Ckpt:
        def __init__(self, directory):
            pass

        def latest_step(self):
            return 0

        def restore_weights(self, params, stats, step=None):
            return params, stats

    def save(path, model, variables, anchor_params=None, inference_config=None):
        seen.update(anchors=anchor_params, inference=inference_config)

    monkeypatch.setattr(ref, "backbone_registry", Backbone)
    monkeypatch.setattr(ref, "Checkpointer", Ckpt)
    monkeypatch.setattr(ref, "save_model", save)
    assert ref.main(argv) == 0
    return seen


def _assert_tree_equal(got, want, prefix=()):
    assert sorted(got) == sorted(want), prefix
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], prefix + (k,))
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, prefix + (k,)
            np.testing.assert_array_equal(g, w, err_msg=str(prefix + (k,)))


ANCHORS_INI = """[anchor_parameters]
sizes   = 32 64 128 256 512
strides = 8 16 32 64 128
ratios  = 0.25 0.5 1 2
scales  = 1 1.26 1.587
"""


@pytest.mark.parametrize("backbone,flags,step", [
    ("resnet50", [], 3),
    ("mobilenet_0.5", ["--step", "1", "--no-nms", "--no-class-specific-filter",
                       "--score-threshold", "0.2", "--nms-threshold", "0.4",
                       "--max-detections", "50", "--soft-nms-sigma", "0.5",
                       "--image-min-side", "600", "--image-max-side", "1000",
                       "--num-classes", "2", "--config", "anchors.ini"], 1)])
def test_convert_model_reads_through_the_reference(tmp_path, monkeypatch, capsys,
                                                   backbone, flags, step):
    from tdnet.models.io import DEFAULT_INFERENCE_CONFIG
    from tdnet.models.io import load_model as ref_load
    from tdnet_torch.bin import convert_model

    (tmp_path / "anchors.ini").write_text(ANCHORS_INI)
    monkeypatch.chdir(tmp_path)
    n_cls = 2 if "--num-classes" in flags else 1
    n_anchors = 12 if "--config" in flags else 9
    saved = _checkpoint(tmp_path / "ckpt", backbone, [step] if step > 1 else [1, 3],
                        n_cls, n_anchors)
    argv = ["ckpt", "out/model.tdn", "--backbone", backbone, *flags]
    assert convert_model.main(argv) == 0
    assert capsys.readouterr().out == f"converted step-{step} snapshot -> out/model.tdn\n"
    model, variables, meta = ref_load("out/model.tdn")
    assert (model.backbone_name, model.num_classes, model.num_anchors) == \
        (backbone, n_cls, n_anchors)
    _assert_tree_equal(variables, saved[step])
    seen = _reference_inference(argv, monkeypatch)
    assert meta["inference"] == {**DEFAULT_INFERENCE_CONFIG, **seen["inference"]}
    if seen["anchors"] is None:
        assert meta["anchors"] is None
    else:
        assert {k: tuple(v) for k, v in meta["anchors"].items()} == vars(seen["anchors"])
    shutil.rmtree(tmp_path / "ckpt")


def test_convert_model_refuses_orbax_and_missing_snapshots(tmp_path):
    from tdnet_torch.bin import convert_model

    (tmp_path / "orbax" / "7" / "default").mkdir(parents=True)
    with pytest.raises(ValueError, match="tdnet.bin.convert_model"):
        convert_model.main([str(tmp_path / "orbax"), str(tmp_path / "m.tdn")])
    with pytest.raises(FileNotFoundError):
        convert_model.main([str(tmp_path / "nowhere"), str(tmp_path / "m.tdn")])
    assert not (tmp_path / "nowhere").exists()


# ------------------------------------------------------------- export_keras


def _h5_contents(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(
            name, (obj.dtype.str, obj.shape, obj[()].tobytes())
            if isinstance(obj, h5py.Dataset) else "group"))
    return out


@pytest.mark.parametrize("backbone", ["resnet50", "mobilenet_0.5"])
def test_export_keras_equals_reference(tmp_path, capsys, backbone):
    from tdnet.bin import export_keras as ref
    from tdnet_torch.bin import export_keras as port

    with torch.device("meta"):
        record = RetinaNet(1, backbone)
    save_model(str(tmp_path / "m.tdn"), record, random_variables(1, backbone, seed=2))
    assert port.main([str(tmp_path / "m.tdn"), str(tmp_path / "port" / "w.h5")]) == 0
    assert ref.main([str(tmp_path / "m.tdn"), str(tmp_path / "ref" / "w.h5")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(tmp_path / "port"), str(tmp_path / "ref")) == out[1]
    got, want = _h5_contents(tmp_path / "port" / "w.h5"), _h5_contents(tmp_path / "ref" / "w.h5")
    assert list(got) == list(want)
    assert got == want
    assert sum(v != "group" for v in got.values()) > 100


def test_export_keras_refuses_se_resnet_as_the_reference(tmp_path):
    from tdnet.bin import export_keras as ref
    from tdnet_torch.bin import export_keras as port

    with torch.device("meta"):
        record = RetinaNet(1, "seresnet50")
    save_model(str(tmp_path / "se.tdn"), record, {"params": {}, "batch_stats": {}})
    errors = []
    for main in (port.main, ref.main):
        with pytest.raises(ValueError) as e:
            main([str(tmp_path / "se.tdn"), str(tmp_path / "se.h5")])
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "SE-ResNet" in errors[0]


# -------------------------------------------------------------------- debug


def test_debug_pngs_equal_reference(tmp_path, capsys):
    """Two pages at 64x96 with --anchors: a box anchors match (green), a
    tiny one they do not (red), captions at the top border; and --limit."""
    from tdnet.bin import debug as ref
    from tdnet_torch.bin import debug as port

    rng = np.random.default_rng(4)
    rows = []
    for i, boxes in enumerate([[(8, 30, 60, 64, "table"), (70, 25, 76, 31, "figure")],
                               [(30, 28, 90, 66, "table")]]):
        page = rng.integers(150, 256, (70, 100, 3)).astype(np.uint8)
        write_image_bgr(tmp_path / f"page{i}.png", page)
        rows += [f"page{i}.png,{x1},{y1},{x2},{y2},{c}" for x1, y1, x2, y2, c in boxes]
    (tmp_path / "ann.csv").write_text("\n".join(rows) + "\n")
    (tmp_path / "classes.csv").write_text("table,0\nfigure,1\n")
    outs = {}
    for name, main in (("ref", ref.main), ("port", port.main)):
        argv = ["--output-dir", str(tmp_path / name), "--image-min-side", "64",
                "--image-max-side", "96", "--anchors", "csv", str(tmp_path / "ann.csv"),
                str(tmp_path / "classes.csv")]
        assert main(argv) == 0
        outs[name] = capsys.readouterr().out.replace(str(tmp_path / name), "OUT")
    assert outs["port"] == outs["ref"]
    assert "2 boxes" in outs["port"] and "positive anchors" in outs["port"]
    for i in range(2):
        got = read_image_bgr(tmp_path / "port" / f"debug_{i:05d}.png")
        want = read_image_bgr(tmp_path / "ref" / f"debug_{i:05d}.png")
        np.testing.assert_array_equal(got, want)
        assert (got[..., 1] == 255).any() and (got == 0).all(axis=2).any()  # box, caption
    assert port.main(["--output-dir", str(tmp_path / "one"), "--limit", "1",
                      "--image-min-side", "64", "--image-max-side", "96", "csv",
                      str(tmp_path / "ann.csv"), str(tmp_path / "classes.csv")]) == 0
    assert os.listdir(tmp_path / "one") == ["debug_00000.png"]


# ------------------------------------- predict --labels, evaluate, train CLIs


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A ResNet-50 .tdn at min_side 64 / max_side 96 whose class head is
    spread (as in tests/test_torch_cli.py), 3 PNG pages with ruled tables,
    and CSVs over them (val: pages 0 and 1)."""
    root = tmp_path_factory.mktemp("workflow")
    v = random_variables(1, "resnet50", seed=0)
    v["params"]["classification_submodel"]["head"]["kernel"] *= 30.0
    v["params"]["classification_submodel"]["head"]["bias"][:] = -2.0
    with torch.device("meta"):
        record = RetinaNet(1)
    save_model(str(root / "model.tdn"), record, v,
               inference_config={"min_side": 64, "max_side": 96})
    rng = np.random.RandomState(0)
    rows = []
    for i in range(3):
        page = np.clip(rng.normal(235, 8, (64, 96, 3)), 0, 255).astype(np.uint8)
        x0, y0 = rng.randint(2, 40), rng.randint(2, 20)
        x1, y1 = x0 + rng.randint(25, 50), y0 + rng.randint(20, 40)
        page[y0:y1:6, x0:x1] = 30
        page[y0:y1, x0:x1:10] = 30
        write_image_bgr(root / f"page{i}.png", page)
        rows.append(f"page{i}.png,{x0},{y0},{x1},{y1},table")
    (root / "ann.csv").write_text("\n".join(rows) + "\n")
    (root / "val.csv").write_text("\n".join(rows[:2]) + "\n")
    (root / "classes.csv").write_text("table,0\n")
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _unambiguous(det, height, width) -> bool:
    """True if the JSONL's rounding cannot have changed the drawing: no box
    coordinate rounded onto an integer (int() of the unrounded value may be
    one less) other than the clip bounds (0 and, for a page the predictor
    does not resize, its width and height) and no score rounded onto a
    2-decimal tie."""
    bounds = ((0, width), (0, height)) * 2
    if any(float(v) == int(v) and v not in b for v, b in zip(det["box"], bounds)):
        return False
    return abs((det["score"] * 100) % 1 - 0.5) > 1e-6


def test_predict_labels_draws_the_reference_captions(tiny, tmp_path):
    """Each annotated page equals the reference's draw_detections with the
    class names: of the predictor's detections, and of the JSONL's where
    its rounding cannot matter."""
    from tdnet.utils.visualization import draw_detections
    from tdnet_torch.bin import predict

    pages = [str(tiny / f"page{i}.png") for i in range(3)]
    argv = [str(tiny / "model.tdn"), *pages, "--labels", str(tiny / "classes.csv"),
            "--output-dir", str(tmp_path), "--device", "cpu"]
    assert predict.main(argv) == 0
    predictor = predict.predictor_from_bundle(argv[0], predict.parse_args(argv))
    records = [json.loads(line) for line in
               (tmp_path / "detections.jsonl").read_text().splitlines()]
    names = {0: "table"}.get
    n, from_jsonl = 0, 0
    for path, rec in zip(pages, records, strict=True):
        page = read_image_bgr(path).astype(np.uint8)
        got = read_image_bgr(tmp_path / f"det_{os.path.basename(path)}")
        want = page.copy()
        draw_detections(want, *predictor(read_image_bgr(path)), label_to_name=names)
        np.testing.assert_array_equal(got, want)
        dets = rec["detections"]
        if all(_unambiguous(d, *page.shape[:2]) for d in dets):
            want = page.copy()
            draw_detections(want, np.array([d["box"] for d in dets]).reshape(-1, 4),
                            np.array([d["score"] for d in dets]),
                            np.array([d["label"] for d in dets]), label_to_name=names)
            np.testing.assert_array_equal(got, want)
            from_jsonl += 1
        n += len(dets)
        if dets:  # caption pixels: the white text, where the page was not white
            assert ((got == 255).all(axis=2) & (page != 255).any(axis=2)).any()
    assert n >= 3 and from_jsonl >= 1


def test_evaluate_coco_prints_the_reference_summary(tiny, capsys, monkeypatch):
    from tdnet.data.csv_dataset import CSVDataset as RefDataset
    from tdnet.utils import coco_eval as ref
    from tdnet_torch.bin import evaluate

    seen = {}
    real = evaluate.evaluate_coco

    def spy(dataset, predictor, **kw):
        seen.update(predictor=predictor, kw=kw)
        return real(dataset, predictor, **kw)

    monkeypatch.setattr(evaluate, "evaluate_coco", spy)
    argv = ["--image-min-side", "64", "--image-max-side", "96", "--device", "cpu",
            "csv", str(tiny / "ann.csv"), str(tiny / "classes.csv"), str(tiny / "model.tdn")]
    assert evaluate.main([*argv[:6], "--coco", *argv[6:]]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert evaluate.main(argv) == 0
    voc = capsys.readouterr().out.splitlines()
    assert lines[:3] == voc
    # the reference's summary of the same detections
    ds = RefDataset(str(tiny / "ann.csv"), str(tiny / "classes.csv"))
    want = ref.evaluate_coco(ds, seen["predictor"], **seen["kw"])
    assert lines[3:] == [*ref.summarize_coco(want).splitlines(),
                         f"AP_table: {want['AP_table']:.4f}"]
    # one process: not sharded (the reference's CLI passes shard= too)
    assert seen["kw"] == {"score_threshold": 0.05, "max_detections": 100, "shard": False}


def test_train_coco_evaluation_logs_the_coco_keys(tiny, tmp_path):
    from tdnet.utils.coco_eval import _SUMMARY_ROWS
    from tdnet_torch.bin import train

    argv = ["--device", "cpu", "--image-min-side", "64", "--image-max-side", "96",
            "--epochs", "1", "--steps", "1", "--no-snapshots", "--coco-evaluation",
            "--weights", str(tiny / "model.tdn"),
            "--metrics-path", str(tmp_path / "metrics.jsonl"),
            "--tensorboard-dir", str(tmp_path / "tb"),
            "csv", str(tiny / "ann.csv"), str(tiny / "classes.csv"),
            "--val-annotations", str(tiny / "val.csv")]
    assert train.main(argv) == 0
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    epoch = [r for r in records if "AP" in r]
    assert len(epoch) == 1
    keys = [k for k, *_ in _SUMMARY_ROWS] + ["AP_table"]
    assert all(isinstance(epoch[0][k], float) for k in keys)
    assert "mAP" not in epoch[0]
    from tdnet_torch.train.events import read_events

    (event_file,) = os.listdir(tmp_path / "tb")
    tags = {v["tag"] for e in read_events(str(tmp_path / "tb" / event_file))
            for v in e["values"]}
    assert set(keys) <= tags

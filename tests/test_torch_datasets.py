"""The port's Pascal VOC, COCO, KITTI and Open Images datasets against
``tdnet.data``'s on the same fixture trees (JPEG pages written by PIL, PNG
for KITTI): classes, labels, every annotation, path, aspect ratio and page
(exactly), each format's options and error messages. Then the slice as a
whole: the port's BatchLoader over a JPEG Pascal VOC set against tdnet's
loader over the reference dataset, the port's ``evaluate pascal`` against
its ``evaluate csv`` on PNG copies of the decoded pages, and
``make_dataset`` for every subcommand against tdnet's."""

import argparse
import json
import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from tdnet_torch.data.coco import CocoDataset
from tdnet_torch.data.kitti import KittiDataset
from tdnet_torch.data.open_images import OpenImagesDataset
from tdnet_torch.data.pascal_voc import VOC_CLASSES, PascalVocDataset

torch.set_num_threads(1)  # tier-1 runs several xdist workers

SHAPES = [(37, 53), (60, 45), (48, 64), (30, 70)]  # (h, w); none on the MCU grid


def _page(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 0)


def _jpeg(path, shape, seed, exif6=False):
    path.parent.mkdir(parents=True, exist_ok=True)
    kw = {}
    if exif6:  # PIL's .size and the port's image_size both ignore it
        exif = Image.Exif()
        exif[0x0112] = 6
        kw["exif"] = exif.tobytes()
    Image.fromarray(_page(shape, seed)).save(path, "JPEG", quality=90, **kw)


def _voc_object(name, box, truncated=0, difficult=0):
    coords = "".join(f"<{k}>{v}</{k}>" for k, v in zip(("xmin", "ymin", "xmax", "ymax"), box))
    return (f"<object><name>{name}</name><truncated>{truncated}</truncated>"
            f"<difficult>{difficult}</difficult><bndbox>{coords}</bndbox></object>")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tree of each format over JPEG pages (KITTI: PNG)."""
    root = tmp_path_factory.mktemp("datasets")
    rng = np.random.default_rng(0)
    names = [f"2008_{i:06d}" for i in range(len(SHAPES))]
    voc = root / "voc"
    (voc / "ImageSets" / "Main").mkdir(parents=True)
    (voc / "Annotations").mkdir()
    for i, (name, (h, w)) in enumerate(zip(names, SHAPES)):
        _jpeg(voc / "JPEGImages" / f"{name}.jpg", (h, w), i)
        objs = []
        for k in range(1 + i % 3):
            x0, y0 = int(rng.integers(1, w // 2)), int(rng.integers(1, h // 2))
            objs.append(_voc_object(("diningtable", "person", "chair")[k],
                                    (x0, y0, x0 + int(rng.integers(5, w // 2)),
                                     y0 + int(rng.integers(5, h // 2))),
                                    truncated=int(k == 1), difficult=int(k == 2)))
        (voc / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><filename>{name}.jpg</filename>{''.join(objs)}</annotation>")
    (voc / "ImageSets" / "Main" / "trainval.txt").write_text(
        "\n".join(names[:3]) + "\n\n")
    (voc / "ImageSets" / "Main" / "test.txt").write_text(
        "\n".join(f"{n} 1" for n in names[2:]) + "\n")

    coco = root / "coco"
    (coco / "annotations").mkdir(parents=True)
    images, anns = [], []
    for i, (h, w) in enumerate(SHAPES):
        _jpeg(coco / "images" / "val" / f"{i:012d}.jpg", (h, w), 10 + i)
        images.append({"id": 100 + i, "file_name": f"{i:012d}.jpg", "width": w, "height": h})
        for k in range(3 if i != 3 else 0):  # the last page has no objects
            x, y = float(rng.uniform(0, w / 2)), float(rng.uniform(0, h / 2))
            bw = [float(rng.uniform(3, w / 2)), 0.5, float(rng.uniform(3, w / 2))][k]
            anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                         "category_id": (67, 1, 67)[k], "bbox": [x, y, bw, 9.0],
                         "iscrowd": int(k == 2 and i == 1), "area": bw * 9.0 * 0.8})
    categories = [{"id": 67, "name": "table"}, {"id": 1, "name": "figure"},
                  {"id": 30, "name": "caption"}]
    (coco / "annotations" / "instances_val.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": categories}))

    kitti = root / "kitti"
    for subset, first in (("train", 0), ("val", 3)):
        (kitti / subset / "images").mkdir(parents=True)
        (kitti / subset / "labels").mkdir()
        for i in range(first, first + (3 if subset == "train" else 1)):
            h, w = SHAPES[i]
            Image.fromarray(_page((h, w), 20 + i)).save(kitti / subset / "images" / f"{i:06d}.png")
            rows = [f"{c} 0.00 0 -1.5 {x0:.2f} {y0:.2f} {x0 + 9.5:.2f} {y0 + 7.25:.2f} "
                    "1.5 1.6 3.9 1.8 1.5 8.5 0.0"
                    for c, x0, y0 in (("Car", 3.0 + i, 4.0), ("Pedestrian", 10.5, 2.25 + i))]
            (kitti / subset / "labels" / f"{i:06d}.txt").write_text("\n".join(rows) + "\n\n")

    oi = root / "oi"
    (oi / "annotations").mkdir(parents=True)
    (oi / "annotations" / "class-descriptions-boxable.csv").write_text(
        "/m/04bcr3,Table\n/m/0c_jw,Furniture\n/m/01g317,Person\n/m/bad\n")
    rows = ["ImageID,Source,LabelName,Confidence,XMin,XMax,YMin,YMax,IsOccluded"]
    for i, (h, w) in enumerate(SHAPES):
        _jpeg(oi / "images" / "train" / f"img{i}.jpg", (h, w), 30 + i, exif6=(i == 1))
        for mid in ("/m/04bcr3", "/m/0c_jw", "/m/01g317", "/m/unknown")[:2 + i % 3]:
            x0, y0 = (float(v) for v in rng.uniform(0, 0.5, 2))
            rows.append(f"img{i},xclick,{mid},1,{x0:.6f},{x0 + 0.3:.6f},{y0:.6f},"
                        f"{y0 + 0.25:.6f},0")
    (oi / "annotations" / "train-annotations-bbox.csv").write_text("\n".join(rows) + "\n")
    return {"root": root, "voc": voc, "coco": coco, "kitti": kitti, "oi": oi}


def _same(port, ref):
    """Every member of the Dataset protocol, each page exactly."""
    assert port.size() == ref.size() > 0
    assert port.num_classes() == ref.num_classes()
    assert port.classes == ref.classes and port.labels == ref.labels
    for label, name in ref.labels.items():
        assert port.has_label(label) and port.label_to_name(label) == name
        assert port.name_to_label(name) == label
    assert not port.has_label(-1) and not ref.has_label(-1)
    for i in range(ref.size()):
        assert port.image_path(i) == ref.image_path(i)
        assert port.image_aspect_ratio(i) == ref.image_aspect_ratio(i)
        got, want = port.load_annotations(i), ref.load_annotations(i)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        img, want_img = port.load_image(i), ref.load_image(i)
        assert img.dtype == want_img.dtype == np.float32
        np.testing.assert_array_equal(img, want_img)


@pytest.mark.parametrize("options", [{}, {"skip_truncated": True}, {"skip_difficult": True},
                                     {"skip_truncated": True, "skip_difficult": True}],
                         ids=["all", "no_truncated", "no_difficult", "neither"])
@pytest.mark.parametrize("set_name", ["trainval", "test"])
def test_pascal_voc_equals_reference(trees, set_name, options):
    from tdnet.data.pascal_voc import VOC_CLASSES as REF_CLASSES
    from tdnet.data.pascal_voc import PascalVocDataset as Ref

    assert VOC_CLASSES == REF_CLASSES
    _same(PascalVocDataset(str(trees["voc"]), set_name, **options),
          Ref(str(trees["voc"]), set_name, **options))


def test_pascal_voc_errors_equal_reference(trees, tmp_path):
    """Unknown class, missing element and malformed XML raise the
    reference's messages; custom classes and image extensions pass
    through."""
    from tdnet.data.pascal_voc import PascalVocDataset as Ref

    voc = tmp_path / "voc"
    (voc / "ImageSets" / "Main").mkdir(parents=True)
    (voc / "Annotations").mkdir()
    bodies = {"unknown": _voc_object("table", (1, 2, 3, 4)),
              "missing": "<object><name>person</name><bndbox><xmin>1</xmin></bndbox></object>",
              "malformed": "<object><name>person</name>"}
    for name, body in bodies.items():
        (voc / "Annotations" / f"{name}.xml").write_text(f"<annotation>{body}</annotation>"
                                                         if name != "malformed" else body)
    (voc / "ImageSets" / "Main" / "all.txt").write_text("\n".join(bodies) + "\n")
    port, ref = PascalVocDataset(str(voc), "all"), Ref(str(voc), "all")
    for i in range(len(bodies)):
        with pytest.raises(ValueError) as want:
            ref.load_annotations(i)
        with pytest.raises(ValueError) as got:
            port.load_annotations(i)
        assert str(got.value) == str(want.value)
    custom = {"table": 0, "person": 1}
    p = PascalVocDataset(str(trees["voc"]), "trainval", classes=custom, image_extension=".jpeg")
    r = Ref(str(trees["voc"]), "trainval", classes=custom, image_extension=".jpeg")
    assert p.num_classes() == r.num_classes() == 2 and p.image_path(0) == r.image_path(0)


@pytest.mark.parametrize("include_crowd", [False, True], ids=["no_crowd", "crowd"])
def test_coco_equals_reference(trees, include_crowd):
    """Labels ordered by category id, the label maps both ways, crowd and
    degenerate (w < 1) boxes, areas, and a page without objects."""
    from tdnet.data.coco import CocoDataset as Ref

    port = CocoDataset(str(trees["coco"]), "val", include_crowd=include_crowd)
    ref = Ref(str(trees["coco"]), "val", include_crowd=include_crowd)
    _same(port, ref)
    assert port.coco_labels == ref.coco_labels == {0: 1, 1: 30, 2: 67}
    assert port.coco_labels_inverse == ref.coco_labels_inverse
    for label, cid in ref.coco_labels.items():
        assert port.label_to_coco_label(label) == cid
        assert port.coco_label_to_label(cid) == label
    counts = [len(port.load_annotations(i)["labels"]) for i in range(port.size())]
    assert counts == ([2, 2, 2, 0] if include_crowd else [2, 1, 2, 0])


def test_kitti_equals_reference(trees, tmp_path):
    from tdnet.data.kitti import KITTI_CLASSES
    from tdnet.data.kitti import KittiDataset as Ref

    from tdnet_torch.data.kitti import KITTI_CLASSES as PORT_CLASSES

    assert PORT_CLASSES == KITTI_CLASSES
    for subset in ("train", "val"):
        _same(KittiDataset(str(trees["kitti"]), subset), Ref(str(trees["kitti"]), subset))
    bad = tmp_path / "kitti" / "train"
    (bad / "images").mkdir(parents=True)
    (bad / "labels").mkdir()
    Image.fromarray(_page((8, 8), 0)).save(bad / "images" / "0.png")
    (bad / "labels" / "0.txt").write_text("Boat 0 0 0 1 2 3 4\n")
    for cls in (KittiDataset, Ref):
        with pytest.raises(ValueError, match="unknown KITTI class 'Boat'"):
            cls(str(tmp_path / "kitti"), "train")


@pytest.mark.parametrize("labels_filter", [None, ["Table"], ["Person", "Table", "Nothing"]],
                         ids=["all", "table", "two"])
def test_open_images_equals_reference(trees, labels_filter):
    """Boxes denormalised against each page's header size (one page
    carries EXIF orientation 6, which PIL's .size ignores too); the label
    filter; rows of unknown classes dropped."""
    from tdnet.data.open_images import OpenImagesDataset as Ref

    _same(OpenImagesDataset(str(trees["oi"]), "train", labels_filter=labels_filter),
          Ref(str(trees["oi"]), "train", labels_filter=labels_filter))


def test_batch_loader_over_jpeg_pascal_equals_reference(trees):
    """The port's BatchLoader over a JPEG Pascal VOC set gives batches
    bit-equal to tdnet's BatchLoader over the reference dataset: images,
    boxes, labels, scales, buckets, for two shuffled epochs (host side)."""
    from tdnet.data.generator import BatchLoader as RefLoader
    from tdnet.data.generator import LoaderConfig as RefConfig
    from tdnet.data.pascal_voc import PascalVocDataset as Ref

    from tdnet_torch.data.generator import BatchLoader, LoaderConfig

    for device_normalize in (False, True):
        kw = dict(batch_size=2, seed=3, min_side=40, max_side=72,
                  device_normalize=device_normalize)
        ref = RefLoader(Ref(str(trees["voc"]), "trainval"),
                        RefConfig(process_index=0, process_count=1, **kw))
        port = BatchLoader(PascalVocDataset(str(trees["voc"]), "trainval"), LoaderConfig(**kw))
        assert port.steps_per_epoch() == ref.steps_per_epoch()
        want = [b for _ in range(2) for b in ref.epoch()]
        got = [b for _ in range(2) for b in port.epoch()]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def voc_bundle(tmp_path_factory):
    """A 20-class ResNet-50 RetinaNet .tdn at min_side = max_side = 64, its
    class head spread as in tests/test_torch_predictor.py."""
    from tdnet_torch.models.io import save_model
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.weights import random_variables

    path = tmp_path_factory.mktemp("bundle") / "voc20.tdn"
    v = random_variables(20, "resnet50", seed=1)
    v["params"]["classification_submodel"]["head"]["kernel"] *= 30.0
    v["params"]["classification_submodel"]["head"]["bias"][:] = -2.0
    save_model(str(path), RetinaNet(20), v, inference_config={"min_side": 64, "max_side": 64})
    return path


def test_evaluate_pascal_equals_evaluate_csv_on_png_copies(trees, voc_bundle, tmp_path, capsys):
    """``evaluate pascal`` on the JPEG pages prints what ``evaluate csv``
    prints on PNG copies of the same decoded pixels with the same boxes
    (CPU, 64-pixel sides)."""
    from tdnet_torch.bin import evaluate
    from tdnet_torch.data.image import write_image_bgr

    ds = PascalVocDataset(str(trees["voc"]), "test")
    rows = []
    for i in range(ds.size()):
        png = tmp_path / f"page{i}.png"
        write_image_bgr(png, ds.load_image(i).astype(np.uint8))
        ann = ds.load_annotations(i)
        for box, label in zip(ann["bboxes"], ann["labels"]):
            rows.append(f"{png},{','.join(str(int(v)) for v in box)},{ds.label_to_name(label)}")
    (tmp_path / "annotations.csv").write_text("\n".join(rows) + "\n")
    (tmp_path / "classes.csv").write_text(
        "".join(f"{name},{i}\n" for name, i in sorted(VOC_CLASSES.items(), key=lambda x: x[1])))
    common = ["--device", "cpu", "--image-min-side", "64", "--image-max-side", "64",
              "--score-threshold", "0.05"]
    capsys.readouterr()
    assert evaluate.main([*common, "pascal", str(trees["voc"]), str(voc_bundle),
                          "--set-name", "test"]) == 0
    via_pascal = capsys.readouterr().out.splitlines()
    assert evaluate.main([*common, "csv", str(tmp_path / "annotations.csv"),
                          str(tmp_path / "classes.csv"), str(voc_bundle)]) == 0
    via_csv = capsys.readouterr().out.splitlines()
    assert via_pascal == via_csv
    assert len(via_pascal) == 22 and via_pascal[-1].startswith("mAP: ")


def _parse(argv):
    from tdnet_torch.bin._common import add_dataset_args

    parser = argparse.ArgumentParser()
    add_dataset_args(parser, trailing=[("model", "model")])
    return parser.parse_args(argv)


def test_make_dataset_every_subcommand_equals_reference(trees, tmp_path):
    """make_dataset builds each subcommand's train and val datasets as
    tdnet's does (same class, split and label filter)."""
    from tdnet.bin._common import make_dataset as ref_make

    from tdnet_torch.bin._common import make_dataset

    (tmp_path / "ann.csv").write_text("a.png,1,2,3,4,table\n")
    (tmp_path / "cls.csv").write_text("table,0\n")
    (trees["coco"] / "annotations" / "instances_train.json").write_text(
        (trees["coco"] / "annotations" / "instances_val.json").read_text())
    (trees["coco"] / "images" / "train").mkdir(exist_ok=True)
    (trees["oi"] / "annotations" / "validation-annotations-bbox.csv").write_text(
        (trees["oi"] / "annotations" / "train-annotations-bbox.csv").read_text())
    cases = [
        ["csv", str(tmp_path / "ann.csv"), str(tmp_path / "cls.csv"), "m",
         "--val-annotations", str(tmp_path / "ann.csv")],
        ["csv", str(tmp_path / "ann.csv"), str(tmp_path / "cls.csv"), "m"],
        ["pascal", str(trees["voc"]), "m"],
        ["pascal", str(trees["voc"]), "m", "--set-name", "test", "--val-set-name", "trainval"],
        ["coco", str(trees["coco"]), "m", "--set-name", "train", "--val-set-name", "val"],
        ["kitti", str(trees["kitti"]), "m"],
        ["open_images", str(trees["oi"]), "m", "--labels-filter", "Table,Person"],
        ["open_images", str(trees["oi"]), "m"],
    ]
    for argv in cases:
        args = _parse(argv)
        for split in ("train", "val"):
            got, want = make_dataset(args, split), ref_make(args, split)
            if want is None:
                assert got is None, argv
                continue
            assert type(got).__name__ == type(want).__name__, argv
            assert got.size() == want.size() and got.classes == want.classes, (argv, split)
            assert got.image_path(0) == want.image_path(0), (argv, split)
    with pytest.raises(ValueError, match="split"):
        make_dataset(_parse(cases[2]), "split")


def test_dataset_help_names_no_missing_port():
    """The subcommands' help no longer says "not ported"."""
    from tdnet_torch.bin._common import add_dataset_args

    parser = argparse.ArgumentParser()
    add_dataset_args(parser)
    text = parser.format_help()
    assert "not ported" not in text
    for kind in ("csv", "pascal", "coco", "kitti", "open_images"):
        assert kind in text


def test_datasets_read_bmp_pages_as_reference(tmp_path):
    """A VOC set whose pages are BMP (image_extension=".bmp"): pages and
    aspect ratios equal the reference's."""
    from tdnet.data.pascal_voc import PascalVocDataset as Ref

    voc = tmp_path / "voc"
    (voc / "ImageSets" / "Main").mkdir(parents=True)
    (voc / "Annotations").mkdir()
    (voc / "JPEGImages").mkdir()
    for i, (h, w) in enumerate(SHAPES[:2]):
        Image.fromarray(_page((h, w), 40 + i)).convert("P").save(voc / "JPEGImages" / f"b{i}.bmp")
        (voc / "Annotations" / f"b{i}.xml").write_text(
            f"<annotation>{_voc_object('sofa', (2, 3, 20, 21))}</annotation>")
    (voc / "ImageSets" / "Main" / "trainval.txt").write_text("b0\nb1\n")
    assert struct.unpack("<H", (voc / "JPEGImages" / "b0.bmp").read_bytes()[28:30])[0] == 8
    _same(PascalVocDataset(str(voc), image_extension=".bmp"),
          Ref(str(voc), image_extension=".bmp"))

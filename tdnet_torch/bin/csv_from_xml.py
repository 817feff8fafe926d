"""Table-annotation -> CSV converter, the counterpart of
``tdnet/bin/csv_from_xml.py`` (the fork's dataset preparation:
Marmot/UNLV/ICDAR-style page annotations -> annotations.csv + classes.csv).

Reads VOC-style per-image XML (<object><name/><bndbox/>), the format
Marmot/UNLV table ground truth commonly ships in; an image without XML
boxes becomes a negative example. The same rows, files and split as the
reference's for the same arguments.

    python -m tdnet_torch.bin.csv_from_xml /data/pages --xml-dir /data/xml \
        --out-dir /data/csv [--class-name table] [--val-split 0.2]
"""

from __future__ import annotations

import argparse
import os
import random
import xml.etree.ElementTree as ET

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def parse_xml_boxes(xml_path: str, keep_classes=None):
    """Extract (x1, y1, x2, y2, class) rows from a VOC-style XML file."""
    tree = ET.parse(xml_path)
    rows = []
    for obj in tree.getroot().iter("object"):
        name_node = obj.find("name")
        name = name_node.text.strip().lower() if name_node is not None else "table"
        if keep_classes and name not in keep_classes:
            continue
        box = obj.find("bndbox")
        if box is None:
            continue
        coords = []
        for key in ("xmin", "ymin", "xmax", "ymax"):
            node = box.find(key)
            if node is None:
                break
            coords.append(int(round(float(node.text))))
        if len(coords) != 4:
            continue
        x1, y1, x2, y2 = coords
        if x2 > x1 and y2 > y1:
            rows.append((x1, y1, x2, y2, name))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert XML table annotations to the tdnet/reference CSV contract."
    )
    parser.add_argument("image_dir", help="directory of page images")
    parser.add_argument("--xml-dir", default=None,
                        help="directory of per-image XML files (default: image_dir)")
    parser.add_argument("--out-dir", default=".", help="where to write the CSVs")
    parser.add_argument("--class-name", default=None,
                        help="map every object to this single class (e.g. 'table')")
    parser.add_argument("--classes", default=None,
                        help="comma-separated class names to keep (others dropped)")
    parser.add_argument("--val-split", type=float, default=0.0,
                        help="fraction of images for val_annotations.csv")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    xml_dir = args.xml_dir or args.image_dir
    keep = set(args.classes.split(",")) if args.classes else None

    images = sorted(
        f for f in os.listdir(args.image_dir)
        if f.lower().endswith(IMAGE_EXTS)
    )
    if not images:
        raise SystemExit(f"no images found in {args.image_dir}")

    all_rows = {}
    class_names = set()
    for img in images:
        stem = os.path.splitext(img)[0]
        xml_path = os.path.join(xml_dir, stem + ".xml")
        path = os.path.abspath(os.path.join(args.image_dir, img))
        rows = []
        if os.path.exists(xml_path):
            for x1, y1, x2, y2, name in parse_xml_boxes(xml_path, keep):
                cls = args.class_name or name
                class_names.add(cls)
                rows.append(f"{path},{x1},{y1},{x2},{y2},{cls}")
        if not rows:
            rows = [f"{path},,,,,"]  # negative example
        all_rows[img] = rows

    if not class_names:
        class_names = {args.class_name or "table"}

    rng = random.Random(args.seed)
    shuffled = images[:]
    rng.shuffle(shuffled)
    n_val = int(len(shuffled) * args.val_split)
    val_set = set(shuffled[:n_val])

    os.makedirs(args.out_dir, exist_ok=True)
    train_csv = os.path.join(args.out_dir, "annotations.csv")
    with open(train_csv, "w") as f:
        for img in images:
            if img not in val_set:
                f.write("\n".join(all_rows[img]) + "\n")
    if n_val:
        val_csv = os.path.join(args.out_dir, "val_annotations.csv")
        with open(val_csv, "w") as f:
            for img in images:
                if img in val_set:
                    f.write("\n".join(all_rows[img]) + "\n")
        print(f"wrote {val_csv} ({n_val} images)")

    classes_csv = os.path.join(args.out_dir, "classes.csv")
    with open(classes_csv, "w") as f:
        for i, name in enumerate(sorted(class_names)):
            f.write(f"{name},{i}\n")

    n_boxes = sum(
        1 for rows in all_rows.values() for r in rows if not r.endswith(",,,,,")
    )
    print(f"wrote {train_csv} ({len(images) - n_val} images, {n_boxes} boxes)")
    print(f"wrote {classes_csv} ({len(class_names)} classes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

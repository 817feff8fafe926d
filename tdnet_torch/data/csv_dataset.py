"""The CSV dataset contract, the counterpart of
``tdnet/data/csv_dataset.py``:

  annotations.csv:  path,x1,y1,x2,y2,class_name
                    (ints, x2 > x1, y2 > y1; all box and class fields empty
                    for a page without objects)
  classes.csv:      class_name,id   (0-based, dense)

Parse errors name the line. Images load through
:func:`tdnet_torch.data.image.read_image_bgr` (PNG, JPEG, BMP, TIFF or ``.npy``),
and ``image_aspect_ratio`` reads the image header instead of decoding the
page.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np

from tdnet_torch.data.image import image_size, read_image_bgr

__all__ = ["read_classes", "read_annotations", "CSVDataset"]


def _parse(value: str, kind, fmt: str, line: int):
    try:
        return kind(value)
    except ValueError as e:
        raise ValueError(fmt.format(line=line, value=value, error=e)) from None


def read_classes(csv_reader) -> Dict[str, int]:
    """Rows 'class_name,id' -> {name: id}."""
    result: Dict[str, int] = {}
    for line, row in enumerate(csv_reader, 1):
        try:
            class_name, class_id = row
        except ValueError:
            raise ValueError(f"line {line}: format should be 'class_name,class_id'") from None
        class_id = _parse(class_id, int, "line {line}: malformed class ID: {error}", line)
        if class_name in result:
            raise ValueError(f"line {line}: duplicate class name: '{class_name}'")
        result[class_name] = class_id
    return result


def read_annotations(csv_reader, classes: Dict[str, int]) -> Dict[str, List[dict]]:
    """Rows 'path,x1,y1,x2,y2,class_name' -> {path: [box dicts]}."""
    result: Dict[str, List[dict]] = {}
    for line, row in enumerate(csv_reader, 1):
        try:
            img_file, x1, y1, x2, y2, class_name = row[:6]
        except ValueError:
            raise ValueError(
                f"line {line}: format should be "
                "'img_file,x1,y1,x2,y2,class_name' or 'img_file,,,,,'") from None
        result.setdefault(img_file, [])
        if (x1, y1, x2, y2, class_name) == ("", "", "", "", ""):
            continue  # a page without objects
        x1 = _parse(x1, int, "line {line}: malformed x1: {error}", line)
        y1 = _parse(y1, int, "line {line}: malformed y1: {error}", line)
        x2 = _parse(x2, int, "line {line}: malformed x2: {error}", line)
        y2 = _parse(y2, int, "line {line}: malformed y2: {error}", line)
        if x2 <= x1:
            raise ValueError(f"line {line}: x2 ({x2}) must be higher than x1 ({x1})")
        if y2 <= y1:
            raise ValueError(f"line {line}: y2 ({y2}) must be higher than y1 ({y1})")
        if class_name not in classes:
            raise ValueError(f"line {line}: unknown class name: '{class_name}' "
                             f"(classes: {sorted(classes)})")
        result[img_file].append({"x1": x1, "x2": x2, "y1": y1, "y2": y2,
                                 "class": class_name})
    return result


class CSVDataset:
    """Pages and boxes over the CSV contract. Relative image paths resolve
    against the annotations file's directory (or ``base_dir``)."""

    def __init__(self, csv_data_file: str, csv_class_file: str,
                 base_dir: Optional[str] = None):
        self.base_dir = os.path.dirname(csv_data_file) if base_dir is None else base_dir
        with open(csv_class_file, "r", newline="") as f:
            self.classes = read_classes(csv.reader(f, delimiter=","))
        self.labels = {v: k for k, v in self.classes.items()}
        with open(csv_data_file, "r", newline="") as f:
            self.image_data = read_annotations(csv.reader(f, delimiter=","), self.classes)
        self.image_names = list(self.image_data.keys())

    def size(self) -> int:
        return len(self.image_names)

    def num_classes(self) -> int:
        return max(self.classes.values()) + 1 if self.classes else 0

    def has_label(self, label: int) -> bool:
        return label in self.labels

    def label_to_name(self, label: int) -> str:
        return self.labels[label]

    def name_to_label(self, name: str) -> int:
        return self.classes[name]

    def image_path(self, image_index: int) -> str:
        return os.path.join(self.base_dir, self.image_names[image_index])

    def image_aspect_ratio(self, image_index: int) -> float:
        w, h = image_size(self.image_path(image_index))
        return w / h

    def load_image(self, image_index: int) -> np.ndarray:
        return read_image_bgr(self.image_path(image_index))

    def max_annotations(self) -> int:
        return max((len(a) for a in self.image_data.values()), default=0)

    def load_annotations(self, image_index: int) -> Dict[str, np.ndarray]:
        """{'labels': (M,) int64, 'bboxes': (M, 4) float64}."""
        annots = self.image_data[self.image_names[image_index]]
        out = {"labels": np.empty((len(annots),), dtype=np.int64),
               "bboxes": np.empty((len(annots), 4), dtype=np.float64)}
        for idx, a in enumerate(annots):
            out["labels"][idx] = self.name_to_label(a["class"])
            out["bboxes"][idx, :] = [a["x1"], a["y1"], a["x2"], a["y2"]]
        return out

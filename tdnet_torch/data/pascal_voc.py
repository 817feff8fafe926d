"""Pascal VOC dataset, the counterpart of ``tdnet/data/pascal_voc.py``
(reference: preprocessing/pascal_voc.py).

Reads the VOCdevkit layout: {data_dir}/Annotations/*.xml, JPEGImages/,
ImageSets/Main/{set_name}.txt. Same Dataset protocol as CSVDataset. Pages
load through the port's ``read_image_bgr`` (JPEG, PNG, BMP or TIFF) and the
aspect ratio comes from the image header (``image_size``).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict

import numpy as np

from tdnet_torch.data.image import image_size, read_image_bgr

__all__ = ["PascalVocDataset", "VOC_CLASSES"]

VOC_CLASSES = {
    "aeroplane": 0, "bicycle": 1, "bird": 2, "boat": 3, "bottle": 4,
    "bus": 5, "car": 6, "cat": 7, "chair": 8, "cow": 9,
    "diningtable": 10, "dog": 11, "horse": 12, "motorbike": 13, "person": 14,
    "pottedplant": 15, "sheep": 16, "sofa": 17, "train": 18, "tvmonitor": 19,
}


class PascalVocDataset:
    def __init__(
        self,
        data_dir: str,
        set_name: str = "trainval",
        classes: Dict[str, int] | None = None,
        skip_truncated: bool = False,
        skip_difficult: bool = False,
        image_extension: str = ".jpg",
    ):
        self.data_dir = data_dir
        self.set_name = set_name
        self.classes = dict(classes or VOC_CLASSES)
        self.labels = {v: k for k, v in self.classes.items()}
        self.skip_truncated = skip_truncated
        self.skip_difficult = skip_difficult
        self.image_extension = image_extension

        set_file = os.path.join(data_dir, "ImageSets", "Main", set_name + ".txt")
        with open(set_file) as f:
            self.image_names = [l.strip().split(None, 1)[0] for l in f if l.strip()]

    def size(self) -> int:
        return len(self.image_names)

    def num_classes(self) -> int:
        return max(self.classes.values()) + 1

    def has_label(self, label: int) -> bool:
        return label in self.labels

    def label_to_name(self, label: int) -> str:
        return self.labels[label]

    def name_to_label(self, name: str) -> int:
        return self.classes[name]

    def image_path(self, image_index: int) -> str:
        return os.path.join(
            self.data_dir, "JPEGImages",
            self.image_names[image_index] + self.image_extension,
        )

    def image_aspect_ratio(self, image_index: int) -> float:
        w, h = image_size(self.image_path(image_index))
        return w / h

    def load_image(self, image_index: int) -> np.ndarray:
        return read_image_bgr(self.image_path(image_index))

    def _parse_annotation(self, element):
        truncated = int(_find_text(element, "truncated", "0"))
        difficult = int(_find_text(element, "difficult", "0"))
        class_name = _find_text(element, "name")
        if class_name not in self.classes:
            raise ValueError(
                f"class name '{class_name}' not found in classes: "
                f"{sorted(self.classes)}"
            )
        bndbox = element.find("bndbox")
        box = [
            float(_find_text(bndbox, "xmin")) - 1,
            float(_find_text(bndbox, "ymin")) - 1,
            float(_find_text(bndbox, "xmax")) - 1,
            float(_find_text(bndbox, "ymax")) - 1,
        ]
        return truncated, difficult, box, self.name_to_label(class_name)

    def load_annotations(self, image_index: int) -> Dict[str, np.ndarray]:
        path = os.path.join(
            self.data_dir, "Annotations", self.image_names[image_index] + ".xml"
        )
        try:
            tree = ET.parse(path)
        except ET.ParseError as e:
            raise ValueError(f"invalid annotations file {path}: {e}") from None

        boxes, labels = [], []
        for element in tree.getroot().iter("object"):
            truncated, difficult, box, label = self._parse_annotation(element)
            if truncated and self.skip_truncated:
                continue
            if difficult and self.skip_difficult:
                continue
            boxes.append(box)
            labels.append(label)
        return {
            "labels": np.asarray(labels, dtype=np.int64),
            "bboxes": np.asarray(boxes, dtype=np.float64).reshape(-1, 4),
        }


def _find_text(element, name, default=None):
    node = element.find(name)
    if node is None or node.text is None:
        if default is not None:
            return default
        raise ValueError(f"missing element '{name}'")
    return node.text

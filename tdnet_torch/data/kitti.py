"""KITTI dataset, the counterpart of ``tdnet/data/kitti.py`` (reference:
preprocessing/kitti.py KittiGenerator).

Layout: {base_dir}/{subset}/images/*.png + labels/*.txt, label rows
`type truncated occluded alpha x1 y1 x2 y2 ...` (space separated). Pages
load through the port's ``read_image_bgr``; the aspect ratio comes from
the image header (``image_size``).
"""

from __future__ import annotations

import csv
import os
from typing import Dict

import numpy as np

from tdnet_torch.data.image import image_size, read_image_bgr

__all__ = ["KittiDataset", "KITTI_CLASSES"]

KITTI_CLASSES = {
    "Car": 0, "Van": 1, "Truck": 2, "Pedestrian": 3, "Person_sitting": 4,
    "Cyclist": 5, "Tram": 6, "Misc": 7, "DontCare": 8,
}


class KittiDataset:
    def __init__(self, base_dir: str, subset: str = "train",
                 classes: Dict[str, int] | None = None):
        self.classes = dict(classes or KITTI_CLASSES)
        self.labels = {v: k for k, v in self.classes.items()}

        self.images_dir = os.path.join(base_dir, subset, "images")
        labels_dir = os.path.join(base_dir, subset, "labels")
        self.image_names = sorted(os.listdir(self.images_dir))

        self.annotations = []
        for name in self.image_names:
            label_path = os.path.join(
                labels_dir, os.path.splitext(name)[0] + ".txt"
            )
            boxes, labs = [], []
            with open(label_path) as f:
                for row in csv.reader(f, delimiter=" "):
                    if not row:
                        continue
                    cls = row[0]
                    if cls not in self.classes:
                        raise ValueError(f"unknown KITTI class {cls!r}")
                    x1, y1, x2, y2 = (float(v) for v in row[4:8])
                    boxes.append([x1, y1, x2, y2])
                    labs.append(self.classes[cls])
            self.annotations.append(
                {
                    "labels": np.asarray(labs, dtype=np.int64),
                    "bboxes": np.asarray(boxes, dtype=np.float64).reshape(-1, 4),
                }
            )

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
        return os.path.join(self.images_dir, self.image_names[image_index])

    def image_aspect_ratio(self, image_index: int) -> float:
        w, h = image_size(self.image_path(image_index))
        return w / h

    def load_image(self, image_index: int) -> np.ndarray:
        return read_image_bgr(self.image_path(image_index))

    def load_annotations(self, image_index: int) -> Dict[str, np.ndarray]:
        return self.annotations[image_index]

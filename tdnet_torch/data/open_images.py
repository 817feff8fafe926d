"""Open Images dataset, the counterpart of ``tdnet/data/open_images.py``
(reference: preprocessing/open_images.py).

Reads the Open Images V4/V5 csv layout:
  {main_dir}/annotations/class-descriptions-boxable.csv   (MID,name)
  {main_dir}/annotations/{subset}-annotations-bbox.csv    (normalized boxes)
  {main_dir}/images/{subset}/{ImageID}.jpg

Boxes are stored normalized; they are denormalized against the image size
read from its header (``image_size``) at load time, like the reference,
which reads image sizes lazily.
"""

from __future__ import annotations

import csv
import os
from typing import Dict

import numpy as np

from tdnet_torch.data.image import image_size, read_image_bgr

__all__ = ["OpenImagesDataset"]


class OpenImagesDataset:
    def __init__(self, main_dir: str, subset: str = "train",
                 version: str = "v4", labels_filter=None):
        self.main_dir = main_dir
        self.subset = subset

        ann_dir = os.path.join(main_dir, "annotations")
        desc_path = os.path.join(ann_dir, "class-descriptions-boxable.csv")
        boxes_path = os.path.join(ann_dir, f"{subset}-annotations-bbox.csv")

        # MID -> human name
        self.mid_to_name: Dict[str, str] = {}
        with open(desc_path, newline="") as f:
            for row in csv.reader(f):
                if len(row) >= 2:
                    self.mid_to_name[row[0]] = row[1]

        names = sorted(set(self.mid_to_name.values()))
        if labels_filter is not None:
            wanted = set(labels_filter)
            names = [n for n in names if n in wanted]
        self.classes = {name: i for i, name in enumerate(names)}
        self.labels = {v: k for k, v in self.classes.items()}

        self._annotations: Dict[str, list] = {}
        with open(boxes_path, newline="") as f:
            reader = csv.DictReader(f)
            for row in reader:
                name = self.mid_to_name.get(row["LabelName"])
                if name is None or name not in self.classes:
                    continue
                self._annotations.setdefault(row["ImageID"], []).append(
                    (
                        float(row["XMin"]), float(row["YMin"]),
                        float(row["XMax"]), float(row["YMax"]),
                        self.classes[name],
                    )
                )
        self.image_ids = sorted(self._annotations.keys())

    def size(self) -> int:
        return len(self.image_ids)

    def num_classes(self) -> int:
        return len(self.classes)

    def has_label(self, label: int) -> bool:
        return label in self.labels

    def label_to_name(self, label: int) -> str:
        return self.labels[label]

    def name_to_label(self, name: str) -> int:
        return self.classes[name]

    def image_path(self, image_index: int) -> str:
        return os.path.join(
            self.main_dir, "images", self.subset,
            self.image_ids[image_index] + ".jpg",
        )

    def image_aspect_ratio(self, image_index: int) -> float:
        w, h = image_size(self.image_path(image_index))
        return w / h

    def load_image(self, image_index: int) -> np.ndarray:
        return read_image_bgr(self.image_path(image_index))

    def load_annotations(self, image_index: int) -> Dict[str, np.ndarray]:
        w, h = image_size(self.image_path(image_index))
        entries = self._annotations[self.image_ids[image_index]]
        boxes = np.asarray(
            [[x1 * w, y1 * h, x2 * w, y2 * h] for x1, y1, x2, y2, _ in entries],
            dtype=np.float64,
        ).reshape(-1, 4)
        labels = np.asarray([e[4] for e in entries], dtype=np.int64)
        return {"labels": labels, "bboxes": boxes}

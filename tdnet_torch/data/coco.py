"""COCO-format dataset, the counterpart of ``tdnet/data/coco.py``
(reference: preprocessing/coco.py CocoGenerator).

The instances json is parsed directly (images / annotations /
categories); behavior mirrors the reference: contiguous labels ordered by
category id, xywh -> xyxy conversion, crowd/degenerate boxes kept out by
the generator's filtering. Pages load through the port's
``read_image_bgr``.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from tdnet_torch.data.image import read_image_bgr

__all__ = ["CocoDataset"]


class CocoDataset:
    def __init__(self, data_dir: str, set_name: str = "train2017",
                 include_crowd: bool = False):
        self.data_dir = data_dir
        self.set_name = set_name

        ann_path = os.path.join(
            data_dir, "annotations", f"instances_{set_name}.json"
        )
        with open(ann_path) as f:
            coco = json.load(f)

        # contiguous labels ordered by category id (reference: load_classes)
        categories = sorted(coco["categories"], key=lambda c: c["id"])
        self.classes: Dict[str, int] = {}
        self.coco_labels: Dict[int, int] = {}
        self.coco_labels_inverse: Dict[int, int] = {}
        for c in categories:
            self.coco_labels[len(self.classes)] = c["id"]
            self.coco_labels_inverse[c["id"]] = len(self.classes)
            self.classes[c["name"]] = len(self.classes)
        self.labels = {v: k for k, v in self.classes.items()}

        self.image_info = {img["id"]: img for img in coco["images"]}
        self.image_ids = [img["id"] for img in coco["images"]]

        self._annotations: Dict[int, list] = {i: [] for i in self.image_ids}
        for a in coco["annotations"]:
            if a.get("iscrowd", 0) and not include_crowd:
                continue
            if a["image_id"] in self._annotations:
                self._annotations[a["image_id"]].append(a)

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

    def label_to_coco_label(self, label: int) -> int:
        return self.coco_labels[label]

    def coco_label_to_label(self, coco_label: int) -> int:
        return self.coco_labels_inverse[coco_label]

    def image_path(self, image_index: int) -> str:
        info = self.image_info[self.image_ids[image_index]]
        return os.path.join(self.data_dir, "images", self.set_name, info["file_name"])

    def image_aspect_ratio(self, image_index: int) -> float:
        info = self.image_info[self.image_ids[image_index]]
        return float(info["width"]) / float(info["height"])

    def load_image(self, image_index: int) -> np.ndarray:
        return read_image_bgr(self.image_path(image_index))

    def load_annotations(self, image_index: int) -> Dict[str, np.ndarray]:
        anns = self._annotations[self.image_ids[image_index]]
        boxes, labels, areas = [], [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            if w < 1 or h < 1:  # reference skips degenerate boxes
                continue
            boxes.append([x, y, x + w, y + h])
            labels.append(self.coco_label_to_label(a["category_id"]))
            # official COCOeval uses the annotation's 'area' (segmentation
            # area) for the S/M/L ignore decision, not the bbox area
            areas.append(float(a.get("area", w * h)))
        return {
            "labels": np.asarray(labels, dtype=np.int64),
            "bboxes": np.asarray(boxes, dtype=np.float64).reshape(-1, 4),
            "areas": np.asarray(areas, dtype=np.float64),
        }

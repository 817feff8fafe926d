"""VOC-style mAP evaluation on the host, the counterpart of
``tdnet/utils/eval.py``.

Per image: detections scoring above ``score_threshold``, at most
``max_detections`` by score. Per class: detections in descending score
order are matched greedily to unmatched GT boxes at IoU >=
``iou_threshold`` (the legacy "+1" IoU of :func:`compute_overlap`); a
second match of a GT box counts as a false positive. AP by VOC all-points
interpolation. Returns ``{label: (ap, num_annotations)}``.

The predictor maps a raw BGR image to (boxes, scores, labels) in image
coordinates; one with ``predict_batch`` and ``batch_size`` > 1 gets chunks
of ``batch_size`` images.

``shard=True`` with a process group (``parallel/mesh.py``): each rank
predicts its strided slice of the dataset (images rank, rank + N, ...) and
the detection rows are all-gathered (``process_allgather_rows``), so every
rank returns the identical, bit-exact result of a single-process run.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from tdnet_torch.parallel.mesh import (process_allgather_rows, process_count,
                                      process_index)

__all__ = ["evaluate", "compute_ap", "compute_overlap"]


def compute_overlap(boxes: np.ndarray, query_boxes: np.ndarray) -> np.ndarray:
    """Pairwise IoU (N, 4) x (K, 4) -> (N, K) float64 with the legacy "+1"
    pixel convention (the reference's native ``compute_overlap``)."""
    boxes = np.asarray(boxes, np.float64)
    query_boxes = np.asarray(query_boxes, np.float64)
    b, q = boxes[:, None, :], query_boxes[None, :, :]
    iw = np.minimum(b[..., 2], q[..., 2]) - np.maximum(b[..., 0], q[..., 0]) + 1.0
    ih = np.minimum(b[..., 3], q[..., 3]) - np.maximum(b[..., 1], q[..., 1]) + 1.0
    iw, ih = np.maximum(iw, 0.0), np.maximum(ih, 0.0)
    inter = iw * ih
    area_b = (boxes[:, 2] - boxes[:, 0] + 1.0) * (boxes[:, 3] - boxes[:, 1] + 1.0)
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0] + 1.0)
              * (query_boxes[:, 3] - query_boxes[:, 1] + 1.0))
    union = area_b[:, None] + area_q[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(inter > 0, inter / union, 0.0)


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC all-points AP."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _get_detections(dataset, predictor, score_threshold, max_detections,
                    shard=False):
    """all_detections[image][label]: (D, 5) rows x1, y1, x2, y2, score; with
    ``shard`` this rank predicts its slice and the rows are gathered."""
    num_classes = dataset.num_classes()
    nproc = process_count() if shard else 1
    my_images = list(range(process_index() if shard else 0, dataset.size(), nproc))
    all_detections = [[None] * num_classes for _ in range(dataset.size())]
    batch_size = int(getattr(predictor, "batch_size", 1) or 1)
    predict_batch = getattr(predictor, "predict_batch", None)

    def record(i, boxes, scores, labels):
        boxes = np.asarray(boxes, np.float64)
        scores = np.asarray(scores, np.float64)
        labels = np.asarray(labels, np.int64)
        keep = scores > score_threshold
        boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
        order = np.argsort(-scores, kind="stable")[:max_detections]
        boxes, scores, labels = boxes[order], scores[order], labels[order]
        dets = np.concatenate([boxes, scores[:, None]], axis=1)
        for label in range(num_classes):
            if dataset.has_label(label):
                all_detections[i][label] = dets[labels == label]

    if predict_batch is not None and batch_size > 1:
        for start in range(0, len(my_images), batch_size):
            idxs = my_images[start:start + batch_size]
            images = [dataset.load_image(i) for i in idxs]
            for i, (boxes, scores, labels) in zip(idxs, predict_batch(images)):
                record(i, boxes, scores, labels)
    else:
        for i in my_images:
            record(i, *predictor(dataset.load_image(i)))
    if nproc > 1:
        # (image, label, x1, y1, x2, y2, score) rows in local record order
        # (score-descending per image): the order within each (image,
        # label) survives the gather, so the matching is bit-identical
        rows = [np.concatenate([np.full((d.shape[0], 2), (i, label), np.float64), d], 1)
                for i in my_images for label, d in enumerate(all_detections[i])
                if d is not None and d.shape[0]]
        gathered = process_allgather_rows(
            np.concatenate(rows) if rows else np.zeros((0, 7), np.float64))
        for i in range(dataset.size()):
            img_rows = gathered[gathered[:, 0] == i]
            for label in range(num_classes):
                if dataset.has_label(label):
                    all_detections[i][label] = img_rows[img_rows[:, 1] == label][:, 2:]
    return all_detections


def _get_annotations(dataset):
    num_classes = dataset.num_classes()
    out = [[None] * num_classes for _ in range(dataset.size())]
    for i in range(dataset.size()):
        ann = dataset.load_annotations(i)
        for label in range(num_classes):
            if dataset.has_label(label):
                out[i][label] = ann["bboxes"][ann["labels"] == label].copy()
    return out


def evaluate(dataset, predictor: Callable, iou_threshold: float = 0.5,
             score_threshold: float = 0.05, max_detections: int = 100,
             shard: bool = False) -> Dict[int, Tuple[float, int]]:
    """Evaluate a predictor over a dataset -> {label: (AP, num_annotations)};
    ``shard`` splits the prediction over the ranks."""
    all_detections = _get_detections(dataset, predictor, score_threshold,
                                     max_detections, shard)
    all_annotations = _get_annotations(dataset)
    average_precisions: Dict[int, Tuple[float, int]] = {}
    for label in range(dataset.num_classes()):
        if not dataset.has_label(label):
            continue
        false_positives, true_positives, scores = [], [], []
        num_annotations = 0.0
        for i in range(dataset.size()):
            detections = all_detections[i][label]
            annotations = all_annotations[i][label]
            num_annotations += annotations.shape[0]
            n_det = detections.shape[0]
            if n_det == 0:
                continue
            scores.extend(detections[:, 4].tolist())
            if annotations.shape[0] == 0:
                false_positives.extend([1] * n_det)
                true_positives.extend([0] * n_det)
                continue
            # each detection's best GT does not depend on the match state,
            # so one D x G IoU call per (image, class) gives the greedy scan
            overlaps = compute_overlap(detections[:, :4], annotations)
            assigned = np.argmax(overlaps, axis=1)
            max_overlap = overlaps[np.arange(n_det), assigned]
            detected: set = set()
            for di in range(n_det):
                if max_overlap[di] >= iou_threshold and assigned[di] not in detected:
                    true_positives.append(1)
                    false_positives.append(0)
                    detected.add(int(assigned[di]))
                else:
                    false_positives.append(1)
                    true_positives.append(0)
        if num_annotations == 0:
            average_precisions[label] = (0.0, 0)
            continue
        order = np.argsort(-np.asarray(scores), kind="stable")
        false_positives = np.cumsum(np.asarray(false_positives)[order])
        true_positives = np.cumsum(np.asarray(true_positives)[order])
        recall = true_positives / num_annotations
        precision = true_positives / np.maximum(
            true_positives + false_positives, np.finfo(np.float64).eps)
        average_precisions[label] = (compute_ap(recall, precision), int(num_annotations))
    return average_precisions

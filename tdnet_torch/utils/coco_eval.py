"""COCO-style evaluation, the counterpart of ``tdnet/utils/coco_eval.py``:
the full 12-metric COCOeval summary in numpy (pycocotools' semantics,
reimplemented without it):

- matching per (image, class, IoU threshold): detections in descending score
  order each match the highest-IoU *still-unmatched* GT with IoU >= t
  (NOT argmax-then-check — a detection whose best-IoU GT is taken can still
  match another GT above threshold, exactly like COCOeval);
- area-range handling: GTs outside the range are "ignored" — detections
  matched to them, and unmatched detections outside the range, are removed
  from scoring rather than counted as FP;
- AP: 101-point interpolated precision averaged over IoU 0.50:0.05:0.95,
  maxDets=100; AR: mean best recall over the same thresholds at
  maxDets 1/10/100.

Metric keys mirror the COCOeval summary: AP, AP50, AP75, AP_small,
AP_medium, AP_large, AR1, AR10, AR100, AR_small, AR_medium, AR_large,
plus per-class 'AP_<name>'.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tdnet_torch.utils.eval import _get_detections

__all__ = ["evaluate_coco", "summarize_coco"]

COCO_IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)

AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}

RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _box_area(boxes: np.ndarray) -> np.ndarray:
    if boxes.size == 0:
        return np.zeros((0,))
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def _iou_exact(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise EXACT IoU (D, G) — pycocotools' maskUtils.iou convention,
    NOT the legacy +1-pixel convention the VOC evaluator inherits from the
    reference's Cython compute_overlap."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = _box_area(a)[:, None] + _box_area(b)[None, :] - inter
    return inter / np.maximum(union, np.finfo(np.float64).eps)


def _match_image(
    dts: np.ndarray,  # (D, 5) score-desc sorted [x1,y1,x2,y2,score]
    gts: np.ndarray,  # (G, 4)
    area_range: Tuple[float, float],
    max_dets: int,
    gt_areas: Optional[np.ndarray] = None,  # (G,) dataset 'area' field
):
    """COCOeval evaluateImg for one (image, class, area range).

    `gt_areas` (when the dataset provides per-annotation areas, e.g. COCO's
    segmentation 'area' field) drives the S/M/L ignore decision exactly like
    official COCOeval; datasets without it fall back to bbox area (the only
    deviation from pycocotools, and only for such datasets).

    Returns (dt_scores (D',), dt_matched (T, D') bool, dt_ignore (T, D') bool,
    num_non_ignored_gt) with D' = min(D, max_dets)."""
    T = len(COCO_IOU_THRESHOLDS)
    dts = dts[:max_dets]
    D, G = len(dts), len(gts)

    gt_area = gt_areas if gt_areas is not None else _box_area(gts)
    gt_ignore = (gt_area < area_range[0]) | (gt_area > area_range[1])
    # sort GTs: non-ignored first (COCOeval sorts by ignore flag)
    gt_order = np.argsort(gt_ignore, kind="stable")
    gts_sorted = gts[gt_order]
    gt_ig = gt_ignore[gt_order]

    dt_matched = np.zeros((T, D), dtype=bool)
    dt_ignore = np.zeros((T, D), dtype=bool)

    if D and G:
        ious = _iou_exact(
            np.asarray(dts[:, :4], np.float64),
            np.asarray(gts_sorted, np.float64),
        )  # (D, G)
        # COCOeval's ascending-gi scan with `>=` updates and the
        # break-on-ignored rule reduces to: prefer the non-ignored section
        # (gts are sorted non-ignored first); within a section pick the
        # LAST index attaining the max (ties update on >=). Vectorized over
        # gi; the di loop must stay sequential (gt_taken state).
        n_ni = int(np.sum(~gt_ig))

        def last_argmax(v):
            return v.size - 1 - int(np.argmax(v[::-1]))

        for ti, thr in enumerate(COCO_IOU_THRESHOLDS):
            init = min(thr, 1.0 - 1e-10)
            gt_taken = np.zeros(G, dtype=bool)
            for di in range(D):
                c = np.where(gt_taken, -np.inf, ious[di])
                m = -1
                if n_ni and c[:n_ni].max() >= init:
                    m = last_argmax(c[:n_ni])
                elif n_ni < G and c[n_ni:].max() >= init:
                    m = n_ni + last_argmax(c[n_ni:])
                if m == -1:
                    continue
                gt_taken[m] = True
                dt_matched[ti, di] = True
                dt_ignore[ti, di] = gt_ig[m]

    # unmatched detections outside the area range are ignored, not FP
    if D:
        dt_area = _box_area(dts[:, :4])
        out_of_range = (dt_area < area_range[0]) | (dt_area > area_range[1])
        dt_ignore |= (~dt_matched) & out_of_range[None, :]

    return dts[:, 4], dt_matched, dt_ignore, int(np.sum(~gt_ignore))


def _accumulate(per_image, max_dets: int = 100) -> Tuple[np.ndarray, np.ndarray]:
    """Accumulate one class's per-image match results over the dataset.

    Greedy matching is prefix-stable in the detections (the match state after
    the first k detections does not depend on later ones), so results matched
    at maxDets=100 evaluate any smaller maxDets by per-image truncation.

    Returns (ap_per_threshold (T,), recall_per_threshold (T,)); NaN when the
    class has no non-ignored GT (excluded from the mean, like COCOeval -1)."""
    T = len(COCO_IOU_THRESHOLDS)
    npig = sum(r[3] for r in per_image)
    if npig == 0:
        return np.full(T, np.nan), np.full(T, np.nan)

    scores = (
        np.concatenate([r[0][:max_dets] for r in per_image])
        if per_image else np.zeros(0)
    )
    matched = np.concatenate([r[1][:, :max_dets] for r in per_image], axis=1)
    ignored = np.concatenate([r[2][:, :max_dets] for r in per_image], axis=1)

    order = np.argsort(-scores, kind="mergesort")
    matched = matched[:, order]
    ignored = ignored[:, order]

    aps = np.zeros(T)
    recalls = np.zeros(T)
    for ti in range(T):
        keep = ~ignored[ti]
        tp = np.cumsum(matched[ti][keep])
        fp = np.cumsum(~matched[ti][keep])
        nd = tp.size
        rc = tp / npig
        pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        recalls[ti] = rc[-1] if nd else 0.0

        # precision envelope (monotone non-increasing from the right)
        q = np.zeros(len(RECALL_POINTS))
        pr = pr.tolist()
        for i in range(nd - 1, 0, -1):
            if pr[i] > pr[i - 1]:
                pr[i - 1] = pr[i]
        inds = np.searchsorted(rc, RECALL_POINTS, side="left")
        for ri, pi in enumerate(inds):
            if pi < nd:
                q[ri] = pr[pi]
        aps[ti] = float(np.mean(q))
    return aps, recalls


def evaluate_coco(
    dataset,
    predictor: Callable,
    score_threshold: float = 0.05,
    max_detections: int = 100,
    shard: bool = False,
) -> Dict[str, float]:
    """Full COCO summary over a dataset. `predictor` as in utils/eval.py;
    ``shard=True`` splits the prediction over the ranks (utils/eval.py
    ``_get_detections``): the same result on every rank."""
    all_detections = _get_detections(
        dataset, predictor, score_threshold, max_detections, shard)
    num_images = dataset.size()

    # per (image, class): GT boxes + per-annotation areas when the dataset
    # provides them (COCO 'area' field — official COCOeval's S/M/L source)
    num_classes = dataset.num_classes()
    all_annotations = [[None] * num_classes for _ in range(num_images)]
    all_areas = [[None] * num_classes for _ in range(num_images)]
    for i in range(num_images):
        ann = dataset.load_annotations(i)
        areas = ann.get("areas")
        for label in range(num_classes):
            if not dataset.has_label(label):
                continue
            sel = ann["labels"] == label
            all_annotations[i][label] = ann["bboxes"][sel].copy()
            if areas is not None:
                all_areas[i][label] = np.asarray(areas)[sel].copy()

    labels = [l for l in range(dataset.num_classes()) if dataset.has_label(l)]

    # AP per (class, area-range) at maxDets=100; AR per (class, maxDets/area)
    ap_table: Dict[str, List[np.ndarray]] = {k: [] for k in AREA_RANGES}
    ar_table: Dict[str, List[np.ndarray]] = {
        "AR1": [], "AR10": [], "AR100": [],
        "AR_small": [], "AR_medium": [], "AR_large": [],
    }
    per_class_ap: Dict[int, float] = {}

    for label in labels:
        dets = [all_detections[i][label] for i in range(num_images)]
        anns = [all_annotations[i][label] for i in range(num_images)]
        areas = [all_areas[i][label] for i in range(num_images)]

        for area_name, area_range in AREA_RANGES.items():
            results = [
                _match_image(d, a, area_range, max_dets=100, gt_areas=ar)
                for d, a, ar in zip(dets, anns, areas)
            ]
            aps, recalls = _accumulate(results)
            ap_table[area_name].append(aps)
            if area_name == "all":
                if not np.all(np.isnan(aps)):
                    per_class_ap[label] = float(np.nanmean(aps))
                ar_table["AR100"].append(recalls)
                for md, key in ((1, "AR1"), (10, "AR10")):
                    _, rec = _accumulate(results, max_dets=md)
                    ar_table[key].append(rec)
            else:
                ar_table[f"AR_{area_name}"].append(recalls)

    def mean_over_classes(stack: List[np.ndarray], thr_idx: Optional[int] = None):
        if not stack:
            return 0.0
        arr = np.stack(stack)  # (C, T)
        if thr_idx is not None:
            arr = arr[:, thr_idx]
        if np.all(np.isnan(arr)):
            return -1.0  # COCOeval prints -1 when nothing to evaluate
        return float(np.nanmean(arr))

    result: Dict[str, float] = {
        "AP": mean_over_classes(ap_table["all"]),
        "AP50": mean_over_classes(ap_table["all"], 0),
        "AP75": mean_over_classes(ap_table["all"], 5),
        "AP_small": mean_over_classes(ap_table["small"]),
        "AP_medium": mean_over_classes(ap_table["medium"]),
        "AP_large": mean_over_classes(ap_table["large"]),
        "AR1": mean_over_classes(ar_table["AR1"]),
        "AR10": mean_over_classes(ar_table["AR10"]),
        "AR100": mean_over_classes(ar_table["AR100"]),
        "AR_small": mean_over_classes(ar_table["AR_small"]),
        "AR_medium": mean_over_classes(ar_table["AR_medium"]),
        "AR_large": mean_over_classes(ar_table["AR_large"]),
    }
    for label, ap in per_class_ap.items():
        result[f"AP_{dataset.label_to_name(label)}"] = ap
    return result


_SUMMARY_ROWS = [
    ("AP", "Average Precision", "0.50:0.95", "all", 100),
    ("AP50", "Average Precision", "0.50", "all", 100),
    ("AP75", "Average Precision", "0.75", "all", 100),
    ("AP_small", "Average Precision", "0.50:0.95", "small", 100),
    ("AP_medium", "Average Precision", "0.50:0.95", "medium", 100),
    ("AP_large", "Average Precision", "0.50:0.95", "large", 100),
    ("AR1", "Average Recall", "0.50:0.95", "all", 1),
    ("AR10", "Average Recall", "0.50:0.95", "all", 10),
    ("AR100", "Average Recall", "0.50:0.95", "all", 100),
    ("AR_small", "Average Recall", "0.50:0.95", "small", 100),
    ("AR_medium", "Average Recall", "0.50:0.95", "medium", 100),
    ("AR_large", "Average Recall", "0.50:0.95", "large", 100),
]


def summarize_coco(result: Dict[str, float]) -> str:
    """Render the 12-line COCOeval-style summary block."""
    lines = []
    for key, name, iou, area, max_dets in _SUMMARY_ROWS:
        tag = "(AP)" if name.endswith("Precision") else "(AR)"
        lines.append(
            f" {name:<18}{tag} @[ IoU={iou:<9} | area={area:>6} | "
            f"maxDets={max_dets:>3} ] = {result.get(key, -1.0):0.3f}"
        )
    return "\n".join(lines)

"""Detection filtering on the device, the counterpart of
``tdnet/ops/nms.py``: the deferred-decode tails (class-specific, with hard
NMS or soft-NMS, and shared NMS) and the legacy decode-everything tails
(``filter_detections``, ``batched_filter_detections``).

Semantics (tf.image.non_max_suppression and keras-retinanet's
filter_detections): per class, score threshold 0.05 (strict >), greedy
IoU-0.5 NMS over the score-sorted top ``pre_nms_top_k`` candidates, up to
``max_detections`` per class, then a global top ``max_detections`` merge,
padded with -1. Soft-NMS (``soft_nms_sigma > 0``) replaces the hard
suppression with gaussian rescoring and is class-specific only. Every top-k
here is ``lax.top_k``'s order: descending, the lower index first on ties.

On CUDA tensors the suppression runs the NMS kernel (``nms_kernel``) and
the rescoring the soft-NMS kernel (``soft_nms``); the reference's
``use_pallas`` switch has no counterpart.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tdnet_torch.ops.boxes import bbox_transform_inv, clip_boxes
from tdnet_torch.ops.nms_kernel import nms_keep, nms_keep_plain
from tdnet_torch.ops.soft_nms import soft_nms_rescore_batched

__all__ = [
    "Detections",
    "exact_topk_lastdim",
    "non_max_suppression",
    "filter_detections",
    "batched_filter_detections",
    "batched_detections_deferred",
    "batched_detections_deferred_shared",
]


class Detections(NamedTuple):
    boxes: torch.Tensor   # (..., max_detections, 4), padded -1
    scores: torch.Tensor  # (..., max_detections), padded -1
    labels: torch.Tensor  # (..., max_detections) int32, padded -1


def exact_topk_lastdim(x: torch.Tensor, k: int):
    """Top-k along the last axis in ``lax.top_k`` order: values descending,
    the lower index first among equal values (``torch.topk`` promises no
    tie order, so this is a stable sort and a slice). Returns (values,
    int64 indices)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def non_max_suppression(boxes: torch.Tensor, scores: torch.Tensor,
                        iou_threshold: float = 0.5,
                        score_threshold: float = float("-inf")) -> torch.Tensor:
    """Greedy NMS keep mask over unsorted (N, 4) boxes / (N,) scores, in the
    original order (exact IoU, score-descending, stable ties)."""
    order = torch.argsort(-scores, stable=True)
    sboxes = boxes[order]
    valid = scores[order] > score_threshold
    keep_sorted = nms_keep_plain(sboxes[None], valid[None], iou_threshold)[0]
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    return keep


def _rows_keep(boxes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float) -> torch.Tensor:
    """Keep mask of score-sorted (R, K, 4) rows through :func:`nms_keep`."""
    return nms_keep(boxes.to(torch.float32).contiguous(), valid.contiguous(),
                    iou_threshold=iou_threshold)


def _rows_soft(boxes: torch.Tensor, scores: torch.Tensor, sigma: float,
               score_threshold: float, max_detections: int) -> torch.Tensor:
    """Gaussian soft-NMS rescoring of (R, K) rows; scores not above the
    threshold enter as 0 (the reference's ``where(valid, s, 0)``)."""
    scores = torch.where(scores > score_threshold, scores,
                         torch.zeros_like(scores))
    return soft_nms_rescore_batched(
        boxes.to(torch.float32).contiguous(),
        scores.to(torch.float32).contiguous(), method="gaussian",
        sigma=sigma, score_threshold=score_threshold,
        max_selections=max_detections)


def _finish(top_scores, sel_boxes, sel_labels, max_detections: int) -> Detections:
    """Mask the -inf slots of a final top-k with -1 and pad the last axis to
    ``max_detections``."""
    ok = top_scores > float("-inf")
    boxes = torch.where(ok[..., None], sel_boxes, torch.full_like(sel_boxes, -1.0))
    scores = torch.where(ok, top_scores, torch.full_like(top_scores, -1.0))
    labels = torch.where(ok, sel_labels.to(torch.int32),
                         torch.full_like(sel_labels, -1, dtype=torch.int32))
    pad = max_detections - scores.shape[-1]
    if pad > 0:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad), value=-1.0)
        scores = torch.nn.functional.pad(scores, (0, pad), value=-1.0)
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    return Detections(boxes, scores, labels)


# ------------------------------------------------------------ legacy tails


def filter_detections(boxes: torch.Tensor, classification: torch.Tensor,
                      class_specific_filter: bool = True, nms: bool = True,
                      score_threshold: float = 0.05, max_detections: int = 300,
                      nms_threshold: float = 0.5, pre_nms_top_k: int = 1024,
                      soft_nms_sigma: float = 0.0) -> Detections:
    """Filter decoded detections of ONE image: boxes (N, 4), classification
    (N, C) scores -> Detections padded with -1 (keras-retinanet's
    filter_detections). The shared branch ignores ``soft_nms_sigma``."""
    if class_specific_filter and nms:  # the batched rows of one image
        det = _batched_filter_detections_rows(
            boxes[None], classification[None], score_threshold=score_threshold,
            max_detections=max_detections, nms_threshold=nms_threshold,
            pre_nms_top_k=pre_nms_top_k, soft_nms_sigma=soft_nms_sigma)
        return Detections(*(t[0] for t in det))
    n, num_classes = classification.shape
    dev = classification.device
    neg_inf = torch.tensor(float("-inf"), dtype=classification.dtype, device=dev)
    if class_specific_filter:
        # every (anchor, class) pair above the threshold competes in the
        # final top-k (the reference's concat-then-top_k)
        flat = classification.reshape(-1)
        flat = torch.where(flat > score_threshold, flat, neg_inf)
        k = min(max_detections * max(1, num_classes), flat.shape[0])
        all_scores, flat_idx = exact_topk_lastdim(flat, k)
        all_idx = flat_idx // num_classes
        all_labels = (flat_idx % num_classes).to(torch.int32)
    else:
        # per-anchor max score and first-max label, one shared NMS
        max_scores = classification.max(dim=1).values
        arg_labels = classification.argmax(dim=1).to(torch.int32)
        thr = torch.where(max_scores > score_threshold, max_scores, neg_inf)
        if nms:
            cand_scores, cand_idx = exact_topk_lastdim(thr, min(pre_nms_top_k, n))
            keep = _rows_keep(boxes[cand_idx][None],
                              (cand_scores > score_threshold)[None],
                              nms_threshold)[0]
            all_scores = torch.where(keep, cand_scores, neg_inf)
            all_idx = cand_idx
            all_labels = arg_labels[cand_idx]
        else:
            all_scores = thr
            all_idx = torch.arange(n, device=dev)
            all_labels = arg_labels

    top_scores, sel = exact_topk_lastdim(all_scores, min(max_detections,
                                                         all_scores.shape[0]))
    return _finish(top_scores, boxes[all_idx[sel]], all_labels[sel], max_detections)


def batched_filter_detections(boxes: torch.Tensor, classification: torch.Tensor,
                              **kwargs) -> Detections:
    """Batched filter: boxes (B, N, 4), classification (B, N, C). The
    class-specific NMS combinations (hard and soft) run every (image, class)
    row through one kernel launch; the others filter image by image."""
    if kwargs.get("nms", True) and kwargs.get("class_specific_filter", True):
        return _batched_filter_detections_rows(boxes, classification, **kwargs)
    per_image = [filter_detections(boxes[i], classification[i], **kwargs)
                 for i in range(boxes.shape[0])]
    return Detections(*(torch.stack(t) for t in zip(*per_image)))


def _batched_filter_detections_rows(
    boxes: torch.Tensor, classification: torch.Tensor, nms: bool = True,
    class_specific_filter: bool = True, score_threshold: float = 0.05,
    max_detections: int = 300, nms_threshold: float = 0.5,
    pre_nms_top_k: int = 1024, soft_nms_sigma: float = 0.0,
) -> Detections:
    """Class-specific filtering batched over (image, class) rows, the
    counterpart of ``_batched_filter_detections_pallas``."""
    del nms, class_specific_filter  # (True, True)
    b, n, c = classification.shape
    k = min(pre_nms_top_k, n)
    neg_inf = torch.tensor(float("-inf"), dtype=classification.dtype,
                           device=classification.device)
    masked = torch.where(classification > score_threshold, classification, neg_inf)
    top_scores, top_idx = exact_topk_lastdim(masked.transpose(1, 2), k)  # (B, C, K)
    cand_boxes = torch.gather(boxes[:, None].expand(b, c, n, 4), 2,
                              top_idx[..., None].expand(b, c, k, 4))
    flat_boxes = cand_boxes.reshape(b * c, k, 4)
    if soft_nms_sigma > 0.0:
        rescored = _rows_soft(flat_boxes, top_scores.reshape(b * c, k),
                              soft_nms_sigma, score_threshold,
                              max_detections).reshape(b, c, k)
        kept = torch.where(rescored > score_threshold,
                           rescored.to(top_scores.dtype), neg_inf)
    else:
        keep = _rows_keep(flat_boxes, (top_scores > score_threshold).reshape(b * c, k),
                          nms_threshold).reshape(b, c, k)
        kept = torch.where(keep, top_scores, neg_inf)

    if k > max_detections:  # per-class cap
        kept, sel = exact_topk_lastdim(kept, max_detections)
        top_idx = torch.gather(top_idx, 2, sel)
    mc = kept.shape[2]
    all_scores = kept.reshape(b, c * mc)
    all_idx = top_idx.reshape(b, c * mc)
    labels_grid = torch.arange(c, dtype=torch.int32, device=boxes.device)[None, :, None] \
        .expand(b, c, mc).reshape(b, c * mc)
    out_k = min(max_detections, c * mc)
    top2, sel2 = exact_topk_lastdim(all_scores, out_k)
    sel_idx = torch.gather(all_idx, 1, sel2)
    sel_boxes = torch.gather(boxes, 1, sel_idx[..., None].expand(b, out_k, 4))
    return _finish(top2, sel_boxes, torch.gather(labels_grid, 1, sel2),
                   max_detections)


# ---------------------------------------------------------- deferred tails


def _conservative_logit_threshold(score_threshold: float,
                                  dtype: torch.dtype) -> float:
    """Pre-mask threshold in logit space: sigmoid(x) > t == x > logit(t),
    widened by a few ulp of ``dtype`` so rounding can only over-include (the
    exact f32 re-mask of the candidates restores the threshold)."""
    if score_threshold <= 0.0:
        return float("-inf")
    if score_threshold >= 1.0:
        return float("inf")
    t = math.log(score_threshold / (1.0 - score_threshold))
    eps = float(torch.finfo(dtype).eps)
    margin = max(1e-4, 8.0 * eps * max(abs(t), 1.0))
    # rounded to dtype, as the reference's jnp.asarray(t - margin, dtype)
    return float(torch.tensor(t - margin, dtype=dtype))


def _candidate_scores(top_raw, classification_is_logits, score_threshold):
    """f32 scores of the chosen candidates, -inf where not above the
    threshold (the exact re-mask)."""
    f32_neg_inf = torch.tensor(float("-inf"), device=top_raw.device)
    if classification_is_logits:
        scores = torch.sigmoid(top_raw.to(torch.float32))
        return torch.where(scores > score_threshold, scores, f32_neg_inf)
    neg_inf = torch.tensor(float("-inf"), dtype=top_raw.dtype, device=top_raw.device)
    return torch.where(top_raw > score_threshold, top_raw, neg_inf).to(torch.float32)


def _pre_threshold(classification, classification_is_logits, score_threshold):
    if classification_is_logits:
        return _conservative_logit_threshold(score_threshold, classification.dtype)
    return score_threshold


def batched_detections_deferred(
    regression: torch.Tensor,
    classification: torch.Tensor,
    anchors: torch.Tensor,
    image_shape_hw,
    classification_is_logits: bool = True,
    score_threshold: float = 0.05,
    max_detections: int = 300,
    nms_threshold: float = 0.5,
    pre_nms_top_k: int = 1024,
    soft_nms_sigma: float = 0.0,
) -> Detections:
    """Deferred-decode tail, class-specific: candidates are chosen per class
    on raw logits, and only those K are decoded (f32), clipped and
    suppressed (hard NMS) or rescored (soft-NMS, ``soft_nms_sigma > 0``).

    regression (B, N, 4), classification (B, N, C) in the heads' dtype;
    anchors (N, 4) float32."""
    b, n, c = classification.shape
    k = min(pre_nms_top_k, n)
    dev = classification.device

    pre_thr = _pre_threshold(classification, classification_is_logits,
                             score_threshold)
    neg_inf = torch.tensor(float("-inf"), dtype=classification.dtype, device=dev)
    masked = torch.where(classification > pre_thr, classification, neg_inf)
    top_raw, top_idx = exact_topk_lastdim(masked.transpose(1, 2), k)  # (B, C, K)
    cand_scores = _candidate_scores(top_raw, classification_is_logits,
                                    score_threshold)

    # decode only the candidates, in f32
    reg = regression[:, None, :, :].expand(b, c, n, 4)
    cand_reg = torch.gather(
        reg, 2, top_idx[..., None].expand(b, c, k, 4)).to(torch.float32)
    cand_anchors = anchors.to(torch.float32)[top_idx]  # (B, C, K, 4)
    cand_boxes = clip_boxes(bbox_transform_inv(cand_anchors, cand_reg),
                            image_shape_hw)
    f32_neg_inf = torch.tensor(float("-inf"), device=dev)

    if soft_nms_sigma > 0.0:
        rescored = _rows_soft(cand_boxes.reshape(b * c, k, 4),
                              cand_scores.reshape(b * c, k), soft_nms_sigma,
                              score_threshold, max_detections).reshape(b, c, k)
        kept_scores = torch.where(rescored > score_threshold, rescored, f32_neg_inf)
    else:
        valid = cand_scores > score_threshold
        keep = _rows_keep(cand_boxes.reshape(b * c, k, 4), valid.reshape(b * c, k),
                          nms_threshold).reshape(b, c, k)
        kept_scores = torch.where(keep, cand_scores, f32_neg_inf)

    # per-class cap, only when the candidate set exceeds it (the tie order
    # of the class merge depends on it, as in the reference)
    cand_boxes_f = cand_boxes
    if k > max_detections:
        kept_scores, sel = exact_topk_lastdim(kept_scores, max_detections)
        cand_boxes_f = torch.gather(
            cand_boxes, 2, sel[..., None].expand(b, c, max_detections, 4))

    mc = kept_scores.shape[2]
    all_scores = kept_scores.reshape(b, c * mc)
    all_boxes = cand_boxes_f.reshape(b, c * mc, 4)
    labels_grid = torch.arange(c, dtype=torch.int32, device=dev)[None, :, None] \
        .expand(b, c, mc).reshape(b, c * mc)

    out_k = min(max_detections, all_scores.shape[1])
    top_scores, sel2 = exact_topk_lastdim(all_scores, out_k)
    sel_boxes = torch.gather(all_boxes, 1, sel2[..., None].expand(b, out_k, 4))
    return _finish(top_scores, sel_boxes, torch.gather(labels_grid, 1, sel2),
                   max_detections)


def batched_detections_deferred_shared(
    regression: torch.Tensor,
    classification: torch.Tensor,
    anchors: torch.Tensor,
    image_shape_hw,
    classification_is_logits: bool = True,
    score_threshold: float = 0.05,
    max_detections: int = 300,
    nms_threshold: float = 0.5,
    pre_nms_top_k: int = 1024,
) -> Detections:
    """Deferred-decode tail, shared NMS: the per-anchor max score and its
    first-max label, one suppression over the merged candidates, and no
    per-class cap (max_detections applies once, at the merge)."""
    b, n, _ = classification.shape
    k = min(pre_nms_top_k, n)
    dev = classification.device

    pre_thr = _pre_threshold(classification, classification_is_logits,
                             score_threshold)
    max_raw = classification.max(dim=2).values  # (B, N)
    arg_labels = classification.argmax(dim=2).to(torch.int32)
    neg_inf = torch.tensor(float("-inf"), dtype=classification.dtype, device=dev)
    masked = torch.where(max_raw > pre_thr, max_raw, neg_inf)
    top_raw, top_idx = exact_topk_lastdim(masked, k)  # (B, K)
    cand_scores = _candidate_scores(top_raw, classification_is_logits,
                                    score_threshold)

    cand_reg = torch.gather(regression, 1,
                            top_idx[..., None].expand(b, k, 4)).to(torch.float32)
    cand_anchors = anchors.to(torch.float32)[top_idx]
    cand_boxes = clip_boxes(bbox_transform_inv(cand_anchors, cand_reg),
                            image_shape_hw)
    cand_labels = torch.gather(arg_labels, 1, top_idx)

    keep = _rows_keep(cand_boxes, cand_scores > score_threshold, nms_threshold)
    kept_scores = torch.where(keep, cand_scores,
                              torch.tensor(float("-inf"), device=dev))

    out_k = min(max_detections, k)
    top_scores, sel = exact_topk_lastdim(kept_scores, out_k)
    sel_boxes = torch.gather(cand_boxes, 1, sel[..., None].expand(b, out_k, 4))
    return _finish(top_scores, sel_boxes, torch.gather(cand_labels, 1, sel),
                   max_detections)

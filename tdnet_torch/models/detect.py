"""Inference tail: model outputs -> detections, the counterpart of
``tdnet/models/detect.py`` (``detections_from_outputs``, ``decode_boxes``).

``deferred=None`` picks the deferred-decode tail for ``nms and
(class_specific_filter or soft_nms_sigma == 0)``: class-specific (hard NMS
or soft-NMS) or shared NMS. Otherwise the legacy tail decodes every anchor
and filters (``batched_filter_detections``); shared NMS with soft-NMS goes
there, and its shared branch ignores soft-NMS, as the reference's does.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tdnet_torch.ops.anchors import AnchorParameters, anchors_for_shape
from tdnet_torch.ops.boxes import bbox_transform_inv, clip_boxes
from tdnet_torch.ops.nms import (Detections, batched_detections_deferred,
                                 batched_detections_deferred_shared,
                                 batched_filter_detections)

__all__ = ["detections_from_outputs", "decode_boxes"]


@functools.lru_cache(maxsize=16)
def _anchors(image_shape_hw: tuple, anchor_params, device: str) -> torch.Tensor:
    """float32 (N, 4) anchors of a bucket on ``device``."""
    return torch.from_numpy(
        anchors_for_shape(image_shape_hw, anchor_params=anchor_params)
        .astype("float32")).to(device)


def _bucket_anchors(image_shape_hw, anchor_params, device) -> torch.Tensor:
    return _anchors(tuple(int(s) for s in image_shape_hw[:2]), anchor_params,
                    str(device))


def decode_boxes(regression: torch.Tensor, image_shape_hw,
                 anchor_params: Optional[AnchorParameters] = None) -> torch.Tensor:
    """Decode (B, N, 4) regression deltas into clipped (B, N, 4) boxes, with
    the anchors in the regression's dtype."""
    anchors = _bucket_anchors(image_shape_hw, anchor_params, regression.device)
    boxes = bbox_transform_inv(anchors.to(regression.dtype)[None], regression)
    return clip_boxes(boxes, image_shape_hw)


def detections_from_outputs(
    outputs: dict,
    image_shape_hw,
    anchor_params: Optional[AnchorParameters] = None,
    classification_is_logits: bool = True,
    nms: bool = True,
    class_specific_filter: bool = True,
    score_threshold: float = 0.05,
    max_detections: int = 300,
    nms_threshold: float = 0.5,
    pre_nms_top_k: int = 1024,
    soft_nms_sigma: float = 0.0,
    deferred: Optional[bool] = None,
) -> Detections:
    """Full inference tail for a batch of outputs; detections are in the
    frame of the padded canvas ``image_shape_hw`` (divide by the resize
    scale on the host afterwards)."""
    common = dict(score_threshold=score_threshold, max_detections=max_detections,
                  nms_threshold=nms_threshold, pre_nms_top_k=pre_nms_top_k)
    if deferred is None:
        # soft-NMS is class-specific only: the shared combination stays on
        # the legacy tail rather than being reinterpreted
        deferred = nms and (class_specific_filter or soft_nms_sigma == 0.0)
    if deferred:
        if not nms:
            raise ValueError("deferred tail requires nms=True")
        if not class_specific_filter and soft_nms_sigma > 0.0:
            raise ValueError("soft-NMS is class-specific (reference semantics)")
        reg = outputs["regression"]
        anchors = _bucket_anchors(image_shape_hw, anchor_params, reg.device)
        if class_specific_filter:
            return batched_detections_deferred(
                reg, outputs["classification"], anchors, image_shape_hw,
                classification_is_logits=classification_is_logits,
                soft_nms_sigma=soft_nms_sigma, **common)
        return batched_detections_deferred_shared(
            reg, outputs["classification"], anchors, image_shape_hw,
            classification_is_logits=classification_is_logits, **common)

    boxes = decode_boxes(outputs["regression"], image_shape_hw, anchor_params)
    scores = outputs["classification"]
    if classification_is_logits:
        scores = torch.sigmoid(scores)
    return batched_filter_detections(
        boxes, scores, nms=nms, class_specific_filter=class_specific_filter,
        soft_nms_sigma=soft_nms_sigma, **common)

"""Box encode/decode, clipping and pairwise IoU on tensors, the counterpart
of ``tdnet/ops/boxes.py``.

Regression targets are corner-parameterized and normalized with mean 0 /
std 0.2 (:func:`bbox_transform`); :func:`bbox_transform_inv` is their exact
inverse. IoU comes in
two conventions: "exact" (continuous, what NMS uses) and "legacy" (the
Fast-R-CNN +1 pixel convention of anchor targets and mAP evaluation).
The operation order follows the reference, so the float32 results agree
to the last ulp.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["bbox_transform", "bbox_transform_inv", "clip_boxes", "box_iou"]

DEFAULT_MEAN = (0.0, 0.0, 0.0, 0.0)
DEFAULT_STD = (0.2, 0.2, 0.2, 0.2)


def bbox_transform(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   mean: Sequence[float] = DEFAULT_MEAN,
                   std: Sequence[float] = DEFAULT_STD) -> torch.Tensor:
    """Corner-parameterized regression targets of (..., 4) boxes against
    (..., 4) anchors, normalized by (mean, std)."""
    mean = torch.tensor(mean, dtype=anchors.dtype, device=anchors.device)
    std = torch.tensor(std, dtype=anchors.dtype, device=anchors.device)
    widths = anchors[..., 2] - anchors[..., 0]
    heights = anchors[..., 3] - anchors[..., 1]
    targets = torch.stack([
        (gt_boxes[..., 0] - anchors[..., 0]) / widths,
        (gt_boxes[..., 1] - anchors[..., 1]) / heights,
        (gt_boxes[..., 2] - anchors[..., 2]) / widths,
        (gt_boxes[..., 3] - anchors[..., 3]) / heights,
    ], dim=-1)
    return (targets - mean) / std


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor,
                       mean: Sequence[float] = DEFAULT_MEAN,
                       std: Sequence[float] = DEFAULT_STD) -> torch.Tensor:
    """Decode (..., 4) regression deltas against (..., 4) anchor boxes."""
    mean = torch.tensor(mean, dtype=deltas.dtype, device=deltas.device)
    std = torch.tensor(std, dtype=deltas.dtype, device=deltas.device)
    width = boxes[..., 2] - boxes[..., 0]
    height = boxes[..., 3] - boxes[..., 1]
    d = deltas * std + mean
    x1 = boxes[..., 0] + d[..., 0] * width
    y1 = boxes[..., 1] + d[..., 1] * height
    x2 = boxes[..., 2] + d[..., 2] * width
    y2 = boxes[..., 3] + d[..., 3] * height
    return torch.stack([x1, y1, x2, y2], dim=-1)


def clip_boxes(boxes: torch.Tensor, image_shape_hw) -> torch.Tensor:
    """Clamp (..., 4) boxes to [0, W] x [0, H]; image_shape_hw is (H, W)."""
    h = float(image_shape_hw[0])
    w = float(image_shape_hw[1])
    return torch.stack([
        boxes[..., 0].clamp(0.0, w),
        boxes[..., 1].clamp(0.0, h),
        boxes[..., 2].clamp(0.0, w),
        boxes[..., 3].clamp(0.0, h),
    ], dim=-1)


def box_iou(boxes: torch.Tensor, query_boxes: torch.Tensor,
            mode: str = "exact") -> torch.Tensor:
    """Pairwise IoU between (N, 4) and (K, 4) boxes -> (N, K)."""
    if mode == "legacy":
        off = 1.0
    elif mode == "exact":
        off = 0.0
    else:
        raise ValueError(f"unknown IoU mode: {mode!r}")
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0] + off)
              * (query_boxes[:, 3] - query_boxes[:, 1] + off))
    area_b = ((boxes[:, 2] - boxes[:, 0] + off)
              * (boxes[:, 3] - boxes[:, 1] + off))
    iw = (torch.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - torch.maximum(boxes[:, None, 0], query_boxes[None, :, 0]) + off)
    ih = (torch.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - torch.maximum(boxes[:, None, 1], query_boxes[None, :, 1]) + off)
    inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)
    union = area_b[:, None] + area_q[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))

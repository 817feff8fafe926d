"""Anchor target assignment on the device, the counterpart of
``tdnet/ops/targets.py``.

- Legacy "+1" IoU of every anchor with every GT slot; padded slots
  (``gt_mask`` False) never match.
- Best IoU >= 0.5 -> positive (1), > 0.4 -> ignore (-1), else negative (0);
  an image with no GT is all negative. No per-GT best-anchor forcing.
- Anchors whose centre has ``cx >= w`` or ``cy >= h`` of the unpadded image
  are ignored.
- labels (B, N, K+1): one-hot of the matched GT's class for positives, plus
  the state column; regression (B, N, 5): ``bbox_transform`` targets of the
  matched GT for positives, plus the state column.

The match is ``torch.argmax`` over the GT axis, which returns the FIRST
maximum, so ties go to the lowest GT index as in the reference (whose
cumsum-matmul one-hot and broadcast-sum row selection are TPU workarounds
for a slow gather). The batch dimension is written out.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tdnet_torch.ops.boxes import DEFAULT_MEAN, DEFAULT_STD, bbox_transform

__all__ = ["anchor_targets", "batched_anchor_targets"]


def _legacy_iou(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(N, 4) anchors x (B, M, 4) boxes -> (B, N, M) IoU with the +1 pixel
    convention, in ``box_iou(mode="legacy")``'s operation order."""
    area_q = (gt[..., 2] - gt[..., 0] + 1.0) * (gt[..., 3] - gt[..., 1] + 1.0)
    area_b = ((anchors[:, 2] - anchors[:, 0] + 1.0)
              * (anchors[:, 3] - anchors[:, 1] + 1.0))
    a = anchors[None, :, None, :]
    q = gt[:, None, :, :]
    iw = (torch.minimum(a[..., 2], q[..., 2])
          - torch.maximum(a[..., 0], q[..., 0]) + 1.0).clamp_min(0.0)
    ih = (torch.minimum(a[..., 3], q[..., 3])
          - torch.maximum(a[..., 1], q[..., 1]) + 1.0).clamp_min(0.0)
    inter = iw * ih
    union = area_b[None, :, None] + area_q[:, None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def batched_anchor_targets(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    image_hw: torch.Tensor,
    num_classes: int,
    negative_overlap: float = 0.4,
    positive_overlap: float = 0.5,
    mean: Sequence[float] = DEFAULT_MEAN,
    std: Sequence[float] = DEFAULT_STD,
):
    """anchors (N, 4); gt_boxes (B, M, 4); gt_labels, gt_mask (B, M);
    image_hw (B, 2) unpadded (h, w). Returns labels (B, N, K+1) and
    regression (B, N, 5), float32."""
    anchors = anchors.to(torch.float32)
    gt_boxes = gt_boxes.to(torch.float32)
    gt_mask = gt_mask.to(torch.bool)
    has_gt = gt_mask.any(dim=1)[:, None]                       # (B, 1)

    overlaps = _legacy_iou(anchors, gt_boxes)                   # (B, N, M)
    overlaps = torch.where(gt_mask[:, None, :], overlaps,
                           torch.full_like(overlaps, -1.0))
    best = torch.argmax(overlaps, dim=2)                        # first max
    max_overlaps = overlaps.gather(2, best[..., None])[..., 0]  # (B, N)
    del overlaps

    positive = (max_overlaps >= positive_overlap) & has_gt
    ignore = (max_overlaps > negative_overlap) & ~positive & has_gt
    state = torch.where(positive, 1.0, torch.where(ignore, -1.0, 0.0))

    cx = (anchors[:, 0] + anchors[:, 2]) / 2.0
    cy = (anchors[:, 1] + anchors[:, 3]) / 2.0
    hw = image_hw.to(torch.float32)
    outside = (cx[None, :] >= hw[:, 1:2]) | (cy[None, :] >= hw[:, 0:1])
    state = torch.where(outside, -1.0, state)
    is_pos = (state == 1.0)[..., None]

    matched_label = gt_labels.to(torch.int64).gather(1, best)   # (B, N)
    classes = torch.arange(num_classes, device=anchors.device)
    one_hot = (matched_label[..., None] == classes).to(torch.float32)
    one_hot = torch.where(is_pos, one_hot, torch.zeros_like(one_hot))
    labels = torch.cat([one_hot, state[..., None]], dim=-1)

    matched_box = gt_boxes.gather(1, best[..., None].expand(-1, -1, 4))
    reg = bbox_transform(anchors[None], matched_box, mean=mean, std=std)
    reg = torch.where(is_pos, reg, torch.zeros_like(reg))
    regression = torch.cat([reg, state[..., None]], dim=-1)
    return labels, regression


def anchor_targets(anchors, gt_boxes, gt_labels, gt_mask, image_hw,
                   num_classes: int, **kwargs):
    """One image: gt_boxes (M, 4), gt_labels/gt_mask (M,), image_hw (2,) ->
    labels (N, K+1), regression (N, 5)."""
    labels, regression = batched_anchor_targets(
        anchors, gt_boxes[None], gt_labels[None], gt_mask[None],
        torch.as_tensor(image_hw)[None], num_classes, **kwargs)
    return labels[0], regression[0]

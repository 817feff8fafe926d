"""Ops: anchors, box transforms, anchor targets, losses, the deferred NMS
tail, the trainable fused stem, and the hand-written CUDA kernels' wrappers
(ingest, stem and its backward, nms_kernel). The package exports the names
of ``tdnet/ops/__init__.py``."""

from tdnet_torch.ops.anchors import (
    AnchorParameters,
    anchors_for_shape,
    generate_anchors,
    guess_shapes,
    shift,
)
from tdnet_torch.ops.boxes import bbox_transform, bbox_transform_inv, box_iou, clip_boxes
from tdnet_torch.ops.losses import focal, smooth_l1
from tdnet_torch.ops.nms import filter_detections, non_max_suppression
from tdnet_torch.ops.targets import anchor_targets

__all__ = [
    "AnchorParameters",
    "anchors_for_shape",
    "generate_anchors",
    "guess_shapes",
    "shift",
    "bbox_transform",
    "bbox_transform_inv",
    "box_iou",
    "clip_boxes",
    "focal",
    "smooth_l1",
    "anchor_targets",
    "filter_detections",
    "non_max_suppression",
]

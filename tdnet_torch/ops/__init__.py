"""Ops: anchors, box transforms, anchor targets, losses, the deferred NMS
tail, the trainable fused stem, and the hand-written CUDA kernels' wrappers
(ingest, stem and its backward, nms_kernel)."""

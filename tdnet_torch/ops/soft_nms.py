"""Soft-NMS rescoring (Bodla et al. 2017), the counterpart of
``tdnet/ops/soft_nms.py`` (``soft_nms_rescore`` and the Pallas
``soft_nms_rescore_batched``).

Contract: boxes (R, K, 4) float32 and scores (R, K) float32 -> rescored
(R, K) float32, each row on its own. Scores at or below ``score_threshold``
start removed (-inf). Up to ``min(max_selections, K)`` greedy picks: the
largest remaining score, the lowest index on ties. A pick above the
threshold keeps the score it has at that moment; every other remaining box
is decayed by its exact IoU with the pick (gaussian ``exp(-iou^2 / sigma)``,
or linear ``1 - iou`` where ``iou > iou_threshold``), and the pick is
removed. A removed box (-inf) is never multiplied: linear decay is exactly 0
at IoU 1, and -inf * 0 is NaN. Boxes never picked get 0. A row stops once
its best remaining score is at or below the threshold (later picks would
change nothing).

The CUDA kernel is in ``csrc/soft_nms.cu``; :func:`soft_nms_rescore_plain`
is the plain PyTorch version, the reference's loop with the row dimension
written out. Unlike the TPU kernel, K and R need no padding.
"""

from __future__ import annotations

import torch

from tdnet_torch import _build

__all__ = ["LAUNCHES", "soft_nms_rescore_batched", "soft_nms_rescore_plain"]

LAUNCHES = _build.LaunchCounter("soft_nms")
_METHODS = {"gaussian": 0, "linear": 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_SLOTS_BYTES = 512     # the kernel's pick slots, beside the row's boxes


def _check(boxes: torch.Tensor, scores: torch.Tensor, method: str) -> None:
    if method not in _METHODS:
        raise ValueError(f"unknown soft-NMS method {method!r}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"boxes and scores must be float32, got {boxes.dtype} "
                        f"and {scores.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (R, K, 4), got {tuple(boxes.shape)}")
    if tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(
            f"scores {tuple(scores.shape)} does not match boxes {tuple(boxes.shape)}")
    if scores.device != boxes.device:
        raise ValueError(f"scores are on {scores.device}, boxes on {boxes.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("soft-NMS needs contiguous boxes and scores")


def soft_nms_rescore_plain(boxes: torch.Tensor, scores: torch.Tensor,
                           method: str = "gaussian", sigma: float = 0.5,
                           iou_threshold: float = 0.3,
                           score_threshold: float = 0.001,
                           max_selections: int = 300) -> torch.Tensor:
    """Plain PyTorch version: one greedy pick per step for every row at
    once, in the reference's operation order (exact IoU against the pick,
    ``union = area + area_pick - inter``)."""
    _check(boxes, scores, method)
    r, k = scores.shape
    dev = boxes.device
    neg_inf = torch.tensor(float("-inf"), device=dev)
    # divide by a tensor: a CUDA division by a Python scalar multiplies by
    # its reciprocal, one rounding more than the reference's divide
    sigma_t = torch.tensor(sigma, dtype=torch.float32, device=dev)
    remaining = torch.where(scores > score_threshold, scores, neg_inf)
    out = torch.zeros_like(scores)
    if r == 0 or k == 0:
        return out
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    lane = torch.arange(k, device=dev)
    rows = torch.arange(r, device=dev)
    for _ in range(min(max_selections, k)):
        top = remaining.max(dim=1, keepdim=True).values
        selected = top > score_threshold  # (R, 1)
        if not bool(selected.any()):
            break
        # lowest index holding the max (jnp.argmax's tie order)
        idx = torch.where(remaining == top, lane, k).min(dim=1).values
        is_idx = lane[None, :] == idx[:, None]
        out = torch.where(selected & is_idx, top, out)
        pick = boxes[rows, idx][:, :, None]  # (R, 4, 1)
        iw = (torch.minimum(x2, pick[:, 2]) - torch.maximum(x1, pick[:, 0])).clamp_min(0.0)
        ih = (torch.minimum(y2, pick[:, 3]) - torch.maximum(y1, pick[:, 1])).clamp_min(0.0)
        inter = iw * ih
        union = area + area[rows, idx][:, None] - inter
        iou = torch.where(union > 0, inter / union, torch.zeros_like(union))
        if method == "gaussian":
            decay = torch.exp(torch.div(-(iou * iou), sigma_t))
        else:
            decay = torch.where(iou > iou_threshold, 1.0 - iou,
                                torch.ones_like(iou))
        decayed = torch.where(remaining > neg_inf, remaining * decay, remaining)
        decayed = torch.where(is_idx, neg_inf, decayed)
        remaining = torch.where(selected, decayed, remaining)
    return out


def soft_nms_rescore_batched(boxes: torch.Tensor, scores: torch.Tensor,
                             method: str = "gaussian", sigma: float = 0.5,
                             iou_threshold: float = 0.3,
                             score_threshold: float = 0.001,
                             max_selections: int = 300) -> torch.Tensor:
    """Rescored (R, K) scores. CUDA tensors launch the CUDA kernel (one
    block per row, one thread per candidate up to K = 1024); CPU tensors use
    the plain version."""
    _check(boxes, scores, method)
    if boxes.device.type == "cpu":
        return soft_nms_rescore_plain(boxes, scores, method, sigma,
                                      iou_threshold, score_threshold,
                                      max_selections)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if boxes.data_ptr() % 16:
        raise ValueError("soft-NMS needs 16-byte aligned boxes")
    r, k = scores.shape
    if k * 16 + _SLOTS_BYTES > _SMEM_LIMIT:
        raise ValueError(f"K={k} boxes do not fit one block's shared memory")
    out = torch.empty((r, k), dtype=torch.float32, device=boxes.device)
    if r == 0 or k == 0:
        return out.zero_()
    lib = _build.library()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tdnet_soft_nms(
            boxes.data_ptr(), scores.data_ptr(), out.data_ptr(), r, k,
            min(int(max_selections), k), _METHODS[method], float(sigma),
            float(iou_threshold), float(score_threshold), stream)
    LAUNCHES.count += 1
    _build.check(err, "tdnet_soft_nms")
    return out

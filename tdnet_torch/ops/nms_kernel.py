"""Greedy-NMS keep mask over score-sorted boxes, the counterpart of
``tdnet/ops/pallas_nms.py`` (``pallas_nms_keep`` / ``pallas_nms_keep_rows``,
chosen there by ``pallas_nms_keep_auto``; both compute one contract).

Contract: boxes (R, K, 4) float32, each row sorted by descending score, and
valid (R, K) bool -> keep (R, K) bool. A box is kept iff it is valid and no
kept higher-ranked box has exact IoU above the threshold (strict >; IoU 0
where the union is <= 0). Invalid boxes are never kept and suppress
nothing. Unlike the TPU kernel, K need not be a multiple of 128.

The CUDA kernel is in ``csrc/nms.cu`` (an IoU bitmask pass over the card,
then a scan of it with one warp a row; a call counts as one launch);
:func:`nms_keep_plain` is the plain PyTorch version, the vectorized fixpoint
of ``tdnet/ops/nms.py`` ``non_max_suppression`` in f32.
"""

from __future__ import annotations

import torch

from tdnet_torch import _build
from tdnet_torch.ops.boxes import box_iou

__all__ = ["LAUNCHES", "nms_keep", "nms_keep_plain"]

LAUNCHES = _build.LaunchCounter("nms")
# the scan stages two 64-box chunks of mask rows in one block's shared
# memory: 2 * 64 * ceil(K / 64) * 8 bytes <= 232,448
_MAX_K = 14336


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (R, K, 4), got {tuple(boxes.shape)}")
    if tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(
            f"valid {tuple(valid.shape)} does not match boxes {tuple(boxes.shape)}")
    if valid.device != boxes.device:
        raise ValueError(f"valid is on {valid.device}, boxes on {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep needs contiguous boxes and valid")


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version: the parallel self-suppression sweep iterated
    to its fixpoint (equal to greedy NMS)."""
    _check(boxes, valid)
    r, k, _ = boxes.shape
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    iou = torch.stack([box_iou(boxes[i], boxes[i], "exact") for i in range(r)]) \
        if r else boxes.new_zeros((0, k, k))
    upper = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    # suppress[r, i, j]: valid i (higher score) can suppress j
    suppress = (iou > thr) & upper & valid[:, :, None]
    keep = valid & ~suppress.any(dim=1)
    while True:
        nxt = valid & ~(suppress & keep[:, :, None]).any(dim=1)
        if torch.equal(nxt, keep):
            return keep
        keep = nxt


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float = 0.5) -> torch.Tensor:
    """Keep mask for score-sorted rows. CUDA tensors launch the CUDA kernel;
    CPU tensors use the plain version."""
    _check(boxes, valid)
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_keep needs 16-byte aligned boxes")
    r, k, _ = boxes.shape
    if k > _MAX_K:
        raise ValueError(f"K={k} boxes exceed the NMS kernel's limit of {_MAX_K}")
    keep = torch.empty((r, k), dtype=torch.bool, device=boxes.device)
    if r == 0 or k == 0:
        return keep
    # the IoU bitmask the kernel's two passes share: one 64-bit word per box
    # and 64-box block of later boxes, a row's words padded to even
    row_words = k * -(-k // 64)
    mask = torch.empty(r * (row_words + row_words % 2), dtype=torch.int64,
                       device=boxes.device)
    lib = _build.library()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tdnet_nms_keep(boxes.data_ptr(), valid.data_ptr(),
                                 keep.data_ptr(), mask.data_ptr(), r, k,
                                 float(iou_threshold), stream)
    LAUNCHES.count += 1
    _build.check(err, "tdnet_nms_keep")
    return keep

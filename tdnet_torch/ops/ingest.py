"""uint8 page ingestion: normalize raw byte canvases on the device.

Replaces ``tdnet/ops/pallas_ingest.py`` ``normalize_uint8_rows`` (Pallas
kernel ``_kernel``; wrappers ``normalize_uint8_flat`` / ``normalize_uint8``,
and ``normalize_uint8_packed_sharded``, the forms for a batch sharded over
the ranks of a data-parallel run and for a (data, spatial) grid's bands
of rows: :func:`normalize_uint8_packed_sharded`).
It carries the Predictor's uint8 route when the fused stem is off. The
kernel walks its rows as one flat array, so any row width divisible by 3
works: the TPU's fixed 3072-byte rows are kept only where they divide.

Contract: an (R, W3) uint8 matrix with W3 % 3 == 0, the bytes of NHWC
canvases, becomes ``(f32(x) - mean[c]) * scale`` rounded to the output dtype,
where c = column % 3. 'caffe' subtracts the float32 BGR means with scale 1;
'tf' subtracts 127.5 and multiplies by the float32 constant 1/127.5.

The CUDA kernel (``csrc/ingest.cu``) is bound by memory bandwidth: it reads
one byte and writes 2 or 4 per element. Each thread moves 16 input bytes
with one vector load and writes its outputs with 16-byte stores. It matches
the plain version bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tdnet_torch import _build
from tdnet_torch.data.image import CAFFE_MEAN_BGR
from tdnet_torch.parallel.mesh import Grid, check_shard, process_count
from tdnet_torch.parallel.spatial import image_band

__all__ = [
    "LAUNCHES",
    "ROW",
    "mode_constants",
    "normalize_uint8_packed_sharded",
    "normalize_uint8_rows",
    "normalize_uint8_rows_plain",
    "pack_uint8_host",
]

ROW = 3072  # flat-row width: 1024 pixels x 3 channels
LAUNCHES = _build.LaunchCounter("ingest")
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mode_constants(mode: str):
    """(per-channel float32 means (3,), float32 scale) of a normalize mode."""
    if mode == "caffe":
        return CAFFE_MEAN_BGR.astype(np.float32), np.float32(1.0)
    if mode == "tf":
        return np.full((3,), 127.5, np.float32), np.float32(1.0 / 127.5)
    raise ValueError(f"unknown preprocessing mode {mode!r}")


def pack_uint8_host(images: np.ndarray, flat: bool = False) -> np.ndarray:
    """The uint8 host->device layouts: (B, H, W*3) packed rows for the fused
    stem, or with flat=True 2-D rows for the normalize kernel: (R, 3072)
    when the size divides 3072, else (B*H, W*3). Other input passes
    through."""
    if getattr(images, "dtype", None) != np.uint8 or images.ndim != 4 \
            or images.shape[-1] != 3:
        return images
    b, h, w, _ = images.shape
    if not flat:
        return images.reshape(b, h, w * 3)
    if (b * h * w * 3) % ROW == 0:
        return images.reshape(-1, ROW)
    return images.reshape(b * h, w * 3)


def _check(mat: torch.Tensor, out_dtype) -> None:
    if mat.dtype != torch.uint8:
        raise TypeError(f"normalize_uint8 expects uint8, got {mat.dtype}")
    if mat.dim() != 2 or mat.shape[-1] % 3 != 0:
        raise ValueError(
            f"expected (R, W3) with W3 % 3 == 0, got {tuple(mat.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if not mat.is_contiguous():
        raise ValueError("normalize_uint8_rows needs a contiguous matrix")


def normalize_uint8_rows_plain(mat: torch.Tensor, mode: str = "caffe",
                               out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract)."""
    _check(mat, out_dtype)
    mean, scale = mode_constants(mode)
    w3 = mat.shape[-1]
    mean_row = torch.from_numpy(np.tile(mean, w3 // 3)).to(mat.device)
    scale_t = torch.tensor(scale, dtype=torch.float32, device=mat.device)
    return ((mat.to(torch.float32) - mean_row) * scale_t).to(out_dtype)


def normalize_uint8_rows(mat: torch.Tensor, mode: str = "caffe",
                         out_dtype=torch.float32) -> torch.Tensor:
    """(R, W3) uint8 -> normalized out_dtype. CUDA tensors launch the CUDA
    kernel; CPU tensors use the plain version."""
    _check(mat, out_dtype)
    if mat.device.type == "cpu":
        return normalize_uint8_rows_plain(mat, mode, out_dtype)
    if mat.device.type != "cuda":
        raise ValueError(f"unsupported device {mat.device}")
    mean, scale = mode_constants(mode)
    out = torch.empty(mat.shape, dtype=out_dtype, device=mat.device)
    if mat.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tdnet_normalize_u8(
            mat.data_ptr(), out.data_ptr(), mat.numel(), _OUT_DTYPES[out_dtype],
            float(mean[0]), float(mean[1]), float(mean[2]), float(scale),
            stream)
    LAUNCHES.count += 1
    _build.check(err, "tdnet_normalize_u8")
    return out


def normalize_uint8_packed_sharded(packed: torch.Tensor, mode: str = "caffe",
                                   out_dtype=torch.float32,
                                   global_batch: Optional[int] = None,
                                   grid: Optional[Grid] = None) -> torch.Tensor:
    """The sharded forms, reference ``normalize_uint8_packed_sharded``.

    On its 1-D data mesh (``grid`` None): ``packed`` (b, H, W3) is this
    rank's shard of a batch of ``global_batch`` rows (default b x the
    ranks), which must divide over the ranks (else it raises, as the
    reference does). Each rank normalizes its own shard with the kernel;
    the elementwise op needs no collective. -> (b, H, W3 // 3, 3).

    On a (data, spatial) grid (``parallel/spatial.py``): ``packed`` holds
    this rank's b pages of a global batch of b x ``grid.data_count``, and
    the rank normalizes its band of their rows with the kernel ->
    (b, band rows, W3 // 3, 3). This form keeps the reference's
    exact-division rule (the batch over the data axis, H over the spatial
    axis) and its refusal of other grids; the train step normalizes any
    band with :func:`normalize_uint8_rows` itself."""
    b, h, w3 = packed.shape
    if grid is None:
        check_shard(b, b * process_count() if global_batch is None else global_batch)
        out = normalize_uint8_rows(packed.reshape(b * h, w3), mode, out_dtype)
        return out.reshape(b, h, w3 // 3, 3)
    if grid.axis != "spatial":
        raise ValueError(f"unsupported mesh axes {grid.axis_names} (expected ('data',) "
                         "or ('data', 'spatial'))")
    nd, ns = grid.data_count, grid.size
    total = b * nd if global_batch is None else global_batch
    if total % nd or h % ns:
        raise ValueError(f"(batch {total}, H {h}) does not divide over the "
                         f"(data={nd}, spatial={ns}) mesh")
    out = normalize_uint8_rows(image_band(packed, grid).reshape(-1, w3), mode, out_dtype)
    return out.reshape(b, h // ns, w3 // 3, 3)

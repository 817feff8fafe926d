"""Fused 1x1 convolution + folded BN + residual + ReLU, the counterpart of
``tdnet/ops/pallas_conv.py`` (``fused_conv1x1``).

Contract: ``out = [relu]((x . kernel) * inv + offset [+ residual])`` for x
(..., K) in the compute dtype (float32 or bfloat16), kernel (1, 1, K, N) or
(K, N) (cast to x's dtype before the product), inv and offset (N,) (the
folded frozen-BN pair) and an optional residual (..., N) (cast to x's
dtype). The product accumulates in f32 and is rounded to the compute dtype
before the affine; inv and offset are rounded to the compute dtype; then
``* inv``, ``+ offset``, ``+ residual`` and the ReLU are each computed in
f32 and rounded after every operation. The output has x's dtype and shape
(..., N).

Like the JAX package, the port wires this into no model: no path of the
system runs it. The CUDA kernel is in ``csrc/conv1x1.cu`` (bfloat16 on the
tensor cores, which needs K % 16 == 0, as every ResNet width has; float32
on the CUDA cores); :func:`fused_conv1x1_plain` is the plain PyTorch
version. The TPU kernel's tiles (``tile_m``, ``tile_n``) and its padding of
M and N have no counterpart: the kernel guards its bounds.
"""

from __future__ import annotations

from typing import Optional

import torch

from tdnet_torch import _build
from tdnet_torch.device import no_tf32

__all__ = ["LAUNCHES", "fused_conv1x1", "fused_conv1x1_plain"]

LAUNCHES = _build.LaunchCounter("conv1x1")
_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def _prepare(x, kernel, inv, offset, residual):
    """Checked (x2 (M, K), w (K, N) in x's dtype, inv, offset, residual
    (M, N) in x's dtype or None, output shape)."""
    if x.dtype not in _KINDS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if kernel.dim() == 4:
        if tuple(kernel.shape[:2]) != (1, 1):
            raise ValueError(f"a 4-D kernel must be (1, 1, K, N), got {tuple(kernel.shape)}")
        kernel = kernel.reshape(kernel.shape[2], kernel.shape[3])
    if kernel.dim() != 2 or x.dim() < 1 or kernel.shape[0] != x.shape[-1]:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not match x {tuple(x.shape)}")
    k, n = kernel.shape
    lead = tuple(x.shape[:-1])
    if tuple(inv.shape) != (n,) or tuple(offset.shape) != (n,):
        raise ValueError(f"inv {tuple(inv.shape)} and offset {tuple(offset.shape)} "
                         f"must be ({n},)")
    if residual is not None and tuple(residual.shape) != lead + (n,):
        raise ValueError(f"residual {tuple(residual.shape)} must be {lead + (n,)}")
    for t in (kernel, inv, offset) + ((residual,) if residual is not None else ()):
        if t.device != x.device:
            raise ValueError(f"an input is on {t.device}, x on {x.device}")
    x2 = x.reshape(-1, k)
    res2 = None if residual is None else residual.reshape(-1, n).to(x.dtype)
    return (x2, kernel.to(x.dtype), inv.float(), offset.float(), res2,
            lead + (n,))


def fused_conv1x1_plain(x: torch.Tensor, kernel: torch.Tensor,
                        inv: torch.Tensor, offset: torch.Tensor,
                        residual: Optional[torch.Tensor] = None,
                        relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the f32 product of compute-dtype operands
    (TF32 off), rounded to the compute dtype, then PyTorch's elementwise ops
    in the compute dtype (each rounds its result)."""
    x2, w, inv, offset, res2, shape = _prepare(x, kernel, inv, offset, residual)
    cd = x.dtype
    with no_tf32():
        y = (x2.float() @ w.float()).to(cd)
    y = y * inv.to(cd)
    y = y + offset.to(cd)
    if res2 is not None:
        y = y + res2
    if relu:
        y = torch.relu(y)
    return y.reshape(shape)


def fused_conv1x1(x: torch.Tensor, kernel: torch.Tensor, inv: torch.Tensor,
                  offset: torch.Tensor, residual: Optional[torch.Tensor] = None,
                  relu: bool = True) -> torch.Tensor:
    """``[relu]((x . kernel) * inv + offset [+ residual])``. CUDA tensors
    launch the CUDA kernel (bfloat16 needs K % 16 == 0); CPU tensors use
    the plain version."""
    if x.device.type == "cpu":
        return fused_conv1x1_plain(x, kernel, inv, offset, residual, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x2, w, inv, offset, res2, shape = _prepare(x, kernel, inv, offset, residual)
    m, k = x2.shape
    n = w.shape[1]
    if x.dtype == torch.bfloat16 and k % 16:
        raise ValueError(f"the bfloat16 kernel needs K % 16 == 0, got K {k}")
    x2, w, inv, offset = (t.contiguous() for t in (x2, w, inv, offset))
    res2 = None if res2 is None else res2.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out.reshape(shape)
    tensors = [x2, w, out] + ([res2] if res2 is not None else [])
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the bfloat16 fused_conv1x1 needs 16-byte aligned tensors")
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tdnet_conv1x1(x2.data_ptr(), w.data_ptr(), inv.data_ptr(),
                                offset.data_ptr(),
                                None if res2 is None else res2.data_ptr(),
                                out.data_ptr(), m, k, n, int(bool(relu)),
                                _KINDS[x.dtype], stream)
        LAUNCHES.count += 1
        _build.check(err, "tdnet_conv1x1")
    return out.reshape(shape)

"""Fused ingest + ResNet stem, the counterpart of
``tdnet/ops/pallas_stem.py`` ``fused_stem_packed`` (forward).

Contract: packed uint8 rows (B, H, W*3) -> caffe/tf normalize in f32 ->
round to the compute dtype -> zero pad 3 (in normalized space) -> 7x7/2
conv 3->64 with f32 accumulation against the weights rounded to the compute
dtype -> f32 folded frozen BN (x*inv + off) -> ReLU -> round to the compute
dtype -> 3x3/2 'SAME' max-pool -> NHWC (B, H/4, W/4, 64). The compute dtype
is bf16 when the output is bf16 and f32 otherwise.

The output is exactly the ``channels_last`` input the stem-input ResNet
takes (``.permute(0, 3, 1, 2)`` is a free view). The CUDA kernel is in
``csrc/stem.cu``; :func:`fused_stem_plain` is the plain PyTorch version.

The backward, the counterpart of ``fused_stem_bwd_packed`` of the same
file: from the pooled cotangent dy (B, H/4, W/4, 64) in the output dtype,
the f32 gradients (dkernel7 (7, 7, 3, 64), dinv (64,), doff (64,)). It
recomputes the conv, routes each pooled gradient to the FIRST maximum of its
3x3 window (row-major, comparing the compute-dtype activations the forward
pooled), masks by ``x*inv + off > 0``, rounds ``dz = dwp*inv`` to the compute
dtype and contracts it with the rounded input in f32. The CUDA kernel is in
``csrc/stem_bwd.cu``; :func:`fused_stem_bwd_plain` is the plain version.

In bf16 both kernels compute the conv on the tensor cores through one shared
tile (``csrc/stem_common.cuh``), so the activations the backward routes on
equal the forward's bit for bit; :func:`fused_stem_bwd_pooled` returns them
pooled, for that check. In f32 both run on the CUDA cores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tdnet_torch import _build
from tdnet_torch.device import no_tf32
from tdnet_torch.models.layers import same_pads
from tdnet_torch.models.resnet import max_pool_same
from tdnet_torch.ops.ingest import mode_constants

__all__ = ["LAUNCHES", "BWD_LAUNCHES", "supports_shape", "fused_stem_packed",
           "fused_stem_plain", "fused_stem_bwd_packed", "fused_stem_bwd_plain",
           "fused_stem_bwd_pooled"]

LAUNCHES = _build.LaunchCounter("stem")
BWD_LAUNCHES = _build.LaunchCounter("stem_bwd")
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_BLOCKS = 264   # the backward's persistent grid: 2 blocks on each of 132 SMs
_NW = 7 * 7 * 3 * 64


def supports_shape(shape) -> bool:
    """(B, H, W, 3) with H % 8 == 0 and W % 4 == 0: the JAX package's gate,
    kept so both route the same buckets to the fused stem."""
    return (len(shape) == 4 and shape[-1] == 3 and shape[1] % 8 == 0
            and shape[2] % 4 == 0 and shape[1] >= 8 and shape[2] >= 8)


def _check(packed, kernel7, bn_inv, bn_off, normalize, out_dtype):
    if packed.dtype != torch.uint8:
        raise TypeError(f"fused stem expects uint8 rows, got {packed.dtype}")
    if packed.dim() != 3 or packed.shape[-1] % 3 != 0:
        raise ValueError(f"expected packed (B, H, W*3), got {tuple(packed.shape)}")
    b, h, w3 = packed.shape
    if not supports_shape((b, h, w3 // 3, 3)):
        raise ValueError(f"unsupported packed stem shape {tuple(packed.shape)}")
    if tuple(kernel7.shape) != (7, 7, 3, 64) or kernel7.dtype != torch.float32:
        raise ValueError(
            f"kernel7 must be float32 (7, 7, 3, 64), got {kernel7.dtype} "
            f"{tuple(kernel7.shape)}")
    for name, t in (("bn_inv", bn_inv), ("bn_off", bn_off)):
        if tuple(t.shape) != (64,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (64,)")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    mode_constants(normalize)  # raises on an unknown mode
    for name, t in (("packed", packed), ("kernel7", kernel7),
                    ("bn_inv", bn_inv), ("bn_off", bn_off)):
        if t.device != packed.device:
            raise ValueError(f"{name} is on {t.device}, packed on {packed.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if packed.device.type == "cuda" and packed.data_ptr() % 4:
        raise ValueError("packed must start on a 4-byte boundary (the "
                         "kernels copy it in 4-byte words)")


def fused_stem_plain(packed: torch.Tensor, kernel7: torch.Tensor,
                     bn_inv: torch.Tensor, bn_off: torch.Tensor,
                     normalize: str = "caffe",
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract). On a CUDA
    device the conv runs in full f32 (TF32 off for the call)."""
    _check(packed, kernel7, bn_inv, bn_off, normalize, out_dtype)
    x, wt = _plain_operands(packed, kernel7, normalize, out_dtype)
    with no_tf32():
        y = F.conv2d(x, wt, stride=2)
    y = y * bn_inv[None, :, None, None] + bn_off[None, :, None, None]
    y = max_pool_same(torch.relu(y).to(out_dtype).to(torch.float32))
    return y.permute(0, 2, 3, 1).contiguous().to(out_dtype)


def _plain_operands(packed, kernel7, normalize, cd):
    """The normalized input rounded to the compute dtype cd, zero-padded by
    3, NCHW f32; and the weights rounded to cd, OIHW f32."""
    b, h, w3 = packed.shape
    mean, scale = mode_constants(normalize)
    dev = packed.device
    x = packed.reshape(b, h, w3 // 3, 3).to(torch.float32)
    x = (x - torch.from_numpy(mean).to(dev)) * torch.tensor(scale, device=dev)
    x = x.to(cd).to(torch.float32).permute(0, 3, 1, 2)
    wt = kernel7.to(cd).to(torch.float32).permute(3, 2, 0, 1)
    return F.pad(x, (3, 3, 3, 3)), wt


def fused_stem_packed(packed: torch.Tensor, kernel7: torch.Tensor,
                      bn_inv: torch.Tensor, bn_off: torch.Tensor,
                      normalize: str = "caffe",
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Packed uint8 rows -> pooled stem activations (B, H/4, W/4, 64) NHWC.
    CUDA tensors launch the CUDA kernel; CPU tensors use the plain
    version."""
    _check(packed, kernel7, bn_inv, bn_off, normalize, out_dtype)
    if packed.device.type == "cpu":
        return fused_stem_plain(packed, kernel7, bn_inv, bn_off, normalize,
                                out_dtype)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    b, h, w3 = packed.shape
    w = w3 // 3
    mean, scale = mode_constants(normalize)
    out = torch.empty((b, h // 4, w // 4, 64), dtype=out_dtype,
                      device=packed.device)
    if b == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tdnet_fused_stem(
            packed.data_ptr(), kernel7.data_ptr(), bn_inv.data_ptr(),
            bn_off.data_ptr(), out.data_ptr(), b, h, w,
            float(mean[0]), float(mean[1]), float(mean[2]), float(scale),
            _OUT_DTYPES[out_dtype], stream)
    LAUNCHES.count += 1
    _build.check(err, "tdnet_fused_stem")
    return out


def _check_bwd(packed, kernel7, bn_inv, bn_off, dy, normalize, out_dtype):
    _check(packed, kernel7, bn_inv, bn_off, normalize, out_dtype)
    b, h, w3 = packed.shape
    want = (b, h // 4, w3 // 12, 64)
    if tuple(dy.shape) != want or dy.dtype != out_dtype:
        raise ValueError(f"dy must be {out_dtype} {want}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    if dy.device != packed.device:
        raise ValueError(f"dy is on {dy.device}, packed on {packed.device}")
    if not dy.is_contiguous():
        raise ValueError("dy must be contiguous")


def fused_stem_bwd_plain(packed: torch.Tensor, kernel7: torch.Tensor,
                         bn_inv: torch.Tensor, bn_off: torch.Tensor,
                         dy: torch.Tensor, normalize: str = "caffe",
                         out_dtype=torch.bfloat16):
    """Plain PyTorch version of the backward kernel (same contract): the
    steps written out, not autograd of the forward (which would neither
    round dz nor promise first-max routing). Convolutions in full f32."""
    _check_bwd(packed, kernel7, bn_inv, bn_off, dy, normalize, out_dtype)
    cd = out_dtype
    x, wt = _plain_operands(packed, kernel7, normalize, cd)
    with no_tf32():
        z = F.conv2d(x, wt, stride=2)                      # (B, 64, H/2, W/2)
    inv = bn_inv[None, :, None, None]
    wp = z * inv + bn_off[None, :, None, None]
    a = torch.relu(wp).to(cd).to(torch.float32)
    h2, w2 = z.shape[2:]
    h4, w4 = dy.shape[1:3]
    ph, pw = same_pads(h2, 3, 2), same_pads(w2, 3, 2)
    a = F.pad(a, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    da = torch.zeros_like(a)

    def window(t, dr, dc):  # the (dr, dc) element of every pooled window
        return t[:, :, dr:dr + 2 * h4 - 1:2, dc:dc + 2 * w4 - 1:2]

    pool = window(a, 0, 0)
    for dr in range(3):
        for dc in range(3):
            pool = torch.maximum(pool, window(a, dr, dc))
    g = dy.to(torch.float32).permute(0, 3, 1, 2)
    taken = torch.zeros_like(pool, dtype=torch.bool)
    for dr in range(3):      # row-major: the first maximum takes the gradient
        for dc in range(3):
            hit = (window(a, dr, dc) == pool) & ~taken
            window(da, dr, dc).add_(torch.where(hit, g, torch.zeros_like(g)))
            taken |= hit
    da = da[:, :, ph[0]:ph[0] + h2, pw[0]:pw[0] + w2]
    dwp = torch.where(wp > 0, da, torch.zeros_like(da))
    doff = dwp.sum(dim=(0, 2, 3))
    dinv = (dwp * z).sum(dim=(0, 2, 3))
    dz = (dwp * inv).to(cd).to(torch.float32)
    with no_tf32():
        dk = torch.nn.grad.conv2d_weight(x, tuple(wt.shape), dz, stride=2)
    return dk.permute(2, 3, 1, 0).contiguous(), dinv, doff


def fused_stem_bwd_packed(packed: torch.Tensor, kernel7: torch.Tensor,
                          bn_inv: torch.Tensor, bn_off: torch.Tensor,
                          dy: torch.Tensor, normalize: str = "caffe",
                          out_dtype=torch.bfloat16):
    """Gradients (dkernel7, dinv, doff), f32, of the fused stem from the
    pooled cotangent dy. CUDA tensors launch the CUDA kernel; CPU tensors
    use the plain version."""
    _check_bwd(packed, kernel7, bn_inv, bn_off, dy, normalize, out_dtype)
    if packed.device.type == "cpu":
        return fused_stem_bwd_plain(packed, kernel7, bn_inv, bn_off, dy,
                                    normalize, out_dtype)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    b, h, w3 = packed.shape
    mean, scale = mode_constants(normalize)
    out = torch.empty(_NW + 2 * 64, dtype=torch.float32, device=packed.device)
    # one partial per block, summed by the kernel's second pass
    partial = torch.empty((BWD_BLOCKS, out.numel()), dtype=torch.float32,
                          device=packed.device)
    lib = _build.library()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tdnet_fused_stem_bwd(
            packed.data_ptr(), kernel7.data_ptr(), bn_inv.data_ptr(),
            bn_off.data_ptr(), dy.data_ptr(), partial.data_ptr(),
            out.data_ptr(), b, h, w3 // 3, float(mean[0]), float(mean[1]),
            float(mean[2]), float(scale), _OUT_DTYPES[out_dtype], BWD_BLOCKS,
            stream)
    BWD_LAUNCHES.count += 1
    _build.check(err, "tdnet_fused_stem_bwd")
    return out[:_NW].view(7, 7, 3, 64), out[_NW:_NW + 64], out[_NW + 64:]


def fused_stem_bwd_pooled(packed: torch.Tensor, kernel7: torch.Tensor,
                          bn_inv: torch.Tensor, bn_off: torch.Tensor,
                          normalize: str = "caffe") -> torch.Tensor:
    """The bf16 backward kernel's recomputed activations, pooled (B, H/4,
    W/4, 64) bf16: what it routes the pool gradient on. Equal to
    ``fused_stem_packed(..., out_dtype=bfloat16)`` bit for bit when the two
    kernels' conv tiles agree. CUDA only (a check of the kernels)."""
    out_dtype = torch.bfloat16
    _check(packed, kernel7, bn_inv, bn_off, normalize, out_dtype)
    if packed.device.type != "cuda":
        raise ValueError("fused_stem_bwd_pooled checks the CUDA kernels: "
                         f"got a tensor on {packed.device}")
    b, h, w3 = packed.shape
    mean, scale = mode_constants(normalize)
    dy = torch.zeros((b, h // 4, w3 // 12, 64), dtype=out_dtype,
                     device=packed.device)
    pooled = torch.empty_like(dy)
    out = torch.empty(_NW + 2 * 64, dtype=torch.float32, device=packed.device)
    partial = torch.empty((BWD_BLOCKS, out.numel()), dtype=torch.float32,
                          device=packed.device)
    lib = _build.library()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tdnet_fused_stem_bwd_pooled(
            packed.data_ptr(), kernel7.data_ptr(), bn_inv.data_ptr(),
            bn_off.data_ptr(), dy.data_ptr(), partial.data_ptr(),
            out.data_ptr(), pooled.data_ptr(), b, h, w3 // 3, float(mean[0]),
            float(mean[1]), float(mean[2]), float(scale), BWD_BLOCKS, stream)
    BWD_LAUNCHES.count += 1
    _build.check(err, "tdnet_fused_stem_bwd_pooled")
    return pooled

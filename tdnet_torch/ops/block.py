"""Fused identity bottlenecks, the counterpart of
``tdnet/ops/pallas_block.py`` (``fused_bottleneck_chain``,
``fused_bottleneck``, ``supports_block``).

Contract of a chain of D identity blocks: x (B, H, W, C) NHWC in the compute
dtype (float32 or bfloat16); w1s (D, C, M), w2s (D, 3, 3, M, M) HWIO,
w3s (D, M, C); folded frozen-BN pairs bn1/bn2 (D, M) and bn3 (D, C) in
float32. Each block: t1 = relu(x . w1 * inv1 + off1), rounded; t2 =
relu(conv3x3_SAME(t1) * inv2 + off2), rounded (t1 is zero outside the
image); y = relu(t2 . w3 * inv3 + off3 + x), rounded. Products of
compute-dtype operands accumulate in f32, and BN, ReLU and the residual are
f32. Inference only: no gradient.

The CUDA kernel is in ``csrc/block.cu`` (one launch per block of the chain;
bfloat16 on the tensor cores through ``wgmma``, which needs M % 32 == 0, as
every ResNet width has: a persistent grid of 16x8- or 8x8-pixel tiles fed by
a cp.async ring of weight chunks, :func:`launch_info`, that reads its
weights K-major, :func:`kmajor_weights`);
:func:`fused_bottleneck_chain_plain` is the plain PyTorch version. The TPU kernel's row tiling (``tm``,
``_resolve_tm``) has no counterpart.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tdnet_torch import _build
from tdnet_torch.device import no_tf32

__all__ = ["LAUNCHES", "supports_block", "fused_bottleneck_chain",
           "fused_bottleneck_chain_plain", "fused_bottleneck", "kmajor_weights",
           "launch_info"]

LAUNCHES = _build.LaunchCounter("block")
_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def supports_block(x_shape, cmid: int) -> bool:
    """(B, H, W, C) with H >= 4, W >= 16, W % 8 == 0, C % 64 == 0 and
    M % 8 == 0: the JAX package's gate, kept so both route the same
    stages."""
    if len(x_shape) != 4:
        return False
    _, h, w, c = x_shape
    return h >= 4 and w >= 16 and w % 8 == 0 and c % 64 == 0 and cmid % 8 == 0


def _check(x, w1s, w2s, w3s, bns, out_dtype):
    if x.dtype not in _KINDS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {x.dtype} or float32, got {out_dtype}")
    if x.dim() != 4 or w1s.dim() != 3:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, w1s {tuple(w1s.shape)}")
    depth, cin, cmid = w1s.shape
    if (cin != x.shape[3] or tuple(w2s.shape) != (depth, 3, 3, cmid, cmid)
            or tuple(w3s.shape) != (depth, cmid, cin)):
        raise ValueError(
            f"bad weight shapes {tuple(w1s.shape)}/{tuple(w2s.shape)}/"
            f"{tuple(w3s.shape)} for x {tuple(x.shape)}")
    if not supports_block(tuple(x.shape), cmid):
        raise ValueError(f"unsupported block shape {tuple(x.shape)} cmid={cmid}")
    for i, t in enumerate(bns):
        want = (depth, cmid if i < 4 else cin)
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"BN vector {i} must be float32 {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (x, w1s, w2s, w3s, *bns):
        if t.device != x.device:
            raise ValueError(f"a chain input is on {t.device}, x on {x.device}")
        if t.requires_grad:
            raise ValueError("fused_bottleneck_chain is inference-only: an "
                             "input requires grad")


def fused_bottleneck_chain_plain(x, w1s, w2s, w3s, bn1_inv, bn1_off,
                                 bn2_inv, bn2_off, bn3_inv, bn3_off,
                                 out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: full-f32 convolutions (TF32 off) of
    compute-dtype-rounded operands, then BN, ReLU and the residual in f32 and
    one rounding per tensor, step by step as the kernel does."""
    bns = (bn1_inv, bn1_off, bn2_inv, bn2_off, bn3_inv, bn3_off)
    out_dtype = out_dtype or x.dtype
    _check(x, w1s, w2s, w3s, bns, out_dtype)
    cd = x.dtype
    f32 = torch.float32

    def bn(t, inv, off):  # (B, ch, H, W) f32
        return t * inv[:, None, None] + off[:, None, None]

    y = x.permute(0, 3, 1, 2)  # NCHW view
    with no_tf32():
        for d in range(w1s.shape[0]):
            w1 = w1s[d].to(cd).to(f32).t()[:, :, None, None]
            w2 = w2s[d].to(cd).to(f32).permute(3, 2, 0, 1)
            w3 = w3s[d].to(cd).to(f32).t()[:, :, None, None]
            yf = y.to(f32)
            t1 = torch.relu(bn(F.conv2d(yf, w1), bn1_inv[d], bn1_off[d])).to(cd)
            t2 = torch.relu(bn(F.conv2d(t1.to(f32), w2, padding=1),
                               bn2_inv[d], bn2_off[d])).to(cd)
            t3 = bn(F.conv2d(t2.to(f32), w3), bn3_inv[d], bn3_off[d])
            y = torch.relu(t3 + yf).to(cd)
    return y.permute(0, 2, 3, 1).contiguous().to(out_dtype)


def kmajor_weights(w1s, w2s, w3s):
    """The bfloat16 kernel's weight layout: w1s (D, C, M), w2s
    (D, 3, 3, M, M) and w3s (D, M, C) rounded to bfloat16 and laid out
    K-major, as its wgmma reads them: (D, M, C), (D, M, 9M) with K ordered
    (dy, dx, input channel), and (D, C, M). A caller that runs the same
    weights many times lays them out once and passes the result to
    :func:`fused_bottleneck_chain` as ``kmajor``."""
    depth, _, m = w1s.shape
    bf = torch.bfloat16
    with torch.no_grad():
        return (w1s.to(bf).transpose(1, 2).contiguous(),
                w2s.to(bf).permute(0, 4, 1, 2, 3).reshape(depth, m, 9 * m).contiguous(),
                w3s.to(bf).transpose(1, 2).contiguous())


def _check_kmajor(kmajor, w1s, device):
    depth, c, m = w1s.shape
    want = ((depth, m, c), (depth, m, 9 * m), (depth, c, m))
    if len(kmajor) != 3 or any(
            tuple(t.shape) != s or t.dtype != torch.bfloat16 or not t.is_contiguous()
            or t.device != device for t, s in zip(kmajor, want)):
        raise ValueError("kmajor must be kmajor_weights(w1s, w2s, w3s) on x's "
                         f"device: contiguous bfloat16 {want}")


def fused_bottleneck_chain(x, w1s, w2s, w3s, bn1_inv, bn1_off, bn2_inv,
                           bn2_off, bn3_inv, bn3_off, out_dtype=None,
                           kmajor=None) -> torch.Tensor:
    """A run of D identity bottlenecks. CUDA tensors launch the CUDA kernel
    once per block: f32 reads the weights rounded to f32; bfloat16, which needs
    M % 32 == 0, reads them K-major, from ``kmajor`` (the
    :func:`kmajor_weights` of these weights, which the caller vouches for)
    or laid out here on every call. CPU tensors use the plain version, which
    reads only the weights as given."""
    bns = (bn1_inv, bn1_off, bn2_inv, bn2_off, bn3_inv, bn3_off)
    out_dtype = out_dtype or x.dtype
    _check(x, w1s, w2s, w3s, bns, out_dtype)
    if x.device.type == "cpu":
        return fused_bottleneck_chain_plain(x, w1s, w2s, w3s, *bns,
                                            out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    cd = x.dtype
    b, h, w, c = x.shape
    depth, _, m = w1s.shape
    if cd == torch.bfloat16:
        if m % 32:
            raise ValueError(f"the bfloat16 kernel needs M % 32 == 0, got M {m}")
        if kmajor is None:
            kmajor = kmajor_weights(w1s, w2s, w3s)
        _check_kmajor(kmajor, w1s, x.device)
        w1s, w2s, w3s = kmajor
    else:
        w1s, w2s, w3s = (t.to(cd).contiguous() for t in (w1s, w2s, w3s))
    bns = tuple(t.contiguous() for t in bns)
    src = x.contiguous()
    if b == 0:
        return src.to(out_dtype, copy=True)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for d in range(depth):
            dst = torch.empty_like(src)
            ptrs = [src, dst, w1s[d], w2s[d], w3s[d], *(t[d] for t in bns)]
            if any(t.data_ptr() % 16 for t in ptrs):
                raise ValueError("fused_bottleneck_chain needs 16-byte "
                                 "aligned tensors")
            err = lib.tdnet_bottleneck(*(t.data_ptr() for t in ptrs),
                                       b, h, w, c, m, _KINDS[cd], stream)
            LAUNCHES.count += 1
            _build.check(err, "tdnet_bottleneck")
            src = dst
    return src.to(out_dtype)


def launch_info(b: int, h: int, w: int, c: int, m: int) -> dict:
    """What the bfloat16 kernel launches for a (b, h, w, c) input of width
    m on the current CUDA device, without launching: tile height, pass
    width, dynamic shared bytes, persistent grid, tiles, blocks an SM."""
    info = (ctypes.c_int * 6)()
    lib = _build.library()
    _build.check(lib.tdnet_bottleneck_launch_info(b, h, w, c, m, info),
                 "tdnet_bottleneck_launch_info")
    keys = ("tile_h", "pass_n", "smem_bytes", "grid", "tiles", "blocks_per_sm")
    return dict(zip(keys, info))


def fused_bottleneck(x, w1, w2, w3, bn1_inv, bn1_off, bn2_inv, bn2_off,
                     bn3_inv, bn3_off, out_dtype=None) -> torch.Tensor:
    """One identity bottleneck (the depth-1 chain): w1 (C, M), w2
    (3, 3, M, M), w3 (M, C), per-channel BN pairs."""
    return fused_bottleneck_chain(
        x, w1[None], w2[None], w3[None], bn1_inv[None], bn1_off[None],
        bn2_inv[None], bn2_off[None], bn3_inv[None], bn3_off[None],
        out_dtype=out_dtype)

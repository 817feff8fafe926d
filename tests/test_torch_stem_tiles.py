"""A CPU rehearsal of the bf16 fused-stem kernels' tile decomposition
(``csrc/stem_common.cuh``, ``stem.cu``, ``stem_bwd.cu``), held against the
plain versions ``fused_stem_plain`` and ``fused_stem_bwd_plain`` at 64x96.

The kernels compute the 7x7/2 conv as a GEMM: an im2col row of K = 160
taps per conv pixel, in (kr, kc, ch) order with taps 147-159 zero, times
the (160, 64) bf16 weights, accumulated in f32. The backward walks tiles of
4x8 pooled pixels (9x17 conv pixels): each tile routes the pooled gradient
of its own windows, rounds dz to bf16 per tile (a conv row or column shared
by two tiles is rounded once in each), and adds im2col^T . dz to the filter
gradient. Here the same steps run as torch ops on bf16-valued f32 tensors,
with the f32 matmul standing in for the tensor cores. Tolerances are
chip_smoke.py's for the kernels: forward >= 99.9% within one bf16 ulp;
dkernel7 relative Frobenius <= 5e-3; dinv/doff rtol 1e-4 with atol 1e-5 of
the largest element."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tdnet_torch.models.layers import same_pads
from tdnet_torch.ops.ingest import mode_constants
from tdnet_torch.ops.stem import fused_stem_bwd_plain, fused_stem_plain

torch.set_num_threads(1)  # tier-1 runs several xdist workers

K_PAD, TP, TQ = 160, 4, 8


def _inputs(seed, table=False):
    r = np.random.RandomState(seed)
    if table:  # constant page with a ruled table: wide exact ties
        raw = np.full((2, 64, 96, 3), 245, np.uint8)
        raw[:, 10:50, 14:80] = 60
        raw[:, 10:50:9, 14:80] = 30
        raw[:, 10:50, 14:80:13] = 30
    else:
        raw = r.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    k7 = r.normal(0, 0.1, (7, 7, 3, 64)).astype(np.float32)
    inv = r.uniform(0.5, 1.5, 64).astype(np.float32)
    off = r.normal(0, 0.3, 64).astype(np.float32)
    dy = r.normal(0, 1, (2, 16, 24, 64)).astype(np.float32)
    packed = torch.from_numpy(raw.reshape(2, 64, 96 * 3))
    return packed, torch.from_numpy(k7), torch.from_numpy(inv), \
        torch.from_numpy(off), torch.from_numpy(dy)


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _im2col(packed):
    """(B, H/2, W/2, 160): each conv pixel's taps in (kr, kc, ch) order from
    the normalized, bf16-rounded, zero-padded input, taps 147-159 zero."""
    b, h, w3 = packed.shape
    mean, scale = mode_constants("caffe")
    x = (packed.reshape(b, h, w3 // 3, 3).to(torch.float32)
         - torch.from_numpy(mean)) * torch.tensor(scale)
    x = F.pad(_bf16(x), (0, 0, 3, 3, 3, 3))
    h2, w2 = h // 2, w3 // 6
    taps = [x[:, kr:kr + 2 * h2:2, kc:kc + 2 * w2:2, :]
            for kr in range(7) for kc in range(7)]
    cols = torch.stack(taps, dim=3).reshape(b, h2, w2, 147)
    return F.pad(cols, (0, K_PAD - 147))


def _weights(k7):
    return F.pad(_bf16(k7).reshape(147, 64), (0, 0, 0, K_PAD - 147))


def _activations(z, inv, off):
    wp = z * inv + off
    return wp, _bf16(torch.relu(wp))


def _first_max_slots(a, h4, w4):
    """Slot (dr*3 + dc) of each pooled window's first maximum, row-major,
    on the -inf 'SAME'-padded activations (B, h2, w2, 64) -> (B, h4, w4, 64)."""
    h2, w2 = a.shape[1:3]
    ph, pw = same_pads(h2, 3, 2), same_pads(w2, 3, 2)
    ap = F.pad(a.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]),
               value=float("-inf")).permute(0, 2, 3, 1)

    def win(dr, dc):
        return ap[:, dr:dr + 2 * h4 - 1:2, dc:dc + 2 * w4 - 1:2]

    best = win(0, 0)
    for d in range(1, 9):
        best = torch.maximum(best, win(d // 3, d % 3))
    slot = torch.full(best.shape, 9, dtype=torch.int64)
    for d in range(8, -1, -1):
        slot = torch.where(win(d // 3, d % 3) == best, d, slot)
    return slot, best


def tiled_forward(packed, k7, inv, off):
    """The forward kernel's arithmetic: im2col GEMM, BN, ReLU, bf16, pool."""
    z = _im2col(packed) @ _weights(k7)
    _, a = _activations(z, inv, off)
    b, h, w3 = packed.shape
    _, pooled = _first_max_slots(a, h // 4, w3 // 12)
    return pooled


def tiled_backward(packed, k7, inv, off, dy):
    """The backward kernel's tile walk: per 4x8 pooled tile, route its
    windows' dy to their first maxima, dz rounded to bf16 per tile, and
    dW += im2col^T . dz; dinv/doff in f32."""
    cols = _im2col(packed)
    z = cols @ _weights(k7)
    wp, a = _activations(z, inv, off)
    b, h4, w4, _ = dy.shape
    h2, w2 = z.shape[1:3]
    slot, _ = _first_max_slots(a, h4, w4)
    dw = torch.zeros(K_PAD, 64)
    dinv = torch.zeros(64)
    doff = torch.zeros(64)
    for n in range(b):
        for p0 in range(0, h4, TP):
            for q0 in range(0, w4, TQ):
                tp, tq = min(TP, h4 - p0), min(TQ, w4 - q0)
                r0, c0 = 2 * p0, 2 * q0
                nr, nc = min(2 * tp + 1, h2 - r0), min(2 * tq + 1, w2 - c0)
                da = torch.zeros(2 * TP + 1, 2 * TQ + 1, 64)
                s = slot[n, p0:p0 + tp, q0:q0 + tq]
                g = dy[n, p0:p0 + tp, q0:q0 + tq]
                for d in range(9):
                    dr, dc = d // 3, d % 3
                    da[dr:dr + 2 * tp:2, dc:dc + 2 * tq:2] += torch.where(
                        s == d, g, torch.zeros_like(g))
                da = da[:nr, :nc]
                zt, wpt = z[n, r0:r0 + nr, c0:c0 + nc], wp[n, r0:r0 + nr, c0:c0 + nc]
                dwp = torch.where(wpt > 0, da, torch.zeros_like(da))
                doff += dwp.sum(dim=(0, 1))
                dinv += (dwp * zt).sum(dim=(0, 1))
                dz = _bf16(dwp * inv).reshape(-1, 64)
                dw += cols[n, r0:r0 + nr, c0:c0 + nc].reshape(-1, K_PAD).T @ dz
    return dw[:147].reshape(7, 7, 3, 64), dinv, doff


def _within_1ulp(got, want):
    d = (got - want).abs()
    a = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    return ((d <= ulp) | (d <= 1e-5)).float().mean().item()


@pytest.mark.parametrize("table", [False, True])
def test_tiled_forward_matches_plain(table):
    packed, k7, inv, off, _ = _inputs(0, table)
    got = tiled_forward(packed, k7, inv, off)
    want = fused_stem_plain(packed, k7, inv, off, "caffe", torch.bfloat16).float()
    assert got.shape == want.shape
    assert _within_1ulp(got, want) >= 0.999


def test_im2col_order_is_the_conv():
    """The (kr, kc, ch) im2col GEMM is the 7x7/2 conv (f32, exact inputs)."""
    packed, k7, _, _, _ = _inputs(1)
    z = _im2col(packed) @ _weights(k7)
    b, h, w3 = packed.shape
    mean, scale = mode_constants("caffe")
    xin = _bf16((packed.reshape(b, h, w3 // 3, 3).float() - torch.from_numpy(mean))
                * torch.tensor(scale)).permute(0, 3, 1, 2)
    ref = F.conv2d(F.pad(xin, (3, 3, 3, 3)), _bf16(k7).permute(3, 2, 0, 1), stride=2)
    np.testing.assert_allclose(z.permute(0, 3, 1, 2).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("table", [False, True])
def test_tiled_backward_matches_plain(table):
    packed, k7, inv, off, dy = _inputs(2, table)
    dy = _bf16(dy)
    got = tiled_backward(packed, k7, inv, off, dy)
    want = fused_stem_bwd_plain(packed, k7, inv, off, dy.to(torch.bfloat16),
                                "caffe", torch.bfloat16)
    dk, dk_want = got[0].double(), want[0].double()
    assert (torch.linalg.vector_norm(dk - dk_want)
            / torch.linalg.vector_norm(dk_want)).item() <= 5e-3
    for g, w in zip(got[1:], want[1:]):
        assert bool((g - w).abs().le(1e-4 * w.abs() + 1e-5 * w.abs().max()).all())

"""A CPU rehearsal of the bf16 fused-bottleneck kernel's tile decomposition
(``csrc/block.cu``, ``bottleneck_tc_kernel``), held against the plain
version ``fused_bottleneck_chain_plain`` and the JAX package's Pallas
kernel (``tdnet.ops.pallas_block.fused_bottleneck_chain``, interpret mode).

The kernel walks tiles of TH x 8 output pixels (TH 16, or 8 where t1 and t2
do not fit shared memory) in a fixed order. Phase 1 computes t1 over the
tile's (TH + 2) x 10 window, padded to whole 64-row warp blocks, from x
chunks that are zero outside the image, and zeroes t1 there; phase 2 reads
each output pixel's nine taps as shifted rows of t1 (K = 9M, tap-major,
16-deep k-steps, a 64-deep ring stage crossing a tap where M is 32 or
96); phase 3 multiplies t2 by w3 and adds the residual, and writes only
rows inside the image (the last tile row is ragged where H % TH != 0).
Every product runs in passes of NB output channels over K in ring-stage
chunks of 64, reading the weights in the kernel's K-major layout
(``kmajor_weights``). Here the same steps run as torch ops on bf16-valued f32
tensors, with an f32 matmul a k-step standing in for the tensor cores.

Limits are chip_smoke.py's BLOCK_BF16_LIMITS for the kernel against the
plain version: >= 99% of outputs within one bf16 ulp, <= 2 ulps of
max(|v|, 1), relative Frobenius <= 1e-3. A control, the same decomposition
without the zeroing of t1 outside the image (conv2's SAME padding moved
onto x), must fail them.
"""

import numpy as np
import pytest
import torch

from tdnet_torch.ops.block import fused_bottleneck_chain_plain, kmajor_weights

torch.set_num_threads(1)  # tier-1 runs several xdist workers

KS, TILE_W = 64, 8  # ring-stage depth, tile width
LIMITS = {"share_within_1ulp": 0.99, "max_ulps_floor1": 2.0, "rel_fro": 1e-3}


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _inputs(seed, b, h, w, c, m):
    """x and one block's weights at chip_smoke.py's scales, bf16-valued."""
    r = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: torch.from_numpy((r.standard_normal(s) * sc).astype(np.float32))
    u = lambda *s: torch.from_numpy(r.uniform(0.5, 1.5, s).astype(np.float32))
    x = _bf16(f(b, h, w, c))
    weights = (_bf16(f(c, m, sc=c ** -0.5)), _bf16(f(3, 3, m, m, sc=(9 * m) ** -0.5)),
               _bf16(f(m, c, sc=0.5 * m ** -0.5)), u(m), f(m, sc=0.1), u(m),
               f(m, sc=0.1), u(c), f(c, sc=0.1))
    return x, weights


def _passes(a_rows, w, nb):
    """sum_k A(k) . w[k] for every pass of nb columns, K in ring stages of
    64 and k-steps of 16 in order from 0; a_rows(k0) gives the (rows, 16) A
    slice of k-step k0."""
    kdim, n = w.shape
    out = []
    for p in range(n // nb):
        acc = None
        for k0 in range(0, kdim, KS):
            for ks in range(k0, min(k0 + KS, kdim), 16):
                part = a_rows(ks) @ w[ks:ks + 16, p * nb:(p + 1) * nb]
                acc = part if acc is None else acc + part
        out.append(acc)
    return torch.cat(out, dim=1)


def _tiled_block(x, weights, th, nb, mask_t1=True):
    """The kernel's decomposition of one bf16 block on bf16-valued f32
    tensors; mask_t1=False is the control (t1 from zero x pixels kept)."""
    w1, w2, w3, i1, o1, i2, o2, i3, o3 = weights
    b, h, w, c = x.shape
    m = w1.shape[1]
    # (K, N) views of the kernel's K-major weight rows
    w1, w2, w3 = (t[0].float().t() for t in kmajor_weights(w1[None], w2[None], w3[None]))
    win_h, win = th + 2, (th + 2) * (TILE_W + 2)
    rows1 = -(-win // 64) * 64  # phase 1's A rows: whole 64-row warp blocks
    out = torch.full_like(x, float("nan"))
    tiles_x, tiles_y = w // TILE_W, -(-h // th)
    for tile in range(b * tiles_y * tiles_x):  # the persistent grid's order
        x0, y0 = tile % tiles_x * TILE_W, tile // tiles_x % tiles_y * th
        bi = tile // (tiles_x * tiles_y)
        iy = torch.arange(y0 - 1, y0 - 1 + win_h)[:, None].expand(win_h, TILE_W + 2)
        ix = torch.arange(x0 - 1, x0 + TILE_W + 1)[None, :].expand(win_h, TILE_W + 2)
        inside = ((iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)).reshape(-1)
        xw = torch.zeros(rows1, c)  # the x window: zero outside the image and past win
        xw[:win][inside] = x[bi, iy.reshape(-1)[inside], ix.reshape(-1)[inside]]
        # phase 1
        acc = _passes(lambda k: xw[:, k:k + 16], w1, nb)[:win]
        t1 = _bf16(torch.relu(acc * i1 + o1))
        if mask_t1:
            t1 = torch.where(inside[:, None], t1, torch.zeros(()))
        # phase 2: output pixel r's tap (dy, dx) is t1 row (r//8 + dy)*10 + r%8 + dx
        r = torch.arange(th * TILE_W)
        base = r // TILE_W * (TILE_W + 2) + r % TILE_W

        def shifted(k):
            tap, ch = divmod(k, m)
            return t1[base + tap // 3 * (TILE_W + 2) + tap % 3, ch:ch + 16]

        t2 = _bf16(torch.relu(_passes(shifted, w2, nb) * i2 + o2))
        # phase 3: rows inside the image only
        oy, ox = y0 + r // TILE_W, x0 + r % TILE_W
        keep = oy < h
        res = x[bi, oy[keep], ox[keep]]
        v = torch.relu(_passes(lambda k: t2[:, k:k + 16], w3, nb)[keep] * i3 + o3 + res)
        out[bi, oy[keep], ox[keep]] = _bf16(v)
    return out


def _readings(got, want):
    """chip_smoke.py's bf16_readings: share within one bf16 ulp (or 1e-5),
    most ulps of max(|v|, 1), relative Frobenius error."""
    d = (got - want).abs()
    big = torch.maximum(got.abs(), want.abs())

    def ulp(t):
        return torch.exp2(torch.floor(torch.log2(t.clamp_min(2.0 ** -126))) - 7)

    return {"share_within_1ulp": ((d <= ulp(big)) | (d <= 1e-5)).float().mean().item(),
            "max_ulps_floor1": (d / ulp(big.clamp_min(1.0))).max().item(),
            "rel_fro": (torch.linalg.vector_norm(d.double())
                        / torch.linalg.vector_norm(want.double())).item()}


def _ok(r):
    return (r["share_within_1ulp"] >= LIMITS["share_within_1ulp"]
            and r["max_ulps_floor1"] <= LIMITS["max_ulps_floor1"]
            and r["rel_fro"] <= LIMITS["rel_fro"])


# (B, H, W, C, M, TH, NB): the test shape of the issue (16-row tiles, a
# ragged last tile row, M 32: a ring stage spans two taps); 8-row tiles (the
# stage-5 form) with a ragged row; M 96 (passes of 32, a last K chunk of 32)
CASES = [(1, 20, 24, 128, 32, 16, 32), (2, 13, 16, 256, 64, 8, 64),
         (1, 17, 16, 128, 96, 16, 32)]


@pytest.mark.parametrize("b,h,w,c,m,th,nb", CASES)
def test_tile_decomposition_matches_plain(b, h, w, c, m, th, nb):
    x, weights = _inputs(h * m, b, h, w, c, m)
    got = _tiled_block(x, weights, th, nb)
    assert torch.isfinite(got).all()  # every output pixel written once
    want = fused_bottleneck_chain_plain(
        x.to(torch.bfloat16), *(t[None] for t in weights)).float()
    assert _ok(_readings(got, want)), _readings(got, want)
    control = _readings(_tiled_block(x, weights, th, nb, mask_t1=False), want)
    assert not _ok(control), control


def test_tile_decomposition_matches_pallas_interpret():
    """The issue's shape against the Pallas kernel in interpret mode (bf16,
    tests/test_torch_block.py's reference call), within the same limits."""
    import jax.numpy as jnp

    from tdnet.ops.pallas_block import fused_bottleneck_chain as ref

    b, h, w, c, m, th, nb = CASES[0]
    x, weights = _inputs(7, b, h, w, c, m)
    want = ref(jnp.asarray(x.numpy(), jnp.bfloat16),
               *(jnp.asarray(t.numpy()[None]) for t in weights), interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = _tiled_block(x, weights, th, nb)
    assert _ok(_readings(got, want)), _readings(got, want)


def test_kmajor_weights_layout():
    """kmajor_weights puts w[.., k, n] at row n, column k, with conv2's K
    ordered (dy, dx, input channel): the order of phase 2's taps above."""
    d, c, m = 2, 64, 32
    r = np.random.RandomState(3)
    w1s, w2s, w3s = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                     for s in ((d, c, m), (d, 3, 3, m, m), (d, m, c)))
    k1, k2, k3 = kmajor_weights(w1s, w2s, w3s)
    assert [t.dtype for t in (k1, k2, k3)] == [torch.bfloat16] * 3
    assert all(t.is_contiguous() for t in (k1, k2, k3))
    assert torch.equal(k1, w1s.to(torch.bfloat16).transpose(1, 2))
    assert torch.equal(k3, w3s.to(torch.bfloat16).transpose(1, 2))
    for dy, dx, ci, n in [(0, 0, 0, 0), (1, 2, 5, 31), (2, 1, 31, 7)]:
        assert k2[1, n, (dy * 3 + dx) * m + ci] == w2s[1, dy, dx, ci, n].to(torch.bfloat16)

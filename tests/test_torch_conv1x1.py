"""The fused 1x1 conv + BN + residual + ReLU (B7): the port's plain version
against ``tdnet.ops.pallas_conv.fused_conv1x1`` (the Pallas kernel in
interpret mode, as ``tests/ops/test_pallas_conv.py`` runs it on the CPU), the
wrapper's checks, and (with a GPU only) the CUDA kernel against the plain
version.

JAX is imported inside the tests that compare with it, so the GPU test also
runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_conv1x1.py``."""

import numpy as np
import pytest
import torch

from tdnet_torch.ops.conv1x1 import LAUNCHES, fused_conv1x1, fused_conv1x1_plain

torch.set_num_threads(1)  # tier-1 runs several xdist workers


def _inputs(seed, lead, k, n, kernel_rank=4, with_res=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, k).astype(np.float32)
    kern = (rng.randn(k, n) * k ** -0.5).astype(np.float32)
    if kernel_rank == 4:
        kern = kern.reshape(1, 1, k, n)
    inv = (rng.rand(n) + 0.5).astype(np.float32)
    off = (rng.randn(n) * 0.1).astype(np.float32)
    res = rng.randn(*lead, n).astype(np.float32) if with_res else None
    return x, kern, inv, off, res


def _jax(x, kern, inv, off, res, relu, dtype):
    import jax.numpy as jnp

    from tdnet.ops.pallas_conv import fused_conv1x1 as ref

    out = ref(jnp.asarray(x, dtype), jnp.asarray(kern), jnp.asarray(inv),
              jnp.asarray(off),
              residual=None if res is None else jnp.asarray(res, dtype),
              relu=relu, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(x, kern, inv, off, res, relu, dtype):
    t = lambda a: None if a is None else torch.from_numpy(a)
    out = fused_conv1x1(t(x).to(dtype), t(kern), t(inv), t(off),
                        residual=None if res is None else t(res).to(dtype),
                        relu=relu)
    assert out.dtype == dtype
    return out.float().numpy()


def _bf16_ulp(v):
    a = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_res", [True, False])
@pytest.mark.parametrize("kernel_rank", [4, 2])
def test_plain_f32_equals_pallas_interpret(relu, with_res, kernel_rank):
    """f32 at rtol = atol = 1e-5 (tests/ops/test_pallas_conv.py's bound)."""
    args = _inputs(0, (2, 9, 17), 64, 96, kernel_rank, with_res)
    want = _jax(*args, relu, "float32")
    got = _port(*args, relu, torch.float32)
    assert got.shape == want.shape == (2, 9, 17, 96)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_f32_nonaligned_shapes():
    """M = 35 and N = 40, neither a multiple of the TPU tiles (the Pallas
    kernel pads them; tile_m 64, tile_n 128 as in
    test_nonaligned_shapes_padded_correctly)."""
    import jax.numpy as jnp

    from tdnet.ops.pallas_conv import fused_conv1x1 as ref

    x, kern, _, _, _ = _inputs(1, (1, 5, 7), 32, 40, with_res=False)
    inv, off = np.ones(40, np.float32), np.zeros(40, np.float32)
    want = np.asarray(ref(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(inv),
                          jnp.asarray(off), relu=True, interpret=True,
                          tile_m=64, tile_n=128))
    got = _port(x, kern, inv, off, None, True, torch.float32)
    assert got.shape == want.shape == (1, 5, 7, 40)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_res", [True, False])
def test_plain_bf16_within_one_ulp(with_res):
    """bf16: >= 99% of outputs equal to the Pallas kernel's and every one
    within 1 bf16 ulp of max(|v|, 1). The two round at the same points; the
    f32 sums run in another order, so a product near a rounding boundary can
    round the other way."""
    args = _inputs(2, (2, 8, 8), 128, 128, with_res=with_res)
    want = _jax(*args, True, "bfloat16")
    got = _port(*args, True, torch.bfloat16)
    d = np.abs(got - want)
    assert (d == 0).mean() >= 0.99, (d == 0).mean()
    ulp = _bf16_ulp(np.maximum(np.maximum(np.abs(got), np.abs(want)), 1.0))
    assert np.all(d <= ulp), float((d / ulp).max())


def test_wrapper_checks_and_cpu_route():
    """Shape and dtype errors raise; a CPU tensor takes the plain version
    and counts no launch."""
    x, kern, inv, off, res = (torch.from_numpy(a) for a in _inputs(3, (4,), 16, 8))
    before = LAUNCHES.count
    out = fused_conv1x1(x, kern, inv, off, residual=res)
    assert LAUNCHES.count == before
    torch.testing.assert_close(out, fused_conv1x1_plain(x, kern, inv, off, residual=res),
                               rtol=0, atol=0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_conv1x1(x.double(), kern, inv, off)
    with pytest.raises(ValueError, match="does not match"):
        fused_conv1x1(x[:, :8], kern, inv, off)
    with pytest.raises(ValueError, match="must be"):
        fused_conv1x1(x, kern, inv[:4], off)
    with pytest.raises(ValueError, match="residual"):
        fused_conv1x1(x, kern, inv, off, residual=res[:, :4])
    with pytest.raises(ValueError, match=r"\(1, 1, K, N\)"):
        fused_conv1x1(x, kern.reshape(1, 2, 8, 8), inv, off)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_res", [True, False])
@pytest.mark.parametrize("lead,k,n", [((2, 9, 17), 64, 96), ((1, 5, 7), 32, 40),
                                      ((3, 11, 13), 256, 1024)])
def test_cuda_kernel_equals_plain(cuda, dtype, with_res, lead, k, n):
    """The kernel vs its plain version on the card, M and N off the 64 x 64
    tiles: f32 (TF32 off) within rtol = atol = 1e-5; bf16 >= 99.9% equal
    and within 4.5 ulps of the chain scale, the largest of 1 and the plain
    version's rounded intermediates (chip_smoke.py's CONV1X1_BF16_LIMITS:
    a product that rounds to the neighbouring bf16 value moves the output
    by an ulp of it times inv, plus one ulp for each rounding after it,
    and the offset and residual may cancel the output into a lower
    binade). bf16 K must be a multiple of 16."""
    x, kern, inv, off, res = (None if a is None else torch.from_numpy(a).to(cuda)
                              for a in _inputs(4, lead, k, n, with_res=with_res))
    x = x.to(dtype)
    res = None if res is None else res.to(dtype)
    before = LAUNCHES.count
    got = fused_conv1x1(x, kern, inv, off, residual=res).float()
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 1
    want = fused_conv1x1_plain(x, kern, inv, off, residual=res).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        d = (got - want).abs()
        assert (d == 0).float().mean().item() >= 0.999
        y = (x.reshape(-1, k).float() @ kern.reshape(k, n).to(dtype).float()).to(dtype)
        steps = [y, y * inv.to(dtype)]
        steps.append(steps[-1] + off.to(dtype))
        if res is not None:
            steps.append(steps[-1] + res.reshape(y.shape))
        chain = torch.stack([t.float().abs() for t in steps]).amax(dim=0).reshape(got.shape)
        big = torch.maximum(torch.maximum(got.abs(), want.abs()), chain).clamp_min(1.0)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
        assert bool((d <= 4.5 * ulp).all())
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="K % 16"):
            fused_conv1x1(x[..., :8], kern[..., :8, :], inv, off)

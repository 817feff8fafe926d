"""The fused-stem backward and its autograd glue on the CPU:
``fused_stem_bwd_plain`` (the CUDA kernel's plain version) against the
Pallas backward in interpret mode, and ``fused_stem_train``'s two backwards
against ``jax.vjp`` of the reference composition. Inputs come from numpy
seeds; both sides get the same arrays. The CUDA kernel itself is held
against the plain version on a GPU only (``cuda`` marker)."""

import numpy as np
import pytest
import torch

from tdnet_torch.ops.stem import (fused_stem_bwd_packed, fused_stem_bwd_plain,
                                  fused_stem_bwd_pooled, fused_stem_packed)
from tdnet_torch.ops.stem_vjp import fused_stem_train

torch.set_num_threads(1)  # tier-1 runs several xdist workers


def _params(seed):
    r = np.random.RandomState(seed)
    k7 = r.normal(0, 0.1, (7, 7, 3, 64)).astype(np.float32)
    inv = r.uniform(0.5, 1.5, 64).astype(np.float32)
    off = r.normal(0, 0.1, 64).astype(np.float32)
    return k7, inv, off


def _random_page(b, h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, h, w, 3)).astype(np.uint8)


def _table_page():
    """Constant page with one dark 'table': conv outputs tie exactly over
    wide regions, so the first-max routing decides."""
    raw = np.full((1, 48, 64, 3), 245, np.uint8)
    raw[:, 12:30, 20:44] = 60
    return raw


def _cot(raw, seed):
    b, h, w, _ = raw.shape
    return np.random.RandomState(seed).normal(
        0, 1, (b, h // 4, w // 4, 64)).astype(np.float32)


def _pallas(raw, cot, mode, dtype, params):
    import jax.numpy as jnp
    from tdnet.ops.pallas_stem import fused_stem_bwd_packed as ref

    b, h, w, _ = raw.shape
    jdt = getattr(jnp, dtype)
    k7, inv, off = (jnp.asarray(a) for a in params)
    out = ref(jnp.asarray(raw.reshape(b, h, w * 3)), k7, inv, off,
              jnp.asarray(cot, jdt), normalize=mode, out_dtype=jdt,
              interpret=True)
    return [np.asarray(x, np.float64) for x in out]


def _plain(raw, cot, mode, dtype, params):
    b, h, w, _ = raw.shape
    tdt = getattr(torch, dtype)
    k7, inv, off = (torch.from_numpy(a) for a in params)
    out = fused_stem_bwd_plain(torch.from_numpy(raw.reshape(b, h, w * 3)),
                               k7, inv, off, torch.tensor(cot, dtype=tdt),
                               mode, tdt)
    assert [tuple(x.shape) for x in out] == [(7, 7, 3, 64), (64,), (64,)]
    assert all(x.dtype == torch.float32 for x in out)
    return [x.numpy().astype(np.float64) for x in out]


@pytest.mark.parametrize("case", ["random_caffe", "random_tf", "table", "constant"])
def test_plain_bwd_f32_matches_pallas_interpret(case):
    """f32: rtol 1e-4, atol 2e-2, tests/ops/test_pallas_stem_bwd.py's bound
    (the 147-tap sums run in another order; gradients reach ~1e4)."""
    mode = "tf" if case == "random_tf" else "caffe"
    raw = {"table": _table_page,
           "constant": lambda: np.full((1, 32, 32, 3), 128, np.uint8)
           }.get(case, lambda: _random_page(2, 32, 64, 1))()
    params, cot = _params(3), _cot(raw, 4)
    want = _pallas(raw, cot, mode, "float32", params)
    got = _plain(raw, cot, mode, "float32", params)
    for name, g, w in zip(("dkernel7", "dinv", "doff"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-2, err_msg=name)


@pytest.mark.parametrize("case", ["random", "table"])
def test_plain_bwd_bf16_within_stated_bound(case):
    """bf16: relative Frobenius error <= 5e-3 on dkernel7 (measured ~1e-3:
    the Pallas kernel rounds dz per row block, so a conv row shared by two
    blocks rounds twice; the plain version rounds the summed gradient once)
    and rtol 1e-4 / atol 2e-2 on dinv/doff, which are not rounded."""
    raw = _random_page(2, 32, 64, 5) if case == "random" else _table_page()
    params, cot = _params(6), _cot(raw, 7)
    want = _pallas(raw, cot, "caffe", "bfloat16", params)
    got = _plain(raw, cot, "caffe", "bfloat16", params)
    rel = np.linalg.norm(got[0] - want[0]) / np.linalg.norm(want[0])
    assert rel <= 5e-3, rel
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_cotangent_gives_zero_gradients(dtype):
    raw = _random_page(1, 32, 32, 8)
    k7, inv, off = (torch.from_numpy(a) for a in _params(9))
    dy = torch.zeros((1, 8, 8, 64), dtype=dtype)
    out = fused_stem_bwd_packed(torch.from_numpy(raw.reshape(1, 32, 96)),
                                k7, inv, off, dy, "caffe", dtype)
    assert all(float(x.abs().max()) == 0.0 for x in out)


def test_bwd_wrapper_checks_and_cpu_route():
    raw = _random_page(1, 32, 32, 10)
    packed = torch.from_numpy(raw.reshape(1, 32, 96))
    k7, inv, off = (torch.from_numpy(a) for a in _params(11))
    dy = torch.from_numpy(_cot(raw, 12))
    got = fused_stem_bwd_packed(packed, k7, inv, off, dy, "caffe", torch.float32)
    want = fused_stem_bwd_plain(packed, k7, inv, off, dy, "caffe", torch.float32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="dy must be"):
        fused_stem_bwd_packed(packed, k7, inv, off, dy, "caffe", torch.bfloat16)
    with pytest.raises(ValueError, match="dy must be"):
        fused_stem_bwd_packed(packed, k7, inv, off, dy[:, :4], "caffe",
                              torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fused_stem_bwd_packed(packed, k7, inv, off,
                              dy.transpose(1, 2).contiguous().transpose(1, 2),
                              "caffe", torch.float32)
    with pytest.raises(TypeError, match="uint8"):
        fused_stem_bwd_packed(packed.float(), k7, inv, off, dy)


# ------------------------------------------------------------ fused_stem_train


def _jax_vjp(raw, cot, mode, params):
    """jax.vjp of tdnet's stem_reference_packed (f32): the gradient both
    backwards of the port must reproduce."""
    import jax
    import jax.numpy as jnp
    from tdnet.ops.stem_vjp import stem_reference_packed

    b, h, w, _ = raw.shape
    packed = jnp.asarray(raw.reshape(b, h, w * 3))
    _, vjp = jax.vjp(lambda k, i, o: stem_reference_packed(
        packed, k, i, o, mode, jnp.float32), *(jnp.asarray(a) for a in params))
    return [np.asarray(g, np.float64) for g in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("backward", ["kernel", "remat"])
@pytest.mark.parametrize("case", ["random", "table"])
def test_fused_stem_train_grads_match_jax_vjp(backward, case):
    """Both backwards against jax.vjp of the reference stem in f32, with the
    tolerance of the JAX package's own test (rtol 1e-4, atol 1e-2); the
    forward equals the plain fused stem; the uint8 input gets no gradient."""
    raw = _random_page(2, 32, 64, 13) if case == "random" else _table_page()
    params, cot = _params(14), _cot(raw, 15)
    want = _jax_vjp(raw, cot, "caffe", params)
    b, h, w, _ = raw.shape
    packed = torch.from_numpy(raw.reshape(b, h, w * 3))
    leaves = [torch.from_numpy(a).requires_grad_() for a in params]
    y = fused_stem_train(packed, *leaves, normalize="caffe",
                         out_dtype=torch.float32, backward=backward)
    assert tuple(y.shape) == (b, h // 4, w // 4, 64)
    (y * torch.from_numpy(cot)).sum().backward()
    assert not packed.requires_grad and packed.grad is None
    for name, leaf, wv in zip(("dkernel7", "dinv", "doff"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), wv, rtol=1e-4, atol=1e-2,
                                   err_msg=name)


def test_fused_stem_train_frozen_bn_and_checks():
    """inv/off that do not require grad get none (frozen BN); bad input
    raises."""
    raw = _random_page(1, 32, 32, 16)
    k7, inv, off = (torch.from_numpy(a) for a in _params(17))
    k7.requires_grad_()
    packed = torch.from_numpy(raw.reshape(1, 32, 96))
    fused_stem_train(packed, k7, inv, off, out_dtype=torch.float32,
                     backward="kernel").sum().backward()
    assert k7.grad is not None and inv.grad is None and off.grad is None
    with pytest.raises(TypeError, match="uint8"):
        fused_stem_train(packed.float(), k7, inv, off)
    with pytest.raises(ValueError, match="unsupported"):
        fused_stem_train(torch.zeros((1, 30, 93), dtype=torch.uint8), k7, inv, off)
    with pytest.raises(ValueError, match="backward"):
        fused_stem_train(packed, k7, inv, off, backward="xla")


# ---------------------------------------------------------------- on a GPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 64, 128), (2, 40, 200), (1, 48, 64)])
def test_cuda_stem_bwd_equals_plain(cuda, dtype, shape):
    """Ragged tiles (40 / 4 = 10 pooled rows, 200 / 4 = 50 pooled cols) and
    the tie-heavy table page. f32: rtol 1e-4 with atol 1e-5 of the gradient's
    scale; bf16: dkernel7 relative Frobenius <= 5e-3 (the kernel rounds dz
    per tile), dinv/doff as f32. Run twice: equal bit for bit (no atomics)."""
    b, h, w = shape
    raw = _table_page() if shape == (1, 48, 64) else _random_page(b, h, w, 18)
    packed = torch.from_numpy(raw.reshape(b, h, w * 3)).to(cuda)
    k7, inv, off = (torch.from_numpy(a).to(cuda) for a in _params(19))
    dy = torch.from_numpy(_cot(raw, 20)).to(cuda, dtype)
    got = fused_stem_bwd_packed(packed, k7, inv, off, dy, "caffe", dtype)
    again = fused_stem_bwd_packed(packed, k7, inv, off, dy, "caffe", dtype)
    want = fused_stem_bwd_plain(packed, k7, inv, off, dy, "caffe", dtype)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    got = [g.cpu().double().numpy() for g in got]
    want = [x.cpu().double().numpy() for x in want]
    for i, (g, wv) in enumerate(zip(got, want)):
        if i == 0 and dtype == torch.bfloat16:
            assert np.linalg.norm(g - wv) <= 5e-3 * np.linalg.norm(wv)
        else:
            np.testing.assert_allclose(g, wv, rtol=1e-4,
                                       atol=1e-5 * np.abs(wv).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 64, 128), (2, 40, 200), (1, 48, 64)])
def test_cuda_stem_bwd_routes_on_the_forward_activations(cuda, shape):
    """bf16: the backward's recomputed activations, pooled, equal the
    forward kernel's output bit for bit (one tensor-core conv tile serves
    both), ragged tiles and the tie-heavy page included."""
    b, h, w = shape
    raw = _table_page() if shape == (1, 48, 64) else _random_page(b, h, w, 21)
    packed = torch.from_numpy(raw.reshape(b, h, w * 3)).to(cuda)
    k7, inv, off = (torch.from_numpy(a).to(cuda) for a in _params(22))
    fwd = fused_stem_packed(packed, k7, inv, off, "caffe", torch.bfloat16)
    routed = fused_stem_bwd_pooled(packed, k7, inv, off, "caffe")
    assert torch.equal(fwd.view(torch.int16), routed.view(torch.int16))


def test_stem_bwd_pooled_is_cuda_only():
    """The routing check reads the CUDA kernel: a CPU tensor raises."""
    raw = _random_page(1, 16, 16, 23)
    k7, inv, off = (torch.from_numpy(a) for a in _params(24))
    with pytest.raises(ValueError, match="CUDA"):
        fused_stem_bwd_pooled(torch.from_numpy(raw.reshape(1, 16, 48)), k7,
                              inv, off, "caffe")

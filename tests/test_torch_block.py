"""The fused identity-bottleneck chain in tdnet_torch vs tdnet, on the CPU:
the plain version against the Pallas kernel (interpret mode, as the JAX
package's own tests run it) at the reference test's shapes, the row edges,
the ``supports_block`` gate, the wrapper's checks, and ``block_kernel``
models (ResNet-50 at 64x64, ResNet-101 at 128x128 against tdnet's chains
cut to two blocks) against tdnet's with the same variables, and the
Predictor's opt-in. Inputs come from numpy seeds; both sides get the same
arrays."""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tdnet_torch.models.resnet as port_resnet
from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.ops.block import (fused_bottleneck, fused_bottleneck_chain,
                                   fused_bottleneck_chain_plain, supports_block)
from tdnet_torch.weights import random_variables, torch_state_from_variables

torch.set_num_threads(1)  # tier-1 runs several xdist workers


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_executables():
    """The ResNet executables compiled here are not reused elsewhere; the
    freed model memory goes back to the system."""
    yield
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: nothing to trim
        pass


def _chain(seed, depth, b, h, w, c, m):
    """x (B, H, W, C) and a depth-D chain's weights (the reference test's
    scales: weights 0.1 / 0.05 / 0.1, BN inv in [0.5, 1.5], off 0.1)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = lambda *s: rng.uniform(0.5, 1.5, s).astype(np.float32)
    x = f(b, h, w, c)
    weights = (f(depth, c, m) * 0.1, f(depth, 3, 3, m, m) * 0.05,
               f(depth, m, c) * 0.1, u(depth, m), f(depth, m) * 0.1,
               u(depth, m), f(depth, m) * 0.1, u(depth, c), f(depth, c) * 0.1)
    return x, weights


def _reference_chain(x, weights, dtype, tm):
    from tdnet.ops.pallas_block import fused_bottleneck_chain as ref

    return np.asarray(ref(jnp.asarray(x, dtype), *map(jnp.asarray, weights),
                          tm=tm, interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", 3e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("depth,h,tm", [(2, 16, 8), (3, 20, 4), (3, 12, 12)])
def test_plain_chain_matches_pallas_interpret(depth, h, tm, dtype, tol):
    """tests/ops/test_pallas_block.py's chain shapes (B 2, W 24, C 64, M 8);
    rtol = atol = 3e-5 in f32 (the products sum in another order), 2e-2 in
    bf16 (a rounding of t1 or t2 that lands on the other side of a bf16
    boundary moves the rest of the chain by an ulp)."""
    x, weights = _chain(depth * h, depth, 2, h, 24, 64, 8)
    want = _reference_chain(x, weights, getattr(jnp, dtype), tm)
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(x).to(tdt), *map(torch.from_numpy, weights))
    got = fused_bottleneck_chain_plain(*args)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(fused_bottleneck_chain(*args), got)


@pytest.mark.parametrize("h,tm", [(8, 8), (16, 8), (24, 8), (16, 16), (32, 8)])
def test_plain_block_row_edges(h, tm):
    """SAME padding at the top and bottom rows, where the Pallas kernel's
    halos are clamped and masked (its test_fused_block_row_edges_and_single
    _tile): rtol = atol = 2e-5 in f32."""
    x, weights = _chain(h + tm, 1, 1, h, 16, 64, 8)
    want = _reference_chain(x, weights, jnp.float32, tm)
    got = fused_bottleneck(torch.from_numpy(x),
                           *(torch.from_numpy(t[0]) for t in weights))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_supports_block_gate_matches_reference():
    from tdnet.ops.pallas_block import supports_block as ref

    shapes = [(2, 16, 32, 64), (1, 200, 336, 256), (1, 100, 168, 512),
              (1, 50, 84, 1024), (1, 25, 42, 2048), (16, 256, 256, 256),
              (16, 32, 32, 2048), (1, 3, 32, 64), (1, 16, 8, 64),
              (1, 16, 24, 96), (1, 16, 32)]
    for shape in shapes:
        for m in (8, 12, 64, 512):
            assert supports_block(shape, m) == ref(shape, m), (shape, m)
    # ResNet-101 at the 1024x1024 bucket: every stage's identity run passes
    for stage, hw in enumerate((256, 128, 64, 32)):
        assert supports_block((16, hw, hw, 256 * 2 ** stage), 64 * 2 ** stage)


def test_chain_rejects_bad_inputs():
    x, weights = _chain(0, 2, 1, 16, 16, 64, 8)
    args = [torch.from_numpy(t) for t in weights]
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="bad weight shapes"):
        fused_bottleneck_chain(xt, args[0], args[1][..., :4], *args[2:])
    with pytest.raises(ValueError, match="unsupported block shape"):
        fused_bottleneck_chain(xt[:, :, :12], *args)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_bottleneck_chain(xt.double(), *args)
    with pytest.raises(ValueError, match="BN vector"):
        fused_bottleneck_chain(xt, *args[:3], args[3][:, :4], *args[4:])
    with pytest.raises(ValueError, match="inference-only"):
        fused_bottleneck_chain(xt.requires_grad_(), *args)


# ------------------------------------------------------------------ models


def _recording_chain(monkeypatch):
    """Record the NHWC shapes and depths the port's ResNet hands the chain."""
    seen = []
    chain = port_resnet.fused_bottleneck_chain

    def recording(x, w1s, *rest, **kw):
        seen.append((tuple(x.shape), w1s.shape[0]))
        return chain(x, w1s, *rest, **kw)

    monkeypatch.setattr(port_resnet, "fused_bottleneck_chain", recording)
    return seen


def _flax_outputs(num_classes, backbone, variables, x, block_kernel):
    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet

    model = FlaxRetinaNet(num_classes=num_classes, backbone_name=backbone,
                          dtype=jnp.float32, block_kernel=block_kernel)
    return jax.jit(model.apply)(jax.tree.map(jnp.asarray, variables), x)


def _port_outputs(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x))


def _close(got, want, tol=2e-4):
    """Within tol of each output's largest magnitude (the reference's own
    block-on/off bound, 2e-4, taken relative to the scale here, as the
    model tests compare whole networks)."""
    for key in ("regression", "classification"):
        ref = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), ref, rtol=0,
                                   atol=tol * float(np.abs(ref).max()))


def test_resnet50_block_kernel_matches_flax(monkeypatch):
    """RetinaNet(2, block_kernel=True) at 64x64, f32: stage 2 (16x16) is
    the one stage the gate admits; the port matches tdnet's fused model
    and its own unfused one, with the same state dict."""
    variables = random_variables(2, "resnet50", seed=3)
    x = np.random.default_rng(2).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    want = _flax_outputs(2, "resnet50", variables, x, block_kernel=True)
    state = torch_state_from_variables(variables)
    fused = RetinaNet(2, block_kernel=True)
    fused.load_state_dict(state)
    fused = fused.to(memory_format=torch.channels_last).eval()
    seen = _recording_chain(monkeypatch)
    got = _port_outputs(fused, x)
    assert seen == [((1, 16, 16, 256), 2)]
    _close(got, want)
    plain = RetinaNet(2)
    plain.load_state_dict(state)
    assert plain.state_dict().keys() == fused.state_dict().keys()
    _close(got, _port_outputs(plain.eval(), x))


@pytest.fixture(scope="module")
def resnet101_case():
    """ResNet-101 variables and one 128x128 image, and tdnet's fused model
    outputs on it with chains of two blocks (batch 1: the tier-1 workers
    share the machine's memory)."""
    variables = random_variables(1, "resnet101", seed=4)
    x = np.random.default_rng(5).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TDNET_CHAIN_DEPTH", "2")
        want = _flax_outputs(1, "resnet101", variables, x, block_kernel=True)
    want = {k: np.asarray(v) for k, v in want.items()}
    yield variables, x, want
    jax.clear_caches()


def test_resnet101_chunked_chains_match_flax(resnet101_case, monkeypatch):
    """tdnet cuts stage 3's three identity blocks into chains of 2 and 1
    (TDNET_CHAIN_DEPTH=2); the port, whose kernel launches once per block
    either way, runs each identity run as one chain and gives the same
    outputs. Stages 2 (32x32) and 3 (16x16) pass the gate, stages 4 and 5
    (8x8, 4x4) run block by block. The chain weights are stacked once and
    reused by the next call."""
    variables, x, want = resnet101_case
    model = RetinaNet(1, "resnet101", block_kernel=True)
    model.load_state_dict(torch_state_from_variables(variables))
    model = model.to(memory_format=torch.channels_last).eval()
    seen = _recording_chain(monkeypatch)
    got = _port_outputs(model, x)
    assert seen == [((1, 32, 32, 256), 2), ((1, 16, 16, 512), 3)]
    _close(got, want)
    cached = {s: id(w) for s, (_, w) in model.backbone._chain_cache.items()}
    assert sorted(cached) == [0, 1]
    _port_outputs(model, x)
    assert {s: id(w) for s, (_, w) in model.backbone._chain_cache.items()} == cached
    with torch.no_grad():  # a weight changed in place rebuilds the stack
        model.backbone.stage2_block1.conv2.weight.mul_(0.5)
    _port_outputs(model, x)
    assert id(model.backbone._chain_cache[0][1]) != cached[0]


def test_predictor_block_opt_in_leaves_the_model(monkeypatch):
    """TDNET_BLOCK_KERNEL=1 turns the kernel on for a CUDA Predictor's own
    calls only: on the CPU it stays off, and the caller's model keeps its
    setting either way (the on-state is the Predictor's, per call)."""
    from tdnet_torch.train.predictor import Predictor

    monkeypatch.setenv("TDNET_BLOCK_KERNEL", "1")
    model = RetinaNet(1)
    pred = Predictor(model, device="cpu")
    assert pred.block_kernel is None and model.backbone.block_kernel is False
    seen = _recording_chain(monkeypatch)
    x = np.random.default_rng(6).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        pred.model(torch.from_numpy(x), block_kernel=True)
        assert seen == [((1, 16, 16, 256), 2)]
        pred.model(torch.from_numpy(x))
    assert len(seen) == 1 and model.backbone.block_kernel is False

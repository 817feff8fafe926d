"""tdnet_torch models and weight bridge vs the flax reference, on the CPU.

The same numpy variables (tdnet_torch.weights.random_variables, checked to
have flax's exact tree) go to flax ``apply`` and, through the bridge, to
the port; the same seeded numpy images go to both. Comparisons are in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.weights import (random_variables, torch_state_from_variables,
                                 variables_from_torch_state)

torch.set_num_threads(1)  # tier-1 runs several xdist workers


@pytest.fixture(scope="module")
def variables():
    return random_variables(1, "resnet50", seed=0)


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_executables():
    """The ResNet-50 executables compiled here are not reused elsewhere; the
    tier-1 workers run hundreds of tests each and their memory adds up."""
    yield
    jax.clear_caches()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_random_variables_have_flax_tree(variables):
    """Same collections, paths, shapes and dtypes as RetinaNet.init."""
    model = FlaxRetinaNet(num_classes=1, dtype=jnp.float32)
    want = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 128, 3)))
    for col in ("params", "batch_stats"):
        w = {p: (tuple(v.shape), np.dtype(v.dtype)) for p, v in _leaves(want[col])}
        g = {p: (v.shape, v.dtype) for p, v in _leaves(variables[col])}
        assert g == w, col


def test_bridge_round_trip_is_exact(variables):
    state = torch_state_from_variables(variables)
    back = variables_from_torch_state(state)
    for col in ("params", "batch_stats"):
        a, b = dict(_leaves(variables[col])), dict(_leaves(back[col]))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    again = torch_state_from_variables(back)
    assert again.keys() == state.keys()
    for k in state:
        assert torch.equal(state[k], again[k]), k


def test_bridge_loads_strictly_and_maps_kernels(variables):
    model = RetinaNet(1)
    model.load_state_dict(torch_state_from_variables(variables))  # strict
    hwio = variables["params"]["fpn"]["P6"]["kernel"]
    np.testing.assert_array_equal(
        model.fpn.P6.weight.detach().numpy(), hwio.transpose(3, 2, 0, 1))


# (64, 128): C5 is 2x4, P6 pads (0, 1); (96, 160): C5 is 3x5, P6 pads (1, 1)
@pytest.mark.parametrize("hw", [(64, 128), (96, 160)])
def test_retinanet_matches_flax_apply(variables, hw):
    """Backbone taps and full outputs in f32. Tolerance: convolutions sum in
    another order on the two sides, and ~60 layers compound it; 1e-4
    relative to each tensor's scale is far below any real mismatch (a
    one-pixel pad shift moves outputs by O(scale))."""
    rng = np.random.RandomState(hw[0])
    x = rng.normal(0, 50, (2,) + hw + (3,)).astype(np.float32)

    flax_model = FlaxRetinaNet(num_classes=1, dtype=jnp.float32)
    flax_vars = jax.tree.map(jnp.asarray, variables)
    want, inter = jax.jit(lambda v, i: flax_model.apply(
        v, i, capture_intermediates=lambda m, _: m.name == "backbone"))(
            flax_vars, x)
    taps = inter["intermediates"]["backbone"]["__call__"][0]

    model = RetinaNet(1)
    model.load_state_dict(torch_state_from_variables(variables))
    model = model.to(memory_format=torch.channels_last).eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = model(xt)
        c3, c4, c5 = model.backbone(xt.permute(0, 3, 1, 2))

    def close(t, ref):
        ref = np.asarray(ref)
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(t, ref, rtol=0, atol=1e-4 * scale)

    for t, ref in zip((c3, c4, c5), taps):
        close(t.permute(0, 2, 3, 1).numpy(), ref)
    for key in ("regression", "classification"):
        assert got[key].shape == want[key].shape
        close(got[key].numpy(), want[key])


def test_stem_input_model_matches_full_model(variables):
    """The port's stem-input route (plain fused stem, then the model from
    C2) equals the full model on the normalized images."""
    from tdnet_torch.data.image import CAFFE_MEAN_BGR
    from tdnet_torch.ops.stem import fused_stem_packed

    model = RetinaNet(1)
    model.load_state_dict(torch_state_from_variables(variables))
    model.eval()
    raw = np.random.RandomState(3).randint(0, 256, (2, 64, 128, 3)).astype(np.uint8)
    with torch.no_grad():
        want = model(torch.from_numpy(raw.astype(np.float32) - CAFFE_MEAN_BGR))
        k7, inv, off = model.backbone.stem_params()
        act = fused_stem_packed(torch.from_numpy(raw.reshape(2, 64, 384)),
                                k7, inv, off, normalize="caffe",
                                out_dtype=torch.float32)
        got = model(act, stem_input=True)
    for key in ("regression", "classification"):
        ref = want[key].numpy()
        np.testing.assert_allclose(got[key].numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_layers_match_reference():
    """Frozen BN fold, TF1 nearest resize and the SAME max-pool, exactly."""
    from flax import linen as nn

    from tdnet.models.layers import FrozenBatchNorm as FlaxBN
    from tdnet.models.layers import resize_nearest_like as ref_resize
    from tdnet_torch.models.layers import FrozenBatchNorm, resize_nearest_like
    from tdnet_torch.models.resnet import max_pool_same

    rng = np.random.RandomState(0)
    x = rng.normal(0, 3, (2, 5, 7, 8)).astype(np.float32)  # NHWC
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    for out_hw in [(10, 14), (11, 13), (5, 7)]:
        want = np.asarray(ref_resize(jnp.asarray(x), out_hw))
        got = resize_nearest_like(xt, out_hw).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)

    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                  padding="SAME"))
    got = max_pool_same(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)

    stats = {"scale": rng.uniform(0.5, 1.5, 8), "bias": rng.normal(0, 1, 8),
             "mean": rng.normal(0, 1, 8), "var": rng.uniform(0.5, 2, 8)}
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    want = np.asarray(FlaxBN().apply(
        {"params": {"scale": stats["scale"], "bias": stats["bias"]},
         "batch_stats": {"mean": stats["mean"], "var": stats["var"]}},
        jnp.asarray(x)))
    bn = FrozenBatchNorm(8)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in stats.items()})
    got = bn(xt).permute(0, 2, 3, 1).numpy()
    # rsqrt is computed by different libraries: 1 f32 ulp-scale tolerance
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unported_backbone_raises():
    """Every family the reference builds is ported; a name it does not know
    raises its ValueError, word for word."""
    from tdnet.models.retinanet import _build_backbone

    with pytest.raises(ValueError) as want:
        _build_backbone("resnet18", jnp.float32, True)
    with pytest.raises(ValueError) as got:
        RetinaNet(1, backbone="resnet18")
    assert str(got.value) == str(want.value)

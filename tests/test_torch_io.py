"""``.tdn`` bundles on the port: the MessagePack codec
(``tdnet_torch/utils/msgpack.py``) against the ``msgpack`` package, and
``tdnet_torch/models/io.py`` against ``tdnet/models/io.py`` (flax) in both
directions."""

import dataclasses

import msgpack
import numpy as np
import pytest
import torch

from tdnet_torch.models import io as port_io
from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.utils import msgpack as codec
from tdnet_torch.weights import random_variables, torch_state_from_variables

torch.set_num_threads(1)  # tier-1 runs several xdist workers


@pytest.fixture(scope="module", autouse=True)
def _release_memory():
    """The tier-1 workers run hundreds of tests each and their memory adds
    up: drop this module's JAX executables and trim the C heap that its
    ResNet-50 weights and bundles leave behind."""
    yield
    import ctypes
    import gc

    import jax

    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: nothing to trim
        pass


_INT_EDGES = [0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF,
              0x100000000, 2 ** 63 - 1, 2 ** 64 - 1]
_NEG_EDGES = [-1, -0x20, -0x21, -0x80, -0x81, -0x8000, -0x8001, -0x80000000,
              -0x80000001, -(2 ** 63)]


@pytest.mark.parametrize("value", _INT_EDGES + _NEG_EDGES
                         + [v + 1 for v in _INT_EDGES[:-1]] + [v - 1 for v in _NEG_EDGES[:-1]])
def test_codec_ints_at_every_width_boundary(value):
    data = codec.packb(value)
    assert data == msgpack.packb(value)
    assert codec.unpackb(data) == value


@pytest.mark.parametrize("n", [0, 1, 31, 32, 255, 256, 65535, 65536])
def test_codec_str_bin_and_containers_at_length_boundaries(n):
    s, b = "é" * (n // 2) + "x" * (n % 2), bytes(range(256)) * (n // 256) + b"z" * (n % 256)
    arr, mp = list(range(n % 70000)), {f"k{i}": i for i in range(n % 70000)}
    for value in (s, b, arr, mp):
        data = codec.packb(value)
        assert data == msgpack.packb(value, use_bin_type=True)
        assert codec.unpackb(data) == value
        assert codec.unpackb(msgpack.packb(value, use_bin_type=True)) == value


def test_codec_floats_nil_bool_nested_and_float32():
    value = {"a": [None, True, False, 0.0, -1.5, 1e300, float("inf")],
             "b": {"c": [[], {}, [1, [2, [3, {"d": -7}]]]]}}
    data = codec.packb(value)
    assert data == msgpack.packb(value, use_bin_type=True)
    assert codec.unpackb(data) == value
    assert codec.unpackb(msgpack.packb(0.25, use_single_float=True)) == 0.25


@pytest.mark.parametrize("arr", [
    np.arange(24, dtype=np.float32).reshape(2, 3, 4), np.zeros((0, 5), np.float64),
    np.array([[1, -2]], np.int64), np.array([True, False]), np.float32(3.5),
    np.int32(-9), np.arange(300, dtype=np.uint8)])
def test_codec_ext_arrays_and_scalars_as_flax_writes_them(arr):
    """ext 1 (ndarray) and ext 3 (numpy scalar): the bytes equal flax's
    msgpack_serialize, and both readers give the value back."""
    from flax import serialization

    tree = {"leaf": arr, "other": [1, "x"]}
    data = codec.packb(tree)
    assert data == serialization.msgpack_serialize(tree)
    for got in (codec.unpackb(data)["leaf"], serialization.msgpack_restore(data)["leaf"]):
        assert type(got) is type(arr) and np.asarray(got).dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)
    if isinstance(arr, np.ndarray) and arr.size:
        assert codec.unpackb(bytearray(data))["leaf"].flags.writeable


def test_codec_rejects_chunked_arrays_and_bad_input():
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True, "shape": {}}})
    with pytest.raises(ValueError, match="chunked"):
        codec.unpackb(chunked)
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(codec.packb("abc")[:-1])
    with pytest.raises(ValueError, match="trailing"):
        codec.unpackb(codec.packb(1) + b"\x00")
    with pytest.raises(TypeError):
        codec.packb({1, 2})


@pytest.fixture(scope="module")
def variables():
    return random_variables(1, "resnet50", seed=0)


def _flax_model():
    import jax.numpy as jnp

    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet

    return FlaxRetinaNet(num_classes=1, dtype=jnp.float32)


def test_reference_bundle_loads_exactly(variables, tmp_path):
    """A bundle written by tdnet's save_model (flax) loads on the port: the
    variables, bridged, equal the original state dict bit for bit, the
    meta equals the reference reader's, and the model takes the state."""
    from tdnet.models import io as ref_io

    path = str(tmp_path / "ref.tdn")
    ref_io.save_model(path, _flax_model(), variables,
                      inference_config={"min_side": 64, "max_side": 96})
    model, got, meta = port_io.load_model(path)
    _, _, ref_meta = ref_io.load_model(path)
    assert meta == ref_meta
    assert meta["inference"]["min_side"] == 64 and meta["anchors"] is None
    want_state = torch_state_from_variables(variables)
    got_state = torch_state_from_variables(got)
    assert got_state.keys() == want_state.keys()
    for k in want_state:
        assert torch.equal(got_state[k], want_state[k]), k
    model.load_state_dict(got_state)
    assert (model.num_classes, model.backbone_name, model.num_anchors,
            model.feature_size, model.prior_probability) == (1, "resnet50", 9, 256, 0.01)


def test_port_bundle_is_the_reference_bundle(variables, tmp_path):
    """The port's save_model without anchors writes the bytes tdnet's
    writes; tdnet's reader gives back equal arrays and meta."""
    from tdnet.models import io as ref_io

    ours, theirs = str(tmp_path / "port.tdn"), str(tmp_path / "ref.tdn")
    cfg = {"soft_nms_sigma": 0.5, "score_threshold": 0.1}
    port_io.save_model(ours, RetinaNet(1), variables, inference_config=cfg)
    ref_io.save_model(theirs, _flax_model(), variables, inference_config=cfg)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    _, ref_vars, meta = ref_io.load_model(ours)
    assert meta["inference"]["soft_nms_sigma"] == 0.5
    assert meta["model"]["backbone_name"] == "resnet50"
    want = torch_state_from_variables(variables)
    for k, v in torch_state_from_variables(ref_vars).items():
        assert torch.equal(v, want[k]), k


def test_port_writes_anchors_the_reference_cannot(variables, tmp_path):
    """tdnet's writer raises on anchor parameters (flax packs strictly and
    dataclasses.asdict leaves tuples); the port writes lists, and tdnet's
    reader gives back the same AnchorParameters."""
    from tdnet.models import io as ref_io
    from tdnet.ops.anchors import AnchorParameters as RefAnchors

    ref_anchors = RefAnchors(sizes=(16, 32, 64, 128, 256), ratios=(0.25, 1.0, 4.0))
    with pytest.raises(TypeError):
        ref_io.save_model(str(tmp_path / "ref.tdn"), _flax_model(), variables,
                          anchor_params=ref_anchors)
    from tdnet_torch.ops.anchors import AnchorParameters

    ours = AnchorParameters(**dataclasses.asdict(ref_anchors))
    path = str(tmp_path / "port.tdn")
    port_io.save_model(path, RetinaNet(1), variables, anchor_params=ours)
    _, _, meta = ref_io.load_model(path)
    assert ref_io.anchor_params_from_meta(meta) == ref_anchors
    _, _, meta = port_io.load_model(path)
    assert port_io.anchor_params_from_meta(meta) == ours


def test_model_state_round_trip_and_bad_bundles_raise(tmp_path):
    """A model's own state written through the bridge loads back equal,
    here for a bf16 model; an unknown backbone raises; another format
    version raises."""
    from tdnet_torch.weights import variables_from_torch_state

    model = RetinaNet(2)
    path = str(tmp_path / "m.tdn")
    port_io.save_model(path, model, variables_from_torch_state(model.state_dict()))
    loaded, variables, _ = port_io.load_model(path, dtype=torch.bfloat16)
    assert loaded.dtype == torch.bfloat16 and loaded.num_classes == 2
    state = torch_state_from_variables(variables)
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v), k

    with open(path, "rb") as f:
        payload = codec.unpackb(f.read())
    payload["meta"]["model"]["backbone_name"] = "resnet18"
    with open(path, "wb") as f:
        f.write(codec.packb(payload))
    with pytest.raises(ValueError, match="unknown backbone 'resnet18'"):
        port_io.load_model(path)
    payload["meta"]["format_version"] = 2
    with open(path, "wb") as f:
        f.write(codec.packb(payload))
    with pytest.raises(ValueError, match="format version"):
        port_io.load_model(path)

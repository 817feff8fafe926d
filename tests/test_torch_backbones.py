"""The port's backbone families (SE-ResNet, VGG, DenseNet, MobileNet) on the
CPU against ``tdnet``: the C3/C4/C5 taps of reduced models at an even and
an odd input size (VGG and DenseNet floor their pools, SE-ResNet and
MobileNet take TF 'SAME' ceilings), a whole RetinaNet, the parameter trees
of every registered name, the weight bridge's dense and depthwise kernels,
SE-ResNet through the fused stem's plain version, the fused-stem gate,
``.tdn`` bundles the reference wrote, keras ``.h5`` files of the three
other families, and one f32 train step of a non-ResNet. Variables are
numpy arrays drawn from seeds; both sides get the same arrays. Tolerances
are relative to each tensor's largest magnitude."""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdnet_torch.models import backbone as registry_backbone
from tdnet_torch.models.densenet import DenseNet
from tdnet_torch.models.mobilenet import MobileNet
from tdnet_torch.models.resnet import ResNet
from tdnet_torch.models.retinanet import RetinaNet, takes_fused_stem
from tdnet_torch.models.vgg import VGG
from tdnet_torch.weights import (random_variables, torch_state_from_variables,
                                 variables_from_torch_state)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

SIZES = [(64, 96), (65, 97)]
NAMES = ["resnet50", "resnet101", "resnet152", "seresnet50", "seresnet101",
         "seresnet152", "vgg16", "vgg19", "densenet121", "densenet169",
         "densenet201", "mobilenet", "mobilenet_0.75", "mobilenet_0.5"]
CAFFE_MEAN_BGR = np.array([103.939, 116.779, 123.68], np.float32)


def _flax_family(family):
    from tdnet.models.densenet import DenseNet as FlaxDenseNet
    from tdnet.models.mobilenet import MobileNet as FlaxMobileNet
    from tdnet.models.resnet import ResNet as FlaxResNet
    from tdnet.models.vgg import VGG as FlaxVGG

    return {
        "seresnet": FlaxResNet(stage_sizes=(1, 1, 1, 1), se_ratio=1.0 / 16),
        "vgg": FlaxVGG(stage_sizes=(1, 1, 1, 1, 1)),
        "densenet": FlaxDenseNet(block_sizes=(1, 2, 1, 1)),
        "mobilenet": FlaxMobileNet(alpha=0.25),
    }[family]


# reduced depth or width: one block a stage, one conv a block, a short
# DenseNet, MobileNet at alpha 0.25; (port module, preprocess mode)
FAMILIES = {
    "seresnet": (lambda: ResNet((1, 1, 1, 1), se_ratio=1.0 / 16), "caffe"),
    "vgg": (lambda: VGG((1, 1, 1, 1, 1)), "caffe"),
    "densenet": (lambda: DenseNet((1, 2, 1, 1)), "tf"),
    "mobilenet": (lambda: MobileNet(0.25), "tf"),
}
# C3 (H, W) at 65x97: the pools of VGG and DenseNet floor, the others ceil
C3_AT_65x97 = {"seresnet": (9, 13), "vgg": (8, 12), "densenet": (8, 12),
               "mobilenet": (9, 13)}


def _trim():
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: nothing to trim
        pass


@pytest.fixture(scope="module", autouse=True)
def _release_memory():
    """Before the module, drop the executables that the worker's earlier
    modules left (the first port file in the collection: in tier-1 its
    worker has just run reference multi-device tests, and the six workers
    share the machine's memory); after it, this module's, and trim the C
    heap its trees leave."""
    _trim()
    yield
    _trim()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _random_state(module, seed):
    """A state dict of numpy arrays for ``module``: weights at the scale of
    lecun_normal, biases small, BatchNorm with non-trivial statistics (so
    the fold and its epsilon matter)."""
    rng = np.random.RandomState(seed)
    state = {}
    for key, t in module.state_dict().items():
        shape, name = tuple(t.shape), key.rsplit(".", 1)[-1]
        if name == "weight":
            arr = rng.normal(0, np.sqrt(1.0 / np.prod(shape[1:])), shape)
        elif name in ("scale", "var"):
            arr = rng.uniform(0.5, 1.5, shape)
        else:  # biases, BN bias and mean
            arr = rng.normal(0, 0.1, shape)
        state[key] = arr.astype(np.float32)
    return state


def _flax_vars(variables):
    return {c: jax.tree.map(jnp.asarray, t) for c, t in variables.items() if t}


def _raw(hw, seed, b=2):
    return np.random.RandomState(seed).randint(0, 256, (b,) + hw + (3,)).astype(np.uint8)


def _normalize(raw, mode):
    x = raw.astype(np.float32)
    return x - CAFFE_MEAN_BGR if mode == "caffe" else (x - 127.5) / 127.5


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


class _FamilyRuns(dict):
    """family -> (port module with the state loaded, mode, {size: (raw
    uint8 pages, tdnet's taps)}); tdnet's apply runs once per family and
    size, each when a test first asks for it: a tier-1 worker that runs
    some of this module's tests pays only for their families and sizes."""

    def __missing__(self, family):
        i = list(FAMILIES).index(family)
        make, mode = FAMILIES[family]
        module = make()
        state = _random_state(module, seed=10 + i)
        module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        module = module.to(memory_format=torch.channels_last).eval()
        self[family] = (module, mode, _Taps(family, mode, state))
        return self[family]


class _Taps(dict):
    def __init__(self, family, mode, state):
        super().__init__()
        self.apply = jax.jit(_flax_family(family).apply)
        self.mode, self.flax_vars = mode, _flax_vars(variables_from_torch_state(state))

    def __missing__(self, hw):
        raw = _raw(hw, seed=hw[1])
        taps = self.apply(self.flax_vars, jnp.asarray(_normalize(raw, self.mode)))
        self[hw] = (raw, [np.asarray(t) for t in taps])
        return self[hw]


@pytest.fixture(scope="module")
def family_runs():
    return _FamilyRuns()


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("family", list(FAMILIES))
def test_backbone_taps_match_reference(family_runs, family, hw):
    """C3/C4/C5 of each reduced family in f32 within 1e-5 of each tap's
    largest magnitude; at 65x97 C3 has the reference's floor or ceiling."""
    module, mode, runs = family_runs[family]
    raw, want = runs[hw]
    with torch.no_grad():
        got = module(torch.from_numpy(_normalize(raw, mode)).permute(0, 3, 1, 2))
    assert len(got) == 3
    for t, ref, c in zip(got, want, module.channels):
        assert t.shape[1] == c
        _close(t.permute(0, 2, 3, 1).numpy(), ref, 1e-5)
    if hw == (65, 97):
        assert tuple(got[0].shape[2:]) == C3_AT_65x97[family]


def test_se_resnet_fused_stem_route_matches_reference(family_runs):
    """SE-ResNet from the fused ingest+stem (its plain version on the CPU)
    on uint8 pages, then the model from the pooled stem: the same taps as
    tdnet's unfused SE-ResNet on the caffe-normalized pages, within 1e-5."""
    from tdnet_torch.ops.stem import fused_stem_packed

    module, _, runs = family_runs["seresnet"]
    raw, want = runs[(64, 96)]
    with torch.no_grad():
        k7, inv, off = module.stem_params()
        act = fused_stem_packed(torch.from_numpy(raw.reshape(2, 64, 96 * 3)), k7, inv,
                                off, normalize="caffe", out_dtype=torch.float32)
        got = module(act.permute(0, 3, 1, 2), stem_input=True, block_kernel=True)
    for t, ref in zip(got, want):
        _close(t.permute(0, 2, 3, 1).numpy(), ref, 1e-5)


def test_se_resnet_gradients_match_reference(family_runs):
    """The gradients of a fixed projection of the reduced SE-ResNet's taps
    (64x96) with respect to every trainable weight, the SE gates' dense
    kernels and biases among them, against ``jax.grad`` of tdnet's: each
    tensor within a relative Frobenius error of 1e-4."""
    module, mode, runs = family_runs["seresnet"]
    raw, taps = runs[(64, 96)]
    x = _normalize(raw, mode)
    proj = [np.random.RandomState(20 + i).normal(size=t.shape).astype(np.float32)
            for i, t in enumerate(taps)]
    state = {k: v.numpy() for k, v in module.state_dict().items()}
    variables = _flax_vars(variables_from_torch_state(state))
    flax_model = _flax_family("seresnet")

    def loss(params):
        out = flax_model.apply({**variables, "params": params}, jnp.asarray(x))
        return sum(jnp.sum(t * p) for t, p in zip(out, proj))

    want = dict(_leaves(jax.tree.map(np.asarray,
                                     jax.jit(jax.grad(loss))(variables["params"]))))
    net = ResNet((1, 1, 1, 1), se_ratio=1.0 / 16)
    net.load_state_dict(module.state_dict())
    out = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    sum((t.permute(0, 2, 3, 1) * torch.from_numpy(p)).sum()
        for t, p in zip(out, proj)).backward()
    names = [n for n, p in net.named_parameters() if p.grad is not None]
    got = dict(_leaves(variables_from_torch_state(
        {n: p.grad for n, p in net.named_parameters() if p.grad is not None})["params"]))
    assert any("se_reduce" in n for n in names) and got.keys() <= want.keys()
    for path, g in got.items():
        w = want[path]
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), path
    # frozen BatchNorm: no gradient on either side
    assert all(not np.any(w) for p, w in want.items() if p not in got)


@pytest.mark.parametrize("se_ratio, chains", [(0.0, 4), (1.0 / 16, 0)])
def test_se_blocks_refuse_the_block_kernel(monkeypatch, se_ratio, chains):
    """block_kernel sends each stage's identity run of a plain ResNet to the
    fused chain, and leaves an SE-ResNet's on its modules, as the
    reference's ``_identity_run`` does."""
    import tdnet_torch.models.resnet as resnet

    calls = []
    monkeypatch.setattr(resnet, "supports_block", lambda shape, filters: True)
    monkeypatch.setattr(resnet, "fused_bottleneck_chain",
                        lambda x, *a, **k: calls.append(x.shape) or x)
    module = ResNet((2, 2, 2, 2), se_ratio=se_ratio).eval()
    with torch.no_grad():
        module(torch.zeros(1, 3, 64, 64), block_kernel=True)
    assert len(calls) == chains


@pytest.mark.parametrize("name", NAMES)
def test_parameter_tree_equals_reference(name):
    """Every registered name builds, and its state dict (on the meta device)
    maps to the paths and shapes of ``jax.eval_shape(RetinaNet.init)``."""
    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet

    want = jax.eval_shape(FlaxRetinaNet(num_classes=2, backbone_name=name).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))
    want = {(c,) + p: tuple(v.shape) for c in want for p, v in _leaves(want[c])}
    with torch.device("meta"):
        model = registry_backbone(name).retinanet(2)
    got = {}
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        shape = tuple(t.shape)
        if leaf == "weight":  # OIHW -> HWIO, (out, in) -> (in, out)
            leaf = "kernel"
            shape = shape[::-1] if len(shape) == 2 else shape[2:] + shape[1::-1]
        collection = "batch_stats" if leaf in ("mean", "var") else "params"
        got[(collection, *path, leaf)] = shape
    assert got == want


def test_bridge_dense_and_depthwise_round_trip():
    """A dense (in, out) kernel and a depthwise (3, 3, 1, C) kernel cross to
    the port's (out, in) and (C, 1, 3, 3) weights and back, bit for bit."""
    rng = np.random.RandomState(0)
    variables = {"params": {
        "se": {"kernel": rng.normal(size=(16, 4)).astype(np.float32),
               "bias": rng.normal(size=4).astype(np.float32)},
        "dw": {"kernel": rng.normal(size=(3, 3, 1, 8)).astype(np.float32)}},
        "batch_stats": {}}
    state = torch_state_from_variables(variables)
    np.testing.assert_array_equal(state["se.weight"].numpy(),
                                  variables["params"]["se"]["kernel"].T)
    np.testing.assert_array_equal(state["dw.weight"].numpy(),
                                  variables["params"]["dw"]["kernel"].transpose(3, 2, 0, 1))
    back = variables_from_torch_state(state)
    for path, value in _leaves(variables["params"]):
        got = dict(_leaves(back["params"]))[path]
        assert got.dtype == value.dtype
        np.testing.assert_array_equal(got, value)
    with pytest.raises(ValueError, match="3-D kernel"):
        torch_state_from_variables({"params": {"x": {"kernel": np.zeros((2, 2, 2))}}})


@pytest.mark.parametrize("name, want", [
    ("resnet50", True), ("seresnet50", True), ("vgg16", False),
    ("densenet121", False), ("mobilenet", False)])
def test_fused_stem_gate(name, want):
    """ResNets and SE-ResNets take the fused stem; the others do not, and
    forcing it on them raises the reference's error."""
    from tdnet_torch.train.predictor import Predictor

    assert takes_fused_stem(name) is want
    if want:
        return
    model = RetinaNet(1, name)
    with pytest.raises(ValueError, match="stem_input is ResNet-only"):
        Predictor(model, device="cpu", fused_stem=True)
    with pytest.raises(ValueError, match="stem_input is ResNet-only"):
        model(torch.zeros(1, 16, 16, 64), stem_input=True)


@pytest.fixture(scope="module")
def mobilenet_bundle(tmp_path_factory):
    """A mobilenet_0.5 RetinaNet's variables (BN statistics perturbed), the
    .tdn the reference wrote of them (no anchors: its writer cannot store
    them), and tdnet's outputs on pages at 65x97."""
    from tdnet.models.io import save_model
    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet

    variables = random_variables(1, "mobilenet_0.5", seed=4)
    rng = np.random.RandomState(5)
    for path, v in _leaves(variables["batch_stats"]):
        v[:] = rng.uniform(0.5, 1.5, v.shape) if path[-1] == "var" else rng.normal(0, 0.1, v.shape)
    flax_model = FlaxRetinaNet(num_classes=1, backbone_name="mobilenet_0.5")
    path = str(tmp_path_factory.mktemp("tdn") / "mobilenet.tdn")
    save_model(path, flax_model, variables)
    x = _normalize(_raw((65, 97), seed=6), "tf")
    want = jax.jit(flax_model.apply)(_flax_vars(variables), jnp.asarray(x))
    return variables, path, x, {k: np.asarray(v) for k, v in want.items()}


def test_retinanet_matches_reference(mobilenet_bundle):
    """A whole MobileNet RetinaNet (alpha 0.5, full depth) at 65x97: the
    regression and classification outputs within 1e-5 of their largest
    magnitudes."""
    variables, _, x, want = mobilenet_bundle
    model = RetinaNet(1, "mobilenet_0.5")
    model.load_state_dict(torch_state_from_variables(variables))
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("regression", "classification"):
        _close(got[key].numpy(), want[key], 1e-5)


def test_reference_bundles_load(mobilenet_bundle, tmp_path):
    """.tdn files that ``tdnet.models.io.save_model`` wrote: mobilenet_0.5's
    loads into the port with tdnet's outputs (1e-5); vgg16's loads with the
    variables bit-equal and outputs equal to the model given the same
    variables directly."""
    from tdnet.models.io import save_model
    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
    from tdnet_torch.models.io import load_model

    _, path, x, want = mobilenet_bundle
    model, variables, meta = load_model(path)
    assert (model.backbone_name, meta["anchors"]) == ("mobilenet_0.5", None)
    model.load_state_dict(torch_state_from_variables(variables))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    for key in ("regression", "classification"):
        _close(got[key].numpy(), want[key], 1e-5)

    ref_vars = random_variables(2, "vgg16", seed=7)
    path = str(tmp_path / "vgg16.tdn")
    save_model(path, FlaxRetinaNet(num_classes=2, backbone_name="vgg16"), ref_vars)
    model, variables, _ = load_model(path)
    assert model.backbone_name == "vgg16" and model.num_classes == 2
    loaded = dict(_leaves(variables))
    for p, v in _leaves(ref_vars):
        np.testing.assert_array_equal(loaded[p], v)
    direct = RetinaNet(2, "vgg16")
    direct.load_state_dict(torch_state_from_variables(ref_vars))
    model.load_state_dict(torch_state_from_variables(variables))
    x = torch.from_numpy(_normalize(_raw((64, 96), seed=8, b=1), "caffe"))
    with torch.no_grad():
        a, b = model.eval()(x), direct.eval()(x)
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("name", ["vgg16", "densenet121", "mobilenet"])
def test_keras_h5_loads_into_family(name, tmp_path):
    """A keras-layout .h5 of a whole RetinaNet of the family, written by the
    port: the port's strict loader and the reference's (h5py) read the same
    tree, equal to what was written, and it loads strictly into the port's
    model."""
    from tdnet.compat.keras_import import load_keras_retinanet_h5 as ref_load
    from tdnet_torch.compat.keras_import import (export_random_keras_weights,
                                                 load_keras_retinanet_h5)

    variables = random_variables(1, name, seed=9)
    path = str(tmp_path / f"{name}.h5")
    export_random_keras_weights(path, variables, backbone_name=name)
    template = random_variables(1, name, seed=10)
    got = load_keras_retinanet_h5(path, template, backbone_name=name, strict=True)
    want = ref_load(path, template, backbone_name=name)
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert got_l.keys() == want_l.keys() == dict(_leaves(variables)).keys()
    for p, v in _leaves(variables):
        np.testing.assert_array_equal(got_l[p], v)
        np.testing.assert_array_equal(np.asarray(want_l[p]), v)
    RetinaNet(1, name).load_state_dict(torch_state_from_variables(got))  # strict


def test_train_step_matches_reference():
    """One f32 train step of a mobilenet_0.25 RetinaNet (a packed uint8
    batch through the normalize route in tf mode) against tdnet's: metrics
    rtol 1e-4 (tests/test_torch_train.py's step rtol) and num_positive
    exact; the whole gradient within a relative Frobenius error of 5e-3."""
    import optax

    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
    from tdnet.train.step import TrainState
    from tdnet.train.step import create_optimizer as ref_opt
    from tdnet.train.step import make_train_step as ref_step
    from tdnet_torch.train.step import ClippedAdam, create_train_state, make_train_step

    h, w, lr = 64, 96, 1e-4
    variables = random_variables(1, "mobilenet_0.25", seed=11)
    raw = _raw((h, w), seed=12)
    batch = {
        "images": raw.reshape(2, h, w * 3),
        "gt_boxes": np.tile(np.array([[10.0, 10.0, 50.0, 40.0],
                                      [30.0, 20.0, 90.0, 60.0]], np.float32), (2, 1, 1)),
        "gt_labels": np.zeros((2, 2), np.int32),
        "gt_mask": np.tile(np.array([True, False]), (2, 1)),
        "image_hw": np.tile(np.array([h, w], np.float32), (2, 1)),
    }

    grab = optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda u, s, p=None: (u, {"g": u}))
    tx = optax.chain(grab, ref_opt(lr, 1e-3))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params), tx=tx)
    flax_model = FlaxRetinaNet(num_classes=1, backbone_name="mobilenet_0.25")
    new, jm = ref_step(flax_model, num_classes=1, preprocess_mode="tf")(state, batch)
    jg = dict(_leaves(jax.tree.map(np.asarray, new.opt_state[0]["g"])))

    class GrabAdam(ClippedAdam):  # keeps the raw (pre-clip) gradients
        def step(self, closure=None, **kw):
            self.raw = [p.grad.clone() for g in self.param_groups for p in g["params"]]
            return super().step(closure, **kw)

    model = RetinaNet(1, "mobilenet_0.25")
    tstate = create_train_state(model, variables, device="cpu",
                                optimizer=lambda p: GrabAdam(p, lr=lr, clipnorm=1e-3))
    step = make_train_step(model, num_classes=1, preprocess_mode="tf")
    _, tm = step(tstate, {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in batch.items()})
    assert int(tm["num_positive"]) == int(jm["num_positive"]) > 0
    for k in ("loss", "classification_loss", "regression_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    tg = dict(_leaves(variables_from_torch_state(
        dict(zip(names, tstate.optimizer.raw)))["params"]))
    err2 = ref2 = 0.0
    for path, g in jg.items():
        if path not in tg:  # frozen BN scale/bias: no gradient in the port
            assert path[-1] in ("scale", "bias") and not np.any(g), path
            continue
        err2 += float(((tg[path] - g).astype(np.float64) ** 2).sum())
        ref2 += float((g.astype(np.float64) ** 2).sum())
    assert set(tg) <= set(jg)
    assert np.sqrt(err2 / ref2) <= 5e-3


def test_bn_warmup_equals_reference_on_mobilenet():
    """``bn_warmup`` of a mobilenet_0.25 RetinaNet (BN eps 1e-3; tf packed
    rows) against tdnet's: every new mean and var within 1e-4 relative plus
    1e-4 of the leaf's largest magnitude (tests/test_torch_bn_warmup.py's
    bound), and every leaf moved."""
    from tdnet.train.weights import bn_warmup as ref_warmup
    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
    from tdnet_torch.train.weights import bn_warmup

    variables = random_variables(1, "mobilenet_0.25", seed=13)
    batches = [_raw((64, 96), seed=s).reshape(2, 64, 96 * 3) for s in (14, 15)]
    got = bn_warmup(RetinaNet(1, "mobilenet_0.25"), variables, iter(batches),
                    preprocess_mode="tf", verbose=False, device="cpu")
    want = ref_warmup(FlaxRetinaNet(num_classes=1, backbone_name="mobilenet_0.25"),
                      variables, iter(batches), preprocess_mode="tf", verbose=False)
    got, want = dict(_leaves(got["batch_stats"])), dict(_leaves(want["batch_stats"]))
    before = dict(_leaves(variables["batch_stats"]))
    assert got.keys() == want.keys() == before.keys() and len(got) == 2 * 27
    for path, w in want.items():
        w, g = np.asarray(w), got[path]
        assert not np.array_equal(g, before[path]), path
        assert (np.abs(g - w) <= 1e-4 * np.abs(w) + 1e-4 * np.abs(w).max()).all(), path

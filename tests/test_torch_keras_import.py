"""Keras ``.h5`` weights through the port (``tdnet_torch/compat/
keras_import.py`` on its own HDF5 code) against the reference
(``tdnet/compat/keras_import.py`` on h5py): the same trees from the same
files, exactly, whichever package wrote them; the skip-mismatch summary;
the ImageNet lookup; and ``.h5`` through the evaluate CLI's loader."""

import ctypes
import gc

import numpy as np
import pytest
import torch

from tdnet_torch.compat import keras_import as port
from tdnet_torch.weights import random_variables

torch.set_num_threads(1)  # tier-1 runs several xdist workers


@pytest.fixture(scope="module", autouse=True)
def _release_memory():
    """Trim the C heap that this module's ResNet-50 trees leave behind."""
    yield
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: nothing to trim
        pass


@pytest.fixture(scope="module")
def variables():
    return random_variables(1, "resnet50", seed=3)


@pytest.fixture(scope="module")
def files(tmp_path_factory, variables):
    """The same variables as .h5, written by the reference (h5py) and by
    the port."""
    from tdnet.compat.keras_import import export_random_keras_weights as ref_export

    root = tmp_path_factory.mktemp("keras")
    ref_export(str(root / "ref.h5"), variables)
    port.export_random_keras_weights(str(root / "port.h5"), variables)
    return root


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, value in want.items():
        value = np.asarray(value)
        assert got[path].dtype == value.dtype, path
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


@pytest.mark.parametrize("writer,strict", [("ref", True), ("port", False)])
def test_load_equals_reference(files, variables, writer, strict, capsys):
    """Both loaders on one file: the same tree, bit for bit, which is the
    exported variables, and the same printed summary."""
    from tdnet.compat.keras_import import load_keras_retinanet_h5 as ref_load

    template = random_variables(1, "resnet50", seed=4)
    path = str(files / f"{writer}.h5")
    got = port.load_keras_retinanet_h5(path, template, strict=strict, verbose=True)
    got_out = capsys.readouterr().out
    want = ref_load(path, template, strict=strict, verbose=True)
    assert capsys.readouterr().out == got_out
    assert got_out == f"keras h5 import: matched {len(list(_leaves(variables)))} weights from {path}\n"
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, variables)


def test_port_file_is_the_reference_file(files):
    """h5py reads the port's file as the reference's: the same names in
    the same order, the same arrays."""
    import h5py

    def walk(group, prefix=""):
        for key in group:
            item = group[key]
            if isinstance(item, h5py.Dataset):
                yield prefix + key, item[()]
            else:
                yield prefix + key + "/", None
                yield from walk(item, prefix + key + "/")

    with h5py.File(files / "port.h5", "r") as p, h5py.File(files / "ref.h5", "r") as r:
        got, want = list(walk(p)), list(walk(r))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (name, g), (_, w) in zip(got, want):
        if w is not None:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_backbone_only_file_skip_mismatch(tmp_path, variables, capsys):
    """A backbone-only file with one layer the model lacks, into a 2-class
    template: unmatched and shape-skipped weights as the reference counts
    them, the same summary line, the same tree; strict raises the
    reference's error."""
    from tdnet.compat.keras_import import load_keras_retinanet_h5 as ref_load

    name_map = {k: v for k, v in port.keras_name_map().items() if v[0] == "backbone"}
    name_map["extra_conv"] = ("backbone", "conv1")
    path = str(tmp_path / "ResNet-50-model.keras.h5")
    v = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    port.export_random_keras_weights(path, v, name_map=name_map)
    two = random_variables(2, "resnet50", seed=5)
    two["batch_stats"]["backbone"]["bn1"]["var"] = np.ones(32, np.float32)
    got = port.load_keras_retinanet_h5(path, two, strict=False, verbose=True)
    got_out = capsys.readouterr().out
    want = ref_load(path, two, strict=False, verbose=True)
    assert capsys.readouterr().out == got_out
    assert "; 1 unmatched (e.g. ['extra_conv/extra_conv/kernel:0'])" in got_out
    assert "; 1 shape-skipped (e.g. ['bn_conv1/bn_conv1/moving_variance:0: (64,) != (32,)'])" in got_out
    _assert_trees_equal(got, want)
    with pytest.raises(ValueError) as e_got:
        port.load_keras_retinanet_h5(path, two)
    with pytest.raises(ValueError) as e_want:
        ref_load(path, two)
    assert str(e_got.value) == str(e_want.value)


def _tiny_tree(name_map, rng):
    """Small conv (with a depthwise one) and BN leaves at every path of a
    name map."""
    params, stats = {}, {}
    for layer, path in name_map.items():
        if "bn" in layer.split("/")[-1] or layer.endswith("_bn"):
            port._set_path(params, path + ("scale",), rng.rand(4).astype(np.float32))
            port._set_path(params, path + ("bias",), rng.rand(4).astype(np.float32))
            port._set_path(stats, path + ("mean",), rng.rand(4).astype(np.float32))
            port._set_path(stats, path + ("var",), rng.rand(4).astype(np.float32))
        else:
            shape = (3, 3, 1, 4) if "conv_dw_" in layer else (1, 1, 4, 4)
            port._set_path(params, path + ("kernel",), rng.rand(*shape).astype(np.float32))
            port._set_path(params, path + ("bias",), rng.rand(4).astype(np.float32))
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("backbone", ["mobilenet", "densenet121", "vgg16"])
def test_other_families_round_trip(tmp_path, backbone, capsys):
    """The other families' name maps equal the reference's, and the
    depthwise transpose and the slashed DenseNet names ('conv1/conv') load
    as the reference loads them, from files either package wrote."""
    from tdnet.compat.keras_import import export_random_keras_weights as ref_export
    from tdnet.compat.keras_import import keras_name_map_for as ref_map
    from tdnet.compat.keras_import import load_keras_retinanet_h5 as ref_load

    name_map = port.keras_name_map_for(backbone)
    assert name_map == ref_map(backbone)
    tree = _tiny_tree(name_map, np.random.RandomState(6))
    for writer, export in (("ref", ref_export), ("port", port.export_random_keras_weights)):
        path = str(tmp_path / f"{writer}.h5")
        export(path, tree, backbone_name=backbone)
        got = port.load_keras_retinanet_h5(path, tree, backbone_name=backbone, verbose=True)
        got_out = capsys.readouterr().out
        want = ref_load(path, tree, backbone_name=backbone, verbose=True)
        assert capsys.readouterr().out == got_out
        _assert_trees_equal(got, want)
        _assert_trees_equal(got, tree)


@pytest.mark.parametrize("backbone", ["resnet101", "resnet152", "seresnet50", "unknown"])
def test_name_map_for_equals_reference(backbone):
    from tdnet.compat.keras_import import keras_name_map_for as ref_map

    try:
        want = ref_map(backbone)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port.keras_name_map_for(backbone)
        assert str(got.value) == str(e)
        return
    assert port.keras_name_map_for(backbone) == want


def test_imagenet_lookup_equals_reference(tmp_path, monkeypatch):
    """The same directories in both modules: the same file found, and
    without one the same FileNotFoundError and recipe."""
    import tdnet.train.weights as ref
    import tdnet_torch.train.weights as got

    dirs = [str(tmp_path / "keras"), "", str(tmp_path / "pretrained")]
    monkeypatch.setattr(ref, "IMAGENET_SEARCH_DIRS", dirs)
    monkeypatch.setattr(got, "IMAGENET_SEARCH_DIRS", dirs)

    def check(name):
        found = ref.find_imagenet_weights(name)
        assert got.find_imagenet_weights(name) == found
        if found:
            assert got.imagenet_weights_or_explain(name) == found
            return found
        with pytest.raises(FileNotFoundError) as e_got:
            got.imagenet_weights_or_explain(name)
        with pytest.raises(FileNotFoundError) as e_want:
            ref.imagenet_weights_or_explain(name)
        assert str(e_got.value) == str(e_want.value)
        return None

    assert [check(n) for n in ("resnet50", "resnet101", "vgg16")] == [None] * 3
    (tmp_path / "pretrained").mkdir()
    (tmp_path / "pretrained" / "resnet50_imagenet.h5").write_bytes(b"")
    (tmp_path / "keras").mkdir()
    (tmp_path / "keras" / "ResNet-101-model.keras.h5").write_bytes(b"")
    (tmp_path / "pretrained" / "ResNet-101-model.keras.h5").write_bytes(b"")
    assert check("resnet50") == str(tmp_path / "pretrained" / "resnet50_imagenet.h5")
    assert check("resnet101") == str(tmp_path / "keras" / "ResNet-101-model.keras.h5")
    assert check("resnet152") is None


def test_evaluate_loads_h5_as_the_reference(files, variables):
    """``evaluate x.h5``'s loader: a model of the dataset's classes and
    ``--backbone`` with the file's weights in every leaf. The reference's
    ``load_any_model`` runs ``tdnet.train.weights.load_initial_weights``
    on a ``model.init`` template; that init takes ~25 s on the CPU, so the
    reference side here is its loader on the port's template (a full file
    replaces every leaf of either)."""
    from tdnet.train.weights import load_initial_weights as ref_load
    from tdnet_torch.bin import evaluate

    argv = ["--device", "cpu", "csv", "a.csv", "c.csv", str(files / "port.h5")]
    model, got, anchors, meta = evaluate.load_any_model(
        str(files / "port.h5"), evaluate.parse_args(argv), 1, torch.float32)
    assert (anchors, meta) == (None, None)
    assert model.num_classes == 1 and model.backbone_name == "resnet50"
    want = ref_load(str(files / "port.h5"), random_variables(1, "resnet50"))
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, variables)


def test_big_endian_file_loads_into_the_model(tmp_path, variables):
    """A big-endian dataset keeps the file's dtype in the tree, as h5py
    gives it, and still loads into the port's model."""
    import h5py

    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.weights import load_initial_weights
    from tdnet_torch.weights import torch_state_from_variables

    kernel = variables["params"]["backbone"]["conv1"]["kernel"]
    with h5py.File(tmp_path / "be.h5", "w") as f:
        f.create_dataset("model_weights/conv1/conv1/kernel:0", data=kernel.astype(">f4"))
    got = load_initial_weights(str(tmp_path / "be.h5"), random_variables(1, "resnet50", seed=7),
                               verbose=False)
    assert got["params"]["backbone"]["conv1"]["kernel"].dtype == np.dtype(">f4")
    model = RetinaNet(1)
    model.load_state_dict(torch_state_from_variables(got))
    np.testing.assert_array_equal(model.backbone.conv1.weight.detach().numpy(),
                                  kernel.transpose(3, 2, 0, 1))

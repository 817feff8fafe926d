"""The port's train CLI (``tdnet_torch.bin.train``) against the
reference's (``tdnet.bin.train``) on a tiny CSV dataset, on the CPU: three
64x96 PNG pages with ruled tables, f32, batch 1, ``--steps 0`` (one pass,
3 steps an epoch), 2 epochs, ``--evaluation`` on two of the pages, both
runs from the same ``.tdn`` (the port's random init cannot reproduce the
reference's ``jax.random`` one); then both CLIs from a keras ``.h5`` with
``--bn-warmup 2 --random-transform``. Also the port alone: resume,
``--weights`` with a mismatched head, the flags that are not ported yet,
the RSS budget, ``--nan-check``, and the backbone registry and the weight
merge (``.tdn`` and ``.h5``) against ``tdnet``'s."""

import ctypes
import gc
import json
import shutil

import numpy as np
import pytest
import torch

from tdnet_torch.bin import train
from tdnet_torch.data.image import write_image_bgr
from tdnet_torch.models.io import save_model
from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.weights import random_variables, variables_from_torch_state

torch.set_num_threads(1)  # tier-1 runs several xdist workers

SIDES = ["--image-min-side", "64", "--image-max-side", "96"]
# The reference's lr (1e-5): Adam's first updates are lr * sign(g), so a
# gradient element within float noise of 0 moves by a whole lr in either
# framework; at lr 1e-4 that drift reaches 0.7% of the loss by step 4, at
# 1e-5 it stays below 1e-5 relative over the 6 steps.
LOSS_RTOL = 1e-4  # tests/test_torch_train.py's step tolerance, every step


@pytest.fixture(scope="module", autouse=True)
def _release_memory():
    """Drop this module's JAX executables and trim the C heap that its
    ResNet-50 weights leave behind."""
    yield
    import jax

    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: nothing to trim
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every file the module writes; removed at module teardown, since each
    .tdn holds ResNet-50's weights (139 MiB) and each snapshot its weights
    and Adam moments (~0.4 GB)."""
    root = tmp_path_factory.mktemp("train_cli_runs")
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def data(runs):
    """Pages, annotations (all three; val: pages 0 and 1), classes and the
    initial .tdn (the port's writer, no anchors)."""
    root = runs / "data"
    root.mkdir()
    rng = np.random.RandomState(0)
    rows = []
    for i in range(3):
        page = np.clip(rng.normal(235, 8, (64, 96, 3)), 0, 255).astype(np.uint8)
        for _ in range(2):
            x0, y0 = rng.randint(0, 50), rng.randint(0, 30)
            x1, y1 = x0 + rng.randint(20, 45), y0 + rng.randint(15, 33)
            page[y0:y1:6, x0:x1] = 30
            page[y0:y1, x0:x1:10] = 30
            rows.append(f"page{i}.png,{x0},{y0},{x1},{y1},table")
        write_image_bgr(root / f"page{i}.png", page)
    (root / "ann.csv").write_text("\n".join(rows) + "\n")
    (root / "val.csv").write_text(
        "\n".join(r for r in rows if not r.startswith("page2")) + "\n")
    (root / "classes.csv").write_text("table,0\n")
    save_model(str(root / "init.tdn"), _record(1), random_variables(1, "resnet50", seed=0))
    return root


def _record(num_classes):
    """The model record save_model reads (no weights: built on meta)."""
    with torch.device("meta"):
        return RetinaNet(num_classes)


@pytest.fixture(scope="module")
def two_class(runs):
    """A 2-class .tdn whose stem BN statistics also have another shape:
    three leaves mismatch a 1-class model."""
    v = random_variables(2, "resnet50", seed=1)
    v["batch_stats"]["backbone"]["bn1"]["var"] = np.ones(32, np.float32)
    path = runs / "two.tdn"
    save_model(str(path), _record(2), v)
    return path, v


def _argv(data, out, *extra, evaluation=True):
    """Both CLIs' arguments; ``out`` holds the run's snapshots, metrics and
    bundle."""
    out.mkdir(parents=True, exist_ok=True)
    ds = ["csv", str(data / "ann.csv"), str(data / "classes.csv")]
    if evaluation:
        ds += ["--val-annotations", str(data / "val.csv")]
    return [*SIDES, "--epochs", "2", "--steps", "0", "--log-every", "1",
            "--weights", str(data / "init.tdn"),
            "--snapshot-path", str(out / "snapshots"),
            "--metrics-path", str(out / "metrics.jsonl"),
            "--model-path", str(out / "model.tdn"),
            *(["--evaluation"] if evaluation else []), *extra, *ds]


def _records(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def jax_run(data, runs):
    from tdnet.bin.train import main

    out = runs / "jax"
    assert main(_argv(data, out)) == 0
    return out


@pytest.fixture(scope="module")
def port_run(data, runs):
    out = runs / "port"
    assert train.main(_argv(data, out, "--device", "cpu")) == 0
    return out


def _payload(directory, step):
    return torch.load(directory / str(step) / "state.pt", weights_only=True)


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ----------------------------------------------------- against the reference


def test_metrics_equal_reference(jax_run, port_run):
    """The same records with the same keys; every step's losses within
    LOSS_RTOL (the step records hold running means over the epoch), the
    same num_positive; each epoch's mAP within 1e-4."""
    _assert_records_match(_records(port_run), _records(jax_run), steps=6)


def _assert_records_match(got, want, steps):
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    step_records = [r for r in got if "step" in r]
    assert [r["step"] for r in step_records] == list(range(1, steps + 1))
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        for key in ("loss", "classification_loss", "regression_loss",
                    "epoch_loss", "grad_norm"):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL, err_msg=key)
        if "num_positive" in w:
            assert g["num_positive"] == w["num_positive"]
        if "mAP" in w:
            assert abs(g["mAP"] - w["mAP"]) <= 1e-4
            assert abs(g["weighted_mAP"] - w["weighted_mAP"]) <= 1e-4
    assert np.isfinite([r["loss"] for r in step_records]).all()


@pytest.fixture(scope="module")
def init_h5(data):
    """init.tdn's variables as a keras .h5, written by the port."""
    from tdnet_torch.compat.keras_import import export_random_keras_weights

    path = data / "init.h5"
    export_random_keras_weights(str(path), random_variables(1, "resnet50", seed=0))
    return path


def test_h5_warmup_and_transform_equal_reference(data, init_h5, runs, capsys):
    """``--weights init.h5 --bn-warmup 2 --random-transform`` (f32, host
    normalize, 1 epoch of 3 steps) through both CLIs: the same keras
    import summary and warm-up line, and the step and epoch records as
    test_metrics_equal_reference compares them. The warm-up draws its two
    batches from the loader's stream, shuffle and transforms included, so
    the steps after it see the same pages only if both loaders advanced
    alike."""
    from tdnet.bin.train import main as ref_main

    def argv(out, *extra):
        a = _argv(data, out, "--bn-warmup", "2", "--random-transform", "--no-snapshots",
                  "--epochs", "1", *extra, evaluation=False)
        a[a.index("--weights") + 1] = str(init_h5)
        return a

    capsys.readouterr()
    assert ref_main(argv(runs / "h5_jax")) == 0
    want = capsys.readouterr().out.splitlines()
    assert train.main(argv(runs / "h5_port", "--device", "cpu")) == 0
    got = capsys.readouterr().out.splitlines()
    n_weights = len(list(_leaves(random_variables(1, "resnet50"))))
    for line in (f"keras h5 import: matched {n_weights} weights from {init_h5}",
                 "bn_warmup: re-estimated BatchNorm statistics from 2 batches"):
        assert line in got and line in want, line
    _assert_records_match(_records(runs / "h5_port"), _records(runs / "h5_jax"), steps=3)


def test_snapshot_and_bundle_are_readable(data, port_run, capsys):
    """The port's evaluate CLI reads the run's snapshot directory; its
    predict CLI (uint8 pages, as the chip smoke runs it) reads the
    --model-path bundle, and so does the reference's reader, whose
    variables are the last snapshot's."""
    from tdnet.models.io import load_model as ref_load_model
    from tdnet_torch.bin import evaluate
    from tdnet_torch.train.checkpoint import Checkpointer

    snapshots = port_run / "snapshots"
    assert Checkpointer(str(snapshots)).steps() == [3, 6]
    capsys.readouterr()
    assert evaluate.main([*SIDES, "--device", "cpu", "csv", str(data / "ann.csv"),
                          str(data / "classes.csv"), str(snapshots)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("6 instances of class table with average precision: ")
    assert lines[-1].startswith("mAP: ")

    from tdnet_torch.bin import predict

    assert predict.main([str(port_run / "model.tdn"), str(data / "page0.png"),
                         "--output-dir", str(port_run / "predict"), "--device", "cpu",
                         "--device-normalize"]) == 0
    lines = (port_run / "predict" / "detections.jsonl").read_text().splitlines()
    assert [json.loads(x)["image"] for x in lines] == [str(data / "page0.png")]

    _, ref_vars, meta = ref_load_model(str(port_run / "model.tdn"))
    assert meta["model"]["num_classes"] == 1 and meta["anchors"] is None
    assert meta["inference"]["min_side"] == 64 and meta["inference"]["max_side"] == 96
    model = Checkpointer(str(snapshots)).restore_weights(RetinaNet(1))
    last = dict(_leaves(variables_from_torch_state(model.state_dict())))
    got = dict(_leaves({k: ref_vars[k] for k in ("params", "batch_stats")}))
    assert got.keys() == last.keys()
    for path, value in last.items():
        np.testing.assert_array_equal(np.asarray(got[path]), value, err_msg="/".join(path))


# ----------------------------------------------------------------- port only


def test_resume_equals_unbroken_run(data, port_run, runs, capsys):
    """One epoch, then --snapshot for the second: the final weights, BN
    statistics, Adam moments, step and lr equal the unbroken run's bit for
    bit. The unbroken run evaluated each epoch and these did not, so the
    evaluation leaves the training untouched."""
    first, second = runs / "first", runs / "second"
    assert train.main(_argv(data, first, "--device", "cpu", "--epochs", "1",
                            evaluation=False)) == 0
    assert train.main(_argv(data, second, "--device", "cpu", "--snapshot",
                            str(first / "snapshots"), evaluation=False)) == 0
    assert "resumed from step 3 (epoch 1)" in capsys.readouterr().out
    got, want = _payload(second / "snapshots", 6), _payload(port_run / "snapshots", 6)
    assert got.keys() == want.keys() == {"params", "batch_stats", "opt_state", "step", "lr"}
    for key in got:
        assert _equal(got[key], want[key]), key
    assert [r["step"] for r in _records(second) if "step" in r] == [4, 5, 6]


def test_weights_with_a_mismatched_head(data, two_class, runs, capsys):
    """A 2-class .tdn into the 1-class model (--epochs 0, so the bundle
    holds the loaded weights): the mismatched leaves keep their init,
    everything else is the file's, and the skipped names are printed."""
    from tdnet_torch.models.io import load_model

    path, two = two_class
    out = runs / "mismatched"
    argv = _argv(data, out, "--device", "cpu", "--epochs", "0", "--no-snapshots",
                 evaluation=False)
    argv[argv.index("--weights") + 1] = str(path)
    assert train.main(argv) == 0
    printed = capsys.readouterr().out
    assert f"loaded weights from {path}; skipped 3 mismatched: " in printed
    assert "'params/classification_submodel/head/bias: shape (18,) != (9,)'" in printed
    assert ("'params/classification_submodel/head/kernel: shape (3, 3, 256, 18) "
            "!= (3, 3, 256, 9)'") in printed
    assert "'batch_stats/backbone/bn1/var: shape (32,) != (64,)'" in printed
    _, saved, _ = load_model(str(out / "model.tdn"))
    init = dict(_leaves(random_variables(1, "resnet50", seed=0)))
    loaded = dict(_leaves(two))
    for path, value in _leaves(saved):
        kept = (path[1:3] == ("classification_submodel", "head")
                or path == ("batch_stats", "backbone", "bn1", "var"))
        np.testing.assert_array_equal(value, (init if kept else loaded)[path])


def test_load_initial_weights_equals_reference(two_class, port_run, capsys):
    """The port's merge against tdnet.train.weights.load_initial_weights on
    the same template and .tdn, and on the same keras .h5 (the 2-class
    weights, written by the port): the same leaves and dtypes, the same
    printed lines. A port checkpoint directory loads its latest weights
    (the run's last snapshot, which its bundle also holds); other files
    raise as the reference does, the port's message naming what it reads
    in the reference's place of an orbax snapshot."""
    from tdnet.train.weights import load_initial_weights as ref_load
    from tdnet_torch.models.io import load_model
    from tdnet_torch.train.weights import load_initial_weights

    template = random_variables(1, "resnet50", seed=0)
    path = str(two_class[0])
    capsys.readouterr()
    got = load_initial_weights(path, template)
    got_out = capsys.readouterr().out
    want = ref_load(path, template)
    assert capsys.readouterr().out == got_out
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for p, value in want_leaves.items():
        assert got_leaves[p].dtype == np.asarray(value).dtype
        np.testing.assert_array_equal(got_leaves[p], np.asarray(value))

    from_dir = dict(_leaves(load_initial_weights(str(port_run / "snapshots"), template)))
    _, last, _ = load_model(str(port_run / "model.tdn"))
    for p, value in _leaves(last):
        np.testing.assert_array_equal(from_dir[p], value)

    from tdnet_torch.compat.keras_import import export_random_keras_weights

    h5 = str(two_class[0]).replace(".tdn", ".h5")
    export_random_keras_weights(h5, two_class[1])
    capsys.readouterr()
    got = load_initial_weights(h5, template)
    got_out = capsys.readouterr().out
    want = ref_load(h5, template)
    assert capsys.readouterr().out == got_out
    assert "; 3 shape-skipped (e.g. " in got_out
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for p, value in want_leaves.items():
        assert got_leaves[p].dtype == np.asarray(value).dtype
        np.testing.assert_array_equal(got_leaves[p], np.asarray(value))
    with pytest.raises(ValueError) as e_got:
        load_initial_weights("w.pkl", template)
    with pytest.raises(ValueError) as e_want:
        ref_load("w.pkl", template)
    head = "unrecognized weights file 'w.pkl' (expected .tdn, .h5/.hdf5, or "
    assert str(e_want.value) == head + "an orbax snapshot directory)"
    assert str(e_got.value) == head + (
        "one of the port's checkpoint directories; a reference orbax snapshot "
        "converts to a .tdn with the reference's convert_model)")


UNPORTED = [
    (["--spatial", "2"], "--zero needs the plain 1-D data mesh"),
    (["--tensor-parallel", "2"], "--zero needs the plain 1-D data mesh"),
    (["--pipeline"], "--pipeline cannot be combined with --zero"),
    (["--microbatches", "2", "--pipeline"], "--pipeline cannot be combined with --zero"),
]


@pytest.mark.parametrize("flags,item", UNPORTED, ids=[" ".join(f[:2]) for f, _ in UNPORTED])
def test_unported_flags_raise_naming_their_item(flags, item):
    """The flags that once raised NotImplementedError naming their ROADMAP
    item (A16.3, A16.4) are ported: with --zero each is refused with the
    reference's message, and no NotImplementedError remains."""
    with pytest.raises(SystemExit, match=item):
        train.main(["--device", "cpu", "--zero", *flags, "csv", "missing.csv",
                    "classes.csv"])


def test_unported_flags_at_their_defaults_pass():
    """At their defaults the parallel flags make no grid, and --zero and
    --distributed parse; --zero with another parallel form is refused with
    the reference's message, an axis that does not divide the one rank
    with the reference's, and a malformed --distributed with its usage."""
    args = train.parse_args(["--bn-warmup", "0", "--spatial", "1", "--tensor-parallel", "1",
                             "--zero", "--weights", "w.tdn", "csv", "a.csv", "c.csv"])
    assert train._make_grid(args) is None
    for flags in (["--spatial", "2"], ["--tensor-parallel", "2"]):
        with pytest.raises(SystemExit, match="--zero needs the plain 1-D data mesh"):
            train.main(["--device", "cpu", "--zero", *flags, "csv", "a.csv", "c.csv"])
    with pytest.raises(SystemExit, match="--spatial: spatial axis 2 must divide the 1 devices"):
        train.main(["--device", "cpu", "--spatial", "2", "csv", "a.csv", "c.csv"])
    with pytest.raises(SystemExit, match="coordinator:port,num_processes,process_id"):
        train.main(["--device", "cpu", "--distributed", "x:1,two,0", "csv", "a.csv", "c.csv"])


def test_rss_budget_needs_snapshots_and_cuda_needs_a_card(data):
    with pytest.raises(SystemExit, match="needs snapshots"):
        train.main(["--rss-budget-mb", "100", "--no-snapshots", "--device", "cpu",
                    "csv", "a.csv", "c.csv"])
    with pytest.raises(SystemExit):  # --no-pallas on CUDA: argparse error
        train.parse_args(["--no-pallas", "csv", "a.csv", "c.csv"])
    assert train.parse_args(["--no-pallas", "--device", "cpu", "csv", "a.csv",
                             "c.csv"]).use_pallas is False
    if torch.cuda.is_available():
        return  # the default device is valid here
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        train.main(["csv", str(data / "ann.csv"), str(data / "classes.csv")])


def test_nan_check_raises_on_a_non_finite_loss(data, runs):
    """A NaN class-head bias makes the first loss NaN: --nan-check stops at
    step 1."""
    v = random_variables(1, "resnet50", seed=0)
    v["params"]["classification_submodel"]["head"]["bias"][:] = np.nan
    save_model(str(runs / "nan.tdn"), _record(1), v)
    argv = _argv(data, runs / "nan", "--device", "cpu", "--nan-check", "--epochs", "1",
                 "--steps", "1", "--no-snapshots", evaluation=False)
    argv[argv.index("--weights") + 1] = str(runs / "nan.tdn")
    with pytest.raises(FloatingPointError, match="loss is nan at step 1"):
        train.main(argv)


# ------------------------------------------------------------------ registry

BACKBONES = ["resnet50", "resnet101", "resnet152", "seresnet50", "seresnet101",
             "seresnet152", "vgg16", "vgg19", "densenet121", "densenet169",
             "densenet201", "mobilenet", "mobilenet_0.75", "mobilenet_0.5", "resnet18"]


@pytest.mark.parametrize("name", BACKBONES)
def test_backbone_registry_equals_reference(name):
    """Every name the reference knows has its preprocess mode and builds a
    model; unknown names raise the reference's ValueError."""
    from tdnet.models import backbone as ref_backbone
    from tdnet_torch.models import backbone

    try:
        want = ref_backbone(name)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            backbone(name)
        assert str(got.value) == str(e)
        return
    bb = backbone(name)
    assert (bb.name, bb.preprocess_mode) == (want.name, want.preprocess_mode)
    with torch.device("meta"):
        assert bb.retinanet(2).backbone_name == name

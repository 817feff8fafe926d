"""Pipeline parallelism (``tdnet_torch/parallel/pipeline.py``, train
``--pipeline``) in one process with both stages on the CPU, held against
``tdnet/parallel/pipeline.py`` on two JAX CPU devices and against the
port's own full model; and every refusal of the train CLI's parallel flags
against ``tdnet.bin.train``'s message.

The model is the data-parallel tests' small RetinaNet (MobileNet at a
quarter width, 32-channel pyramid and heads, f32) at 64x128, a batch of 4
in 2 microbatches whose halves hold different numbers of positive
anchors."""

import json

import numpy as np
import pytest
import torch

from tdnet_torch.data.image import write_image_bgr
from tdnet_torch.models.io import save_model
from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.parallel.pipeline import (STAGE0_KEYS, PipelinedForward, PipelineTrainer,
                                           make_stage_modules, split_variables)
from tdnet_torch.train.step import create_optimizer
from tdnet_torch.weights import random_variables, torch_state_from_variables

H, W = 64, 128
BATCH, MICRO = 4, 2
LR, CLIPNORM = 1e-4, 1e-3
BACKBONE, FEATURES = "mobilenet128_0.25", 32
CPU2 = ("cpu", "cpu")


def _variables():
    return random_variables(1, BACKBONE, seed=0, feature_size=FEATURES)


def _model():
    return RetinaNet(1, BACKBONE, feature_size=FEATURES)


def _batch():
    """Float NHWC pages; GT boxes 1, 1, 3 and 2 a page (three slots)."""
    images = np.random.RandomState(1).uniform(-120, 130, (BATCH, H, W, 3)).astype(np.float32)
    boxes = np.zeros((BATCH, 3, 4), np.float32)
    mask = np.zeros((BATCH, 3), bool)
    rng = np.random.RandomState(2)
    for i, n in enumerate((1, 1, 3, 2)):
        xy = rng.uniform(0, 60, (n, 2))
        boxes[i, :n] = np.concatenate([xy, xy + rng.uniform(20, 60, (n, 2))], 1)
        mask[i, :n] = True
    return {"images": images, "gt_boxes": boxes, "gt_labels": np.zeros((BATCH, 3), np.int32),
            "gt_mask": mask, "image_hw": np.tile(np.array([H, W], np.float32), (BATCH, 1))}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def reference():
    """tdnet's PipelineTrainer step on two JAX CPU devices from the port's
    initial variables: its metrics and merged variables."""
    import jax

    import jax.numpy as jnp
    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
    from tdnet.parallel.pipeline import PipelineTrainer as RefTrainer
    from tdnet.train.step import create_optimizer as ref_opt

    model = FlaxRetinaNet(num_classes=1, backbone_name=BACKBONE, feature_size=FEATURES,
                          dtype=jnp.float32)
    trainer = RefTrainer(model, 1, jax.devices()[:2], tx_factory=lambda: ref_opt(LR, CLIPNORM))
    states = trainer.states_from_variables(_variables())
    states, metrics = trainer.step(states, _batch(), num_microbatches=MICRO)
    out = {"metrics": metrics,
           "variables": jax.tree.map(np.asarray, trainer.merged_variables(states))}
    yield out
    jax.clear_caches()


@pytest.fixture(scope="module")
def stepped():
    """The port's step, and its states (both stages on the CPU)."""
    trainer = PipelineTrainer(_model(), 1, CPU2, optimizer_factory=create_optimizer(LR, CLIPNORM))
    states = trainer.states_from_variables(_variables())
    states, metrics = trainer.step(states, _batch(), num_microbatches=MICRO)
    return trainer, states, metrics


def test_split_and_merge_equal_the_variables():
    """The split is a partition of the tree by STAGE0_KEYS; the stage
    modules' state dicts are the full model's (backbone prefix dropped), and
    merging the stages' states gives the variables back exactly."""
    variables = _variables()
    v0, v1 = split_variables(variables)
    assert set(v0["params"]) == set(STAGE0_KEYS)
    assert set(v0["params"]) | set(v1["params"]) == set(variables["params"])
    full = _model().state_dict()
    backbone, head = make_stage_modules(_model())
    assert {f"backbone.{k}" for k in backbone.state_dict()} | set(head.state_dict()) == set(full)
    trainer = PipelineTrainer(_model(), 1, CPU2)
    merged = trainer.merged_variables(trainer.states_from_variables(variables))
    want, got = dict(_leaves(variables)), dict(_leaves(merged))
    assert set(want) == set(got)
    for path, v in want.items():
        assert np.array_equal(got[path], v), path


def test_stage_composition_is_the_forward_bit_for_bit():
    """backbone -> head on one page batch equals RetinaNet.forward bit for
    bit (both run retinanet_tail; the model in channels_last, as the stages
    are)."""
    variables = _variables()
    model = _model()
    model.load_state_dict(torch_state_from_variables(variables))
    model.to(memory_format=torch.channels_last)
    trainer = PipelineTrainer(_model(), 1, CPU2)
    s0, s1 = trainer.states_from_variables(variables)
    x = torch.from_numpy(_batch()["images"])
    with torch.no_grad():
        want = model(x)
        got = s1.model(*s0.model(x.permute(0, 3, 1, 2)))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_pipelined_forward_equals_the_full_model():
    """PipelinedForward in microbatches of 1 (two taps in flight at most)
    equals the full model on the whole batch (within 1e-5 relative: oneDNN
    picks its kernels by batch size), its outputs on the stage-1 device; a
    batch that does not divide, a third device or no flight raises."""
    variables = _variables()
    model = _model()
    model.load_state_dict(torch_state_from_variables(variables))
    model.to(memory_format=torch.channels_last)
    images = _batch()["images"]
    with torch.no_grad():
        want = model(torch.from_numpy(images))
    fwd = PipelinedForward(_model(), variables, CPU2, microbatch_size=1, max_in_flight=2)
    got = fwd(images)
    for k in want:
        assert got[k].device == torch.device("cpu") and got[k].shape == want[k].shape
        scale = float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= 1e-5 * scale, k
    with pytest.raises(ValueError, match="not divisible by microbatch 3"):
        PipelinedForward(_model(), variables, CPU2, microbatch_size=3)(images)
    with pytest.raises(ValueError, match="needs 2 devices, got 3"):
        PipelinedForward(_model(), variables, ("cpu",) * 3)
    with pytest.raises(ValueError, match="max_in_flight must be >= 1"):
        PipelinedForward(_model(), variables, CPU2, max_in_flight=0)


def test_step_equals_the_reference_pipeline_trainer(reference, stepped):
    """One step, 2 microbatches: num_positive exactly, the loss and its parts
    within rtol 1e-5 (each framework's f32 convolutions round differently);
    after the clipped Adam step every weight moved by at most lr, and at
    most 5% of them differ from the reference's by more than 1e-3 lr + 1e-7
    (the tolerance tests/test_torch_train.py holds the one-process step
    to). Each stage's optimizer holds only its own stage's parameters."""
    trainer, states, metrics = stepped
    want = reference["metrics"]
    assert metrics["num_positive"] == int(want["num_positive"]) > 0
    for k in ("loss", "classification_loss", "regression_loss"):
        np.testing.assert_allclose(metrics[k], float(want[k]), rtol=1e-5, err_msg=k)
    got = dict(_leaves(trainer.merged_variables(states)["params"]))
    ref = dict(_leaves(reference["variables"]["params"]))
    before = dict(_leaves(_variables()["params"]))
    n = n_apart = 0
    for path, w in ref.items():
        moved_t, moved_j = got[path] - before[path], w - before[path]
        assert max(np.abs(moved_t).max(), np.abs(moved_j).max()) <= LR * (1 + 1e-3) + 1e-7
        n_apart += int((np.abs(moved_t - moved_j) > 1e-3 * LR + 1e-7).sum())
        n += w.size
    assert n_apart <= 0.05 * n
    for state in states:
        owned = {id(p) for p in state.model.parameters()}
        held = [p for g in state.optimizer.param_groups for p in g["params"]]
        assert held and all(id(p) in owned for p in held)
        assert all(id(p) in owned for p in state.optimizer.state)


def test_step_equals_gradient_accumulation(stepped):
    """The same step by hand on the full model: each microbatch's loss over
    its own positives, the gradients summed, times 1/2, clipped per tensor
    and applied. The updated weights agree to 1e-9 (the rematerialised
    backbone backward and the split backward sum in the same order)."""
    from tdnet_torch.ops.anchors import anchors_for_shape
    from tdnet_torch.ops.losses import focal, smooth_l1
    from tdnet_torch.ops.targets import batched_anchor_targets
    from tdnet_torch.train.step import create_train_state

    trainer, states, metrics = stepped
    model = _model()
    state = create_train_state(model, _variables(), device="cpu",
                               optimizer=create_optimizer(LR, CLIPNORM))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    anchors = torch.tensor(anchors_for_shape((H, W)), dtype=torch.float32)
    losses = []
    for k in range(MICRO):
        sl = slice(k * BATCH // MICRO, (k + 1) * BATCH // MICRO)
        out = model(batch["images"][sl])
        labels, reg = batched_anchor_targets(anchors, batch["gt_boxes"][sl],
                                             batch["gt_labels"][sl], batch["gt_mask"][sl],
                                             batch["image_hw"][sl], 1)
        npos = (labels[..., -1] == 1).sum()
        loss = focal()(labels, out["classification"], npos) + smooth_l1()(
            reg, out["regression"], npos)
        loss.backward()
        losses.append(float(loss))
    for p in model.parameters():
        if p.grad is not None:
            p.grad.mul_(1.0 / MICRO)
    state.optimizer.step()
    assert metrics["loss"] == pytest.approx(np.mean(losses), rel=1e-6)
    merged = trainer.merged_state_dict(states)
    for k, v in model.state_dict().items():
        assert float((merged[k] - v).abs().max()) <= 1e-9, k


def test_merged_variables_bundle_reads_in_the_reference(stepped, tmp_path):
    """merged_variables written as a .tdn by the port reads in tdnet's
    reader with every leaf equal."""
    from tdnet.models.io import load_model as ref_load

    trainer, states, _ = stepped
    merged = trainer.merged_variables(states)
    with torch.device("meta"):
        record = _model()
    save_model(str(tmp_path / "m.tdn"), record, merged)
    _, variables, meta = ref_load(str(tmp_path / "m.tdn"))
    assert meta["model"]["backbone_name"] == BACKBONE
    got = dict(_leaves(variables))
    for path, v in _leaves(merged):
        assert np.array_equal(got[path], v), path


# ------------------------------------------------------------------ the CLI

CLI_BACKBONE = "mobilenet_0.5"  # a registered name: the CLI takes the registry's


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    """Four 64x96 PNG pages with two tables each, their CSVs and an initial
    .tdn."""
    root = tmp_path_factory.mktemp("pipeline_cli")
    rng = np.random.RandomState(0)
    rows = []
    for i in range(4):
        page = np.clip(rng.normal(235, 8, (64, 96, 3)), 0, 255).astype(np.uint8)
        for _ in range(2):
            x0, y0 = rng.randint(0, 50), rng.randint(0, 30)
            x1, y1 = x0 + rng.randint(20, 45), y0 + rng.randint(15, 33)
            page[y0:y1:6, x0:x1] = 30
            rows.append(f"page{i}.png,{x0},{y0},{x1},{y1},table")
        write_image_bgr(root / f"page{i}.png", page)
    (root / "ann.csv").write_text("\n".join(rows) + "\n")
    (root / "classes.csv").write_text("table,0\n")
    with torch.device("meta"):
        record = RetinaNet(1, CLI_BACKBONE)
    save_model(str(root / "init.tdn"), record, random_variables(1, CLI_BACKBONE, seed=0))
    return root


def _cli(pages, out, *extra):
    out.mkdir(parents=True, exist_ok=True)
    return ["--device", "cpu", "--backbone", CLI_BACKBONE, "--image-min-side", "64",
            "--image-max-side", "96", "--batch-size", "2", "--steps", "1", "--epochs", "1",
            "--log-every", "1", "--lr", str(LR), "--weights", str(pages / "init.tdn"),
            "--snapshot-path", str(out / "snapshots"), "--metrics-path",
            str(out / "metrics.jsonl"), "--model-path", str(out / "model.tdn"), *extra,
            "csv", str(pages / "ann.csv"), str(pages / "classes.csv")]


def test_train_cli_pipeline_equals_the_plain_run(pages, tmp_path, capsys):
    """``train --pipeline --device cpu`` for one step at batch 2 in one
    microbatch: its record's loss and num_positive equal the plain run's
    (rtol 1e-6), and its .tdn (the merged variables) equal the plain run's
    within 1e-9; its snapshot holds no optimizer state, and a plain run
    resumed from it restores the weights only, with the reference's
    message."""
    from tdnet_torch.bin import train
    from tdnet_torch.models.io import load_model
    from tdnet_torch.train.checkpoint import Checkpointer

    assert train.main(_cli(pages, tmp_path / "pipe", "--pipeline", "--microbatches", "1")) == 0
    said = capsys.readouterr().out
    assert "pipeline training: 2 stages on cpu | cpu, 1 microbatches of 2" in said
    assert train.main(_cli(pages, tmp_path / "plain", "--no-snapshots")) == 0
    capsys.readouterr()
    recs = {n: [json.loads(x) for x in (tmp_path / n / "metrics.jsonl").read_text().splitlines()]
            for n in ("pipe", "plain")}
    p, q = recs["pipe"][0], recs["plain"][0]
    assert p["num_positive"] == q["num_positive"] > 0
    assert p["loss"] == pytest.approx(q["loss"], rel=1e-6)
    a = dict(_leaves(load_model(str(tmp_path / "pipe" / "model.tdn"))[1]))
    b = dict(_leaves(load_model(str(tmp_path / "plain" / "model.tdn"))[1]))
    assert set(a) == set(b)
    assert max(float(np.abs(a[k] - b[k]).max()) for k in a) <= 1e-9
    assert not Checkpointer(str(tmp_path / "pipe" / "snapshots")).has_opt_state()
    assert train.main(_cli(pages, tmp_path / "resumed", "--no-snapshots", "--epochs", "2",
                           "--snapshot", str(tmp_path / "pipe" / "snapshots"))) == 0
    said = capsys.readouterr().out
    assert ("snapshot has no optimizer state (saved by a --pipeline run): restored "
            "weights only; optimizer restarts") in said
    assert "resumed from step 1 (epoch 1)" in said


def test_train_cli_pipeline_runs_through_fit(pages, tmp_path, capsys):
    """``train --pipeline`` runs fit()'s loop, so the loop's flags reach it:
    with ``--nan-check`` and an RSS budget of 1 MB the run checkpoints
    epoch 0 (merged variables, no optimizer state), then stops with the
    budget's exit code; and its state's optimizer view sets the learning
    rate of both stage optimizers."""
    from tdnet_torch.bin import train
    from tdnet_torch.train.checkpoint import Checkpointer
    from tdnet_torch.train.loop import RSS_BUDGET_EXIT_CODE, set_learning_rate

    out = tmp_path / "budget"
    rc = train.main(_cli(pages, out, "--pipeline", "--nan-check", "--epochs", "2",
                         "--rss-budget-mb", "1"))
    assert rc == RSS_BUDGET_EXIT_CODE
    assert "crossed the 1 MB budget after epoch 0" in capsys.readouterr().out
    ckpt = Checkpointer(str(out / "snapshots"))
    assert ckpt.latest_step() == 1 and not ckpt.has_opt_state()
    assert not (out / "model.tdn").exists()

    trainer = PipelineTrainer(_model(), 1, CPU2, optimizer_factory=create_optimizer(LR, CLIPNORM))
    state = train._PipelineState(trainer.states_from_variables(_variables()), 0)
    set_learning_rate(state.optimizer, 3e-7)
    assert [g["lr"] for s in state.states for g in s.optimizer.param_groups] == [3e-7, 3e-7]


# (argv flags, how the reference's message reads in the port: the device
# counts of one CPU process where the reference counts its 8 CPU devices)
REFUSALS = [
    *[(["--pipeline", *f], None) for f in (
        ["--spatial", "2"], ["--tensor-parallel", "2"], ["--zero"],
        ["--distributed", "127.0.0.1:1,2,0"], ["--device-normalize"], ["--fused-stem"],
        ["--freeze-backbone"], ["--bn-warmup", "1"])],
    (["--pipeline"], "devices"),
    (["--pipeline", "--batch-size", "3", "--microbatches", "2"], None),
    (["--spatial", "3"], "8 devices"),
    (["--tensor-parallel", "3"], "8 devices"),
    (["--spatial", "2", "--tensor-parallel", "2"], None),
    (["--zero", "--spatial", "2"], None),
    (["--zero", "--tensor-parallel", "4"], None),
]


@pytest.mark.parametrize("flags,counted", REFUSALS, ids=[" ".join(f) for f, _ in REFUSALS])
def test_refusals_equal_the_reference(flags, counted, pages, monkeypatch, tmp_path):
    """Each refusal of the parallel flags is tdnet.bin.train's message. The
    reference runs on the test process's 8 JAX CPU devices, the port in one
    CPU process (one rank, no card): an axis that does not divide counts
    8 devices there and 1 here, and the pipeline's device count is taken
    there with jax.local_devices() reporting none."""
    import jax

    from tdnet.bin import train as ref
    from tdnet_torch.bin import train

    ds = ["csv", str(pages / "ann.csv"), str(pages / "classes.csv")]
    common = ["--image-min-side", "64", "--image-max-side", "96", "--steps", "1",
              "--epochs", "1", "--no-snapshots", "--backbone", CLI_BACKBONE]
    # the reference joins --distributed's group before it refuses
    monkeypatch.setattr(ref, "_maybe_init_distributed", lambda spec: None)
    if counted == "devices":
        monkeypatch.setattr(jax, "local_devices", lambda: [])
    with pytest.raises(SystemExit) as want:
        ref.main([*common, *flags, *ds])
    monkeypatch.undo()
    port_flags = flags if counted == "devices" else ["--device", "cpu", *flags]
    with pytest.raises(SystemExit) as got:
        train.main([*common, *port_flags, *ds])
    message = str(want.value)
    if counted == "8 devices":
        message = message.replace("the 8 devices", "the 1 devices")
    assert isinstance(want.value.code, str) and str(got.value) == message

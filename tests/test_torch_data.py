"""The port's trainer plumbing on the CPU: BatchLoader against tdnet's on
one in-memory dataset and seed, the prefetcher, ReduceLROnPlateau against
tdnet's, and a checkpointed 2+2-epoch resume through ``fit`` that must equal
4 unbroken epochs bit for bit. The prefetcher's CUDA copy is checked on a
GPU only (``cuda`` marker)."""

import json

import numpy as np
import pytest
import torch

from tdnet_torch.data.generator import BatchLoader, LoaderConfig
from tdnet_torch.data.prefetch import DevicePrefetcher

torch.set_num_threads(1)  # tier-1 runs several xdist workers

SIDES = dict(min_side=64, max_side=96)


class MemoryDataset:
    """BGR pages and boxes held in memory (the reference's Dataset
    protocol). Page sizes are chosen so the resize scale is exactly 1.0:
    the resize itself is held against cv2 in tests/test_torch_ops.py."""

    def __init__(self, n, seed=0, dense=None):
        rng = np.random.RandomState(seed)
        shapes = [(64, 96), (96, 64), (64, 80), (80, 64)]
        self.pages, self.boxes = [], []
        for i in range(n):
            h, w = shapes[i % len(shapes)]
            self.pages.append(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
            k = dense if (dense and i == 0) else rng.randint(0, 4)
            xy = rng.uniform(0, min(h, w) / 2, (k, 2))
            self.boxes.append(np.concatenate([xy, xy + rng.uniform(4, 30, (k, 2))], 1))

    def size(self):
        return len(self.pages)

    def load_image(self, i):
        return self.pages[i].copy()

    def load_annotations(self, i):
        return {"bboxes": self.boxes[i].copy(),
                "labels": np.zeros(len(self.boxes[i]), np.int32)}

    def image_aspect_ratio(self, i):
        h, w = self.pages[i].shape[:2]
        return w / h

    def num_classes(self):
        return 1


@pytest.mark.parametrize("device_normalize", [False, True])
def test_batch_loader_matches_reference(device_normalize):
    """Same batches, keys, dtypes and values (exactly) as tdnet's loader for
    two shuffled epochs of 7 pages in two buckets (repeat-padded tails); the
    same step count; skip_epochs replays the shuffle stream."""
    from tdnet.data.generator import BatchLoader as RefLoader
    from tdnet.data.generator import LoaderConfig as RefConfig

    ds = MemoryDataset(7)
    kw = dict(batch_size=3, seed=5, device_normalize=device_normalize, **SIDES)
    ref = RefLoader(ds, RefConfig(process_index=0, process_count=1, **kw))
    port = BatchLoader(ds, LoaderConfig(**kw))
    assert port.steps_per_epoch() == ref.steps_per_epoch() == 3
    assert port.max_boxes == ref.max_boxes == 64
    want = [b for _ in range(2) for b in ref.epoch()]
    got = [b for _ in range(2) for b in port.epoch()]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    resumed = BatchLoader(ds, LoaderConfig(**kw))
    resumed.skip_epochs(1)
    for g, w in zip(resumed.epoch(), want[3:]):
        np.testing.assert_array_equal(g["indices"], w["indices"])


def test_batch_loader_options():
    """Auto max_boxes sizes to the densest image; worker threads give the
    same batches, with random_transform too (the transforms are drawn
    before the loads; tests/test_torch_transform.py holds them against the
    reference's)."""
    ds = MemoryDataset(4, dense=70)
    assert BatchLoader(ds, LoaderConfig(**SIDES)).max_boxes == 72
    for random_transform in (False, True):
        kw = dict(batch_size=2, random_transform=random_transform, **SIDES)
        one = list(BatchLoader(ds, LoaderConfig(**kw)).epoch())
        loader = BatchLoader(ds, LoaderConfig(workers=3, **kw))
        many = list(loader.epoch())
        loader.close()
        for a, b in zip(one, many):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_packs_and_moves_batches():
    ds = MemoryDataset(5)
    cfg = LoaderConfig(batch_size=2, device_normalize=True, shuffle=False, **SIDES)
    want = list(BatchLoader(ds, cfg).epoch())
    pf = DevicePrefetcher(BatchLoader(ds, cfg).epoch(), device="cpu")
    got = list(pf)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        b, h, wd, _ = w["images"].shape
        assert tuple(g["images"].shape) == (b, h, wd * 3)  # packed rows
        np.testing.assert_array_equal(g["images"].numpy(), w["images"].reshape(b, h, -1))
        np.testing.assert_array_equal(g["gt_boxes"].numpy(), w["gt_boxes"])
    pf.close()
    assert not pf._thread.is_alive()

    def failing():
        yield want[0]
        raise OSError("disk gone")

    pf = DevicePrefetcher(failing(), device="cpu")
    next(pf)
    with pytest.raises(OSError, match="disk gone"):
        next(pf)
    pf.close()


def test_reduce_lr_on_plateau_matches_reference():
    from tdnet.train.loop import ReduceLROnPlateau as Ref
    from tdnet_torch.train.loop import ReduceLROnPlateau

    losses = [5.0, 4.0, 4.5, 4.2, 4.1, 4.3, 3.0, 3.0, 3.0, 2.9, 3.1]
    ref, port = Ref(verbose=False), ReduceLROnPlateau(verbose=False)
    lr_ref = lr_port = 1e-3
    for loss in losses:
        lr_ref, lr_port = ref.update(loss, lr_ref), port.update(loss, lr_port)
        assert lr_port == lr_ref
    assert lr_port < 1e-3


def test_metrics_writer_has_no_tensorboard(tmp_path):
    """TensorBoard scalars without the tensorboard or tensorflow packages
    (the GPU machine has neither): the writer makes the directory and an
    event file of one scalar a numeric value, at the record's step;
    tests/test_torch_events.py holds the file against the reference's."""
    import subprocess
    import sys
    from pathlib import Path

    code = f"""
import sys
from tdnet_torch.train.loop import MetricsWriter
w = MetricsWriter(tensorboard_dir={str(tmp_path / "tb")!r})
w.write({{"step": 3, "epoch": 0, "loss": 1.5, "name": "x"}})
w.close()
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("tensorboard", "tensorflow"))
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    from tdnet_torch.train.events import read_events

    (path,) = (tmp_path / "tb").iterdir()
    scalars = [(e["step"], v["tag"], v["value"]) for e in read_events(str(path))
               for v in e["values"]]
    assert scalars == [(3, "epoch", 0.0), (3, "loss", 1.5)]


# ------------------------------------------------------ checkpoint + resume


@pytest.fixture(scope="module")
def variables():
    from tdnet_torch.weights import random_variables

    return random_variables(1, "resnet50", seed=0)


def _fit(variables, epochs, initial_epoch=0, checkpointer=None, metrics=None,
         skip=0, restore=False, **fit_kwargs):
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.loop import fit
    from tdnet_torch.train.step import (create_optimizer, create_train_state,
                                        make_train_step)

    model = RetinaNet(1)
    state = create_train_state(model, variables, device="cpu",
                               optimizer=create_optimizer(1e-3, 1e-3))
    if restore:
        state = checkpointer.restore(state)
    loader = BatchLoader(MemoryDataset(2, seed=9),
                         LoaderConfig(batch_size=2, device_normalize=True, **SIDES))
    loader.skip_epochs(skip)
    batches = DevicePrefetcher(loader.forever(), device="cpu")
    try:
        state = fit(state, make_train_step(model, num_classes=1), batches,
                    steps_per_epoch=1, epochs=epochs, initial_epoch=initial_epoch,
                    checkpointer=checkpointer, metrics_path=metrics, log_every=1,
                    **fit_kwargs)
    finally:
        batches.close()
    return state


def test_checkpoint_resume_equals_unbroken_run(variables, tmp_path):
    """2 epochs, checkpoint, a fresh state restored from it (Adam moments
    and step included) and 2 more epochs == 4 unbroken epochs: equal
    parameters, optimizer state and per-step metrics, bit for bit."""
    from tdnet_torch.train.checkpoint import Checkpointer

    whole = _fit(variables, 4, metrics=str(tmp_path / "whole.jsonl"))
    ckpt = Checkpointer(str(tmp_path / "ckpt"), max_to_keep=1)
    _fit(variables, 2, checkpointer=ckpt, metrics=str(tmp_path / "part.jsonl"))
    assert ckpt.latest_step() == 2 and ckpt.steps() == [2] and ckpt.has_opt_state()
    resumed = _fit(variables, 4, initial_epoch=2, checkpointer=ckpt, skip=2,
                   restore=True, metrics=str(tmp_path / "part.jsonl"))
    assert resumed.step == whole.step == 4 and ckpt.latest_step() == 4

    def steps(path):
        recs = [json.loads(line) for line in open(path)]
        return [{k: r[k] for k in ("step", "loss", "grad_norm", "num_positive")}
                for r in recs if "step" in r]

    assert steps(tmp_path / "part.jsonl") == steps(tmp_path / "whole.jsonl")
    for (n, a), (_, b) in zip(whole.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), n
    sw, sr = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sw["param_groups"] == sr["param_groups"]
    for i, st in sw["state"].items():
        for k in st:
            assert torch.equal(st[k], sr["state"][i][k]), (i, k)

    from tdnet_torch.models.retinanet import RetinaNet

    weights = ckpt.restore_weights(RetinaNet(1))
    for (n, a), (_, b) in zip(weights.state_dict().items(),
                              whole.model.state_dict().items()):
        assert torch.equal(a, b), n
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(whole)


def test_fit_profiles_and_stops_at_the_rss_budget(variables, tmp_path):
    """profile_dir traces the second epoch with torch.profiler; a host RSS
    above rss_budget_mb stops the run after the epoch's checkpoint."""
    from tdnet_torch.train.checkpoint import Checkpointer
    from tdnet_torch.train.loop import RssBudgetExceeded

    state = _fit(variables, 2, profile_dir=str(tmp_path / "prof"))
    assert state.step == 2 and (tmp_path / "prof" / "trace.json").stat().st_size > 0
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    with pytest.raises(RssBudgetExceeded) as info:
        _fit(variables, 3, checkpointer=ckpt, rss_budget_mb=1.0)
    assert info.value.epoch == 0 and info.value.state.step == 1
    assert ckpt.latest_step() == 1


# ---------------------------------------------------------------- on a GPU


@pytest.mark.cuda
def test_cuda_prefetcher_delivers_the_bytes():
    """Pinned, non-blocking side-stream copies: the consumer's stream waits
    for them, so a kernel launched right away reads the batch's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.RandomState(0)
    batches = [{"images": rng.randint(0, 256, (4, 256, 384, 3)).astype(np.uint8),
                "gt_boxes": rng.normal(size=(4, 64, 4)).astype(np.float32)}
               for _ in range(6)]
    pf = DevicePrefetcher(iter(batches), device="cuda", buffer_size=3)
    sums = []
    for got in pf:
        assert got["images"].is_cuda and got["images"].shape == (4, 256, 384 * 3)
        sums.append((got["images"].to(torch.int64).sum(),  # reads on the device
                     got["gt_boxes"].double().sum(), got["images"].cpu().numpy()))
    for (isum, bsum, img), want in zip(sums, batches):
        assert int(isum) == int(want["images"].astype(np.int64).sum())
        np.testing.assert_allclose(float(bsum), want["gt_boxes"].astype(np.float64).sum(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(img, want["images"].reshape(4, 256, -1))
    assert len(sums) == 6

"""ZeRO-1 (``tdnet_torch/parallel/zero.py``, train ``--zero``) on two CPU
ranks over gloo, a MobileNet RetinaNet: two data-parallel steps with the
Adam state partitioned over the ranks are bit-equal to plain data
parallelism's, as the reference holds its own form (``tests/parallel/test_zero.py``); each rank holds about
half of the state; a snapshot (``train/checkpoint.py``: the state gathered
on rank 0, which alone writes) resumes bit-equal to the unbroken run. The
reference's sharding rule, kept as documentation, is held to
``tdnet/parallel/zero.py``'s.

The ranks are spawned once for the module (this file run as a script) and
write ``rank<r>.json``."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import RANKS, _digest, spawn_ranks

H, W = 64, 96
LR, CLIPNORM = 1e-4, 1e-3
# a small RetinaNet (MobileNet at a quarter width, 32-channel pyramid and
# heads): what is held here does not depend on the widths, and the ranks'
# collectives move every parameter and moment on each step; its step takes
# the sharded normalize
BACKBONE, FEATURES = "mobilenet128_0.25", 32


def _local_batch(rank):
    """One packed uint8 page a rank, one GT box each."""
    raw = np.random.RandomState(20 + rank).randint(0, 256, (1, H, W * 3)).astype(np.uint8)
    return {
        "images": torch.from_numpy(raw),
        "gt_boxes": torch.tensor([[[10.0, 8.0, 50.0 + 10 * rank, 40.0]]]),
        "gt_labels": torch.zeros((1, 1), dtype=torch.int32),
        "gt_mask": torch.ones((1, 1), dtype=torch.bool),
        "image_hw": torch.tensor([[H, W]], dtype=torch.float32),
    }


def _rank_main(rank, port, work):
    torch.set_num_threads(1)
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.parallel.mesh import initialize_distributed
    from tdnet_torch.parallel.zero import zero_optimizer
    from tdnet_torch.train.checkpoint import Checkpointer
    from tdnet_torch.train.step import create_optimizer, create_train_state, make_train_step
    from tdnet_torch.weights import random_variables

    initialize_distributed(f"127.0.0.1:{port}", RANKS, rank, device="cpu")
    variables = random_variables(1, BACKBONE, seed=0, feature_size=FEATURES)
    batch = _local_batch(rank)
    snaps = os.path.join(work, "snaps")

    def run(optimizer, steps, snapshot_at=None, resume=False):
        model = RetinaNet(1, BACKBONE, feature_size=FEATURES)
        state = create_train_state(model, variables, device="cpu",
                                   optimizer=optimizer(LR, CLIPNORM))
        if resume:
            state = Checkpointer(snaps).restore(state)
        step = make_train_step(model, num_classes=1, preprocess_mode="tf")
        losses = []
        while state.step < steps:
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if state.step == snapshot_at:
                Checkpointer(snaps).save(state.step, state)
        return state, losses

    out = {}
    state, losses = run(create_optimizer, 2)
    out["plain"] = {"digest": _digest(state.model.parameters()), "losses": losses}
    state, losses = run(zero_optimizer, 2, snapshot_at=1)
    local = state.optimizer.optim.state.values()
    out["zero"] = {
        "digest": _digest(state.model.parameters()), "losses": losses,
        "state_numel": sum(t.numel() for s in local for k, t in s.items() if k != "step"),
        "param_numel": sum(p.numel() for p in state.model.parameters() if p.requires_grad),
        "snapshots": sorted(os.listdir(snaps)) if rank == 0 else None}
    state, losses = run(zero_optimizer, 2, resume=True)
    out["resumed"] = {"digest": _digest(state.model.parameters()), "losses": losses,
                      "step": state.step}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import shutil

    work = tmp_path_factory.mktemp("zero")
    results, _ = spawn_ranks(os.path.abspath(__file__), work)()
    shutil.rmtree(work / "snaps", ignore_errors=True)  # the weights with their moments
    return results


def _check_zero_step_is_plain_data_parallel_bit_for_bit(ranks):
    """Two steps: the parameters after each run bit-equal on both ranks and
    between the runs, the global losses equal."""
    digests = {got[run]["digest"] for got in ranks for run in ("plain", "zero")}
    assert len(digests) == 1
    for got in ranks:
        assert got["zero"]["losses"] == got["plain"]["losses"] == ranks[0]["plain"]["losses"]


def _check_each_rank_holds_about_half_of_the_adam_state(ranks):
    """Each rank's moments (two a parameter it owns) cover 40-60% of the
    parameters' two moments, and together all of them once."""
    whole = 2 * ranks[0]["zero"]["param_numel"]
    parts = [got["zero"]["state_numel"] for got in ranks]
    assert sum(parts) == whole
    for part in parts:
        assert 0.4 * whole <= part <= 0.6 * whole


def _check_zero_snapshot_resumes_bit_equal(ranks):
    """The step-1 snapshot (one directory, written once by rank 0) restored
    on both ranks, each keeping its partition: step 2 gives the unbroken
    run's parameters and loss."""
    assert ranks[0]["zero"]["snapshots"] == ["1"]
    for got in ranks:
        assert got["resumed"]["step"] == 2
        assert got["resumed"]["digest"] == got["zero"]["digest"]
        assert got["resumed"]["losses"] == got["zero"]["losses"][1:]


def test_zero_on_two_cpu_ranks(ranks):
    """Every check on the module's ranks. One test: under pytest-xdist's
    load distribution a module-scoped fixture runs once per worker that
    takes one of the module's tests."""
    for check in (_check_zero_step_is_plain_data_parallel_bit_for_bit,
                  _check_each_rank_holds_about_half_of_the_adam_state,
                  _check_zero_snapshot_resumes_bit_equal):
        check(ranks)


def test_moment_rule_is_the_reference_s():
    """moment_partition_spec (documentation of what the reference shards)
    against tdnet.parallel.zero's on every ResNet-50 RetinaNet parameter
    shape, for data axes of 1, 2 and 8."""
    from jax.sharding import PartitionSpec as P
    from jax.tree_util import DictKey

    from tdnet.parallel.zero import MIN_SHARDED_SIZE as REF_MIN
    from tdnet.parallel.zero import moment_partition_spec as ref_rule
    from tdnet_torch.parallel.zero import MIN_SHARDED_SIZE, moment_partition_spec
    from tdnet_torch.weights import random_variables

    assert MIN_SHARDED_SIZE == REF_MIN
    leaves = []

    def walk(tree):
        for v in tree.values():
            walk(v) if isinstance(v, dict) else leaves.append(np.asarray(v))

    walk(random_variables(1, "resnet50", seed=0)["params"])
    path = (DictKey("opt_state"), DictKey("mu"))
    for n in (1, 2, 8):
        got = [moment_partition_spec(leaf.shape, n) for leaf in leaves]
        assert got == [ref_rule(path, leaf, n) != P() for leaf in leaves]
        assert any(got) == (n > 1)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])

"""Data parallelism on two CPU ranks over gloo (``tdnet_torch/parallel/
mesh.py``, the data-parallel train step, the sharded kernels' forms and the
sharded evaluation), held against tdnet's 2-device mesh on the same inputs.

The two ranks are spawned once for the module (this file run as a script,
one process a rank); each writes its results to ``rank<r>.json`` and rank 0
its gradients and parameters to ``step.pt``. The JAX side runs in the test
process while the ranks work: ``tdnet.train.step.make_train_step(mesh=...)``
on a 2-device CPU mesh (``tests/conftest.py`` makes 8), a MobileNet
RetinaNet, f32, 64x128, a global batch of 4 packed uint8 pages whose two
halves hold different numbers of positive anchors, the sharded normalize in
interpret mode; and the sharded ``fused_stem_train`` (``shard_map``,
parameter gradients ``psum``'d). The ranks' ResNet-50 step on the fused-stem
route is held against the port's own one-process step on the whole global
batch, run in a third process beside the ranks."""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

H, W = 64, 128
GLOBAL = 4
RANKS = 2
LR, CLIPNORM = 1e-4, 1e-3
# a small RetinaNet for the step held against the reference (MobileNet at a
# quarter width, 32-channel pyramid and heads): what is held does not
# depend on the widths. Its step takes the sharded normalize; ResNet-50
# runs only the fused-stem route's step
BACKBONE, MODE, FEATURES = "mobilenet128_0.25", "tf", 32
STEM_SHAPE = (GLOBAL, 16, 32 * 3)  # the stem gradient case (H % 8, W % 4)
EVAL_IMAGES = 5                     # 3 + 2 over the ranks
LOADER_IMAGES = 9                   # uneven over a global batch of 2 x 2


# ----------------------------------------------------------------- inputs


def _global_batch():
    """Packed uint8 pages; GT: one box on each of the first two pages, three
    and two on the others (three slots, the rest masked), so rank 1's half
    holds more positive anchors than rank 0's."""
    raw = np.random.RandomState(1).randint(0, 256, (GLOBAL, H, W * 3)).astype(np.uint8)
    boxes = np.zeros((GLOBAL, 3, 4), np.float32)
    mask = np.zeros((GLOBAL, 3), bool)
    rng = np.random.RandomState(2)
    for i, n in enumerate((1, 1, 3, 2)):
        xy = rng.uniform(0, 60, (n, 2))
        boxes[i, :n] = np.concatenate([xy, xy + rng.uniform(20, 60, (n, 2))], 1)
        mask[i, :n] = True
    return {
        "images": raw,
        "gt_boxes": boxes,
        "gt_labels": np.zeros((GLOBAL, 3), np.int32),
        "gt_mask": mask,
        "image_hw": np.tile(np.array([H, W], np.float32), (GLOBAL, 1)),
    }


def _stem_inputs():
    rng = np.random.RandomState(3)
    packed = rng.randint(0, 256, STEM_SHAPE).astype(np.uint8)
    k7 = rng.normal(0, 0.05, (7, 7, 3, 64)).astype(np.float32)
    inv = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    off = rng.normal(0, 0.5, 64).astype(np.float32)
    b, h, w3 = STEM_SHAPE
    cot = rng.normal(0, 1, (b, h // 4, w3 // 12, 64)).astype(np.float32)
    return packed, k7, inv, off, cot


def _gather_rows(rank):
    """Ragged rows for the all-gather: float64 (3 and 6 rows), int64 (none
    and 2 rows)."""
    f = np.random.RandomState(10 + rank).normal(size=((rank + 1) * 3, 3)) * 1e10
    i = np.arange(rank * 4, dtype=np.int64).reshape(-1, 2) - 2 ** 40
    return f, i


class Pages:
    """Constant float pages of two aspect ratios (two buckets at sides
    64/96), with boxes in two classes; a page is filled with its index."""

    def __init__(self, n):
        rng = np.random.RandomState(4)
        self.shapes = [(64, 96) if i % 3 else (96, 64) for i in range(n)]
        self.boxes, self.labels = [], []
        for i in range(n):
            k = 1 + i % 3
            xy = rng.uniform(0, 30, (k, 2))
            self.boxes.append(np.concatenate([xy, xy + rng.uniform(10, 30, (k, 2))], 1))
            self.labels.append(np.arange(k) % 2)

    def size(self):
        return len(self.shapes)

    def num_classes(self):
        return 2

    def has_label(self, label):
        return True

    def label_to_name(self, label):
        return f"c{label}"

    def image_aspect_ratio(self, i):
        h, w = self.shapes[i]
        return w / h

    def load_image(self, i):
        return np.full(self.shapes[i] + (3,), float(i), np.float32)

    def load_annotations(self, i):
        return {"bboxes": self.boxes[i].copy(), "labels": self.labels[i].copy()}


class ScriptedPredictor:
    """Detections that depend on the page alone (its fill value): its GT
    boxes moved by a few pixels, some with the other class, and two strays,
    through ``predict_batch`` in chunks of 2 as the Predictor is called."""

    batch_size = 2

    def __init__(self, pages):
        self.pages = pages

    def __call__(self, image):
        i = int(image[0, 0, 0])
        rng = np.random.RandomState(100 + i)
        gt = self.pages.load_annotations(i)
        stray = rng.uniform(0, 40, (2, 2))
        boxes = np.concatenate([gt["bboxes"] + rng.normal(0, 3, gt["bboxes"].shape),
                                np.concatenate([stray, stray + 15], 1)])
        labels = np.concatenate([gt["labels"], [0, 1]])
        labels[rng.uniform(size=labels.size) < 0.2] ^= 1
        return boxes, rng.uniform(0, 1, labels.size).astype(np.float32), labels

    def predict_batch(self, images):
        return [self(im) for im in images]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------------------ ranks


def _fused_step(batch):
    """One ResNet-50 step on the fused-stem route; -> its metrics and the
    digest of its parameters."""
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.step import create_optimizer, create_train_state, make_train_step
    from tdnet_torch.weights import random_variables

    model = RetinaNet(1)
    state = create_train_state(model, random_variables(1, "resnet50", seed=0), device="cpu",
                               optimizer=create_optimizer(LR, CLIPNORM))
    state, metrics = make_train_step(model, num_classes=1, fused_stem=True)(state, batch)
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "digest": _digest(p for p in model.parameters() if p.requires_grad)}


def _solo_main(work):
    """The fused-stem step of one process without a group, on the whole
    global batch."""
    torch.set_num_threads(2)
    got = _fused_step({k: torch.from_numpy(v) for k, v in _global_batch().items()})
    with open(os.path.join(work, "solo.json"), "w") as fh:
        json.dump(got, fh)


def _rank_main(rank, port, work):
    torch.set_num_threads(1)
    from torch.nn.parallel import DistributedDataParallel

    from tdnet_torch.data.generator import BatchLoader, LoaderConfig
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.ops.ingest import normalize_uint8_packed_sharded
    from tdnet_torch.ops.losses import focal, smooth_l1
    from tdnet_torch.ops.stem_vjp import fused_stem_train
    from tdnet_torch.ops.anchors import anchors_for_shape
    from tdnet_torch.ops.targets import batched_anchor_targets
    from tdnet_torch.parallel.mesh import initialize_distributed, process_allgather_rows
    from tdnet_torch.train.step import ClippedAdam, create_train_state, make_train_step
    from tdnet_torch.utils.coco_eval import evaluate_coco
    from tdnet_torch.utils.eval import evaluate
    from tdnet_torch.weights import random_variables

    initialize_distributed(f"127.0.0.1:{port}", RANKS, rank, device="cpu")
    initialize_distributed(f"127.0.0.1:{port}", RANKS, rank, device="cpu")  # again: a no-op
    out = {}
    f, i = _gather_rows(rank)
    out["gather"] = {"f64": process_allgather_rows(f).tolist(),
                     "i64": process_allgather_rows(i).tolist()}

    # the loader's shards of an uneven dataset: two epochs (the second
    # through the batches it yields)
    loader = BatchLoader(Pages(LOADER_IMAGES), LoaderConfig(batch_size=2, min_side=64,
                                                            max_side=96, seed=5))
    out["loader"] = {"process": [loader.process_index, loader.process_count],
                     "epoch1": [[list(b), c] for b, c in loader.local_batches()],
                     "epoch2": [b["indices"].tolist() for b in loader.epoch()]}

    pages = Pages(EVAL_IMAGES)
    predictor = ScriptedPredictor(pages)
    out["voc"] = {str(k): v for k, v in evaluate(pages, predictor, shard=True).items()}
    out["coco"] = evaluate_coco(pages, predictor, shard=True)

    # the sharded fused stem's parameter gradients under DDP
    packed, k7, inv, off, cot = _stem_inputs()
    rows = slice(rank * GLOBAL // RANKS, (rank + 1) * GLOBAL // RANKS)

    class Stem(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.k7, self.inv, self.off = (torch.nn.Parameter(torch.from_numpy(a.copy()))
                                           for a in (k7, inv, off))

        def forward(self, x):
            return fused_stem_train(x, self.k7, self.inv, self.off, "caffe",
                                    torch.float32, backward="kernel", global_batch=GLOBAL)

    stem = Stem()
    ddp = DistributedDataParallel(stem)  # held: its reducer all-reduces in backward
    y = ddp(torch.from_numpy(packed[rows].copy()))
    ((y * torch.from_numpy(cot[rows])).sum() * RANKS).backward()
    out["stem_grads"] = {k: getattr(stem, k).grad.numpy().tolist() for k in ("k7", "inv", "off")}
    local = torch.from_numpy(packed[rows].copy())
    out["shard_errors"] = []
    for call in (lambda: fused_stem_train(local, stem.k7, stem.inv, stem.off, global_batch=5),
                 lambda: normalize_uint8_packed_sharded(local, global_batch=6)):
        try:
            call()
        except ValueError as e:
            out["shard_errors"].append(str(e))

    # the data-parallel train step on this rank's half of the global batch
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
             for k, v in _global_batch().items()}
    variables = random_variables(1, BACKBONE, seed=0, feature_size=FEATURES)

    class GrabAdam(ClippedAdam):
        def step(self, closure=None, **kw):
            self.raw = [p.grad.clone() for g in self.param_groups for p in g["params"]]
            return super().step(closure, **kw)

    model = RetinaNet(1, BACKBONE, feature_size=FEATURES)
    state = create_train_state(model, variables, device="cpu",
                               optimizer=lambda p: GrabAdam(p, lr=LR, clipnorm=CLIPNORM))
    # the normaliser fault: this half's loss over its own positives
    with torch.no_grad():
        o = model(normalize_uint8_packed_sharded(batch["images"], MODE))
        anchors = torch.tensor(anchors_for_shape((H, W)), dtype=torch.float32)
        labels, reg = batched_anchor_targets(
            anchors, batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"],
            batch["image_hw"], 1)
        out["local_loss"] = float(focal()(labels, o["classification"])
                                  + smooth_l1()(reg, o["regression"]))
        out["local_positive"] = int((labels[..., -1] == 1).sum())
    state, metrics = make_train_step(model, num_classes=1, preprocess_mode=MODE)(state, batch)
    params = [p for p in model.parameters() if p.requires_grad]
    out["step"] = {"metrics": {k: v.item() for k, v in metrics.items()},
                   "digest": _digest(params)}
    if rank == 0:
        torch.save({"names": [n for n, p in model.named_parameters() if p.requires_grad],
                    "grads": state.optimizer.raw, "params": [p.detach() for p in params]},
                   os.path.join(work, "step.pt"))

    # freeze_backbone: the backbone's gradients are reduced, not applied
    model = RetinaNet(1, BACKBONE, feature_size=FEATURES)
    state = create_train_state(model, variables, device="cpu", freeze_backbone=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, _ = make_train_step(model, num_classes=1, preprocess_mode=MODE)(state, batch)
    out["frozen"] = {
        "backbone_still": all(torch.equal(p, before[n]) for n, p in model.named_parameters()
                              if n.startswith("backbone.")),
        "heads_moved": any(not torch.equal(p, before[n]) for n, p in model.named_parameters()
                           if not n.startswith("backbone.")),
        "digest": _digest(model.parameters())}

    # ResNet-50 on the fused-stem route (the sharded stem's plain versions)
    out["fused"] = _fused_step(batch)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(script, work, extra=(), timeout=600, ranks=RANKS):
    """Run ``script rank port work`` as ``ranks`` processes, and ``script
    role port work`` for each role of ``extra`` beside them; -> the ranks'
    JSON results and outputs. Raises with a process's output when it
    fails."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, script, str(r), port, str(work)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (*range(ranks), *extra)]

    def wait():
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
        for p, text in zip(procs, outs):
            assert p.returncode == 0, f"process {p.args[2]} failed:\n{text[-4000:]}"
        return ([json.loads((work / f"rank{r}.json").read_text()) for r in range(ranks)],
                outs[:ranks])

    return wait


# ------------------------------------------------------------------ fixture


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, and the references: the 2-device mesh step and
    the sharded stem's gradients (computed while the ranks run), and the
    port's one-process fused-stem step on the global batch (a process of
    its own beside the ranks)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
    from tdnet.ops.stem_vjp import fused_stem_train as ref_stem
    from tdnet.parallel.mesh import batch_sharding, create_mesh, replicated_sharding
    from tdnet.train.step import TrainState
    from tdnet.train.step import create_optimizer as ref_opt
    from tdnet.train.step import make_train_step as ref_step
    from tdnet_torch.weights import random_variables

    work = tmp_path_factory.mktemp("ranks")
    wait = spawn_ranks(os.path.abspath(__file__), work, extra=("solo",))
    try:
        mesh = create_mesh(jax.devices()[:RANKS])
        variables = random_variables(1, BACKBONE, seed=0, feature_size=FEATURES)
        grab = optax.GradientTransformation(
            lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
            lambda u, s, p=None: (u, {"g": u}))
        tx = optax.chain(grab, ref_opt(LR, CLIPNORM))
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                           opt_state=tx.init(params), tx=tx)
        state = jax.device_put(state, replicated_sharding(mesh))
        batch = jax.device_put(_global_batch(), batch_sharding(mesh))
        model = FlaxRetinaNet(num_classes=1, backbone_name=BACKBONE,
                              feature_size=FEATURES, dtype=jnp.float32)
        new, metrics = ref_step(model, num_classes=1, preprocess_mode=MODE,
                                mesh=mesh)(state, batch)
        to_np = lambda t: jax.tree.map(np.asarray, t)
        ref = {"metrics": {k: np.asarray(v) for k, v in metrics.items()},
               "grads": to_np(new.opt_state[0]["g"]), "params": to_np(new.params),
               "variables": variables}
        del new, state

        packed, k7, inv, off, cot = _stem_inputs()
        sharded = NamedSharding(mesh, P("data"))
        _, vjp = jax.vjp(lambda k, i, o: ref_stem(
            jax.device_put(packed, sharded), k, i, o, normalize="caffe",
            out_dtype=jnp.float32, backward="remat", mesh=mesh), k7, inv, off)
        ref["stem_grads"] = dict(zip(("k7", "inv", "off"),
                                     (np.asarray(g) for g in vjp(jax.device_put(cot, sharded)))))
    finally:
        ranks, logs = wait()
    ref["fused"] = json.loads((work / "solo.json").read_text())
    step = torch.load(work / "step.pt", weights_only=True)
    yield ranks, logs, step, ref
    jax.clear_caches()


# ------------------------------------------------------------------- tests


def _check_ranks_choose_gloo_on_the_cpu(runs):
    _, logs, _, _ = runs
    for r, text in enumerate(logs):
        assert f"distributed: rank {r} of {RANKS}, backend gloo, CPU" in text
        assert text.count("distributed: rank") == 1  # the second call was a no-op


def _check_allgather_rows_is_ragged_and_bit_exact(runs):
    """process_allgather_rows: 3 + 6 float64 rows (values near 1e10, kept to
    the bit), 0 + 2 int64 rows below -2**40; the same on both ranks, in
    rank order."""
    ranks, _, _, _ = runs
    want_f = np.concatenate([_gather_rows(r)[0] for r in range(RANKS)])
    want_i = np.concatenate([_gather_rows(r)[1] for r in range(RANKS)])
    for got in ranks:
        f = np.asarray(got["gather"]["f64"], np.float64)
        assert f.shape == (9, 3) and np.array_equal(f.view(np.uint64), want_f.view(np.uint64))
        assert np.array_equal(np.asarray(got["gather"]["i64"], np.int64), want_i)


def _check_loader_shards_equal_the_reference(runs):
    """Each rank resolved its slice from the process group; over two epochs
    of 9 pages in two buckets at a global batch of 2 x 2, its batches are
    the reference's per-process index lists (the global sequence padded,
    then strided)."""
    from tdnet.data.generator import BatchLoader as RefLoader
    from tdnet.data.generator import LoaderConfig as RefConfig

    ranks, _, _, _ = runs
    seen = []
    for r, got in enumerate(ranks):
        assert got["loader"]["process"] == [r, RANKS]
        ref = RefLoader(Pages(LOADER_IMAGES), RefConfig(batch_size=2, min_side=64, max_side=96,
                                                        seed=5, process_index=r,
                                                        process_count=RANKS))
        assert got["loader"]["epoch1"] == [[list(b), c] for b, c in ref.local_batches()]
        assert got["loader"]["epoch2"] == [c for _, c in ref.local_batches()]
        seen += [i for c in got["loader"]["epoch2"] for i in c]
    assert sorted(set(seen)) == list(range(LOADER_IMAGES)) and len(seen) == 12


def _check_sharded_evaluation_equals_one_process(runs):
    """evaluate and evaluate_coco with shard=True on two ranks (3 + 2
    pages): the same on both ranks and bit-equal to one process, the
    port's and the reference's."""
    from tdnet.utils.coco_eval import evaluate_coco as ref_coco
    from tdnet.utils.eval import evaluate as ref_voc
    from tdnet_torch.utils.coco_eval import evaluate_coco
    from tdnet_torch.utils.eval import evaluate

    ranks, _, _, _ = runs
    pages = Pages(EVAL_IMAGES)
    predictor = ScriptedPredictor(pages)
    voc = {str(k): list(v) for k, v in evaluate(pages, predictor).items()}
    assert voc == {str(k): list(v) for k, v in ref_voc(pages, predictor).items()}
    coco = evaluate_coco(pages, predictor)
    assert coco == ref_coco(pages, predictor)
    assert 0 < voc["0"][0] < 1 and voc["1"][1] > 0
    for got in ranks:
        assert got["voc"] == voc
        assert got["coco"] == coco


def _check_sharded_stem_gradients_are_the_psum(runs):
    """fused_stem_train(global_batch=4) on each rank's 2 rows under DDP,
    its loss scaled by the rank count: the filter and BN-fold gradients
    are the reference's shard_map form's psum over the 2-device mesh (rtol
    1e-4: sums in another order), not half or twice it. A batch that does
    not divide over the ranks, or a shard of the wrong size, raises."""
    ranks, _, _, ref = runs
    for got in ranks:
        for k, want in ref["stem_grads"].items():
            g = np.asarray(got["stem_grads"][k], np.float32)
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                       err_msg=k)
        assert "batch 5 does not divide over the data axis (2 ranks)" in got["shard_errors"][0]
        assert "holds 2 rows of a batch of 6" in got["shard_errors"][1]
    assert ranks[0]["stem_grads"] == ranks[1]["stem_grads"]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _check_data_parallel_step_equals_the_reference(runs):
    """The 2-rank packed-uint8 step (the sharded normalize) against the
    reference's 2-device mesh step at the tolerances of
    tests/test_torch_train.py's single-process step: loss, its parts and
    grad_norm rtol 1e-4, num_positive exact (global, on both ranks); each
    gradient tensor (DDP's average of the scaled losses' gradients) within
    3e-2 relative Frobenius floored at 1e-3 of the largest, the whole
    within 5e-3; after the clipped Adam step every element moved at most
    lr, and at most 5% of them differ by more than 1e-3 lr + 1e-7. The
    halves hold different positive counts, and each rank's own normaliser
    would give another loss (the fault the global count repairs). The
    ranks' parameters are bit-equal."""
    from tdnet_torch.weights import variables_from_torch_state

    ranks, _, step, ref = runs
    jm = ref["metrics"]
    for got in ranks:
        tm = got["step"]["metrics"]
        assert int(tm["num_positive"]) == int(jm["num_positive"]) > 0
        for k in ("loss", "classification_loss", "regression_loss", "grad_norm"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    assert ranks[0]["step"] == ranks[1]["step"]
    local = [got["local_positive"] for got in ranks]
    assert local[0] != local[1] and sum(local) == int(jm["num_positive"])
    naive = np.mean([got["local_loss"] for got in ranks])
    assert abs(naive - float(jm["loss"])) > 10 * 1e-4 * float(jm["loss"])  # 10x the rtol

    tg = dict(_leaves(variables_from_torch_state(dict(zip(step["names"], step["grads"])))["params"]))
    tp = dict(_leaves(variables_from_torch_state(dict(zip(step["names"], step["params"])))["params"]))
    jp = dict(_leaves(ref["params"]))
    before = dict(_leaves(ref["variables"]["params"]))
    biggest = max(np.linalg.norm(g) for _, g in _leaves(ref["grads"]))
    err2 = ref2 = 0.0
    n_params = n_apart = 0
    for path, g in _leaves(ref["grads"]):
        if path not in tg:  # frozen BN scale/bias: no gradient in the port
            assert path[-1] in ("scale", "bias") and not np.any(g), path
            continue
        d = (tg[path] - g).astype(np.float64)
        norm = np.linalg.norm(g.astype(np.float64))
        assert np.linalg.norm(d) <= 3e-2 * max(norm, 1e-3 * biggest), path
        err2 += float((d ** 2).sum())
        ref2 += norm ** 2
        moved_t, moved_j = tp[path] - before[path], jp[path] - before[path]
        assert max(np.abs(moved_t).max(), np.abs(moved_j).max()) <= LR * (1 + 1e-3) + 1e-7
        n_apart += int((np.abs(moved_t - moved_j) > 1e-3 * LR + 1e-7).sum())
        n_params += g.size
    assert np.sqrt(err2 / ref2) <= 5e-3
    assert n_apart <= 0.05 * n_params
    assert n_params == sum(p.numel() for p in step["params"])  # every trainable tensor


def _check_fused_stem_and_frozen_backbone_steps(runs):
    """The 2-rank ResNet-50 step on the fused-stem route (its plain versions
    here, the sharded stem) against the port's one-process step on the
    whole global batch: num_positive exact, loss and grad_norm within rtol
    1e-4, the ranks bit-equal. With freeze_backbone the backbone's
    gradients are still all-reduced (no rank waits for another) and the
    backbone does not move while the heads do, equal on both ranks."""
    ranks, _, _, ref = runs
    want = ref["fused"]["metrics"]
    assert int(want["num_positive"]) == int(ref["metrics"]["num_positive"])
    for got in ranks:
        tm = got["fused"]["metrics"]
        assert int(tm["num_positive"]) == int(want["num_positive"])
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[k], want[k], rtol=1e-4, err_msg=k)
        assert got["frozen"]["backbone_still"] and got["frozen"]["heads_moved"]
    assert ranks[0]["fused"] == ranks[1]["fused"]
    assert ranks[0]["frozen"] == ranks[1]["frozen"]


def test_two_cpu_ranks_against_the_reference(runs):
    """Every check of the module on one set of ranks. One test: under
    pytest-xdist's load distribution a module-scoped fixture runs once per
    worker that takes one of the module's tests."""
    for check in (_check_ranks_choose_gloo_on_the_cpu,
                  _check_allgather_rows_is_ragged_and_bit_exact,
                  _check_loader_shards_equal_the_reference,
                  _check_sharded_evaluation_equals_one_process,
                  _check_sharded_stem_gradients_are_the_psum,
                  _check_data_parallel_step_equals_the_reference,
                  _check_fused_stem_and_frozen_backbone_steps):
        check(runs)


if __name__ == "__main__":
    if sys.argv[1] == "solo":
        _solo_main(sys.argv[3])
    else:
        _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])

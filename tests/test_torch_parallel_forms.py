"""Spatial and tensor parallelism (``tdnet_torch/parallel/spatial.py``,
``parallel/tensor.py``, train ``--spatial`` and ``--tensor-parallel``) on
four CPU ranks over gloo, held against tdnet's SINGLE-DEVICE functions
(the reference's own tests prove its mesh forms equal to those).

The four ranks are spawned once for the module (this file run as a
script); each writes ``rank<r>.json``, and rank 0 its tensors to
``rank0.pt``. They run, in order:

- a 1 x 4 spatial grid: the ResNet-50 RetinaNet forward at 64x64, P7 one
  row over four bands (three empty), and its detections;
- a 2 x 2 (data x spatial) step of the small MobileNet RetinaNet on packed
  uint8 pages (the normalize kernel's route on each band) and a 2 x 2
  (data x model) step of the same (the kernel's route on the whole pages,
  kernels sharded), from one global batch of 4 pages whose halves hold
  different numbers of positive anchors;
- ``train --spatial 2 --device-normalize`` and ``train --tensor-parallel
  2`` for one step at 64x96 (a 2 x 2 grid of the four ranks).

The test process meanwhile runs tdnet's single-device forward, detections
and step, and the port's plain train CLI on the whole global batch."""

import io
import json
import os
import sys
from contextlib import contextmanager, redirect_stdout

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import spawn_ranks

RANKS = 4
LR, CLIPNORM = 1e-4, 1e-3
FWD_HW = (64, 64)
STEP_HW, GLOBAL = (64, 128), 4
BACKBONE, MODE, FEATURES = "mobilenet128_0.25", "tf", 32
CLI_BACKBONE = "mobilenet_0.5"  # a registered name: the CLI takes the registry's
CLI_HW = (64, 96)


def _fwd_images():
    return np.random.RandomState(1).uniform(-120, 130, (1, *FWD_HW, 3)).astype(np.float32)


def _global_batch():
    """Packed uint8 pages; GT: 1, 1, 3 and 2 boxes a page (three slots)."""
    h, w = STEP_HW
    raw = np.random.RandomState(1).randint(0, 256, (GLOBAL, h, w * 3)).astype(np.uint8)
    boxes = np.zeros((GLOBAL, 3, 4), np.float32)
    mask = np.zeros((GLOBAL, 3), bool)
    rng = np.random.RandomState(2)
    for i, n in enumerate((1, 1, 3, 2)):
        xy = rng.uniform(0, 60, (n, 2))
        boxes[i, :n] = np.concatenate([xy, xy + rng.uniform(20, 60, (n, 2))], 1)
        mask[i, :n] = True
    return {"images": raw, "gt_boxes": boxes, "gt_labels": np.zeros((GLOBAL, 3), np.int32),
            "gt_mask": mask, "image_hw": np.tile(np.array([h, w], np.float32), (GLOBAL, 1))}


def _write_pages(root):
    """Four 64x96 PNG pages with two tables each, their CSVs and an initial
    .tdn of the CLI's backbone."""
    from tdnet_torch.data.image import write_image_bgr
    from tdnet_torch.models.io import save_model
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.weights import random_variables

    rng = np.random.RandomState(0)
    rows = []
    for i in range(4):
        page = np.clip(rng.normal(235, 8, (*CLI_HW, 3)), 0, 255).astype(np.uint8)
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


def _cli_argv(work, name, batch, *extra):
    return ["--device", "cpu", "--device-normalize", "--backbone", CLI_BACKBONE,
            "--image-min-side", str(CLI_HW[0]), "--image-max-side", str(CLI_HW[1]),
            "--batch-size", str(batch), "--steps", "1", "--epochs", "1", "--log-every", "1",
            "--lr", str(LR), "--no-snapshots", "--weights", str(work / "init.tdn"),
            "--metrics-path", str(work / f"{name}.jsonl"),
            "--model-path", str(work / f"{name}.tdn"), *extra,
            "csv", str(work / "ann.csv"), str(work / "classes.csv")]


# ------------------------------------------------------------------ ranks


@contextmanager
def _normalized_rows(out: list):
    """Record the (rows, W3) shape of every call the train step makes to
    the normalize kernel's wrapper (on the CPU it runs the plain version:
    the call is the route)."""
    import tdnet_torch.train.step as step_mod

    real = step_mod.normalize_uint8_rows

    def counted(mat, *args, **kwargs):
        out.append(list(mat.shape))
        return real(mat, *args, **kwargs)

    step_mod.normalize_uint8_rows = counted
    try:
        yield out
    finally:
        step_mod.normalize_uint8_rows = real


def _step(grid, rank, out, tensors, name):
    """One grid step of the MobileNet RetinaNet on this rank's data row of
    the global batch; records metrics, the rows the normalize kernel's
    route took and (tensor) the moments' shapes and the whole-tensor clip;
    rank 0 keeps the whole updated state dict and the raw gradients."""
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.parallel.tensor import full_state_dict, shard_state
    from tdnet_torch.parallel.tensor import _gather_rows0
    from tdnet_torch.train.step import ClippedAdam, create_train_state, make_train_step
    from tdnet_torch.weights import random_variables

    class GrabAdam(ClippedAdam):
        def step(self, closure=None, **kw):
            self.raw = [p.grad.clone() for g in self.param_groups for p in g["params"]]
            return super().step(closure, **kw)

    per_row = GLOBAL // grid.data_count
    rows = slice(grid.data_index * per_row, (grid.data_index + 1) * per_row)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
             for k, v in _global_batch().items()}
    model = RetinaNet(1, BACKBONE, feature_size=FEATURES)
    state = create_train_state(model, random_variables(1, BACKBONE, seed=0,
                                                       feature_size=FEATURES),
                               device="cpu",
                               optimizer=lambda p: GrabAdam(p, lr=LR, clipnorm=CLIPNORM))
    if grid.axis == "model":
        shard_state(state, grid)
    with _normalized_rows([]) as normalized:
        state, metrics = make_train_step(model, 1, preprocess_mode=MODE, grid=grid)(
            state, batch)
    rec = {"metrics": {k: v.item() for k, v in metrics.items()}, "normalized": normalized}
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = [p for p in model.parameters() if p.requires_grad]
    raw = dict(zip(names, state.optimizer.raw))
    if state.sharding is not None:
        sharding = state.sharding
        rec["moments"] = {n: [list(state.optimizer.state[p]["exp_avg"].shape),
                              list(state.optimizer.state[p]["exp_avg_sq"].shape),
                              sharding.full_rows[n]]
                          for n, p in zip(names, params) if n in sharding.full_rows}
        # the clip of each sharded kernel against its whole gradient's norm
        worst = 0.0
        for n, p in zip(names, params):
            if n not in sharding.full_rows:
                continue
            whole_raw = _gather_rows0(raw[n], grid)
            whole_clipped = _gather_rows0(p.grad, grid)
            factor = min(1.0, CLIPNORM / max(float(whole_raw.norm()), 1e-12))
            worst = max(worst, float((whole_clipped - whole_raw * factor).abs().max()
                                     / max(float(whole_raw.abs().max()), 1e-30)))
        # ClippedAdam on a kernel cut in two whose whole gradient (ones) has
        # norm sqrt 8: clipped to 1 by the whole norm, each element to
        # 1 / sqrt 8 (its slice alone, of norm 2, would give 1 / 2)
        g = torch.ones((4, 2))
        p = torch.nn.Parameter(torch.zeros(2, 2))
        p.grad = g[grid.index * 2:(grid.index + 1) * 2].clone()
        opt = ClippedAdam([p], lr=LR, clipnorm=1.0)
        opt.shard_norms({id(p)}, grid.group)
        opt.step()
        rec["clip"] = {"worst": worst,
                       "synthetic": float((p.grad - 8 ** -0.5).abs().max())}
        raw = {n: (_gather_rows0(g, grid) if n in sharding.full_rows else g)
               for n, g in raw.items()}
        whole = full_state_dict(model, sharding)
    else:
        whole = model.state_dict()
    out[name] = rec
    if rank == 0:
        tensors[name] = {"state": {k: v.clone() for k, v in whole.items()}, "raw": raw}


def _rank_main(rank, port, work):
    from pathlib import Path

    torch.set_num_threads(1)
    from tdnet_torch.bin import train
    from tdnet_torch.models.detect import detections_from_outputs
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.parallel.mesh import initialize_distributed
    from tdnet_torch.parallel.spatial import (band_rows, create_spatial_mesh, image_band,
                                              spatial_bands)
    from tdnet_torch.parallel.tensor import create_tensor_mesh
    from tdnet_torch.weights import random_variables, torch_state_from_variables

    work = Path(work)
    spec = f"127.0.0.1:{port},{RANKS},{rank}"
    initialize_distributed(f"127.0.0.1:{port}", RANKS, rank, device="cpu")
    out, tensors = {}, {}

    # the spatial forward over four bands
    grid = create_spatial_mesh(4)
    model = RetinaNet(2)
    model.load_state_dict(torch_state_from_variables(random_variables(2, "resnet50", seed=0)))
    model.to(memory_format=torch.channels_last).eval()
    x = torch.from_numpy(_fwd_images())
    with torch.no_grad(), spatial_bands(grid, FWD_HW) as bands:
        outputs = model(image_band(x, grid))
    heights = dict(bands._heights)
    out["forward"] = {"grid": [grid.data_count, grid.size, grid.index],
                      "p7_rows": band_rows(heights[1], 4, grid.index), "p7_height": heights[1],
                      "band": list(image_band(x, grid).shape)}
    det = detections_from_outputs(outputs, FWD_HW)
    if rank == 0:
        tensors["forward"] = {k: v.clone() for k, v in outputs.items()}
        tensors["detections"] = {k: getattr(det, k).clone()
                                 for k in ("boxes", "scores", "labels")}

    # the 2 x 2 steps
    _step(create_spatial_mesh(2), rank, out, tensors, "spatial")
    _step(create_tensor_mesh(2), rank, out, tensors, "tensor")

    # the CLI: a 2 x 2 grid of the four ranks, batch 1 a data row
    for name, flags in (("cli_spatial", ["--spatial", "2"]),
                        ("cli_tensor", ["--tensor-parallel", "2"])):
        with redirect_stdout(io.StringIO()), _normalized_rows([]) as normalized:
            rc = train.main(_cli_argv(work, f"{name}", 1, *flags, "--distributed", spec))
        assert rc == 0, (name, rc)
        out[f"{name}_normalized"] = normalized
    if rank == 0:
        torch.save(tensors, work / "rank0.pt")
    with open(work / f"rank{rank}.json", "w") as fh:
        json.dump(out, fh)


# ------------------------------------------------------------------ fixture


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, and the references computed while they run:
    tdnet's single-device ResNet-50 forward and detections, its
    single-device step of the MobileNet RetinaNet (raw gradients kept), and
    the port's plain train CLI on the global batch of 2."""
    import jax
    import jax.numpy as jnp
    import optax

    from tdnet.models.detect import detections_from_outputs as ref_detections
    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
    from tdnet.train.step import TrainState
    from tdnet.train.step import create_optimizer as ref_opt
    from tdnet.train.step import make_train_step as ref_step
    from tdnet_torch.bin import train
    from tdnet_torch.weights import random_variables

    work = tmp_path_factory.mktemp("forms")
    _write_pages(work)
    wait = spawn_ranks(os.path.abspath(__file__), work, ranks=RANKS)
    try:
        ref = {}
        dev = jax.devices()[0]
        fv = random_variables(2, "resnet50", seed=0)
        fmodel = FlaxRetinaNet(num_classes=2, dtype=jnp.float32)
        fout = jax.jit(fmodel.apply)(jax.device_put(fv, dev),
                                     jax.device_put(_fwd_images(), dev))
        ref["forward"] = {k: np.asarray(v) for k, v in fout.items()}
        # jitted, as tdnet's Predictor runs it (one compile, not an op at a time)
        d = jax.jit(lambda o: ref_detections(o, FWD_HW, use_pallas=False))(fout)
        ref["detections"] = {k: np.asarray(getattr(d, k)) for k in ("boxes", "scores", "labels")}

        variables = random_variables(1, BACKBONE, seed=0, feature_size=FEATURES)
        grab = optax.GradientTransformation(
            lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
            lambda u, s, p=None: (u, {"g": u}))
        tx = optax.chain(grab, ref_opt(LR, CLIPNORM))
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                           opt_state=tx.init(params), tx=tx)
        smodel = FlaxRetinaNet(num_classes=1, backbone_name=BACKBONE, feature_size=FEATURES,
                               dtype=jnp.float32)
        new, metrics = ref_step(smodel, num_classes=1, preprocess_mode=MODE, fused_stem=False)(
            jax.device_put(state, dev), jax.device_put(_global_batch(), dev))
        ref["step"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                       "grads": jax.tree.map(np.asarray, new.opt_state[0]["g"]),
                       "params": jax.tree.map(np.asarray, new.params),
                       "variables": variables}
        del new, state
        said = io.StringIO()
        with redirect_stdout(said):
            assert train.main(_cli_argv(work, "cli_plain", 2)) == 0
    finally:
        ranks, logs = wait()
    tensors = torch.load(work / "rank0.pt", weights_only=True)
    yield ranks, logs, tensors, ref, work
    jax.clear_caches()


# ------------------------------------------------------------------- checks


def _check_spatial_forward_and_detections(runs):
    """The 1 x 4 spatial forward of the ResNet-50 RetinaNet at 64x64 (16
    image rows a band; P7 one row, on band 0, bands 1-3 empty) equals
    tdnet's single-device forward within the port's f32 forward tolerance
    (1e-4 of the largest output), and the detections from it equal the
    reference's: scores within 1e-5, labels equal, boxes within 1e-3."""
    ranks, _, tensors, ref, _ = runs
    for r, got in enumerate(ranks):
        f = got["forward"]
        assert f["grid"] == [1, 4, r] and f["band"] == [1, 16, 64, 3]
        assert f["p7_height"] == 1
        assert f["p7_rows"] == ([0, 1] if r == 0 else [1, 1])
    for k, want in ref["forward"].items():
        got = tensors["forward"][k].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)
    det, want = tensors["detections"], ref["detections"]
    np.testing.assert_allclose(det["scores"].numpy(), want["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(det["labels"].numpy(), want["labels"])
    np.testing.assert_allclose(det["boxes"].numpy(), want["boxes"], rtol=1e-5, atol=1e-3)
    assert (want["scores"] > 0).any()


def _check_steps_equal_the_single_device_step(runs):
    """The 2 x 2 spatial and tensor steps against tdnet's single-device step
    on the global batch, at tests/test_torch_parallel.py's tolerances:
    num_positive exact (global, each page counted once), loss, parts and
    grad_norm rtol 1e-4; each raw gradient (the grid's sum) within 3e-2
    relative Frobenius floored at 1e-3 of the largest, the whole within
    5e-3; after the clipped Adam step every weight moved by at most lr and
    at most 5% apart by more than 1e-3 lr + 1e-7. Every rank reports the
    same metrics. Both steps took the normalize kernel's route: the
    spatial ranks on their band of 32 of the 64 rows of their data row's
    2 pages, the tensor ranks on the whole pages."""
    from tdnet_torch.weights import variables_from_torch_state

    ranks, _, tensors, ref, _ = runs
    jm = ref["step"]["metrics"]
    w3 = STEP_HW[1] * 3
    for name, rows in (("spatial", 2 * STEP_HW[0] // 2), ("tensor", 2 * STEP_HW[0])):
        for got in ranks:
            tm = got[name]["metrics"]
            assert int(tm["num_positive"]) == int(jm["num_positive"]) > 0
            for k in ("loss", "classification_loss", "regression_loss", "grad_norm"):
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=f"{name} {k}")
            assert tm == ranks[0][name]["metrics"]
            assert got[name]["normalized"] == [[rows, w3]], name
        tg = dict(_leaves(variables_from_torch_state(tensors[name]["raw"])["params"]))
        tp = dict(_leaves(variables_from_torch_state(tensors[name]["state"])["params"]))
        before = dict(_leaves(ref["step"]["variables"]["params"]))
        biggest = max(np.linalg.norm(g) for _, g in _leaves(ref["step"]["grads"]))
        err2 = ref2 = 0.0
        n_params = n_apart = 0
        for path, g in _leaves(ref["step"]["grads"]):
            if path not in tg:  # frozen BN scale/bias: no gradient in the port
                assert path[-1] in ("scale", "bias") and not np.any(g), path
                continue
            d = (tg[path] - g).astype(np.float64)
            norm = np.linalg.norm(g.astype(np.float64))
            assert np.linalg.norm(d) <= 3e-2 * max(norm, 1e-3 * biggest), (name, path)
            err2 += float((d ** 2).sum())
            ref2 += norm ** 2
            moved_t = tp[path] - before[path]
            moved_j = ref["step"]["params"]
            for key in path:
                moved_j = moved_j[key]
            moved_j = moved_j - before[path]
            assert max(np.abs(moved_t).max(), np.abs(moved_j).max()) <= LR * (1 + 1e-3) + 1e-7
            n_apart += int((np.abs(moved_t - moved_j) > 1e-3 * LR + 1e-7).sum())
            n_params += g.size
        assert np.sqrt(err2 / ref2) <= 5e-3, name
        assert n_apart <= 0.05 * n_params, (name, n_apart, n_params)


def _check_tensor_shards_moments_and_clips_whole(runs):
    """Each rank's Adam moments of a sharded kernel are 1/2 of its rows; the
    clip of every sharded kernel is the whole tensor's (the gathered clipped
    gradient is the gathered raw one times min(1, c / ||whole||) to 1e-6);
    and ClippedAdam at clipnorm 1 scales a kernel cut in two whose whole
    gradient (ones, 4 x 2) has norm sqrt 8 to 1 / sqrt 8 an element (its
    slice's own norm, 2, would give 1 / 2)."""
    ranks, _, _, _, _ = runs
    for got in ranks:
        moments = got["tensor"]["moments"]
        assert moments
        for n, (mu, nu, full) in moments.items():
            assert mu == nu and mu[0] * 2 == full, n
        assert got["tensor"]["clip"]["worst"] <= 1e-6
        assert got["tensor"]["clip"]["synthetic"] <= 1e-7
    assert ranks[0]["tensor"]["moments"] == ranks[3]["tensor"]["moments"]


def _check_cli_bundles_equal_the_plain_run(runs):
    """``train --spatial 2 --device-normalize`` and ``train --tensor-parallel
    2`` on the 2 x 2 grid (batch 1 a data row) against the plain run at
    batch 2: num_positive equal, loss within rtol 1e-4, and every weight of
    the .tdn within 1e-3 lr + 1e-7 of the plain run's for at least 95% of
    them, each moved by at most lr. Every rank's step took the normalize
    kernel's route: the spatial ranks on their band (32 of the 64 rows),
    the tensor ranks on the whole page."""
    from tdnet_torch.models.io import load_model

    ranks, _, _, _, work = runs
    rec = {n: json.loads((work / f"{n}.jsonl").read_text().splitlines()[0])
           for n in ("cli_plain", "cli_spatial", "cli_tensor")}
    plain = dict(_leaves(load_model(str(work / "cli_plain.tdn"))[1]["params"]))
    init = dict(_leaves(load_model(str(work / "init.tdn"))[1]["params"]))
    for name in ("cli_spatial", "cli_tensor"):
        assert rec[name]["num_positive"] == rec["cli_plain"]["num_positive"] > 0
        np.testing.assert_allclose(rec[name]["loss"], rec["cli_plain"]["loss"], rtol=1e-4)
        got = dict(_leaves(load_model(str(work / f"{name}.tdn"))[1]["params"]))
        n = n_apart = 0
        for path, w in plain.items():
            assert np.abs(got[path] - init[path]).max() <= LR * (1 + 1e-3) + 1e-7
            n_apart += int((np.abs(got[path] - w) > 1e-3 * LR + 1e-7).sum())
            n += w.size
        assert n_apart <= 0.05 * n, (name, n_apart, n)
    w3 = CLI_HW[1] * 3
    for got in ranks:
        assert got["cli_spatial_normalized"] == [[CLI_HW[0] // 2, w3]]
        assert got["cli_tensor_normalized"] == [[CLI_HW[0], w3]]


def test_four_cpu_ranks_against_the_single_device_reference(runs):
    """Every check of the ranks on one set of four. One test: under
    pytest-xdist's load distribution a module-scoped fixture runs once per
    worker that takes one of the module's tests."""
    for check in (_check_spatial_forward_and_detections,
                  _check_steps_equal_the_single_device_step,
                  _check_tensor_shards_moments_and_clips_whole,
                  _check_cli_bundles_equal_the_plain_run):
        check(runs)


# ------------------------------------------------ checks without the ranks


@pytest.mark.parametrize("backbone", ["resnet50", "seresnet50", "mobilenet_0.5"])
def test_partition_rule_equals_the_reference_leaf_by_leaf(backbone):
    """parallel/tensor.py param_partition_spec on the port's state dict
    shards exactly the leaves tdnet.parallel.tensor.param_partition_spec
    shards on the reference's tree (SE gates' dense kernels and MobileNet's
    depthwise kernels included), at M = 2 and 4."""
    import jax
    from jax.sharding import PartitionSpec as P

    import jax.numpy as jnp

    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
    from tdnet.parallel.tensor import param_partition_spec as ref_spec
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.parallel.tensor import param_partition_spec, state_shardings

    with torch.device("meta"):
        model = RetinaNet(2, backbone)
    # the reference's own tree, shapes only
    flax_params = jax.eval_shape(lambda: FlaxRetinaNet(num_classes=2, backbone_name=backbone).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))["params"]
    for m in (2, 4):
        want = {}
        jax.tree_util.tree_map_with_path(
            lambda path, leaf: want.__setitem__(
                tuple(k.key for k in path), ref_spec(path, leaf, m) != P()), flax_params)
        got = {}
        for name, spec in state_shardings(model, m).items():
            *module, leaf = name.split(".")
            got[tuple(module) + ("kernel" if leaf == "weight" else leaf,)] = bool(spec)
        assert got == want
        assert sum(want.values()) > 0
    assert param_partition_spec("fpn.P3.weight", (256, 256, 3, 3), 4) == ("model", None, None,
                                                                           None)
    assert param_partition_spec("fpn.P3.bias", (256,), 4) == ()
    assert param_partition_spec("classification_submodel.head.weight", (18, 256, 3, 3), 2) == ()


@pytest.mark.parametrize("h,size", [(7, 8), (1, 4), (25, 2), (64, 4), (13, 4)])
def test_band_rows_is_the_ceil_split(h, size):
    """band_rows: ceil(h / size) rows a band in order, the last bands short
    or empty, covering [0, h) once (JAX's split of uneven shards)."""
    from tdnet_torch.parallel.spatial import band_rows

    c = -(-h // size)
    bands = [band_rows(h, size, i) for i in range(size)]
    assert [hi - lo for lo, hi in bands][:h // c] == [c] * (h // c)
    assert sum(hi - lo for lo, hi in bands) == h
    assert all(b[0] == a[1] for a, b in zip(bands, bands[1:]))


def test_normalize_grid_forms_refuse_as_the_reference(monkeypatch):
    """normalize_uint8_packed_sharded on a (data, spatial) grid whose H does
    not divide, or on a (data, model) grid, raises the reference's
    messages."""
    import jax
    import jax.numpy as jnp

    from tdnet.ops.pallas_ingest import normalize_uint8_packed_sharded as ref_norm
    from tdnet.parallel.spatial import create_spatial_mesh as ref_spatial
    from tdnet.parallel.tensor import create_tensor_mesh as ref_tensor
    from tdnet_torch.ops.ingest import normalize_uint8_packed_sharded
    from tdnet_torch.parallel.mesh import Grid

    packed = np.zeros((2, 6, 12), np.uint8)
    for ref_mesh, grid in ((ref_spatial(4, jax.devices()[:8]), Grid("spatial", 4, 0, 0, 2)),
                           (ref_tensor(4, jax.devices()[:8]), Grid("model", 4, 0, 0, 2))):
        with pytest.raises(ValueError) as want:
            ref_norm(jnp.asarray(packed), mesh=ref_mesh)
        with pytest.raises(ValueError) as got:
            normalize_uint8_packed_sharded(torch.from_numpy(packed[:1]), grid=grid)
        assert str(got.value) == str(want.value)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])

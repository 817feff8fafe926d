"""Training CLI, the counterpart of ``tdnet/bin/train.py``:

    python -m tdnet_torch.bin.train [options] csv annotations.csv classes.csv

The reference's flags and defaults: Adam lr 1e-5 with clipnorm 1e-3, batch
size 1, 10000 steps an epoch, 50 epochs, a checkpoint every epoch, optional
per-epoch mAP (``--evaluation`` with ``--val-annotations``; with
``--coco-evaluation`` the COCO summary's numeric keys in its place) and
ReduceLROnPlateau(loss, 0.1, patience 2). Runs on CUDA unless ``--device
cpu``; ``--backbone`` takes every name of ``models.backbone``. With
``--device-normalize`` a ResNet or SE-ResNet trains through the fused
ingest+stem kernels (forward and backward), and ``--no-fused-stem`` takes
the normalize kernel and cuDNN instead, as the other backbones do.

Initial weights: ``--weights`` takes a ``.tdn`` bundle, a keras ``.h5``
(a keras-retinanet snapshot or a keras-resnet ImageNet backbone, read by
the port's own HDF5 reader) or one of the port's checkpoint directories (a
reference orbax snapshot converts to a ``.tdn`` with the reference's
``convert_model``). Without it, ``--imagenet-weights`` looks for the
backbone's keras-resnet ImageNet file in local directories
(``train/weights.py`` ``IMAGENET_SEARCH_DIRS``; it never downloads), and
without either the model starts from
``tdnet_torch.weights.random_variables(seed=--seed)``, which does not
reproduce the reference's ``jax.random`` init: only runs from the same
weights file match the reference's. ``--bn-warmup N`` then re-estimates
the frozen BatchNorm statistics from the loader's first N batches.
``--snapshot`` resumes one of the port's checkpoint directories in full
(weights, Adam moments, step and learning rate; no warm-up) and replays
the loader's epochs, as the reference does.

``--random-transform`` draws the reference's affine augmentation for each
image (``data/transform.py``); ``--tensorboard-dir`` writes TensorBoard
scalars of every metrics record (``train/events.py``).

``--distributed coord:port,N,rank`` makes this process one of N ranks
(``parallel/mesh.py``: one process a card, ``nccl`` when each rank has its
own card, else ``gloo``): each rank loads its own rows of every global
batch of ``--batch-size`` x N, the step runs under
``DistributedDataParallel`` with the reference's global loss, the
per-epoch evaluation is sharded over the ranks, and rank 0 alone writes
snapshots, metrics, events, the bundle and the logs. ``--zero`` partitions
the Adam state over the ranks (``parallel/zero.py``), with the numbers of
plain data parallelism.

``--spatial S`` and ``--tensor-parallel M`` lay the ranks of
``--distributed`` out as a 2-D grid of S (or M) ranks a row
(``parallel/spatial.py``: each rank of a row computes a band of the image
rows; ``parallel/tensor.py``: each holds a slice of the conv and dense
output channels and of their Adam moments); the ranks of a row load the
same pages, ``--batch-size`` a row. ``--pipeline`` trains a 2-stage
pipeline (backbone | FPN + heads) over two cards of this one process
(``parallel/pipeline.py``; ``--device cpu``: both stages on the CPU), with
``--microbatches`` microbatches a step; its snapshots and bundle hold the
merged variables, and a ``--snapshot`` of it resumes the weights with a
fresh optimizer, in either kind of run. The combinations the reference
refuses are refused with its messages.
"""

from __future__ import annotations

import argparse
import math
from types import SimpleNamespace

import torch

from tdnet_torch.bin._common import (add_dataset_args, anchor_params_from_args, make_dataset,
                                    maybe_init_distributed)
from tdnet_torch.data.generator import BatchLoader, LoaderConfig
from tdnet_torch.data.prefetch import DevicePrefetcher
from tdnet_torch.device import resolve_device
from tdnet_torch.models import backbone as backbone_registry
from tdnet_torch.models.io import save_model
from tdnet_torch.ops.anchors import AnchorParameters
from tdnet_torch.parallel.mesh import barrier, is_distributed, process_count, process_index
from tdnet_torch.parallel.pipeline import PipelineTrainer
from tdnet_torch.parallel.spatial import create_spatial_mesh
from tdnet_torch.parallel.tensor import create_tensor_mesh, full_state_dict, shard_state
from tdnet_torch.parallel.zero import zero_optimizer
from tdnet_torch.train.checkpoint import Checkpointer
from tdnet_torch.train.loop import (RSS_BUDGET_EXIT_CODE, ReduceLROnPlateau,
                                    RssBudgetExceeded, fit)
from tdnet_torch.train.predictor import Predictor
from tdnet_torch.train.step import create_optimizer, create_train_state, make_train_step
from tdnet_torch.train.weights import (bn_warmup, imagenet_weights_or_explain,
                                       load_initial_weights)
from tdnet_torch.utils.coco_eval import evaluate_coco
from tdnet_torch.utils.eval import evaluate
from tdnet_torch.weights import random_variables, variables_from_torch_state

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a tdnet_torch RetinaNet.")
    add_dataset_args(parser)

    parser.add_argument("--backbone", default="resnet50", type=str)
    parser.add_argument("--batch-size", default=1, type=int)
    parser.add_argument("--lr", default=1e-5, type=float)
    parser.add_argument("--clipnorm", default=1e-3, type=float)
    parser.add_argument("--epochs", default=50, type=int)
    parser.add_argument("--steps", default=10000, type=int,
                        help="steps per epoch (reference default 10000); "
                             "0 = one full pass over the dataset per epoch")
    parser.add_argument("--reduce-lr-factor", default=0.1, type=float,
                        help="plateau LR multiplier")
    parser.add_argument("--reduce-lr-patience", default=2, type=int,
                        help="epochs without loss improvement before the LR drops")
    parser.add_argument("--snapshot-path", default="./snapshots", type=str)
    parser.add_argument("--snapshot", default=None, type=str,
                        help="resume from one of the port's checkpoint directories")
    parser.add_argument("--weights", default=None, type=str,
                        help="initialize weights from a .tdn bundle, a keras "
                             ".h5/.hdf5 or one of the port's checkpoint "
                             "directories (a reference orbax snapshot: convert "
                             "it to .tdn with the reference's convert_model)")
    parser.add_argument("--imagenet-weights", action="store_true",
                        help="without --weights: load the backbone's keras-resnet "
                             "ImageNet .h5 from ~/.keras/models, "
                             "$TDNET_PRETRAINED_DIR or ./pretrained (never "
                             "downloaded)")
    parser.add_argument("--bn-warmup", default=0, type=int, metavar="N",
                        help="re-estimate the frozen BatchNorm statistics from "
                             "N batches before training (not with --snapshot)")
    parser.add_argument("--model-path", default=None, type=str,
                        help="write a deployable .tdn at the end")
    parser.add_argument("--no-snapshots", dest="snapshots", action="store_false")
    parser.add_argument("--freeze-backbone", action="store_true")
    parser.add_argument("--random-transform", action="store_true",
                        help="random affine augmentation (the reference's ranges)")
    parser.add_argument("--config", default=None, type=str,
                        help="anchor parameters INI (reference-compatible)")
    parser.add_argument("--image-min-side", default=800, type=int)
    parser.add_argument("--image-max-side", default=1333, type=int)
    parser.add_argument("--max-boxes", default=None, type=int,
                        help="GT padding width (default: auto-sized from a "
                             "dataset scan to the densest image, floor 64)")
    parser.add_argument("--evaluation", dest="evaluation", action="store_true",
                        help="run mAP evaluation each epoch (needs --val-annotations)")
    parser.add_argument("--coco-evaluation", action="store_true",
                        help="per-epoch COCO 12-metric evaluation instead of "
                             "VOC mAP (needs --val-annotations)")
    parser.add_argument("--score-threshold", default=0.05, type=float)
    parser.add_argument("--seed", default=0, type=int,
                        help="loader shuffle and, without --weights, the random "
                             "init (which differs from the reference's)")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--device-normalize", action="store_true",
                        help="ship uint8 batches; normalization runs on the device")
    parser.add_argument("--no-fused-stem", dest="fused_stem",
                        action="store_false", default=None,
                        help="with --device-normalize, the normalize kernel and "
                             "cuDNN in place of the fused ingest+stem kernels "
                             "(default: fused on CUDA for ResNets and SE-ResNets)")
    parser.add_argument("--fused-stem", dest="fused_stem",
                        action="store_true", default=None,
                        help="force the fused ingest+stem route on (on the CPU: "
                             "its plain version)")
    parser.add_argument("--log-every", default=50, type=int)
    parser.add_argument("--metrics-path", default=None, type=str)
    parser.add_argument("--tensorboard-dir", default=None, type=str,
                        help="write TensorBoard scalars of every metrics record")
    parser.add_argument("--profile-dir", default=None, type=str,
                        help="capture a torch.profiler trace of the second epoch")
    parser.add_argument("--nan-check", action="store_true",
                        help="raise FloatingPointError on a non-finite loss or "
                             "gradient norm (one device sync a step)")
    parser.add_argument("--no-pallas", dest="use_pallas", action="store_false",
                        default=None, help="the plain route in the per-epoch "
                                           "eval: CPU only")
    parser.add_argument("--eval-batch-size", default=None, type=int,
                        help="per-epoch eval batch size (default: 16 on CUDA, "
                             "1 on the CPU)")
    parser.add_argument("--rss-budget-mb", default=None, type=float,
                        metavar="MB",
                        help="stop cleanly (exit code 75) after the first "
                             "epoch whose end finds host RSS above MB, with "
                             "the epoch snapshot saved; relaunch with "
                             "--snapshot. Requires snapshots.")
    parser.add_argument("--eval-every", default=1, type=int, metavar="N",
                        help="run the per-epoch evaluation every N epochs "
                             "(always on the final epoch)")
    parser.add_argument("--workers", default=1, type=int,
                        help="host decode/resize threads per batch (<=1: in "
                             "the prefetch thread)")
    parser.add_argument("--spatial", default=1, type=int, metavar="S",
                        help="spatial partitioning: shard the image H axis over S "
                             "ranks of a 2-D (data, spatial) grid of the "
                             "--distributed ranks (parallel/spatial.py); divides "
                             "per-card activation memory and single-image latency "
                             "by ~S; S must divide the ranks. 1 = plain data "
                             "parallelism")
    parser.add_argument("--tensor-parallel", default=1, type=int, metavar="M",
                        help="tensor (model) parallelism: shard conv and dense "
                             "output channels (and their Adam moments) over M "
                             "ranks of a 2-D (data, model) grid of the "
                             "--distributed ranks (parallel/tensor.py); divides "
                             "per-card weight+optimizer memory and conv FLOPs by "
                             "~M; M must divide the ranks. 1 = plain data "
                             "parallelism")
    parser.add_argument("--zero", action="store_true",
                        help="ZeRO-1: partition the Adam state over the ranks "
                             "(parallel/zero.py); parameters stay replicated, "
                             "numbers equal to plain data parallelism. Not "
                             "with --spatial/--tensor-parallel")
    parser.add_argument("--pipeline", action="store_true",
                        help="2-stage pipeline parallelism over two cards of this "
                             "process (backbone | FPN+heads): each stage's params "
                             "and Adam moments on their own card, 1F1B microbatch "
                             "schedule, rematerialised stage-0 backward "
                             "(parallel/pipeline.py). Snapshots store the MERGED "
                             "model variables; the optimizer restarts on "
                             "--snapshot resume. Not combinable with --spatial/"
                             "--tensor-parallel/--zero/--distributed/"
                             "--device-normalize/--fused-stem/--freeze-backbone/"
                             "--bn-warmup")
    parser.add_argument("--microbatches", default=None, type=int,
                        help="pipeline microbatches per optimizer step (default: "
                             "2 when the batch divides, else 1); semantics = "
                             "gradient accumulation at batch/microbatches images "
                             "a microbatch")
    parser.add_argument("--distributed", default=None, type=str,
                        metavar="COORD:PORT,NPROC,RANK",
                        help="one of NPROC ranks (e.g. 10.0.0.1:1234,4,0): each "
                             "loads its own rows of every global batch of "
                             "--batch-size x NPROC; one process a card")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.use_pallas is False and torch.device(args.device).type == "cuda":
        parser.error("--no-pallas asks for the plain route, which the port "
                     "runs only on the CPU (--device cpu)")
    return args


def _refuse_pipeline_combinations(args) -> None:
    """The reference's refusals of ``--pipeline`` (``_run_pipeline``), with
    its messages."""
    for flag, name in (
        (args.spatial > 1, "--spatial"),
        (args.tensor_parallel > 1, "--tensor-parallel"),
        (args.zero, "--zero"),
        (bool(args.distributed), "--distributed"),
        (args.device_normalize, "--device-normalize"),
        (bool(args.fused_stem), "--fused-stem"),
        (args.freeze_backbone, "--freeze-backbone"),
        (args.bn_warmup > 0, "--bn-warmup"),
    ):
        if flag:
            raise SystemExit(f"--pipeline cannot be combined with {name}")


def _pipeline_devices(args):
    """The stages' devices: cards 0 and 1 (the reference's two local
    devices; fewer raise its message), or the CPU twice."""
    if torch.device(args.device).type == "cpu":
        return torch.device("cpu"), torch.device("cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2 or process_count() > 1:
        raise SystemExit(
            f"--pipeline needs >= 2 local devices in one process "
            f"(have {n} across {process_count()} processes)")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _make_grid(args):
    """The 2-D grid of --spatial or --tensor-parallel (None for plain data
    parallelism), with the reference's refusals: the combinations first
    (the reference meets them once its mesh exists; here they need no
    ranks), then an axis that does not divide the ranks."""
    if args.spatial > 1 and args.tensor_parallel > 1:
        raise SystemExit(
            "--spatial and --tensor-parallel cannot be combined (pick the "
            "axis that addresses your bottleneck: activation memory/latency "
            "-> --spatial, weight+optimizer memory -> --tensor-parallel)")
    if args.zero and (args.spatial > 1 or args.tensor_parallel > 1):
        raise SystemExit(
            "--zero needs the plain 1-D data mesh (tensor parallelism "
            "already shards the moments; spatial shards activations)")
    for flag, n, make in (("--spatial", args.spatial, create_spatial_mesh),
                          ("--tensor-parallel", args.tensor_parallel, create_tensor_mesh)):
        if n > 1:
            try:
                return make(n)
            except ValueError as e:
                raise SystemExit(f"{flag}: {e}")
    return None


def _map_of(aps) -> dict:
    """'mAP' is the UNWEIGHTED class mean (the reference Evaluate callback's
    default); the annotation-weighted value is logged under its own key."""
    present = [(ap, n) for ap, n in aps.values() if n > 0]
    mAP = sum(ap for ap, _ in present) / len(present) if present else 0.0
    total = sum(n for _, n in present)
    weighted = sum(ap * n for ap, n in present) / total if total else 0.0
    return {"mAP": mAP, "weighted_mAP": weighted}


def _initial_variables(args, train_ds, n_anchors):
    """--weights / --imagenet-weights, else the seeded random init."""
    variables = random_variables(train_ds.num_classes(), args.backbone,
                                 seed=args.seed, num_anchors=n_anchors)
    weights_path = args.weights
    if weights_path is None and args.imagenet_weights:
        weights_path = imagenet_weights_or_explain(args.backbone)
    if weights_path:
        variables = load_initial_weights(weights_path, variables,
                                         backbone_name=args.backbone)
    return variables


def _bundle(args, model, variables, anchor_params, bb) -> None:
    save_model(
        args.model_path,
        model,
        variables,
        anchor_params=anchor_params,
        inference_config={
            "min_side": args.image_min_side,
            "max_side": args.image_max_side,
            "preprocess_mode": bb.preprocess_mode,
        },
    )
    print(f"saved deployable model to {args.model_path}")


class _PipelineState:
    """fit()'s view of a pipeline run: the two stage states, the step count,
    the first stage's device, and an optimizer whose ``param_groups`` are
    both stage optimizers' (the LR schedule sets both)."""

    def __init__(self, states, step: int):
        self.states, self.step = states, step
        self.device = states[0].device
        self.optimizer = SimpleNamespace(
            param_groups=[g for s in states for g in s.optimizer.param_groups])


class _MergedSnapshots:
    """fit()'s checkpointer for a pipeline run: the merged variables with an
    empty optimizer state."""

    def __init__(self, checkpointer: Checkpointer, trainer: PipelineTrainer):
        self.checkpointer, self.trainer = checkpointer, trainer

    def save(self, step: int, state: _PipelineState) -> None:
        self.checkpointer.save_variables(step, self.trainer.merged_state_dict(state.states))


def _run_pipeline(args, model, bb, anchor_params, train_ds, val_ds, loader, devices) -> int:
    """2-stage pipeline training (``--pipeline``, reference ``_run_pipeline``):
    each stage's params and Adam on its own device, the microbatched 1F1B
    schedule (``parallel/pipeline.py``), driven by fit(). Snapshots and
    --model-path hold the MERGED variables with an empty optimizer state, so
    evaluate, convert_model and a --snapshot resume of either kind of run
    read them; only the optimizer restarts on resume."""
    nmb = args.microbatches or (2 if args.batch_size % 2 == 0 else 1)
    if nmb < 1 or args.batch_size % nmb != 0:
        raise SystemExit(
            f"--microbatches {nmb} must divide --batch-size {args.batch_size}")
    trainer = PipelineTrainer(
        model, train_ds.num_classes(), devices, anchor_params=anchor_params,
        optimizer_factory=create_optimizer(args.lr, args.clipnorm))
    variables = _initial_variables(args, train_ds, model.num_anchors)
    step0 = initial_epoch = 0
    if args.snapshot:
        resume = Checkpointer(args.snapshot)
        variables = variables_from_torch_state(resume.weights())
        step0 = resume.latest_step() or 0
        initial_epoch = step0 // max(args.steps, 1)
        loader.skip_epochs(initial_epoch)
        print(f"resumed merged variables from step {step0} "
              f"(epoch {initial_epoch}; optimizer restarts)")
    state = _PipelineState(trainer.states_from_variables(variables), step0)

    evaluate_fn = None
    if (args.evaluation or args.coco_evaluation) and val_ds is not None:
        # the user's model object holds the merged weights for the Predictor
        predictor = Predictor(
            model, variables, anchor_params=anchor_params,
            min_side=args.image_min_side, max_side=args.image_max_side,
            preprocess_mode=bb.preprocess_mode,
            score_threshold=args.score_threshold,
            use_pallas=args.use_pallas, batch_size=args.eval_batch_size,
            device=devices[0])

        def evaluate_fn(state):
            predictor.model.load_state_dict(trainer.merged_state_dict(state.states))
            if args.coco_evaluation:
                return {k: float(v) for k, v in evaluate_coco(val_ds, predictor).items()}
            return _map_of(evaluate(val_ds, predictor))
    del variables

    def train_step(state, batch):
        state.states, metrics = trainer.step(state.states, batch, num_microbatches=nmb)
        state.step += 1
        return state, metrics

    print(f"pipeline training: 2 stages on {devices[0]} | {devices[1]}, "
          f"{nmb} microbatches of {args.batch_size // nmb}")
    snapshots = (_MergedSnapshots(Checkpointer(args.snapshot_path), trainer)
                 if args.snapshots else None)
    try:
        state = _fit(args, state, train_step, loader.forever(), snapshots, evaluate_fn,
                     initial_epoch)
    finally:
        loader.close()
    if state is None:
        return RSS_BUDGET_EXIT_CODE
    if args.model_path:
        _bundle(args, model, trainer.merged_variables(state.states), anchor_params, bb)
    return 0


def _nan_checked(train_step):
    """The step, then a check that loss and grad_norm (where the step
    reports it) are finite (a device sync)."""

    def step(state, batch):
        state, metrics = train_step(state, batch)
        for key in ("loss", "grad_norm"):
            if key in metrics and not math.isfinite(float(metrics[key])):
                raise FloatingPointError(
                    f"--nan-check: {key} is {float(metrics[key])} at step {state.step}")
        return state, metrics

    return step


def _fit(args, state, train_step, batches, checkpointer, evaluate_fn, initial_epoch):
    """fit() with the CLI's flags -> the final state, or None where the RSS
    budget stopped the run after its checkpoint. Closes ``batches``."""
    if args.nan_check:
        train_step = _nan_checked(train_step)
    try:
        return fit(
            state,
            train_step,
            batches,
            steps_per_epoch=args.steps,
            epochs=args.epochs,
            checkpointer=checkpointer,
            evaluate_fn=evaluate_fn,
            lr_schedule=ReduceLROnPlateau(
                factor=args.reduce_lr_factor,
                patience=args.reduce_lr_patience,
            ),
            metrics_path=args.metrics_path,
            tensorboard_dir=args.tensorboard_dir,
            log_every=args.log_every,
            initial_epoch=initial_epoch,
            profile_dir=args.profile_dir,
            eval_every=args.eval_every,
            rss_budget_mb=args.rss_budget_mb,
        )
    except RssBudgetExceeded as stop:
        print(f"tdnet: {stop}", flush=True)
        return None
    finally:
        batches.close()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.pipeline:
        _refuse_pipeline_combinations(args)
        devices = _pipeline_devices(args)
    if args.rss_budget_mb is not None and not args.snapshots:
        raise SystemExit("--rss-budget-mb needs snapshots (the budget stop "
                         "checkpoints and exits for a --snapshot relaunch); "
                         "drop --no-snapshots")
    device = resolve_device(args.device)
    maybe_init_distributed(args.distributed, device)
    grid = None if args.pipeline else _make_grid(args)
    tensor = grid is not None and grid.axis == "model"
    shard_eval = process_count() > 1

    train_ds = make_dataset(args, "train")
    val_ds = make_dataset(args, "val")
    anchor_params = anchor_params_from_args(args)

    bb = backbone_registry(args.backbone)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    n_anchors = (anchor_params or AnchorParameters.default).num_anchors
    model = bb.retinanet(train_ds.num_classes(), dtype=dtype, num_anchors=n_anchors)

    loader = BatchLoader(train_ds, LoaderConfig(
        batch_size=args.batch_size,
        min_side=args.image_min_side,
        max_side=args.image_max_side,
        max_boxes=args.max_boxes,
        preprocess_mode=bb.preprocess_mode,
        device_normalize=args.device_normalize,
        random_transform=args.random_transform,
        seed=args.seed,
        workers=args.workers,
        # under a grid the ranks of a row load the same pages: rows of the
        # global batch go by data index, not by rank
        process_index=grid.data_index if grid is not None else None,
        process_count=grid.data_count if grid is not None else None,
    ))
    if args.pipeline:
        if args.steps <= 0:
            args.steps = loader.steps_per_epoch()
            print(f"--steps 0: using one dataset pass = {args.steps} steps/epoch")
        return _run_pipeline(args, model, bb, anchor_params, train_ds, val_ds, loader,
                             devices)
    try:
        if args.steps <= 0:
            args.steps = loader.steps_per_epoch()
            print(f"--steps 0: using one dataset pass = {args.steps} steps/epoch")

        # initial weights (reference: create_models --weights /
        # --imagenet-weights; --snapshot below takes precedence over both)
        variables = _initial_variables(args, train_ds, n_anchors)
        resume = Checkpointer(args.snapshot) if args.snapshot else None
        weights_only = resume is not None and not resume.has_opt_state()
        if weights_only:
            # a --pipeline run's snapshot (merged variables, no optimizer
            # state): the weights, and the optimizer restarts
            variables = variables_from_torch_state(resume.weights())
        if args.bn_warmup > 0 and not args.snapshot:
            # drawn from the loader's own stream, as the reference's warm-up
            # is: it advances the shuffle and transform draws
            variables = bn_warmup(model, variables, loader.forever(),
                                  num_batches=args.bn_warmup,
                                  preprocess_mode=bb.preprocess_mode, device=device)
        # one process without a group: --zero has nothing to partition, as
        # the reference's one-device mesh keeps the plain state
        make_optimizer = zero_optimizer if args.zero and is_distributed() else create_optimizer
        state = create_train_state(model, variables,
                                   optimizer=make_optimizer(args.lr, args.clipnorm),
                                   freeze_backbone=args.freeze_backbone, device=device)
        if tensor:
            state = shard_state(state, grid)

        ckpt = Checkpointer(args.snapshot_path) if args.snapshots else None
        initial_epoch = 0
        if resume is not None:
            if weights_only:
                state.step = resume.latest_step() or 0
                print("snapshot has no optimizer state (saved by a --pipeline "
                      "run): restored weights only; optimizer restarts")
            else:
                state = resume.restore(state)
            initial_epoch = state.step // max(args.steps, 1)
            # replay the loader's shuffle to this epoch (as the reference does:
            # epochs, not steps, ROADMAP C5)
            loader.skip_epochs(initial_epoch)
            print(f"resumed from step {state.step} (epoch {initial_epoch})")

        train_step = make_train_step(
            model, train_ds.num_classes(), anchor_params=anchor_params,
            preprocess_mode=bb.preprocess_mode, fused_stem=args.fused_stem, grid=grid)

        evaluate_fn = None
        if (args.evaluation or args.coco_evaluation) and val_ds is not None:
            # with several ranks every rank predicts its strided slice of the
            # val set and the detections are all-gathered: the same metrics
            # on every rank, those of one process
            if shard_eval and process_index() == 0:
                print(f"per-epoch evaluation: sharded over {process_count()} processes")
            # one Predictor over the live training model (no copy of the
            # weights); under tensor parallelism over a whole copy, which
            # the evaluation fills from the gathered slices (reference
            # :588-594)
            eval_model = (bb.retinanet(train_ds.num_classes(), dtype=dtype,
                                       num_anchors=n_anchors) if tensor else model)
            predictor = Predictor(
                eval_model,
                variables if tensor else None,
                anchor_params=anchor_params,
                min_side=args.image_min_side,
                max_side=args.image_max_side,
                preprocess_mode=bb.preprocess_mode,
                score_threshold=args.score_threshold,
                use_pallas=args.use_pallas,
                batch_size=args.eval_batch_size,
                device=device,
            )
            if not tensor:
                # the Predictor put the model in eval mode with the heads'
                # dtype at its boundary; training keeps f32 outputs, as the
                # reference's model
                eval_output_dtype, model.output_dtype = model.output_dtype, torch.float32
                model.train()

            def evaluate_fn(state):
                if tensor:
                    eval_model.load_state_dict(full_state_dict(state.model, state.sharding))
                else:
                    model.eval()
                    model.output_dtype = eval_output_dtype
                try:
                    if args.coco_evaluation:
                        # the numeric keys: AP ... AR_large and AP_<name>
                        return {k: float(v) for k, v in evaluate_coco(
                            val_ds, predictor, shard=shard_eval).items()}
                    return _map_of(evaluate(val_ds, predictor, shard=shard_eval))
                finally:
                    if not tensor:
                        model.output_dtype = torch.float32
                        model.train()
        del variables

        state = _fit(args, state, train_step, DevicePrefetcher(loader.forever(), device),
                     ckpt, evaluate_fn, initial_epoch)
    finally:
        loader.close()
    if state is None:
        return RSS_BUDGET_EXIT_CODE

    if args.model_path:
        whole = (full_state_dict(state.model, state.sharding) if tensor
                 else model.state_dict())
        if process_index() == 0:
            _bundle(args, model, variables_from_torch_state(whole), anchor_params, bb)
    barrier()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

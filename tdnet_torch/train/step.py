"""Train and eval steps, the counterpart of ``tdnet/train/step.py``.

Training contract (the reference's compile settings): Adam at lr 1e-5 with
Keras ``clipnorm`` 1e-3, which clips EACH gradient tensor by its own L2 norm
(not the global norm); loss = smooth-L1 on the boxes + focal on the
classes, with anchor targets assigned on the device.

The state is the model (parameters and BN statistics), the optimizer
(Adam moments and step) and the step count. The step updates them in
place, where the reference returns a new state.

Image routes, as in the reference:

- packed (B, H, W*3) uint8 on a shape the fused stem supports, with the
  fused stem on -> ``fused_stem_train`` -> the model from its pooled output
  (``stem_input=True``); ``TDNET_STEM_BWD`` (default ``kernel``) picks its
  backward;
- other uint8 -> the normalize kernel -> the full model;
- float -> the full model.

Data parallelism (the reference's step over a batch-sharded mesh): when a
process group is initialised (``parallel/mesh.py``), each rank runs the
step on its own rows of the global batch, with the model under
``DistributedDataParallel`` (``broadcast_buffers=False``: the BatchNorm is
frozen and has no batch statistics to share) and the kernels' sharded
forms. The reference is one graph over the global batch: focal and
smooth-L1 divide by the positive anchors of the WHOLE global batch. So the
step all-reduces the positive count, each rank divides its sums by it and
scales its loss by the number of ranks, and DDP's average of the ranks'
gradients is the reference's gradient. The reported loss, its parts,
``num_positive`` and ``grad_norm`` are the global ones, equal on every
rank, and each tensor's clipping then sees the reference's gradient.

The 2-D forms (``grid``, ``parallel/mesh.py`` :class:`Grid`): the ranks of
one grid row hold the same pages, so the positive count and the loss
parts are summed over the DATA group (the world would count each page S
or M times), and there is no DDP: each rank backpropagates its own loss
(its pages over the global positive count) and the step sums the
gradients itself, over the group the reference reduces over:

- spatial (``parallel/spatial.py``): each rank's gradient is its band's
  partial sum, to be summed over the spatial group and the data axis: the
  world;
- tensor (``parallel/tensor.py``): a sharded kernel's slice already has its
  whole gradient, and a replicated tensor's is the same on each rank of the
  row, so the sum runs over the data group only. Clipping and
  ``grad_norm`` count each sharded tensor once, whole.

Under a grid the fused stem is off, as the reference's ``_pallas_ok`` has
it (its kernels split only the batch axis). The normalize kernel runs on
every grid: on each spatial rank's band of rows, whatever H (the kernel
walks any run of rows), and on the whole pages of a tensor rank. The
reference's ``_ingest_mesh_ok`` takes the plain normalize where H does not
divide over the spatial axis and under a model axis; that is a limit of
its ``shard_map``, not of the kernel.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from tdnet_torch.device import resolve_device
from tdnet_torch.models.retinanet import takes_fused_stem
from tdnet_torch.ops.anchors import AnchorParameters, anchors_for_shape
from tdnet_torch.ops.ingest import normalize_uint8_packed_sharded, normalize_uint8_rows
from tdnet_torch.ops.losses import focal, smooth_l1
from tdnet_torch.ops.stem import supports_shape
from tdnet_torch.ops.stem_vjp import fused_stem_train
from tdnet_torch.ops.targets import batched_anchor_targets
from tdnet_torch.parallel.mesh import Grid, is_distributed, process_count
from tdnet_torch.parallel.spatial import image_band, spatial_bands
from tdnet_torch.weights import torch_state_from_variables

__all__ = [
    "ClippedAdam",
    "TrainState",
    "clip_by_leaf_norm_",
    "leaf_norms",
    "create_optimizer",
    "create_train_state",
    "make_train_step",
    "make_eval_step",
]


@torch.no_grad()
def leaf_norms(grads, sharded=None, group=None):
    """Each tensor's L2 norm; where ``sharded[i]``, tensor i is this rank's
    slice of a tensor cut over ``group`` (``parallel/tensor.py``), and its
    norm is the whole tensor's (the slices' squares summed over the
    group)."""
    norms = [torch.linalg.vector_norm(g) for g in grads]
    idx = [i for i, s in enumerate(sharded or ()) if s]
    if idx:
        sq = torch.stack([norms[i].square() for i in idx])
        src = sq.cpu() if sq.is_cuda and dist.get_backend(group) != "nccl" else sq
        dist.all_reduce(src, group=group)
        for i, v in zip(idx, src.to(sq.device).sqrt()):
            norms[i] = v
    return norms


@torch.no_grad()
def clip_by_leaf_norm_(grads, max_norm: float, norms=None) -> None:
    """Keras ``clipnorm``, in place: scale each tensor g by
    min(1, max_norm / max(||g||, 1e-12)); ``norms`` (default each g's own)
    are the norms to clip by."""
    for g, norm in zip(grads, norms or [torch.linalg.vector_norm(g) for g in grads]):
        g.mul_(torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0))


class ClippedAdam(torch.optim.Adam):
    """Adam with per-tensor gradient clipping before each update. The update
    is optax's ``adam`` with its defaults (b1 0.9, b2 0.999, eps 1e-8 added
    outside the square root, bias-corrected moments):
    ``torch.optim.Adam`` computes the same ``lr * m_hat / (sqrt(v_hat) +
    eps)``."""

    def __init__(self, params, lr: float = 1e-5, clipnorm: float = 1e-3):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.clipnorm = clipnorm
        self._sharded, self._norm_group = frozenset(), None

    def shard_norms(self, sharded_ids, group) -> None:
        """Clip the parameters whose ``id`` is in ``sharded_ids`` (slices cut
        over ``group`` by ``parallel/tensor.py``) by their whole tensor's
        norm."""
        self._sharded, self._norm_group = frozenset(sharded_ids), group

    @torch.no_grad()
    def step(self, closure=None, norms: Optional[dict] = None):
        """Clip, then Adam. ``norms`` maps each parameter to its gradient's
        norm where the caller has them already (the train step's
        ``grad_norm`` reads the same ones), else they are computed here."""
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        if norms is None:
            clip_norms = leaf_norms(grads, [id(p) in self._sharded for p in params],
                                    self._norm_group)
        else:
            clip_norms = [norms[p] for p in params]
        clip_by_leaf_norm_(grads, self.clipnorm, clip_norms)
        return super().step(closure)


def create_optimizer(learning_rate: float = 1e-5,
                     clipnorm: float = 1e-3) -> Callable:
    """Adam(1e-5, clipnorm=0.001), the reference's settings, as a factory
    of the trainable parameters."""
    return functools.partial(ClippedAdam, lr=learning_rate, clipnorm=clipnorm)


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # parallel/tensor.py TensorSharding, set by shard_state
    sharding: Optional[object] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(model, variables: dict,
                       optimizer: Optional[Callable] = None,
                       freeze_backbone: bool = False,
                       device=None) -> TrainState:
    """Load ``variables`` (the flax ``{params, batch_stats}`` numpy tree,
    e.g. ``weights.random_variables``) into ``model``, move it to the device
    in ``channels_last``, and build the optimizer over the trainable
    parameters. ``freeze_backbone`` leaves the backbone out of the optimizer
    (it still gets gradients, which count in ``grad_norm`` as in the
    reference), so its parameters never move."""
    dev = resolve_device(device)
    model.load_state_dict(torch_state_from_variables(variables))
    model.to(device=dev, memory_format=torch.channels_last).train()
    params = [p for name, p in model.named_parameters() if p.requires_grad
              and not (freeze_backbone and name.startswith("backbone."))]
    optimizer = (optimizer or create_optimizer())(params)
    return TrainState(model=model, optimizer=optimizer)


def make_train_step(
    model,
    num_classes: int,
    anchor_params: Optional[AnchorParameters] = None,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
    smooth_l1_sigma: float = 3.0,
    preprocess_mode: str = "caffe",
    fused_stem: Optional[bool] = None,
    grid: Optional[Grid] = None,
) -> Callable:
    """train_step(state, batch) -> (state, metrics). ``batch`` holds device
    tensors: images, gt_boxes, gt_labels, gt_mask, image_hw (with a process
    group: this rank's rows). ``fused_stem`` None means on for CUDA with a
    ResNet or SE-ResNet backbone and caffe/tf mode, without a grid; other
    backbones take the normalize kernel. ``grid`` (a spatial or tensor
    :class:`Grid` of more than one rank a row) runs the step in that form;
    a tensor grid's state must have been cut by ``parallel/tensor.py``
    ``shard_state``. Metrics are device tensors: loss,
    classification_loss, regression_loss, num_positive, grad_norm (the
    global norm before clipping). Build it on every rank after the state:
    with a process group and no grid it wraps the model in DDP, which
    broadcasts rank 0's parameters."""
    focal_fn = focal(alpha=focal_alpha, gamma=focal_gamma, from_logits=True)
    l1_fn = smooth_l1(sigma=smooth_l1_sigma)
    anchors: Dict[tuple, torch.Tensor] = {}
    spatial = grid is not None and grid.axis == "spatial"
    if fused_stem is None:
        fused_stem = (next(model.parameters()).device.type == "cuda"
                      and takes_fused_stem(model.backbone_name)
                      and preprocess_mode in ("caffe", "tf") and grid is None)
    if grid is not None:
        # the reference's _pallas_ok: the fused stem's kernels split only the
        # batch axis, so no 2-D grid takes them
        fused_stem = False
    parallel = is_distributed() and grid is None
    world = process_count()
    # the data group: where the positive count and the loss parts are summed
    data_group = grid.data_group if grid is not None and grid.data_count > 1 else None
    # where the gradients are summed: the world for spatial bands, the data
    # group for tensor slices (None: no sum)
    grad_group = (dist.group.WORLD if spatial and world > 1 else data_group)
    net = model
    if parallel:
        dev = next(model.parameters()).device
        net = DistributedDataParallel(
            model, broadcast_buffers=False,
            device_ids=[dev] if dev.type == "cuda" else None)
        # DDP broadcast rank 0's parameters; the BN statistics too, once (a
        # --bn-warmup estimates them from each rank's own batches)
        for buf in model.buffers():
            dist.broadcast(buf, 0)

    def grid_normalize(images):
        """Packed uint8 under a grid -> this rank's input, normalized by the
        kernel: its band of rows (spatial) or the whole pages (tensor)."""
        rows = image_band(images, grid) if spatial else images
        b, h, w3 = rows.shape
        x = normalize_uint8_rows(rows.contiguous().reshape(-1, w3), preprocess_mode,
                                 model.dtype)
        return x.reshape(b, h, w3 // 3, 3)

    def forward(images):
        """images -> (model outputs, unpadded canvas (h, w))."""
        if images.dtype == torch.uint8 and images.dim() == 4:
            b, h, w, _ = images.shape
            images = images.reshape(b, h, w * 3)
        if grid is not None:
            hw = ((images.shape[1], images.shape[2] // 3) if images.dtype == torch.uint8
                  else tuple(images.shape[1:3]))
            if images.dtype == torch.uint8:
                x = grid_normalize(images)
            else:
                x = image_band(images, grid) if spatial else images
            if not spatial:
                return net(x), hw
            with spatial_bands(grid, hw):
                return net(x), hw
        if images.dtype != torch.uint8:
            return net(images), tuple(images.shape[1:3])
        b, h, w3 = images.shape
        # the reference's mesh forms of the kernels: this rank's shard of a
        # global batch of b x ranks rows (one rank: the whole batch)
        if fused_stem and supports_shape((b, h, w3 // 3, 3)):
            k7, inv, off = model.stem_params()
            act = fused_stem_train(
                images, k7, inv, off, normalize=preprocess_mode,
                out_dtype=model.dtype,
                backward=os.environ.get("TDNET_STEM_BWD", "kernel"),
                global_batch=b * world)
            return net(act, stem_input=True), (h, w3 // 3)
        x = normalize_uint8_packed_sharded(images, preprocess_mode, model.dtype,
                                           global_batch=b * world)
        return net(x), (h, w3 // 3)

    def train_step(state: TrainState, batch: dict):
        outputs, hw = forward(batch["images"])
        if hw not in anchors:
            anchors[hw] = torch.tensor(
                anchors_for_shape(hw, anchor_params=anchor_params),
                dtype=torch.float32, device=outputs["regression"].device)
        labels, regression = batched_anchor_targets(
            anchors[hw], batch["gt_boxes"], batch["gt_labels"],
            batch["gt_mask"], batch["image_hw"], num_classes)
        num_positive = (labels[..., -1] == 1.0).sum()
        if parallel:
            dist.all_reduce(num_positive)
        elif data_group is not None:
            num_positive = _summed(num_positive, data_group)
        cls_loss = focal_fn(labels, outputs["classification"].float(), num_positive)
        reg_loss = l1_fn(regression, outputs["regression"].float(), num_positive)
        total = cls_loss + reg_loss
        for p in state.model.parameters():
            p.grad = None
        # DDP averages the ranks' gradients: scaled, the average is the sum
        (total * world if parallel else total).backward()
        named = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
        if grad_group is not None:
            _sum_grads([p for _, p in named], grad_group)
        named = [(n, p) for n, p in named if p.grad is not None]
        cut = state.sharding.full_rows if state.sharding is not None else {}
        norms = leaf_norms([p.grad for _, p in named], [n in cut for n, _ in named],
                           grid.group if grid is not None else None)
        grad_norm = torch.linalg.vector_norm(torch.stack(norms))
        # the same norms clip (ZeRO passes them on to its shard's ClippedAdam)
        state.optimizer.step(norms=dict(zip((p for _, p in named), norms)))
        state.step += 1
        parts = torch.stack([cls_loss.detach(), reg_loss.detach()])
        if parallel:
            dist.all_reduce(parts)
        elif data_group is not None:
            parts = _summed(parts, data_group)
        metrics = {
            "loss": parts[0] + parts[1],
            "classification_loss": parts[0],
            "regression_loss": parts[1],
            "num_positive": num_positive,
            "grad_norm": grad_norm,
        }
        return state, metrics

    return train_step


def _host_side(t: torch.Tensor, group) -> torch.Tensor:
    return t.cpu() if t.is_cuda and dist.get_backend(group) != "nccl" else t


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (a new tensor on t's device)."""
    src = _host_side(t.clone(), group)
    dist.all_reduce(src, group=group)
    return src.to(t.device)


@torch.no_grad()
def _sum_grads(params, group) -> None:
    """Sum every parameter's gradient over ``group`` in one flat all-reduce
    (a parameter without one contributes zeros and gets the sum)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = _host_side(torch.cat([g.reshape(-1) for g in grads]), group)
    dist.all_reduce(flat, group=group)
    flat = flat.to(grads[0].device)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def make_eval_step(model) -> Callable:
    """Forward-only step: images -> the model's raw outputs (logits)."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor, stem_input: bool = False):
        return model(images, stem_input=stem_input)

    return eval_step

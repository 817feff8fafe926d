"""Tensor (model) parallelism: conv and dense output channels over the
ranks of a 2-D (data, model) grid, the counterpart of
``tdnet/parallel/tensor.py``.

The reference places every conv or dense kernel whose output-channel dim
is at least ``MIN_SHARDED_CHANNELS`` and divides over the ``model`` axis as
``P(None, ..., 'model')`` and lets GSPMD insert the collectives; Adam's
moments mirror the parameter tree, so they shard with their kernels. The
port runs one process a card (``parallel/mesh.py`` :class:`Grid`): the M
ranks of a grid row hold the same pages and each holds its slice of every
such kernel (:func:`shard_state` cuts them in place, so the Adam moments
made from them are slices too).

- **The rule** (:func:`param_partition_spec`) is the reference's on the
  port's layouts: conv weights are OIHW and dense weights (out, in), so
  C_out is dim 0 here where the reference's kernels have it last. It
  covers the SE gate's dense kernels and MobileNet's depthwise kernels.
- **Column-parallel layers** (``models/layers.py`` ``Conv2d``, ``Dense``,
  ``models/resnet.py`` ``StemConv``, chosen by the ``tp`` flag that
  :func:`shard_state` sets on the module): the rank computes its C_out slice
  from the whole input and all-gathers the channels over the model group
  (:func:`column_parallel`); the backward of the gather takes the rank's
  own slice, and the replicated input's gradient is all-reduced over the
  model group (:class:`_CopyToModel`). A depthwise conv reads only its
  matching input channels. The bias (replicated, as in the reference) is
  added to the gathered channels, so its gradient, like every replicated
  tensor's, is the same on each rank of the row; frozen BatchNorm, ReLU and
  the residual add run on the gathered channels.
- **Gradients**: each rank's kernel slice gets the whole gradient of its
  slice, so every gradient is reduced over the DATA group only
  (``train/step.py``). Clipping is per tensor with the whole tensor's norm:
  the slices' squared norms are summed over the model group first.
- **Snapshots** consolidate the whole parameters and moments on rank 0
  (:func:`full_state_dict`, :func:`full_optimizer_state`), in the plain
  run's format; a resume cuts them again (:func:`shard_state_dict`,
  :func:`shard_optimizer_state`).

Under gloo a CUDA tensor crosses through host memory; NCCL moves it on the
card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from tdnet_torch.parallel.mesh import Grid, create_grid

__all__ = [
    "MODEL_AXIS",
    "MIN_SHARDED_CHANNELS",
    "TensorSharding",
    "create_tensor_mesh",
    "model_size",
    "param_partition_spec",
    "state_shardings",
    "shard_state",
    "column_parallel",
    "full_state_dict",
    "full_optimizer_state",
    "shard_state_dict",
    "shard_optimizer_state",
]

MODEL_AXIS = "model"

# the reference's: narrower kernels (the 9*K / 9*4 task heads) stay replicated
MIN_SHARDED_CHANNELS = 64


def create_tensor_mesh(n_model: int) -> Grid:
    """The (data, model) grid: ``n_model`` ranks a row, the rest along
    data; ``n_model`` must divide the ranks (else the reference's
    ValueError)."""
    return create_grid(n_model, MODEL_AXIS)


def model_size(grid: Optional[Grid]) -> int:
    """Size of the model axis (1 when the grid has none)."""
    return grid.size if grid is not None and grid.axis == MODEL_AXIS else 1


def param_partition_spec(name: str, shape, n_model: int,
                         min_channels: int = MIN_SHARDED_CHANNELS) -> Tuple:
    """The partition of one parameter (or its Adam moment) of the port's
    state dict, in the reference's notation: ``("model", None, ...)`` for a
    conv or dense weight (the reference's ``kernel`` leaves: >= 2 dims)
    whose C_out (dim 0) is at least ``min_channels`` and divides over
    ``n_model`` ranks, else ``()`` (replicated)."""
    shape = tuple(shape)
    if (n_model > 1 and name.rsplit(".", 1)[-1] == "weight" and len(shape) >= 2
            and shape[0] >= min_channels and shape[0] % n_model == 0):
        return (MODEL_AXIS,) + (None,) * (len(shape) - 1)
    return ()


def state_shardings(model: torch.nn.Module, n_model: int,
                    min_channels: int = MIN_SHARDED_CHANNELS) -> Dict[str, Tuple]:
    """{parameter name: partition} of a whole (unsharded) model."""
    return {name: param_partition_spec(name, p.shape, n_model, min_channels)
            for name, p in model.named_parameters()}


@dataclass(frozen=True)
class TensorSharding:
    """What :func:`shard_state` cut: the grid, and the sharded parameters'
    names with their whole C_out."""

    grid: Grid
    full_rows: Dict[str, int]

    def rows(self, full: int) -> slice:
        c = full // self.grid.size
        return slice(self.grid.index * c, (self.grid.index + 1) * c)


def shard_state(state, grid: Grid, min_channels: int = MIN_SHARDED_CHANNELS):
    """Cut ``state``'s model (built whole, before its first step) to this
    rank's slices of the sharded kernels, in place, and flag their modules;
    record the sharding on the state and on its optimizer, whose per-tensor
    clipping then takes whole-tensor norms. Returns the state."""
    if state.step or state.optimizer.state:
        raise ValueError("shard_state cuts a fresh state, before its first step")
    sharding = TensorSharding(grid, {})
    owners = {id(m.weight): m for m in state.model.modules()
              if isinstance(getattr(m, "weight", None), torch.nn.Parameter)}
    cut = []
    for name, p in state.model.named_parameters():
        if param_partition_spec(name, p.shape, grid.size, min_channels):
            sharding.full_rows[name] = p.shape[0]
            with torch.no_grad():
                p.data = p.data[sharding.rows(p.shape[0])].clone()
            owners[id(p)].tp = grid
            cut.append(id(p))
    state.sharding = sharding
    state.optimizer.shard_norms(cut, grid.group)
    return state


class _CopyToModel(torch.autograd.Function):
    """The identity on a replicated input; its backward sums the ranks'
    partial input gradients over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if dist.get_backend(ctx.group) == "nccl":
            src = g
        else:  # gloo, on the host, sums no bfloat16
            src = g.cpu().float()
        dist.all_reduce(src, group=ctx.group)
        return src.to(device=g.device, dtype=g.dtype), None


class _GatherChannels(torch.autograd.Function):
    """All-gather of the ranks' channel slices (the last dim of ``x``) over
    the model group; the backward takes this rank's slice."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.rows = (grid.index * x.shape[-1], (grid.index + 1) * x.shape[-1])
        src = x.contiguous()
        if src.is_cuda and dist.get_backend(grid.group) != "nccl":
            src = src.cpu()
        wire = src.view(torch.uint8)  # every dtype bit for bit
        parts = [torch.empty_like(wire) for _ in range(grid.size)]
        dist.all_gather(parts, wire, group=grid.group)
        return torch.cat([p.view(x.dtype) for p in parts], dim=-1).to(x.device)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[..., lo:hi], None


def column_parallel(x: torch.Tensor, layer: Callable, grid: Grid,
                    channel_dim: int = 1, depthwise: bool = False) -> torch.Tensor:
    """``layer`` (this rank's C_out slice, without bias) on the replicated
    ``x``, its output channels gathered over the model group. ``channel_dim``
    1 is an NCHW activation (``channels_last``: the gather runs on its NHWC
    buffer), -1 a dense layer's features. ``depthwise`` feeds the layer only
    its slice of the input channels."""
    x = _CopyToModel.apply(x, grid.group)
    if depthwise:
        c = x.shape[1] // grid.size
        x = x[:, grid.index * c:(grid.index + 1) * c]
    y = layer(x)
    if channel_dim == 1:
        return _GatherChannels.apply(y.permute(0, 2, 3, 1), grid).permute(0, 3, 1, 2)
    return _GatherChannels.apply(y, grid)


def _gather_rows0(t: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The whole tensor from its dim-0 slices, on every rank of the row."""
    src = t.detach().contiguous()
    if src.is_cuda and dist.get_backend(grid.group) != "nccl":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(grid.size)]
    dist.all_gather(parts, src, group=grid.group)
    return torch.cat(parts, dim=0).cpu()


def full_state_dict(model: torch.nn.Module, sharding: TensorSharding) -> dict:
    """The model's whole state dict (host tensors), the sharded kernels
    gathered over the model group: a collective of every rank."""
    out = {}
    for key, value in model.state_dict().items():
        out[key] = (_gather_rows0(value, sharding.grid) if key in sharding.full_rows
                    else value.detach().cpu().clone())
    return out


def _param_names(model, optimizer):
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(optimizer, model, sharding: TensorSharding) -> dict:
    """The optimizer's state dict with each sharded kernel's moments
    gathered whole over the model group: a collective of every rank."""
    sd = optimizer.state_dict()
    names = _param_names(model, optimizer)
    state = {}
    for idx, entry in sd["state"].items():
        sharded = names[idx] in sharding.full_rows
        state[idx] = {k: (_gather_rows0(v, sharding.grid)
                          if sharded and torch.is_tensor(v) and v.dim() else
                          (v.detach().cpu().clone() if torch.is_tensor(v) else v))
                      for k, v in entry.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def shard_state_dict(sd: dict, sharding: TensorSharding) -> dict:
    """A whole state dict cut to this rank's slices of the sharded kernels."""
    return {k: (v[sharding.rows(v.shape[0])].clone() if k in sharding.full_rows else v)
            for k, v in sd.items()}


def shard_optimizer_state(sd: dict, optimizer, model, sharding: TensorSharding) -> dict:
    """A whole optimizer state dict cut to this rank's slices."""
    names = _param_names(model, optimizer)
    state = {}
    for idx, entry in sd["state"].items():
        sharded = names[int(idx)] in sharding.full_rows
        state[idx] = {k: (v[sharding.rows(v.shape[0])].clone()
                          if sharded and torch.is_tensor(v) and v.dim() else v)
                      for k, v in entry.items()}
    return {"state": state, "param_groups": sd["param_groups"]}

"""Parallelism across processes and devices, the counterpart of
``tdnet/parallel``: data parallelism (``mesh.py``), ZeRO-1 (``zero.py``),
the 2-D (data, spatial) and (data, model) grids of one process a card
(``spatial.py``: the image H axis in bands with halo fetches; ``tensor.py``:
conv and dense output channels, with their Adam moments), and the 2-stage
pipeline over two devices of one process (``pipeline.py``: backbone |
FPN + heads, a 1F1B microbatch schedule, rematerialised stage-0 backward).
``pipeline`` and ``zero`` import the models and the train step, which
import this package: their names load on first use."""

from tdnet_torch.parallel.mesh import (
    Grid,
    barrier,
    create_grid,
    initialize_distributed,
    is_distributed,
    process_allgather_rows,
    process_count,
    process_index,
)
from tdnet_torch.parallel.spatial import create_spatial_mesh, spatial_size
from tdnet_torch.parallel.tensor import (
    create_tensor_mesh,
    model_size,
    param_partition_spec,
    shard_state,
)

_LAZY = {
    "PipelineTrainer": "pipeline",
    "PipelinedForward": "pipeline",
    "split_variables": "pipeline",
    "make_stage_modules": "pipeline",
    "zero_optimizer": "zero",
}

__all__ = [
    "Grid",
    "barrier",
    "create_grid",
    "create_spatial_mesh",
    "create_tensor_mesh",
    "initialize_distributed",
    "is_distributed",
    "model_size",
    "param_partition_spec",
    "process_allgather_rows",
    "process_count",
    "process_index",
    "shard_state",
    "spatial_size",
    *_LAZY,
]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"tdnet_torch.parallel.{_LAZY[name]}"), name)
    raise AttributeError(f"module 'tdnet_torch.parallel' has no attribute {name!r}")

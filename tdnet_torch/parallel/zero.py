"""ZeRO-1: the Adam state partitioned over the ranks, the parameters
replicated, the counterpart of ``tdnet/parallel/zero.py`` (train ``--zero``).

The reference places every Adam moment whose last dimension is at least
``MIN_SHARDED_SIZE`` and divides over the data axis as ``P(..., 'data')``:
each device holds a slice of the last dimension of every such moment
(:func:`moment_partition_spec`), and GSPMD all-gathers the parameter update.

The port uses ``torch.distributed.optim.ZeroRedundancyOptimizer`` with
``optimizer_class=ClippedAdam``. It partitions whole tensors, not
last-dimension slices: each rank owns a set of parameters, holds their
moments only (about 1/N of the state, balanced by size), updates them,
and broadcasts them to the other ranks. The gradients arrive
all-reduced by ``DistributedDataParallel`` as in plain data parallelism,
and each tensor is clipped by its own norm wherever it is updated, so the
numbers are exactly the plain data-parallel step's, as the reference
asserts of its own form (``tests/parallel/test_zero.py``). A snapshot
consolidates the state on rank 0 (``train/checkpoint.py``), and a resume
gives each rank its partition back.
"""

from __future__ import annotations

from typing import Callable, Sequence

from torch.distributed.optim import ZeroRedundancyOptimizer

from tdnet_torch.train.step import ClippedAdam

__all__ = ["MIN_SHARDED_SIZE", "moment_partition_spec", "zero_optimizer"]

# the reference's: narrower moments stay replicated
MIN_SHARDED_SIZE = 64


def moment_partition_spec(shape: Sequence[int], n_data: int,
                          min_size: int = MIN_SHARDED_SIZE) -> bool:
    """Whether the reference shards the Adam moment of a parameter of this
    shape (in the reference's layout: a conv kernel HWIO, its output
    channels last) over a data axis of ``n_data`` devices, along its last
    dimension. Documentation of the reference's rule: the port partitions
    whole tensors instead."""
    return (n_data > 1 and len(shape) >= 1 and shape[-1] >= min_size
            and shape[-1] % n_data == 0)


def zero_optimizer(learning_rate: float = 1e-5, clipnorm: float = 1e-3) -> Callable:
    """``create_optimizer``'s ZeRO-1 form: a factory of the trainable
    parameters for ``create_train_state``. Needs the process group."""

    def make(params):
        return ZeroRedundancyOptimizer(list(params), optimizer_class=ClippedAdam,
                                       lr=learning_rate, clipnorm=clipnorm)

    return make

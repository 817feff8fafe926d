"""Checkpoint and resume, the counterpart of ``tdnet/train/checkpoint.py``.

The reference saves {params, batch_stats, opt_state, step} with orbax under
``{directory}/{step}``; orbax is not on the GPU machine, so this writes the
same payload (plus the learning rate) with ``torch.save`` to
``{directory}/{step}/state.pt``, through a temporary directory renamed into
place, so a reader never sees half a checkpoint. ``opt_state`` is the
optimizer's ``state_dict``: a resume restores the Adam moments and step
count, not only the weights. Loading uses ``weights_only=True``.

With a process group (``parallel/mesh.py``) every rank calls ``save``:
a ZeRO-1 optimizer (``parallel/zero.py``) first gathers its partitions on
rank 0, rank 0 alone writes, and the other ranks wait at a barrier, so
the checkpoint is written once and is in place on every rank's return.
``restore`` reads the same file on every rank; a ZeRO-1 optimizer keeps
its own partition of the Adam state. A tensor-parallel state
(``parallel/tensor.py``) gathers its whole parameters and moments over the
model group before rank 0 writes, so the checkpoint is a plain run's, and
``restore`` cuts them again.

A snapshot of a ``--pipeline`` run holds the merged variables and an empty
optimizer state (``has_opt_state`` is false): ``restore_weights`` or
``weights`` read it.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer

from tdnet_torch.parallel.mesh import barrier, process_index
from tdnet_torch.parallel.tensor import (full_optimizer_state, full_state_dict,
                                         shard_optimizer_state, shard_state_dict)

__all__ = ["Checkpointer"]

_FILE = "state.pt"
_BATCH_STATS = ("mean", "var")


def _split(state_dict):
    """a model's state dict -> (params, batch_stats), keyed by module path."""
    params, stats = {}, {}
    for key, value in state_dict.items():
        target = stats if key.rsplit(".", 1)[-1] in _BATCH_STATS else params
        target[key] = value.detach().cpu().clone()
    return params, stats


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _FILE)

    def steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(self._path(int(d))))

    def save(self, step: int, state) -> None:
        """Save {params, batch_stats, opt_state, step, lr}; returns when the
        checkpoint is in place. Call it on every rank."""
        sharding = getattr(state, "sharding", None)
        if sharding is not None:
            whole = (full_state_dict(state.model, sharding),
                     full_optimizer_state(state.optimizer, state.model, sharding))
        else:
            if isinstance(state.optimizer, ZeroRedundancyOptimizer):
                state.optimizer.consolidate_state_dict(to=0)
            whole = None
        if process_index() == 0:
            if whole is None:
                whole = (state.model.state_dict(), state.optimizer.state_dict())
            self._write(step, state, *whole)
        barrier()

    def save_variables(self, step: int, state_dict: dict) -> None:
        """Save a model state dict with an empty optimizer state (a
        ``--pipeline`` run's merged variables); one process."""
        self._write(step, None, state_dict, {"state": {}, "param_groups": []})

    def _write(self, step: int, state, model_state: dict, opt: dict) -> None:
        params, stats = _split(model_state)
        payload = {
            "params": params,
            "batch_stats": stats,
            "opt_state": _to_cpu(opt),
            "step": int(step if state is None else state.step),
            "lr": (float(state.optimizer.param_groups[0]["lr"]) if state is not None
                   else None),
        }
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp-")
        try:
            torch.save(payload, os.path.join(tmp, _FILE))
            final = os.path.join(self.directory, str(step))
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if self.max_to_keep is not None:
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _load(self, step: Optional[int]):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Load weights, BN statistics, optimizer state (Adam moments and
        step count), step and lr into ``state`` (built as at the start of
        the run, on its device); returns it."""
        payload = self._load(step)
        if not payload["opt_state"]["state"]:
            raise ValueError("the checkpoint has no optimizer state; use "
                             "restore_weights")
        weights, opt = {**payload["params"], **payload["batch_stats"]}, payload["opt_state"]
        sharding = getattr(state, "sharding", None)
        if sharding is not None:
            weights = shard_state_dict(weights, sharding)
            opt = shard_optimizer_state(opt, state.optimizer, state.model, sharding)
        state.model.load_state_dict(weights)
        state.optimizer.load_state_dict(opt)
        for group in state.optimizer.param_groups:
            group["lr"] = payload["lr"]
        state.step = int(payload["step"])
        return state

    def has_opt_state(self, step: Optional[int] = None) -> bool:
        """True if the snapshot carries optimizer moments."""
        return bool(self._load(step)["opt_state"]["state"])

    def restore_weights(self, model, step: Optional[int] = None):
        """Load only {params, batch_stats} into ``model``; returns it."""
        model.load_state_dict(self.weights(step))
        return model

    def weights(self, step: Optional[int] = None) -> dict:
        """The snapshot's model state dict ({params, batch_stats})."""
        payload = self._load(step)
        return {**payload["params"], **payload["batch_stats"]}


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj

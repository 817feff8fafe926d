"""Checkpoint and resume, the counterpart of ``tdnet/train/checkpoint.py``.

The reference saves {params, batch_stats, opt_state, step} with orbax under
``{directory}/{step}``; orbax is not on the GPU machine, so this writes the
same payload (plus the learning rate) with ``torch.save`` to
``{directory}/{step}/state.pt``, through a temporary directory renamed into
place, so a reader never sees half a checkpoint. ``opt_state`` is the
optimizer's ``state_dict``: a resume restores the Adam moments and step
count, not only the weights. Loading uses ``weights_only=True``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch

__all__ = ["Checkpointer"]

_FILE = "state.pt"
_BATCH_STATS = ("mean", "var")


def _split(model):
    """model state -> (params, batch_stats), keyed by module path."""
    params, stats = {}, {}
    for key, value in model.state_dict().items():
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
        checkpoint is in place."""
        params, stats = _split(state.model)
        opt = state.optimizer.state_dict()
        payload = {
            "params": params,
            "batch_stats": stats,
            "opt_state": _to_cpu(opt),
            "step": int(state.step),
            "lr": float(state.optimizer.param_groups[0]["lr"]),
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
        state.model.load_state_dict({**payload["params"],
                                     **payload["batch_stats"]})
        state.optimizer.load_state_dict(payload["opt_state"])
        for group in state.optimizer.param_groups:
            group["lr"] = payload["lr"]
        state.step = int(payload["step"])
        return state

    def has_opt_state(self, step: Optional[int] = None) -> bool:
        """True if the snapshot carries optimizer moments."""
        return bool(self._load(step)["opt_state"]["state"])

    def restore_weights(self, model, step: Optional[int] = None):
        """Load only {params, batch_stats} into ``model``; returns it."""
        payload = self._load(step)
        model.load_state_dict({**payload["params"], **payload["batch_stats"]})
        return model


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj

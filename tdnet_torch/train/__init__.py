"""Inference (Predictor) and training: the train step, the fit loop and
checkpoints. The package exports the names of ``tdnet/train/__init__.py``."""

from tdnet_torch.train.step import (
    TrainState,
    create_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "TrainState",
    "create_optimizer",
    "create_train_state",
    "make_eval_step",
    "make_train_step",
]

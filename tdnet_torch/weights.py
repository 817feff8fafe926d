"""Weight bridge between the flax variable tree of ``tdnet`` and the port's
modules.

The flax tree is ``{"params": ..., "batch_stats": ...}`` of numpy arrays
(nested dicts keyed by module name). The port's module names follow it, so a
flax path ``backbone/stage2_block0/conv1/kernel`` is the state key
``backbone.stage2_block0.conv1.weight``; conv kernels go HWIO -> OIHW (a
depthwise (k, k, 1, C) to (C, 1, k, k)), dense kernels (in, out) -> (out,
in), and BatchNorm ``mean``/``var`` live in ``batch_stats``. Both directions copy the
values unchanged, so a round trip is exact.

``.tdn`` bundles (msgpack written through flax) are read by a later slice:
the GPU machine has no msgpack.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

__all__ = ["torch_state_from_variables", "variables_from_torch_state",
           "random_variables"]

_BATCH_STATS = ("mean", "var")
# flax kernel -> torch weight axes: conv HWIO -> OIHW, dense (in, out) -> (out, in)
_KERNEL_TO_WEIGHT = {4: (3, 2, 0, 1), 2: (1, 0)}
_WEIGHT_TO_KERNEL = {4: (2, 3, 1, 0), 2: (1, 0)}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def torch_state_from_variables(variables: Mapping) -> dict:
    """flax ``{params, batch_stats}`` (numpy) -> the port's state dict of
    float32 tensors, ready for ``module.load_state_dict``."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            arr = np.asarray(value)
            name = path[-1]
            if name == "kernel":
                if arr.ndim not in _KERNEL_TO_WEIGHT:
                    raise ValueError(f"{'/'.join(path)}: a {arr.ndim}-D kernel "
                                     "is neither a conv's nor a dense layer's")
                arr, name = arr.transpose(_KERNEL_TO_WEIGHT[arr.ndim]), "weight"
            key = ".".join(path[:-1] + (name,))
            # native byte order: an .h5 may hold big-endian arrays
            state[key] = torch.from_numpy(
                np.ascontiguousarray(arr, arr.dtype.newbyteorder("=")))
    return state


def variables_from_torch_state(state: Mapping) -> dict:
    """The inverse of :func:`torch_state_from_variables`: state dict ->
    flax ``{params, batch_stats}`` tree of numpy arrays."""
    out = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
            else np.asarray(value)
        path = key.split(".")
        name = path[-1]
        if name == "weight":
            arr, name = arr.transpose(_WEIGHT_TO_KERNEL[arr.ndim]), "kernel"
        collection = "batch_stats" if name in _BATCH_STATS else "params"
        node = out[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return out


def _truncated_normal(rng: np.random.RandomState, shape, std: float) -> np.ndarray:
    """Normal(0, std) truncated to +-2 std (resampled)."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return (x * std).astype(np.float32)


def random_variables(num_classes: int, backbone: str = "resnet50",
                     seed: int = 0, num_anchors: int = 9,
                     feature_size: int = 256,
                     prior_probability: float = 0.01) -> dict:
    """A flax-shaped ``{params, batch_stats}`` numpy tree with flax's init
    distributions (the counterpart of ``RetinaNet.init``; the values are
    not jax.random's): lecun_normal conv and dense kernels in the backbone
    and FPN, Normal(0.01) subnet kernels, zero biases, the classification
    head bias at -log((1 - p) / p), BatchNorm at identity."""
    from tdnet_torch.models.retinanet import RetinaNet

    with torch.device("meta"):
        model = RetinaNet(num_classes, backbone=backbone,
                          num_anchors=num_anchors, feature_size=feature_size)
    rng = np.random.RandomState(seed)
    state = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        name = key.rsplit(".", 1)[-1]
        subnet = key.startswith(("regression_submodel", "classification_submodel"))
        if name == "weight" and subnet:
            arr = (rng.standard_normal(shape) * 0.01).astype(np.float32)
        elif name == "weight":
            fan_in = math.prod(shape[1:])  # conv (O, I/groups, k, k), dense (out, in)
            # flax lecun_normal: variance 1/fan_in, truncated at 2 std
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            arr = _truncated_normal(rng, shape, std)
        elif key == "classification_submodel.head.bias":
            value = -math.log((1.0 - prior_probability) / prior_probability)
            arr = np.full(shape, value, np.float32)
        elif name in ("scale", "var"):
            arr = np.ones(shape, np.float32)
        else:  # biases, BN bias and mean
            arr = np.zeros(shape, np.float32)
        state[key] = arr
    return variables_from_torch_state(state)

"""keras-retinanet ``.h5`` weights <-> the flax-layout variable tree, the
counterpart of ``tdnet/compat/keras_import.py``, reading and writing
through the port's own HDF5 code (``compat/hdf5.py``).

Keras layer names (keras-resnet and keras_retinanet/models/retinanet.py):

  conv1, bn_conv1                         -> backbone conv1 / bn1
  res{S}{b}_branch2a/2b/2c (+ bn...)      -> stage{S}_block{i} conv1..3
  res{S}{b}_branch1, bn{S}{b}_branch1     -> the projection shortcut
  C3_reduced .. C5_reduced, P3 .. P7      -> fpn
  pyramid_classification_{0..3}, ...      -> classification_submodel
  pyramid_regression_{0..3}, ...          -> regression_submodel

Keras Conv2D kernels are HWIO, flax's layout, so kernels copy through; a
depthwise kernel (H, W, C, 1) becomes flax's grouped (H, W, 1, C). Keras
BatchNormalization's gamma, beta, moving_mean and moving_variance become
scale, bias, mean and var. The result is the numpy ``{params,
batch_stats}`` tree that ``tdnet_torch/weights.py`` turns into a state
dict. VGG, DenseNet and MobileNet files load into their families'
templates (``weights.random_variables``); SE-ResNet has no verified keras
naming of its SE layers and raises, as in the reference.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np

from tdnet_torch.compat import hdf5
from tdnet_torch.models.densenet import DENSENET_BLOCKS
from tdnet_torch.models.resnet import STAGE_SIZES
from tdnet_torch.models.vgg import VGG_STAGES

__all__ = [
    "load_keras_retinanet_h5",
    "keras_name_map",
    "keras_name_map_for",
    "export_random_keras_weights",
]


def keras_name_map(stage_sizes=(3, 4, 6, 3)) -> Dict[str, Tuple[str, ...]]:
    """Keras layer name -> param path (a tuple of tree keys) of a ResNet
    RetinaNet. Conv layers hold (kernel[, bias]); BN layers the
    FrozenBatchNorm params and batch_stats."""
    m: Dict[str, Tuple[str, ...]] = {}
    m["conv1"] = ("backbone", "conv1")
    m["bn_conv1"] = ("backbone", "bn1")
    for stage, num_blocks in enumerate(stage_sizes):
        s = stage + 2  # keras-resnet naming: res2.., res3..
        for block in range(num_blocks):
            letter = chr(ord("a") + block)
            base = ("backbone", f"stage{s}_block{block}")
            m[f"res{s}{letter}_branch2a"] = base + ("conv1",)
            m[f"bn{s}{letter}_branch2a"] = base + ("bn1",)
            m[f"res{s}{letter}_branch2b"] = base + ("conv2",)
            m[f"bn{s}{letter}_branch2b"] = base + ("bn2",)
            m[f"res{s}{letter}_branch2c"] = base + ("conv3",)
            m[f"bn{s}{letter}_branch2c"] = base + ("bn3",)
            if block == 0:  # the projection shortcut: first block only
                m[f"res{s}{letter}_branch1"] = base + ("conv_shortcut",)
                m[f"bn{s}{letter}_branch1"] = base + ("bn_shortcut",)
    _add_fpn_and_heads(m)
    return m


def _add_fpn_and_heads(m: Dict[str, Tuple[str, ...]]) -> None:
    """The FPN and shared-subnet names, common to every backbone family."""
    for name in ["C3_reduced", "C4_reduced", "C5_reduced", "P3", "P4", "P5", "P6", "P7"]:
        m[name] = ("fpn", name)
    for i in range(4):
        m[f"pyramid_classification_{i}"] = ("classification_submodel", f"conv{i}")
        m[f"pyramid_regression_{i}"] = ("regression_submodel", f"conv{i}")
    m["pyramid_classification"] = ("classification_submodel", "head")
    m["pyramid_regression"] = ("regression_submodel", "head")


def keras_name_map_vgg(stage_sizes=(2, 2, 3, 3, 3)) -> Dict[str, Tuple[str, ...]]:
    """keras-applications VGG naming (block{B}_conv{i}), kept under
    'backbone'."""
    m: Dict[str, Tuple[str, ...]] = {}
    for block, n_convs in enumerate(stage_sizes):
        for i in range(n_convs):
            name = f"block{block + 1}_conv{i + 1}"
            m[name] = ("backbone", name)
    _add_fpn_and_heads(m)
    return m


def keras_name_map_mobilenet(num_blocks: int = 13) -> Dict[str, Tuple[str, ...]]:
    """keras-applications MobileNetV1 naming."""
    m: Dict[str, Tuple[str, ...]] = {
        "conv1": ("backbone", "conv1"),
        "conv1_bn": ("backbone", "bn_conv1"),
    }
    for i in range(1, num_blocks + 1):
        m[f"conv_dw_{i}"] = ("backbone", f"conv_dw_{i}")
        m[f"conv_dw_{i}_bn"] = ("backbone", f"bn_dw_{i}")
        m[f"conv_pw_{i}"] = ("backbone", f"conv_pw_{i}")
        m[f"conv_pw_{i}_bn"] = ("backbone", f"bn_pw_{i}")
    _add_fpn_and_heads(m)
    return m


def keras_name_map_densenet(block_sizes=(6, 12, 24, 16)) -> Dict[str, Tuple[str, ...]]:
    """keras-applications DenseNet naming, both the slashed names of
    keras-applications 1.0 ('conv1/conv') and the underscored ones
    ('conv1_conv')."""
    m: Dict[str, Tuple[str, ...]] = {}
    for stem_conv in ("conv1/conv", "conv1_conv"):
        m[stem_conv] = ("backbone", "conv1")
    for stem_bn in ("conv1/bn", "conv1_bn"):
        m[stem_bn] = ("backbone", "bn1")
    for b, n_layers in enumerate(block_sizes):
        s = b + 2  # keras: conv2..conv5; the tree: block2..block5
        for i in range(n_layers):
            base = ("backbone", f"block{s}_layer{i}")
            m[f"conv{s}_block{i + 1}_0_bn"] = base + ("bn1",)
            m[f"conv{s}_block{i + 1}_1_conv"] = base + ("conv1",)
            m[f"conv{s}_block{i + 1}_1_bn"] = base + ("bn2",)
            m[f"conv{s}_block{i + 1}_2_conv"] = base + ("conv2",)
        if b != len(block_sizes) - 1:
            m[f"pool{s}_bn"] = ("backbone", f"transition{s}_bn")
            m[f"pool{s}_conv"] = ("backbone", f"transition{s}_conv")
    _add_fpn_and_heads(m)
    return m


def keras_name_map_for(backbone_name: str) -> Dict[str, Tuple[str, ...]]:
    """The name map of a backbone family."""
    name = backbone_name
    if name.startswith("seresnet"):
        # no verified upstream naming of the SE Dense layers: a plain ResNet
        # map would leave them at their init on a strict=False load
        raise ValueError(
            f"no verified Keras h5 name map for SE-ResNet backbone "
            f"{backbone_name!r} (the se_reduce/se_expand Dense layers); pass "
            "an explicit name_map to load_keras_retinanet_h5, or import into "
            "the plain resnet and re-train the SE gates"
        )
    if name in STAGE_SIZES:
        return keras_name_map(STAGE_SIZES[name])
    if name.startswith("vgg"):
        return keras_name_map_vgg(VGG_STAGES[name])
    if name.startswith("densenet"):
        return keras_name_map_densenet(DENSENET_BLOCKS[name])
    if name.startswith("mobilenet"):
        return keras_name_map_mobilenet()
    raise ValueError(f"no Keras name map for backbone {backbone_name!r}")


def _set_path(tree: dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _get_path(tree, path: Tuple[str, ...]):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node


def _walk_h5_weights(group, prefix=""):
    """(weight name, array) of every dataset under a group, in name order."""
    for key in group:
        item = group[key]
        if isinstance(item, hdf5.Dataset):
            yield prefix + key, item.read()
        else:
            yield from _walk_h5_weights(item, prefix + key + "/")


def _to_plain(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _to_plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _resolve_map(name_map, backbone_name, stage_sizes):
    if name_map is not None:
        return name_map
    return keras_name_map_for(backbone_name) if backbone_name else keras_name_map(stage_sizes)


def load_keras_retinanet_h5(
    path: str, variables: dict, stage_sizes=(3, 4, 6, 3), strict: bool = True,
    verbose: bool = False, backbone_name: str = None, name_map: dict = None,
) -> dict:
    """A keras-retinanet ``.h5`` into a copy of ``variables`` (the template
    ``{params, batch_stats}``) -> a new tree with the matched leaves
    replaced. ``strict``: every Keras conv or BN weight must find a leaf of
    the template's shape. Otherwise unmatched and shape-mismatched weights
    are skipped: Keras ``load_weights(by_name=True, skip_mismatch=True)``,
    which loading an ImageNet backbone-only file into a detection model
    relies on."""
    name_map = _resolve_map(name_map, backbone_name, stage_sizes)
    params = copy.deepcopy(
        {"params": _to_plain(variables["params"]),
         "batch_stats": _to_plain(variables.get("batch_stats", {}))})

    unmatched, skipped, matched = [], [], 0
    with hdf5.File(path) as f:
        group = f["model_weights"] if "model_weights" in f else f
        weights = dict(_walk_h5_weights(group))

    for wname, array in weights.items():
        parts = [p for p in wname.split("/") if p]
        # the layout is <layer>/<layer>/<weight> (keras repeats the name);
        # a layer name may hold '/' (densenet 'conv1/conv'): the longest
        # joined match first
        layer = None
        for i in range(len(parts)):
            if i + 1 < len(parts) and parts[i] + "/" + parts[i + 1] in name_map:
                layer = parts[i] + "/" + parts[i + 1]
                break
            if parts[i] in name_map and layer is None:
                layer = parts[i]
        leaf = parts[-1].split(":")[0]
        if layer is None:
            unmatched.append(wname)
            continue
        path_ = name_map[layer]
        if leaf == "depthwise_kernel":
            # keras depthwise (H, W, C, 1) -> flax grouped (H, W, 1, C)
            array = np.transpose(array, (0, 1, 3, 2))
            leaf = "kernel"
        dest = {
            "kernel": ("params", path_ + ("kernel",)),
            "bias": ("params", path_ + ("bias",)),
            "gamma": ("params", path_ + ("scale",)),
            "beta": ("params", path_ + ("bias",)),
            "moving_mean": ("batch_stats", path_ + ("mean",)),
            "moving_variance": ("batch_stats", path_ + ("var",)),
        }.get(leaf)
        if dest is None:
            unmatched.append(wname)
            continue
        tree_key, full_path = dest
        existing = _get_path(params[tree_key], full_path)
        if existing is not None and np.shape(existing) != np.shape(array):
            skipped.append(f"{wname}: {np.shape(array)} != {np.shape(existing)}")
            continue
        _set_path(params[tree_key], full_path, array)
        matched += 1

    if strict and (unmatched or skipped):
        raise ValueError(
            f"unmatched Keras weights: {unmatched[:10]}; shape-skipped: {skipped[:10]}")
    if verbose:
        msg = f"keras h5 import: matched {matched} weights from {path}"
        if unmatched:
            msg += f"; {len(unmatched)} unmatched (e.g. {unmatched[:3]})"
        if skipped:
            msg += f"; {len(skipped)} shape-skipped (e.g. {skipped[:3]})"
        print(msg)
    return params


def export_random_keras_weights(
    path: str, variables: dict, stage_sizes=(3, 4, 6, 3),
    backbone_name: str = None, name_map: dict = None,
) -> None:
    """Write a ``{params, batch_stats}`` tree as an ``.h5`` in Keras naming
    (``model_weights/<layer>/<layer>/<weight>:0``)."""
    name_map = _resolve_map(name_map, backbone_name, stage_sizes)
    params = _to_plain(variables["params"])
    stats = _to_plain(variables.get("batch_stats", {}))

    tree: dict = {}
    for layer, path_ in name_map.items():
        p = _get_path(params, path_)
        s = _get_path(stats, path_)
        if p is None and s is None:
            continue
        # h5py's create_group(layer) nests at each '/' of the name
        where = ("model_weights", *layer.split("/"), *layer.split("/"))
        _set_path(tree, where, {})
        lg = _get_path(tree, where)
        if p is not None and "kernel" in p:  # conv layer
            if "conv_dw_" in layer:  # flax grouped (H, W, 1, C) -> keras
                lg["depthwise_kernel:0"] = np.transpose(p["kernel"], (0, 1, 3, 2))
            else:
                lg["kernel:0"] = p["kernel"]
            if "bias" in p:
                lg["bias:0"] = p["bias"]
        elif p is not None and "scale" in p:  # batch norm
            lg["gamma:0"] = p["scale"]
            lg["beta:0"] = p["bias"]
            lg["moving_mean:0"] = s["mean"]
            lg["moving_variance:0"] = s["var"]
    hdf5.write_hdf5(path, tree)

"""Deployable ``.tdn`` bundles, the counterpart of ``tdnet/models/io.py``,
read and written without flax (the GPU machine has neither flax nor
msgpack: ``tdnet_torch/utils/msgpack.py`` is the codec).

A ``.tdn`` file is one MessagePack map:

- ``meta``: ``format_version``, ``model`` (num_classes, backbone_name,
  num_anchors, feature_size, prior_probability), ``anchors`` (the anchor
  parameters or nil) and ``inference`` (the defaults below, overridden);
- ``variables``: the flax ``{params, batch_stats}`` tree of numpy arrays,
  which :func:`tdnet_torch.weights.torch_state_from_variables` bridges.

:func:`save_model` writes every map with its keys sorted, as flax's
``tree_map`` leaves them, so a bundle is byte for byte the reference's. One
difference: the anchor parameters are written as lists. The reference
stores ``dataclasses.asdict`` of them, whose tuples flax's strict packer
refuses (``TypeError``), so the reference cannot write a bundle with
anchors; its reader takes the lists.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.ops.anchors import AnchorParameters
from tdnet_torch.utils import msgpack

__all__ = ["FORMAT_VERSION", "DEFAULT_INFERENCE_CONFIG", "save_model",
           "load_model", "anchor_params_from_meta"]

FORMAT_VERSION = 1

DEFAULT_INFERENCE_CONFIG = {
    "nms": True,
    "class_specific_filter": True,
    "score_threshold": 0.05,
    "max_detections": 300,
    "nms_threshold": 0.5,
    "soft_nms_sigma": 0.0,  # > 0 switches to gaussian soft-NMS (config 5)
    "min_side": 800,
    "max_side": 1333,
    "preprocess_mode": "caffe",
}


def _sorted_tree(tree):
    """Every map of the tree with its keys sorted."""
    if isinstance(tree, Mapping):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def save_model(path: str, model: RetinaNet, variables: Dict[str, Any],
               anchor_params: Optional[AnchorParameters] = None,
               inference_config: Optional[dict] = None) -> None:
    """Write ``model``'s record and ``variables`` (the flax
    ``{params, batch_stats}`` numpy tree, e.g.
    ``weights.variables_from_torch_state(model.state_dict())``)."""
    anchors = None
    if anchor_params is not None:
        anchors = {f.name: list(getattr(anchor_params, f.name))
                   for f in dataclasses.fields(anchor_params)}
    meta = {
        "format_version": FORMAT_VERSION,
        "model": {
            "num_classes": int(model.num_classes),
            "backbone_name": model.backbone_name,
            "num_anchors": int(model.num_anchors),
            "feature_size": int(model.feature_size),
            "prior_probability": float(model.prior_probability),
        },
        "anchors": anchors,
        "inference": {**DEFAULT_INFERENCE_CONFIG, **(inference_config or {})},
    }
    payload = {
        "meta": meta,
        "variables": {
            "params": variables["params"],
            "batch_stats": variables.get("batch_stats", {}),
        },
    }
    data = msgpack.packb(_sorted_tree(payload))
    with open(path, "wb") as f:
        f.write(data)


def load_model(path: str, dtype: torch.dtype = torch.float32
               ) -> Tuple[RetinaNet, Dict[str, Any], dict]:
    """Load a ``.tdn`` bundle -> (model, variables, meta). The variables
    are writable numpy arrays (views of the file's bytes); an unknown
    backbone raises ``ValueError``."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    payload = msgpack.unpackb(buf)
    meta = payload["meta"]
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported .tdn format version {meta.get('format_version')}")
    mc = meta["model"]
    model = RetinaNet(
        num_classes=int(mc["num_classes"]),
        backbone=mc["backbone_name"],
        num_anchors=int(mc["num_anchors"]),
        feature_size=int(mc["feature_size"]),
        prior_probability=float(mc["prior_probability"]),
        dtype=dtype,
    )
    variables = {
        "params": payload["variables"]["params"],
        "batch_stats": payload["variables"]["batch_stats"],
    }
    return model, variables, meta


def anchor_params_from_meta(meta: dict) -> Optional[AnchorParameters]:
    a = meta.get("anchors")
    if not a:
        return None
    return AnchorParameters(
        sizes=tuple(a["sizes"]),
        strides=tuple(a["strides"]),
        ratios=tuple(a["ratios"]),
        scales=tuple(a["scales"]),
    )


"""Initial weights for training, the counterpart of
``tdnet/train/weights.py`` ``load_initial_weights``. Accepted:

  *.tdn            deployable bundle (``models/io.py``)
  directory        one of the port's checkpoint directories
                   (``train/checkpoint.py``), weights only: the optimizer
                   state is not restored (``--snapshot`` resumes in full)

A reference orbax snapshot reaches the port as a ``.tdn`` through the
reference's ``convert_model``. Keras ``.h5`` files are not ported yet
(ROADMAP A12).

Keras ``load_weights(by_name=True, skip_mismatch=True)`` semantics, as in
the reference: leaves that match by name and shape are loaded, cast to the
template's dtype, the rest keep their init values, and the first skipped
names are printed.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

__all__ = ["load_initial_weights"]


def _merge_matching(template: Dict, loaded: Dict, skipped: list, prefix=()):
    """Copy loaded leaves over template leaves where names and shapes agree."""
    out = {}
    for key, tval in template.items():
        if key not in loaded:
            out[key] = tval
            continue
        lval = loaded[key]
        if isinstance(tval, dict):
            out[key] = _merge_matching(tval, dict(lval), skipped, prefix + (key,))
        elif np.shape(tval) == np.shape(lval):
            out[key] = np.asarray(lval).astype(np.asarray(tval).dtype)
        else:
            skipped.append("/".join(prefix + (key,))
                           + f": shape {np.shape(lval)} != {np.shape(tval)}")
            out[key] = tval
    return out


def load_initial_weights(path: str, variables: Dict[str, Any],
                         backbone_name: str = "resnet50",
                         verbose: bool = True) -> Dict[str, Any]:
    """Load weights from ``path`` into a copy of ``variables`` (the flax
    ``{params, batch_stats}`` numpy tree, e.g. ``weights.random_variables``)
    -> ``{params, batch_stats}``, the tree ``create_train_state`` takes."""
    template = {"params": variables["params"],
                "batch_stats": variables.get("batch_stats", {})}

    if os.path.isdir(path):  # the port's checkpoint: weights only
        import torch

        from tdnet_torch.models.retinanet import RetinaNet
        from tdnet_torch.train.checkpoint import Checkpointer
        from tdnet_torch.weights import variables_from_torch_state

        heads = template["params"]
        num_anchors = np.shape(heads["regression_submodel"]["head"]["bias"])[0] // 4
        num_classes = (np.shape(heads["classification_submodel"]["head"]["bias"])[0]
                       // num_anchors)
        with torch.device("meta"):
            model = RetinaNet(num_classes, backbone=backbone_name,
                              num_anchors=num_anchors)
        Checkpointer(path).restore_weights(model.to_empty(device="cpu"))
        if verbose:
            print(f"loaded weights from snapshot {path}")
        return variables_from_torch_state(model.state_dict())

    if path.endswith(".tdn"):
        from tdnet_torch.models.io import load_model

        _, loaded, _ = load_model(path)
        skipped: list = []
        merged = _merge_matching(
            template,
            {"params": loaded["params"],
             "batch_stats": loaded.get("batch_stats", {})},
            skipped)
        if verbose:
            print(f"loaded weights from {path}" +
                  (f"; skipped {len(skipped)} mismatched: {skipped[:5]}" if skipped else ""))
        return merged

    if path.endswith((".h5", ".hdf5")):
        raise NotImplementedError("keras .h5 weights are not ported yet (ROADMAP A12)")

    raise ValueError(
        f"unrecognized weights file {path!r} (expected .tdn, .h5/.hdf5, or "
        "an orbax snapshot directory)"
    )

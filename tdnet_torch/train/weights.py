"""Initial weights for training, the counterpart of
``tdnet/train/weights.py``. ``load_initial_weights`` accepts:

  *.tdn            deployable bundle (``models/io.py``)
  *.h5 / *.hdf5    keras-retinanet training snapshot or a keras-resnet
                   ImageNet backbone (``compat/keras_import.py``, through
                   the port's own HDF5 reader)
  directory        one of the port's checkpoint directories
                   (``train/checkpoint.py``), weights only: the optimizer
                   state is not restored (``--snapshot`` resumes in full)

A reference orbax snapshot reaches the port as a ``.tdn`` through the
reference's ``convert_model``.

Keras ``load_weights(by_name=True, skip_mismatch=True)`` semantics, as in
the reference: leaves that match by name and shape are loaded, the rest
keep their init values, and the skipped names are printed.

``find_imagenet_weights`` looks for a keras-resnet ImageNet file in local
directories only; it never downloads. Without one, ``bn_warmup``
re-estimates the frozen BatchNorm statistics from batches of the data.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Optional

import numpy as np

__all__ = ["load_initial_weights", "find_imagenet_weights",
           "imagenet_weights_or_explain", "bn_warmup", "IMAGENET_SEARCH_DIRS"]

# where keras-resnet's download_imagenet would have cached its file (the
# keras get_file cache), then $TDNET_PRETRAINED_DIR, then ./pretrained
IMAGENET_SEARCH_DIRS = [
    os.path.expanduser("~/.keras/models"),
    os.environ.get("TDNET_PRETRAINED_DIR", ""),
    "./pretrained",
]

_IMAGENET_FILENAMES = {
    "resnet50": ["ResNet-50-model.keras.h5", "resnet50_imagenet.h5"],
    "resnet101": ["ResNet-101-model.keras.h5", "resnet101_imagenet.h5"],
    "resnet152": ["ResNet-152-model.keras.h5", "resnet152_imagenet.h5"],
}

# the reference's tdnet/data/image.py CAFFE_MEAN_BGR
_CAFFE_MEAN_BGR = np.array([103.939, 116.779, 123.68], dtype=np.float32)


def find_imagenet_weights(backbone_name: str) -> Optional[str]:
    """A locally cached ImageNet ``.h5`` for ``backbone_name``, or None."""
    for directory in IMAGENET_SEARCH_DIRS:
        if not directory or not os.path.isdir(directory):
            continue
        for fname in _IMAGENET_FILENAMES.get(backbone_name, []):
            path = os.path.join(directory, fname)
            if os.path.isfile(path):
                return path
    return None


def imagenet_weights_or_explain(backbone_name: str) -> str:
    """``--imagenet-weights`` -> a local path, or raise with the recipe."""
    path = find_imagenet_weights(backbone_name)
    if path:
        return path
    raise FileNotFoundError(
        f"no local ImageNet weights found for {backbone_name!r} (searched "
        f"{[d for d in IMAGENET_SEARCH_DIRS if d]} for "
        f"{_IMAGENET_FILENAMES.get(backbone_name)}). This environment has no "
        "network egress; either (a) place the keras-resnet release h5 (e.g. "
        "ResNet-50-model.keras.h5) in one of those directories or set "
        "TDNET_PRETRAINED_DIR, or (b) train with --bn-warmup N to estimate "
        "BatchNorm statistics from N batches of your data instead."
    )


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
        from tdnet_torch.compat.keras_import import load_keras_retinanet_h5

        return load_keras_retinanet_h5(path, template, backbone_name=backbone_name,
                                       strict=False, verbose=verbose)

    raise ValueError(
        f"unrecognized weights file {path!r} (expected .tdn, .h5/.hdf5, or "
        "one of the port's checkpoint directories; a reference orbax snapshot "
        "converts to a .tdn with the reference's convert_model)"
    )


def bn_warmup(model, variables: Dict[str, Any], batches: Iterable,
              num_batches: int = 100, preprocess_mode: str = "caffe",
              verbose: bool = True, device=None) -> Dict[str, Any]:
    """Re-estimate the FrozenBatchNorm statistics from data: load
    ``variables`` into ``model`` on ``device`` (CUDA unless told
    otherwise), run ``num_batches`` forward passes with the stored
    statistics (none is updated between passes), record each BN input's
    float32 mean and mean of squares over the batch and spatial axes,
    average them over the batches, and write ``mean`` and ``var = max(
    sq_mean - mean**2, 1e-6)`` -> ``{params, batch_stats}`` (numpy).

    uint8 batches, (B, H, W, 3) or the prefetcher's packed (B, H, W*3)
    rows, are normalized on the host as the reference does (caffe ``x -
    mean``, tf ``(x - 127.5) / 127.5``); float batches are taken as
    normalized. The passes run the unfused modules in the model's compute
    dtype: the fused stem and bottleneck kernels fold BN into the kernel,
    so the BN inputs would never exist.

    Later BNs see activations computed with the old statistics of earlier
    ones, as in the reference: an initialization aid, not a substitute for
    pretrained weights.
    """
    import torch

    from tdnet_torch.device import resolve_device
    from tdnet_torch.models.layers import recording_bn_inputs
    from tdnet_torch.weights import torch_state_from_variables

    dev = resolve_device(device)
    model.load_state_dict(torch_state_from_variables(variables))
    model.to(device=dev, memory_format=torch.channels_last)
    sums, count = None, 0
    it = iter(batches)
    with torch.no_grad(), recording_bn_inputs(model) as records:
        for _ in range(num_batches):
            try:
                batch = next(it)
            except StopIteration:
                break
            images = np.asarray(batch["images"] if isinstance(batch, dict) else batch)
            if images.dtype == np.uint8:
                if images.ndim == 3:
                    b, h, w3 = images.shape
                    images = images.reshape(b, h, w3 // 3, 3)
                x = images.astype(np.float32)
                if preprocess_mode == "caffe":
                    images = x - _CAFFE_MEAN_BGR
                else:
                    images = (x - 127.5) / 127.5
            model(torch.from_numpy(np.ascontiguousarray(images)).to(dev),
                  stem_input=False, block_kernel=False)
            moments = {name: tuple(t.cpu().numpy() for t in calls[0])
                       for name, calls in records.items() if calls}
            for calls in records.values():
                calls.clear()
            if sums is None:
                sums = moments
            else:
                sums = {k: (sums[k][0] + m[0], sums[k][1] + m[1])
                        for k, m in moments.items()}
            count += 1
    if count == 0:
        raise ValueError("bn_warmup got no batches")

    stats = _copy_tree(variables.get("batch_stats", {}))
    for name, (mean_sum, sq_sum) in sums.items():
        mean, sq_mean = mean_sum / count, sq_sum / count
        node = stats
        for key in name.split("."):
            node = node[key]
        node["mean"] = mean
        node["var"] = np.maximum(sq_mean - mean * mean, 1e-6)
    if verbose:
        print(f"bn_warmup: re-estimated BatchNorm statistics from {count} batches")
    return {"params": variables["params"], "batch_stats": stats}


def _copy_tree(tree):
    return {k: _copy_tree(v) if isinstance(v, dict) else v for k, v in tree.items()}

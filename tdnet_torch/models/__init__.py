"""Models: the backbones (ResNet, SE-ResNet, VGG, DenseNet, MobileNet),
FPN + subnets (RetinaNet), inference tail; and the backbone registry, the
counterpart of ``tdnet/models/__init__.py``.

``backbone(name)`` returns a descriptor with the name and the preprocess
mode the CLIs need, for every name the reference knows. The package
exports the names of ``tdnet/models/__init__.py``, and has its
``load_model`` and ``convert_model``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tdnet_torch.models.detect import decode_boxes, detections_from_outputs
from tdnet_torch.models.resnet import ResNet
from tdnet_torch.models.retinanet import RetinaNet

__all__ = [
    "Backbone",
    "backbone",
    "RetinaNet",
    "ResNet",
    "detections_from_outputs",
    "decode_boxes",
]


@dataclass(frozen=True)
class Backbone:
    """Descriptor for a registered backbone family."""

    name: str
    preprocess_mode: str  # data/image.py preprocess_image mode

    def retinanet(self, num_classes: int, dtype: torch.dtype = torch.float32,
                  **kwargs):
        """The RetinaNet on this backbone."""
        return RetinaNet(num_classes, backbone=self.name, dtype=dtype, **kwargs)

    def validate(self) -> None:
        if self.name not in _REGISTRY:
            raise ValueError(
                f"backbone {self.name!r} not implemented; available: {sorted(_REGISTRY)}"
            )


# Preprocessing modes follow the reference backbones: ResNet/SE-ResNet/VGG
# use caffe (BGR + mean subtraction); MobileNet/DenseNet use tf ([-1, 1]
# scaling).
_REGISTRY = {
    "resnet50": Backbone("resnet50", "caffe"),
    "resnet101": Backbone("resnet101", "caffe"),
    "resnet152": Backbone("resnet152", "caffe"),
    "seresnet50": Backbone("seresnet50", "caffe"),
    "seresnet101": Backbone("seresnet101", "caffe"),
    "seresnet152": Backbone("seresnet152", "caffe"),
    "vgg16": Backbone("vgg16", "caffe"),
    "vgg19": Backbone("vgg19", "caffe"),
    "densenet121": Backbone("densenet121", "tf"),
    "densenet169": Backbone("densenet169", "tf"),
    "densenet201": Backbone("densenet201", "tf"),
    "mobilenet": Backbone("mobilenet", "tf"),
    "mobilenet_0.75": Backbone("mobilenet_0.75", "tf"),
    "mobilenet_0.5": Backbone("mobilenet_0.5", "tf"),
}


def backbone(name: str) -> Backbone:
    """Look up a backbone by name (reference: models/__init__.py backbone())."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown backbone {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def load_model(path: str, **kwargs):
    """The reference's ``models.load_model``: a ``.tdn`` bundle -> (model,
    variables, meta); see ``models/io.py``."""
    from tdnet_torch.models.io import load_model as _load

    return _load(path, **kwargs)


def convert_model(model, variables, anchor_params=None, nms=True,
                  class_specific_filter=True, **inference_overrides):
    """The reference's ``models.convert_model``: a Predictor wired with the
    inference tail (decode, clip, NMS), the runtime form of the reference's
    retinanet_bbox-converted graph."""
    from tdnet_torch.train.predictor import Predictor

    return Predictor(model, variables, anchor_params=anchor_params, nms=nms,
                     class_specific_filter=class_specific_filter, **inference_overrides)

"""Each name of the reference packages' ``__all__`` (``tdnet/ops``,
``tdnet/data``, ``tdnet/train``, ``tdnet/models``) imports from the port's
package of the same name, and the reference models package's extra API
(``load_model``, ``convert_model``, ``Backbone.validate``) behaves as
there."""

import importlib

import numpy as np
import pytest

PACKAGES = ("ops", "data", "train", "models")
NAMES = [(pkg, name) for pkg in PACKAGES
         for name in importlib.import_module(f"tdnet.{pkg}").__all__]


def test_reference_counts():
    counts = {pkg: len(importlib.import_module(f"tdnet.{pkg}").__all__) for pkg in PACKAGES}
    assert counts == {"ops": 14, "data": 15, "train": 5, "models": 6}


@pytest.mark.parametrize("pkg,name", NAMES, ids=[f"{p}.{n}" for p, n in NAMES])
def test_reference_name_imports_from_the_port(pkg, name):
    port = importlib.import_module(f"tdnet_torch.{pkg}")
    assert name in port.__all__
    assert getattr(port, name) is not None


def test_models_load_convert_and_validate(tmp_path):
    """``models.load_model`` reads a ``.tdn`` as ``models/io.py`` does,
    ``models.convert_model`` wraps the model in a Predictor with the
    inference tail, ``Backbone.validate`` raises the reference's message
    for a name outside the registry."""
    import torch

    from tdnet_torch import models
    from tdnet_torch.models.io import save_model
    from tdnet_torch.train.predictor import Predictor
    from tdnet_torch.weights import random_variables

    v = random_variables(2, "mobilenet_0.5", seed=0)
    model = models.backbone("mobilenet_0.5").retinanet(2)
    path = tmp_path / "m.tdn"
    save_model(str(path), model, v)
    loaded, variables, meta = models.load_model(str(path))
    assert loaded.num_classes == 2 and loaded.backbone_name == "mobilenet_0.5"
    np.testing.assert_array_equal(variables["params"]["classification_submodel"]["head"]["bias"],
                                  v["params"]["classification_submodel"]["head"]["bias"])
    pred = models.convert_model(loaded, variables, device="cpu", nms=True,
                                class_specific_filter=False, min_side=32, max_side=48)
    assert isinstance(pred, Predictor)
    boxes, scores, labels = pred.predict_batch([np.zeros((32, 48, 3), np.float32)])[0]
    assert boxes.shape == (300, 4) and scores.shape == labels.shape == (300,)
    models.backbone("resnet50").validate()
    with pytest.raises(ValueError, match="not implemented; available"):
        models.Backbone("resnet18", "caffe").validate()
    assert torch.float32 == loaded.dtype

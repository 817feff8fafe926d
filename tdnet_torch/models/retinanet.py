"""RetinaNet: a backbone + FPN + shared subnets, the counterpart of
``tdnet/models/retinanet.py``.

- Backbones (``build_backbone``, the reference's ``_build_backbone``):
  ResNet-50/101/152, SE-ResNet-50/101/152 (``seresnet<n>``: the ResNet's
  stages with ``se_ratio`` 1/16), VGG-16/19, DenseNet-121/169/201 and
  MobileNet (``mobilenet[_<alpha>]``).

- FPN: P5 = 1x1(C5); P4 = 1x1(C4) + nearest-up(P5 before its 3x3); P3
  likewise; P3..P5 then 3x3; P6 = 3x3/2 on C5; P7 = 3x3/2 on ReLU(P6). All
  'SAME' with bias; at C5 25x42 (the 800x1344 bucket) TF pads P6's rows
  (1, 1) and its cols (0, 1).
- Subnets: 4 x [3x3(256) + ReLU] + head, weights shared across levels.
- Each level's output is flattened in NHWC order (the anchor order) and the
  levels are concatenated P3 -> P7. :func:`retinanet_tail` (the reference's
  ``apply_retinanet_tail``) is FPN, subnets and flatten in one function:
  ``RetinaNet.forward`` and the pipeline's head stage
  (``parallel/pipeline.py``) both call it. In the band form
  (``parallel/spatial.py``) it gathers each level's head outputs over the
  spatial group before the flatten.

``forward`` takes NHWC images (or, with ``stem_input``, the NHWC pooled stem
activations: ResNets and SE-ResNets only) like the flax model and runs NCHW
``channels_last`` inside; an NHWC-contiguous tensor permuted to NCHW is
exactly that, with no copy. Classification is returned as logits.
``block_kernel`` routes a plain ResNet's identity bottlenecks through the
fused kernel (inference only, same state dict); ``forward(...,
block_kernel=...)`` overrides it for one call, and other backbones ignore
it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tdnet_torch.models.densenet import DENSENET_BLOCKS, DenseNet
from tdnet_torch.models.layers import Conv2d, resize_nearest_like
from tdnet_torch.models.mobilenet import MobileNet
from tdnet_torch.models.resnet import STAGE_SIZES, ResNet
from tdnet_torch.models.vgg import VGG, VGG_STAGES
from tdnet_torch.parallel.spatial import gather_rows

__all__ = ["RetinaNet", "FPN", "Subnet", "build_backbone", "takes_fused_stem",
           "retinanet_tail"]


def takes_fused_stem(backbone_name: str) -> bool:
    """Whether the backbone starts with the ResNet stem that the fused
    ingest+stem kernels compute: ResNets and SE-ResNets (the reference's
    ``backbone_name.lstrip("se").startswith("resnet")``)."""
    return backbone_name.removeprefix("se").startswith("resnet")


def build_backbone(name: str, dtype: torch.dtype = torch.float32,
                   block_kernel: bool = False) -> nn.Module:
    """A C3/C4/C5 feature extractor by registry name (reference:
    ``tdnet/models/retinanet.py`` ``_build_backbone``); its ``channels``
    are the taps' widths. ``block_kernel`` applies to plain ResNets only."""
    if name in STAGE_SIZES:
        return ResNet(STAGE_SIZES[name], dtype=dtype, block_kernel=block_kernel)
    if name.startswith("seresnet") and name[2:] in STAGE_SIZES:
        return ResNet(STAGE_SIZES[name[2:]], dtype=dtype, se_ratio=1.0 / 16)
    if name in VGG_STAGES:
        return VGG(VGG_STAGES[name], dtype=dtype)
    if name in DENSENET_BLOCKS:
        return DenseNet(DENSENET_BLOCKS[name], dtype=dtype)
    if name.startswith("mobilenet"):
        # 'mobilenet224_1.0' style names (reference) or plain 'mobilenet'
        alpha = float(name.split("_")[-1]) if "_" in name else 1.0
        return MobileNet(alpha, dtype=dtype)
    raise ValueError(
        f"unknown backbone {name!r}; available: resnet50/101/152, "
        "seresnet50/101/152, vgg16/19, densenet121/169/201, "
        "mobilenet[_<alpha>]"
    )


class FPN(nn.Module):
    """Pyramid features P3..P7 from C3/C4/C5."""

    def __init__(self, c3: int = 512, c4: int = 1024, c5: int = 2048,
                 feature_size: int = 256):
        super().__init__()
        f = feature_size
        self.C5_reduced = Conv2d(c5, f, 1)
        self.P5 = Conv2d(f, f, 3)
        self.C4_reduced = Conv2d(c4, f, 1)
        self.P4 = Conv2d(f, f, 3)
        self.C3_reduced = Conv2d(c3, f, 1)
        self.P3 = Conv2d(f, f, 3)
        self.P6 = Conv2d(c5, f, 3, stride=2)
        self.P7 = Conv2d(f, f, 3, stride=2)

    def forward(self, c3, c4, c5):
        p5 = self.C5_reduced(c5)
        p5_up = resize_nearest_like(p5, c4.shape[2:4])
        p5 = self.P5(p5)
        p4 = self.C4_reduced(c4) + p5_up
        p4_up = resize_nearest_like(p4, c3.shape[2:4])
        p4 = self.P4(p4)
        p3 = self.P3(self.C3_reduced(c3) + p4_up)
        p6 = self.P6(c5)
        p7 = self.P7(torch.relu(p6))
        return p3, p4, p5, p6, p7


class Subnet(nn.Module):
    """depth x [3x3 conv + ReLU] tower + a 3x3 head."""

    def __init__(self, out_channels: int, feature_size: int = 256,
                 depth: int = 4):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"conv{i}", Conv2d(feature_size, feature_size, 3))
        self.head = Conv2d(feature_size, out_channels, 3)

    def forward(self, x):
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        return self.head(x)


def retinanet_tail(fpn: FPN, regression_submodel: Subnet,
                   classification_submodel: Subnet, c3, c4, c5, num_classes: int,
                   output_dtype: Optional[torch.dtype] = torch.float32
                   ) -> Dict[str, torch.Tensor]:
    """FPN + shared subnets + the per-level flatten from the NCHW backbone
    taps, the reference's ``apply_retinanet_tail``: (B, N, 4) regression
    and (B, N, C) logits in ``output_dtype`` (None: the heads' dtype)."""
    features = fpn(c3, c4, c5)
    b = c3.shape[0]
    flat = lambda t, n: gather_rows(t).permute(0, 2, 3, 1).reshape(b, -1, n)
    regression = torch.cat([flat(regression_submodel(f), 4) for f in features], dim=1)
    classification = torch.cat(
        [flat(classification_submodel(f), num_classes) for f in features], dim=1)
    if output_dtype is not None:
        regression = regression.to(output_dtype)
        classification = classification.to(output_dtype)
    return {"regression": regression, "classification": classification}


class RetinaNet(nn.Module):
    """NHWC images -> {"regression": (B, N, 4), "classification": (B, N, C)
    logits}. ``dtype`` is the compute dtype; ``output_dtype=None`` keeps
    the heads' dtype at the boundary (the deferred tail upcasts only its K
    candidates)."""

    def __init__(self, num_classes: int, backbone: str = "resnet50",
                 num_anchors: int = 9, feature_size: int = 256,
                 prior_probability: float = 0.01,
                 dtype: torch.dtype = torch.float32,
                 output_dtype: Optional[torch.dtype] = torch.float32,
                 block_kernel: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.backbone_name = backbone
        self.num_anchors = num_anchors
        self.feature_size = feature_size
        # the class head's initial bias (random_variables); kept for the
        # .tdn bundle's model record
        self.prior_probability = prior_probability
        self.dtype = dtype
        self.output_dtype = output_dtype
        self.backbone = build_backbone(backbone, dtype, block_kernel)
        self.fpn = FPN(*self.backbone.channels, feature_size=feature_size)
        self.regression_submodel = Subnet(num_anchors * 4, feature_size)
        self.classification_submodel = Subnet(num_anchors * num_classes,
                                              feature_size)

    def stem_params(self):
        """The backbone's stem for the fused ingest+stem kernels
        (``ResNet.stem_params``); other families raise, as the reference's
        ``stem_input`` does."""
        self._require_resnet()
        return self.backbone.stem_params()

    def _require_resnet(self) -> None:
        if not isinstance(self.backbone, ResNet):
            raise ValueError(
                f"stem_input is ResNet-only, got backbone {self.backbone_name!r}")

    def forward(self, images: torch.Tensor, stem_input: bool = False,
                block_kernel: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        x = images.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        if stem_input:
            self._require_resnet()
        if isinstance(self.backbone, ResNet):
            c3, c4, c5 = self.backbone(x, stem_input=stem_input,
                                       block_kernel=block_kernel)
        else:
            c3, c4, c5 = self.backbone(x)
        return retinanet_tail(self.fpn, self.regression_submodel,
                              self.classification_submodel, c3, c4, c5,
                              self.num_classes, self.output_dtype)

"""RetinaNet: ResNet + FPN + shared subnets, the counterpart of
``tdnet/models/retinanet.py``.

- FPN: P5 = 1x1(C5); P4 = 1x1(C4) + nearest-up(P5 before its 3x3); P3
  likewise; P3..P5 then 3x3; P6 = 3x3/2 on C5; P7 = 3x3/2 on ReLU(P6). All
  'SAME' with bias; at C5 25x42 (the 800x1344 bucket) TF pads P6's rows
  (1, 1) and its cols (0, 1).
- Subnets: 4 x [3x3(256) + ReLU] + head, weights shared across levels.
- Each level's output is flattened in NHWC order (the anchor order) and the
  levels are concatenated P3 -> P7.

``forward`` takes NHWC images (or, with ``stem_input``, the NHWC pooled stem
activations) like the flax model and runs NCHW ``channels_last`` inside; an
NHWC-contiguous tensor permuted to NCHW is exactly that, with no copy.
Classification is returned as logits. ``block_kernel`` routes the
backbone's identity bottlenecks through the fused kernel (inference only,
same state dict); ``forward(..., block_kernel=...)`` overrides it for one
call.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tdnet_torch.models.layers import Conv2d, resize_nearest_like
from tdnet_torch.models.resnet import STAGE_SIZES, ResNet

__all__ = ["RetinaNet", "FPN", "Subnet"]


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


class RetinaNet(nn.Module):
    """NHWC images -> {"regression": (B, N, 4), "classification": (B, N, C)
    logits}. ``dtype`` is the compute dtype; ``output_dtype=None`` keeps
    the heads' dtype at the boundary (the deferred tail upcasts only its K
    candidates)."""

    def __init__(self, num_classes: int, backbone: str = "resnet50",
                 num_anchors: int = 9, feature_size: int = 256,
                 dtype: torch.dtype = torch.float32,
                 output_dtype: Optional[torch.dtype] = torch.float32,
                 block_kernel: bool = False):
        super().__init__()
        if backbone not in STAGE_SIZES:
            raise NotImplementedError(
                f"backbone {backbone!r} is not ported yet (ROADMAP A15); "
                f"ported: {sorted(STAGE_SIZES)}")
        self.num_classes = num_classes
        self.backbone_name = backbone
        self.num_anchors = num_anchors
        self.dtype = dtype
        self.output_dtype = output_dtype
        self.backbone = ResNet(STAGE_SIZES[backbone], dtype=dtype,
                               block_kernel=block_kernel)
        self.fpn = FPN(feature_size=feature_size)
        self.regression_submodel = Subnet(num_anchors * 4, feature_size)
        self.classification_submodel = Subnet(num_anchors * num_classes,
                                              feature_size)

    def forward(self, images: torch.Tensor, stem_input: bool = False,
                block_kernel: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        x = images.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        c3, c4, c5 = self.backbone(x, stem_input=stem_input,
                                   block_kernel=block_kernel)
        features = self.fpn(c3, c4, c5)
        b = images.shape[0]
        flat = lambda t, n: t.permute(0, 2, 3, 1).reshape(b, -1, n)
        regression = torch.cat(
            [flat(self.regression_submodel(f), 4) for f in features], dim=1)
        classification = torch.cat(
            [flat(self.classification_submodel(f), self.num_classes)
             for f in features], dim=1)
        if self.output_dtype is not None:
            regression = regression.to(self.output_dtype)
            classification = classification.to(self.output_dtype)
        return {"regression": regression, "classification": classification}

"""MobileNetV1 backbone, the counterpart of ``tdnet/models/mobilenet.py``.

A 3x3/2 conv, then 13 depthwise-separable blocks (a depthwise 3x3 at the
block's stride, a pointwise 1x1), each conv without bias and followed by a
frozen BatchNorm (eps 1e-3) and ReLU6; widths are ``int(filters * alpha)``.
Every 3x3 pads TF 'SAME', so a stride-2 conv on an even size pads (0, 1).
C3/C4/C5 are the outputs of blocks 5/11/13 (strides 8/16/32). Module names
follow the flax tree (``conv1``, ``bn_conv1``, ``conv_dw_{i}``,
``bn_dw_{i}``, ``conv_pw_{i}``, ``bn_pw_{i}``).
"""

from __future__ import annotations

import torch
from torch import nn

from tdnet_torch.models.layers import Conv2d, FrozenBatchNorm

__all__ = ["MobileNet"]

# (pointwise filters, stride) of each depthwise-separable block
_BLOCKS = [
    (64, 1),
    (128, 2), (128, 1),
    (256, 2), (256, 1),          # block 5 -> C3 (stride 8)
    (512, 2), (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),  # 11 -> C4
    (1024, 2), (1024, 1),        # 13 -> C5 (stride 32)
]
_TAPS = (5, 11, 13)
_EPS = 1e-3


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x).clamp_max(6.0)


class MobileNet(nn.Module):
    """(C3, C4, C5) from NCHW images."""

    def __init__(self, alpha: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = int(32 * alpha)
        self.conv1 = Conv2d(3, cin, 3, 2, bias=False)
        self.bn_conv1 = FrozenBatchNorm(cin, _EPS)
        for i, (filters, stride) in enumerate(_BLOCKS, start=1):
            f = int(filters * alpha)
            self.add_module(f"conv_dw_{i}", Conv2d(cin, cin, 3, stride, bias=False,
                                                   groups=cin))
            self.add_module(f"bn_dw_{i}", FrozenBatchNorm(cin, _EPS))
            self.add_module(f"conv_pw_{i}", Conv2d(cin, f, 1, bias=False))
            self.add_module(f"bn_pw_{i}", FrozenBatchNorm(f, _EPS))
            cin = f
        self.channels = tuple(int(_BLOCKS[i - 1][0] * alpha) for i in _TAPS)

    def forward(self, x: torch.Tensor):
        x = _relu6(self.bn_conv1(self.conv1(x.to(self.dtype))))
        taps = []
        for i in range(1, len(_BLOCKS) + 1):
            x = _relu6(getattr(self, f"bn_dw_{i}")(getattr(self, f"conv_dw_{i}")(x)))
            x = _relu6(getattr(self, f"bn_pw_{i}")(getattr(self, f"conv_pw_{i}")(x)))
            if i in _TAPS:
                taps.append(x)
        return tuple(taps)

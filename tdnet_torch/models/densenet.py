"""DenseNet-BC 121/169/201 backbone, the counterpart of
``tdnet/models/densenet.py``.

- stem: explicit zero pad 3 -> 7x7/2 conv (no bias) -> frozen BN -> ReLU ->
  3x3/2 max-pool with TF 'SAME' padding;
- dense blocks of layers BN -> ReLU -> 1x1 (4 x growth 32) -> BN -> ReLU
  -> 3x3 'SAME' (growth), each output concatenated to its input;
- transitions between blocks: BN -> ReLU -> 1x1 to half the channels ->
  2x2/2 VALID average pool (odd sizes floor).

C3/C4/C5 are the outputs of dense blocks 2/3/4 (strides 8/16/32; the
modules count the blocks from 2: ``block3_layer{i}`` is the second block).
Module names follow the flax tree (``conv1``, ``bn1``,
``block{b}_layer{i}.{bn1,conv1,bn2,conv2}``, ``transition{b}_bn``,
``transition{b}_conv``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tdnet_torch.models.layers import Conv2d, FrozenBatchNorm
from tdnet_torch.models.resnet import StemConv, max_pool_same
from tdnet_torch.models.vgg import pool_valid

__all__ = ["DenseNet", "DENSENET_BLOCKS"]

DENSENET_BLOCKS = {
    "densenet121": (6, 12, 24, 16),
    "densenet169": (6, 12, 32, 32),
    "densenet201": (6, 12, 48, 32),
}


class _DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int):
        super().__init__()
        self.bn1 = FrozenBatchNorm(cin)
        self.conv1 = Conv2d(cin, 4 * growth_rate, 1, bias=False)
        self.bn2 = FrozenBatchNorm(4 * growth_rate)
        self.conv2 = Conv2d(4 * growth_rate, growth_rate, 3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(torch.relu(self.bn1(x)))
        y = self.conv2(torch.relu(self.bn2(y)))
        return torch.cat([x, y], dim=1)


class DenseNet(nn.Module):
    """(C3, C4, C5) from NCHW images."""

    def __init__(self, block_sizes: Sequence[int] = DENSENET_BLOCKS["densenet121"],
                 growth_rate: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.block_sizes = tuple(block_sizes)
        self.conv1 = StemConv(64)
        self.bn1 = FrozenBatchNorm(64)
        c, taps = 64, []
        for b, n_layers in enumerate(self.block_sizes):
            for i in range(n_layers):
                self.add_module(f"block{b + 2}_layer{i}", _DenseLayer(c, growth_rate))
                c += growth_rate
            if b >= 1:
                taps.append(c)
            if b != len(self.block_sizes) - 1:
                self.add_module(f"transition{b + 2}_bn", FrozenBatchNorm(c))
                self.add_module(f"transition{b + 2}_conv", Conv2d(c, c // 2, 1, bias=False))
                c //= 2
        self.channels = tuple(taps)

    def forward(self, x: torch.Tensor):
        x = torch.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = max_pool_same(x)
        taps = []
        for b, n_layers in enumerate(self.block_sizes):
            for i in range(n_layers):
                x = getattr(self, f"block{b + 2}_layer{i}")(x)
            if b >= 1:
                taps.append(x)
            if b != len(self.block_sizes) - 1:
                x = torch.relu(getattr(self, f"transition{b + 2}_bn")(x))
                x = pool_valid(getattr(self, f"transition{b + 2}_conv")(x), F.avg_pool2d)
        return tuple(taps)

"""VGG-16/19 backbone, the counterpart of ``tdnet/models/vgg.py``.

Blocks of 3x3 'SAME' convs with bias and ReLU, each closed by a 2x2/2
VALID max-pool (odd sizes floor); C3/C4/C5 are the block3/4/5 pools
(strides 8/16/32). No BatchNorm. Module names follow the flax tree
(``block{b}_conv{i}``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tdnet_torch.models.layers import Conv2d
from tdnet_torch.parallel import spatial

__all__ = ["VGG", "VGG_STAGES", "pool_valid"]

# convs a block
VGG_STAGES = {
    "vgg16": (2, 2, 3, 3, 3),
    "vgg19": (2, 2, 4, 4, 4),
}
_WIDTHS = (64, 128, 256, 512, 512)


def pool_valid(x: torch.Tensor, pool) -> torch.Tensor:
    """A 2x2/2 VALID pool (``F.max_pool2d`` or ``F.avg_pool2d``; odd sizes
    floor); in the band form, this rank's band of output rows."""
    bands = spatial.active()
    if bands is None:
        return pool(x, 2, stride=2)
    window, empty = bands.window(x, 2, 2, (0, 0), (0, 0))
    y = pool(window, 2, stride=2)
    return y[:, :, :0] if empty else y


class VGG(nn.Module):
    """(C3, C4, C5) from NCHW images."""

    def __init__(self, stage_sizes: Sequence[int] = VGG_STAGES["vgg16"],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        self.channels = _WIDTHS[2:]
        cin = 3
        for block, (n_convs, width) in enumerate(zip(self.stage_sizes, _WIDTHS)):
            for i in range(n_convs):
                self.add_module(f"block{block + 1}_conv{i + 1}", Conv2d(cin, width, 3))
                cin = width

    def forward(self, x: torch.Tensor):
        x = x.to(self.dtype)
        taps = []
        for block, n_convs in enumerate(self.stage_sizes):
            for i in range(n_convs):
                x = torch.relu(getattr(self, f"block{block + 1}_conv{i + 1}")(x))
            x = pool_valid(x, F.max_pool2d)
            if block >= 2:
                taps.append(x)
        return tuple(taps)

"""ResNet-50/101/152 backbone with C3/C4/C5 taps, the counterpart of
``tdnet/models/resnet.py`` (keras-resnet v1 bottlenecks).

- stem: explicit zero pad 3 -> 7x7/2 conv (no bias) -> frozen BN -> ReLU
  -> 3x3/2 max-pool with TF 'SAME' padding (on even dims that pads (0, 1)
  with -inf, which ``nn.MaxPool2d(padding=1)`` would get wrong);
- bottlenecks with the stride on the FIRST 1x1 conv, a projection shortcut
  on each stage's first block, stage strides 1, 2, 2, 2.

Module names follow the flax tree (``conv1``, ``bn1``,
``stage{2..5}_block{i}``) so the weight bridge is a rename. ``forward``
takes NCHW (``channels_last``) activations; with ``stem_input=True`` the
input is the pooled stem output (B, 64, H/4, W/4) from the fused ingest+stem
kernel. With ``block_kernel`` each stage's identity run (blocks 1..n-1)
goes through the fused bottleneck kernel (``tdnet_torch/ops/block.py``) as
one chain wherever ``supports_block`` admits the stage, as
``tdnet/models/resnet.py`` ``_identity_run`` does; the state dict is the
same either way. The kernel launches once per block, so the reference's
``TDNET_CHAIN_DEPTH`` (how many blocks share a launch) has no counterpart.
SE-ResNet is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tdnet_torch.models.layers import Conv2d, FrozenBatchNorm, same_pads
from tdnet_torch.ops.block import fused_bottleneck_chain, kmajor_weights, supports_block

__all__ = ["STAGE_SIZES", "Bottleneck", "StemConv", "ResNet", "max_pool_same"]

STAGE_SIZES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """k x k / s max-pool with TF 'SAME' padding (pads hold -inf)."""
    ph = same_pads(x.shape[2], k, s)
    pw = same_pads(x.shape[3], k, s)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, stride=s)


class Bottleneck(nn.Module):
    """1x1(/s) -> 3x3 -> 1x1(x4) with a post-activation residual."""

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 projection: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, filters, 1, stride, bias=False)
        self.bn1 = FrozenBatchNorm(filters)
        self.conv2 = Conv2d(filters, filters, 3, 1, bias=False)
        self.bn2 = FrozenBatchNorm(filters)
        self.conv3 = Conv2d(filters, filters * 4, 1, 1, bias=False)
        self.bn3 = FrozenBatchNorm(filters * 4)
        if projection:
            self.conv_shortcut = Conv2d(cin, filters * 4, 1, stride, bias=False)
            self.bn_shortcut = FrozenBatchNorm(filters * 4)
        self.projection = projection

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        shortcut = self.bn_shortcut(self.conv_shortcut(x)) if self.projection else x
        return torch.relu(y + shortcut)


class StemConv(nn.Module):
    """Explicit pad 3 + VALID 7x7/2 conv, 3 -> 64, no bias."""

    def __init__(self, features: int = 64):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, 3, 7, 7))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), stride=2, padding=3)


class ResNet(nn.Module):
    """(C3, C4, C5) at strides 8/16/32 from NCHW images."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32, block_kernel: bool = False):
        super().__init__()
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        self.block_kernel = block_kernel  # inference-only
        self._chain_cache = {}  # stage -> (key, (stacked weights, K-major or None))
        self.conv1 = StemConv(64)
        self.bn1 = FrozenBatchNorm(64)
        cin, filters = 64, 64
        for stage, num_blocks in enumerate(self.stage_sizes):
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                self.add_module(
                    f"stage{stage + 2}_block{block}",
                    Bottleneck(cin, filters, stride=stride, projection=block == 0))
                cin = filters * 4
            filters *= 2

    def stem_params(self):
        """(kernel7 (7,7,3,64) float32 HWIO, bn_inv (64,), bn_off (64,)) for
        the fused ingest+stem kernel (``stem_params_from_variables``)."""
        inv, off = self.bn1.folded()
        return self.conv1.weight.permute(2, 3, 1, 0).contiguous(), inv, off

    def forward(self, x: torch.Tensor, stem_input: bool = False,
                block_kernel: Optional[bool] = None):
        """``block_kernel`` None takes the module's setting."""
        if block_kernel is None:
            block_kernel = self.block_kernel
        x = x.to(self.dtype)
        if not stem_input:
            x = torch.relu(self.bn1(self.conv1(x)))
            x = max_pool_same(x)
        outputs = []
        for stage, num_blocks in enumerate(self.stage_sizes):
            x = getattr(self, f"stage{stage + 2}_block0")(x)
            x = self._identity_run(x, stage, num_blocks - 1, block_kernel)
            outputs.append(x)
        return outputs[1], outputs[2], outputs[3]

    def _identity_run(self, x: torch.Tensor, stage: int, n: int,
                      block_kernel: bool) -> torch.Tensor:
        """Blocks 1..n of a stage: one by one, or as one chain through the
        fused kernel. A channels_last NCHW tensor is an NHWC buffer, so
        neither side of the kernel copies."""
        blocks = [getattr(self, f"stage{stage + 2}_block{i}") for i in range(1, n + 1)]
        filters = 64 * 2 ** stage
        b, c, h, w = x.shape
        if not (block_kernel and blocks and c == 4 * filters
                and supports_block((b, h, w, c), filters)):
            for block in blocks:
                x = block(x)
            return x
        weights, kmajor = self._chain_weights(stage, blocks)
        y = fused_bottleneck_chain(x.permute(0, 2, 3, 1), *weights, kmajor=kmajor)
        return y.permute(0, 3, 1, 2)

    def _chain_weights(self, stage: int, blocks):
        """The run's weights stacked for the kernel (w1s (D, C, M), w2s
        (D, 3, 3, M, M), w3s (D, M, C) in the compute dtype, folded BN in
        f32), and for bfloat16 on CUDA their K-major layout
        (``kmajor_weights``, else None), built once and rebuilt only when a
        weight is replaced or changed in place (its storage or version
        counter moves)."""
        tensors = [t for blk in blocks for t in (
            blk.conv1.weight, blk.conv2.weight, blk.conv3.weight,
            *(getattr(getattr(blk, bn), a) for bn in ("bn1", "bn2", "bn3")
              for a in ("scale", "bias", "mean", "var")))]
        key = (self.dtype, tuple((t.data_ptr(), t._version) for t in tensors))
        cached = self._chain_cache.get(stage)
        if cached is not None and cached[0] == key:
            return cached[1]
        with torch.no_grad():
            folded = [(blk.bn1.folded(), blk.bn2.folded(), blk.bn3.folded())
                      for blk in blocks]
            weights = (
                torch.stack([blk.conv1.weight[:, :, 0, 0].t() for blk in blocks]),
                torch.stack([blk.conv2.weight.permute(2, 3, 1, 0) for blk in blocks]),
                torch.stack([blk.conv3.weight[:, :, 0, 0].t() for blk in blocks]),
            )
            weights = tuple(t.to(self.dtype).contiguous() for t in weights) + tuple(
                torch.stack([f[i][j] for f in folded]).contiguous()
                for i in range(3) for j in range(2))
        kmajor = (kmajor_weights(*weights[:3])
                  if self.dtype == torch.bfloat16 and weights[0].is_cuda else None)
        self._chain_cache[stage] = (key, (weights, kmajor))
        return weights, kmajor

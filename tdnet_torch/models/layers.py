"""Shared building blocks, the counterpart of ``tdnet/models/layers.py``:
frozen BatchNorm, a conv with TensorFlow 'SAME' padding (grouped too, for
MobileNet's depthwise convs), a dense layer (the SE gate's) and the TF1
nearest resize.

Activations are NCHW tensors in ``channels_last`` memory (an NHWC buffer
seen through ``.permute(0, 3, 1, 2)``); parameters are float32 and are
rounded to the activation dtype where they are used, as flax's
``dtype``/``param_dtype`` split does.

The same modules carry the 2-D parallel forms: inside
``parallel/spatial.py`` ``spatial_bands`` a conv and the resize compute
this rank's band of rows from the global geometry, and a conv or dense
layer whose weight ``parallel/tensor.py`` ``shard_state`` cut (its ``tp``
flag) computes its output-channel slice and gathers the channels.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tdnet_torch.parallel import spatial
from tdnet_torch.parallel.tensor import column_parallel

__all__ = ["FrozenBatchNorm", "recording_bn_inputs", "Conv2d", "Dense",
           "conv2d", "same_pads", "resize_nearest_like"]


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm with stored statistics (keras-resnet
    freeze_bn, eps 1e-5; MobileNet's 1e-3). Folds in f32 to
    ``inv = rsqrt(var + eps) * scale``, ``off = bias - mean * inv``, then
    computes ``x * inv + off`` in the activation dtype."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def folded(self):
        """(inv, off) float32 (features,)."""
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale
        return inv, self.bias - self.mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv, off = self.folded()
        return x * inv.to(x.dtype)[:, None, None] + off.to(x.dtype)[:, None, None]


def _record_input(sink: list, module, args) -> None:
    x = args[0].float()
    sink.append((x.mean(dim=(0, 2, 3)), x.square().mean(dim=(0, 2, 3))))


@contextlib.contextmanager
def recording_bn_inputs(
        model: nn.Module) -> Iterator[Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]]:
    """Within the block, every FrozenBatchNorm of ``model`` records its
    input's float32 mean and mean of squares over the batch and spatial
    axes, a (mean, sq_mean) pair a call, under its module name (the
    counterpart of the guarded ``sow`` of ``tdnet/models/layers.py``). The
    hooks exist only inside the block, so other calls pay nothing."""
    records: Dict[str, list] = {}
    handles = []
    try:
        for name, module in model.named_modules():
            if isinstance(module, FrozenBatchNorm):
                records[name] = []
                handles.append(module.register_forward_pre_hook(
                    functools.partial(_record_input, records[name])))
        yield records
    finally:
        for handle in handles:
            handle.remove()


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, **kw) -> torch.Tensor:
    """``F.conv2d`` with the float32 weight and bias rounded to the input's
    dtype. A bfloat16 conv on the CPU is computed in float32 and its result
    rounded to bfloat16, as XLA's CPU backend computes the reference's:
    oneDNN's bfloat16 kernels returned NaN for ResNet-50's P6 at a 64x96
    canvas in the train CLI's first steps of a process, and finite values
    for the same call repeated."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        b = None if bias is None else bias.float()
        return F.conv2d(x.float(), weight.float(), b, **kw).to(torch.bfloat16)
    b = None if bias is None else bias.to(x.dtype)
    return F.conv2d(x, weight.to(x.dtype), b, **kw)


def same_pads(n: int, k: int, s: int):
    """TensorFlow 'SAME' padding (before, after) of one spatial dim."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """k x k conv with TF 'SAME' padding (1x1: none); the weight is float32
    OIHW and is rounded to the input dtype at the call, like flax
    ``nn.Conv(dtype=..., param_dtype=float32)``. ``groups`` is flax's
    ``feature_group_count``: a depthwise conv's weight is (C, 1, k, k), the
    bridge's image of flax's (k, k, 1, C)."""

    tp = None  # parallel/tensor.py: the grid whose model axis cut the weight

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = True, groups: int = 1):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self._conv(x, self.weight, self.bias, self.groups)
        # column-parallel: this rank's C_out slice, gathered; the replicated
        # bias on the gathered channels
        depthwise = self.groups > 1
        groups = self.weight.shape[0] if depthwise else 1
        y = column_parallel(x, lambda v: self._conv(v, self.weight, None, groups),
                            self.tp, depthwise=depthwise)
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]

    def _conv(self, x, weight, bias, groups):
        conv = functools.partial(conv2d, weight=weight, bias=bias,
                                 stride=self.stride, groups=groups)
        bands = spatial.active()
        if bands is not None and x.shape[2] == 0 and self.k == self.stride == 1:
            # an empty band: one row of padding through the conv, dropped,
            # so the band stays in the graph (its fetches' backwards run)
            return conv(F.pad(x, (0, 0, 0, 1)))[:, :, :0]
        if bands is not None and not (self.k == 1 and self.stride == 1):
            # this rank's band of output rows: pads and stride phase from
            # the global height
            ph = same_pads(bands.height(x), self.k, self.stride)
            pw = same_pads(x.shape[3], self.k, self.stride)
            window, empty = bands.window(x, self.k, self.stride, ph, pw)
            y = conv(window)
            return y[:, :, :0] if empty else y
        if self.k == 1:
            return conv(x)
        ph = same_pads(x.shape[2], self.k, self.stride)
        pw = same_pads(x.shape[3], self.k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return conv(x, padding=(ph[0], pw[0]))
        # uneven (a stride-2 conv on an even size pads (0, 1))
        return conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))


class Dense(nn.Module):
    """x @ W^T + b on the last axis; the float32 (out, in) weight (flax's
    (in, out) kernel transposed by the bridge) and the bias are rounded to
    the input dtype at the call, like flax ``nn.Dense(dtype=...,
    param_dtype=float32)``."""

    tp = None  # parallel/tensor.py: the grid whose model axis cut the weight

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
        y = column_parallel(x, lambda v: F.linear(v, self.weight.to(v.dtype)),
                            self.tp, channel_dim=-1)
        return y + self.bias.to(y.dtype)


def resize_nearest_like(x: torch.Tensor, target_hw) -> torch.Tensor:
    """Nearest resize of NCHW ``x`` to (H, W) with TF1 semantics
    (align_corners=False): gather source index floor(dst * in / out). In
    the band form ``target_hw`` is the target band's shape, whose global
    height the band context knows by its width."""
    bands = spatial.active()
    if bands is not None:
        return bands.resize_rows(x, target_hw)
    h_in, w_in = x.shape[2], x.shape[3]
    h_out, w_out = int(target_hw[0]), int(target_hw[1])
    if (h_in, w_in) == (h_out, w_out):
        return x
    rows = torch.from_numpy((np.arange(h_out) * h_in) // h_out).to(x.device)
    cols = torch.from_numpy((np.arange(w_out) * w_in) // w_out).to(x.device)
    return x.index_select(2, rows).index_select(3, cols)

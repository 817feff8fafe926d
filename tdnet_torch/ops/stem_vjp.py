"""Training-path fused ingest+stem: the fused forward with a custom
backward, the counterpart of ``tdnet/ops/stem_vjp.py``.

- forward: ``fused_stem_packed`` (normalize + 7x7/2 conv + folded frozen BN
  + ReLU + 3x3/2 'SAME' max-pool in one kernel), uint8 in;
- backward ``"kernel"`` (the default of the train step): the fused backward
  ``fused_stem_bwd_packed``, which recomputes the conv and routes the pool
  gradient on the values the forward kernel pooled;
- backward ``"remat"``: autograd through :func:`stem_reference_packed`, the
  op sequence the non-fused path runs (the normalize kernel, then conv, BN,
  ReLU and pool in the compute dtype), so its routing follows that path.

In f32 the two backwards agree to rounding. In bf16 each routes on its own
forward's rounded values. The uint8 input gets no gradient; ``inv``/``off``
get one only when they require it (BN not frozen). The mesh-sharded form of
the reference waits for the parallel slice (ROADMAP A16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tdnet_torch.models.resnet import max_pool_same
from tdnet_torch.ops.ingest import normalize_uint8_rows
from tdnet_torch.ops.stem import fused_stem_bwd_packed, fused_stem_packed

__all__ = ["BACKWARDS", "fused_stem_train", "stem_reference_packed"]

BACKWARDS = ("kernel", "remat")


def stem_reference_packed(packed, kernel7, inv, off, normalize, out_dtype):
    """normalize -> pad-3 7x7/2 conv -> x*inv + off -> ReLU -> 3x3/2 'SAME'
    max-pool from packed uint8 rows, in the compute dtype with the f32
    parameters cast in (StemConv + FrozenBatchNorm). NHWC out."""
    b, h, w3 = packed.shape
    x = normalize_uint8_rows(packed.reshape(b * h, w3), normalize,
                             out_dtype=out_dtype)
    x = x.reshape(b, h, w3 // 3, 3).permute(0, 3, 1, 2)
    z = F.conv2d(x, kernel7.to(out_dtype).permute(3, 2, 0, 1), stride=2,
                 padding=3)
    a = torch.relu(z * inv.to(out_dtype)[:, None, None]
                   + off.to(out_dtype)[:, None, None])
    return max_pool_same(a).permute(0, 2, 3, 1)


class _StemTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, packed, kernel7, inv, off, normalize, out_dtype, backward):
        ctx.save_for_backward(packed, kernel7, inv, off)
        ctx.config = (normalize, out_dtype, backward)
        return fused_stem_packed(packed, kernel7, inv, off, normalize,
                                 out_dtype)

    @staticmethod
    def backward(ctx, dy):
        packed, kernel7, inv, off = ctx.saved_tensors
        normalize, out_dtype, backward = ctx.config
        if backward == "kernel":
            dk, dinv, doff = fused_stem_bwd_packed(
                packed, kernel7, inv, off, dy.contiguous(), normalize,
                out_dtype)
        else:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (kernel7, inv, off)]
                y = stem_reference_packed(packed, *leaves, normalize, out_dtype)
                dk, dinv, doff = torch.autograd.grad(y, leaves, dy)
        needs = ctx.needs_input_grad
        return (None, dk if needs[1] else None, dinv if needs[2] else None,
                doff if needs[3] else None, None, None, None)


def fused_stem_train(packed: torch.Tensor, kernel7: torch.Tensor,
                     inv: torch.Tensor, off: torch.Tensor,
                     normalize: str = "caffe", out_dtype=torch.bfloat16,
                     backward: str = "remat") -> torch.Tensor:
    """Differentiable fused ingest+stem on packed (B, H, W*3) uint8 rows ->
    (B, H/4, W/4, 64) in out_dtype; ``backward`` is "kernel" or "remat".
    The forward checks the inputs."""
    if backward not in BACKWARDS:
        raise ValueError(f"unknown backward mode {backward!r}")
    return _StemTrain.apply(packed, kernel7, inv, off, normalize, out_dtype,
                            backward)

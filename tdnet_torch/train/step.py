"""Train and eval steps, the counterpart of ``tdnet/train/step.py``.

Training contract (the reference's compile settings): Adam at lr 1e-5 with
Keras ``clipnorm`` 1e-3, which clips EACH gradient tensor by its own L2 norm
(not the global norm); loss = smooth-L1 on the boxes + focal on the
classes, with anchor targets assigned on the device.

The state is the model (parameters and BN statistics), the optimizer
(Adam moments and step) and the step count. The step updates them in
place, where the reference returns a new state.

Image routes, as in the reference:

- packed (B, H, W*3) uint8 on a shape the fused stem supports, with the
  fused stem on -> ``fused_stem_train`` -> the model from its pooled output
  (``stem_input=True``); ``TDNET_STEM_BWD`` (default ``kernel``) picks its
  backward;
- other uint8 -> the normalize kernel -> the full model;
- float -> the full model.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from tdnet_torch.device import resolve_device
from tdnet_torch.ops.anchors import AnchorParameters, anchors_for_shape
from tdnet_torch.ops.ingest import normalize_uint8_rows
from tdnet_torch.ops.losses import focal, smooth_l1
from tdnet_torch.ops.stem import supports_shape
from tdnet_torch.ops.stem_vjp import fused_stem_train
from tdnet_torch.ops.targets import batched_anchor_targets
from tdnet_torch.weights import torch_state_from_variables

__all__ = [
    "ClippedAdam",
    "TrainState",
    "clip_by_leaf_norm_",
    "create_optimizer",
    "create_train_state",
    "make_train_step",
    "make_eval_step",
]


@torch.no_grad()
def clip_by_leaf_norm_(grads, max_norm: float) -> None:
    """Keras ``clipnorm``, in place: scale each tensor g by
    min(1, max_norm / max(||g||, 1e-12))."""
    for g in grads:
        norm = torch.linalg.vector_norm(g)
        g.mul_(torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0))


class ClippedAdam(torch.optim.Adam):
    """Adam with per-tensor gradient clipping before each update. The update
    is optax's ``adam`` with its defaults (b1 0.9, b2 0.999, eps 1e-8 added
    outside the square root, bias-corrected moments):
    ``torch.optim.Adam`` computes the same ``lr * m_hat / (sqrt(v_hat) +
    eps)``."""

    def __init__(self, params, lr: float = 1e-5, clipnorm: float = 1e-3):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.clipnorm = clipnorm

    @torch.no_grad()
    def step(self, closure=None):
        clip_by_leaf_norm_([p.grad for group in self.param_groups
                            for p in group["params"] if p.grad is not None],
                           self.clipnorm)
        return super().step(closure)


def create_optimizer(learning_rate: float = 1e-5,
                     clipnorm: float = 1e-3) -> Callable:
    """Adam(1e-5, clipnorm=0.001), the reference's settings, as a factory
    of the trainable parameters."""
    return functools.partial(ClippedAdam, lr=learning_rate, clipnorm=clipnorm)


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(model, variables: dict,
                       optimizer: Optional[Callable] = None,
                       freeze_backbone: bool = False,
                       device=None) -> TrainState:
    """Load ``variables`` (the flax ``{params, batch_stats}`` numpy tree,
    e.g. ``weights.random_variables``) into ``model``, move it to the device
    in ``channels_last``, and build the optimizer over the trainable
    parameters. ``freeze_backbone`` leaves the backbone out of the optimizer
    (it still gets gradients, which count in ``grad_norm`` as in the
    reference), so its parameters never move."""
    dev = resolve_device(device)
    model.load_state_dict(torch_state_from_variables(variables))
    model.to(device=dev, memory_format=torch.channels_last).train()
    params = [p for name, p in model.named_parameters() if p.requires_grad
              and not (freeze_backbone and name.startswith("backbone."))]
    optimizer = (optimizer or create_optimizer())(params)
    return TrainState(model=model, optimizer=optimizer)


def make_train_step(
    model,
    num_classes: int,
    anchor_params: Optional[AnchorParameters] = None,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
    smooth_l1_sigma: float = 3.0,
    preprocess_mode: str = "caffe",
    fused_stem: Optional[bool] = None,
) -> Callable:
    """train_step(state, batch) -> (state, metrics). ``batch`` holds device
    tensors: images, gt_boxes, gt_labels, gt_mask, image_hw. ``fused_stem``
    None means on for CUDA with a ResNet backbone and caffe/tf mode. Metrics
    are device tensors: loss, classification_loss, regression_loss,
    num_positive, grad_norm (the global norm before clipping)."""
    focal_fn = focal(alpha=focal_alpha, gamma=focal_gamma, from_logits=True)
    l1_fn = smooth_l1(sigma=smooth_l1_sigma)
    anchors: Dict[tuple, torch.Tensor] = {}
    if fused_stem is None:
        fused_stem = (next(model.parameters()).device.type == "cuda"
                      and model.backbone_name.startswith("resnet")
                      and preprocess_mode in ("caffe", "tf"))

    def forward(images):
        """images -> (model outputs, unpadded canvas (h, w))."""
        if images.dtype == torch.uint8 and images.dim() == 4:
            b, h, w, _ = images.shape
            images = images.reshape(b, h, w * 3)
        if images.dtype != torch.uint8:
            return model(images), tuple(images.shape[1:3])
        b, h, w3 = images.shape
        if fused_stem and supports_shape((b, h, w3 // 3, 3)):
            k7, inv, off = model.backbone.stem_params()
            act = fused_stem_train(
                images, k7, inv, off, normalize=preprocess_mode,
                out_dtype=model.dtype,
                backward=os.environ.get("TDNET_STEM_BWD", "kernel"))
            return model(act, stem_input=True), (h, w3 // 3)
        x = normalize_uint8_rows(images.reshape(b * h, w3), preprocess_mode,
                                 out_dtype=model.dtype)
        return model(x.reshape(b, h, w3 // 3, 3)), (h, w3 // 3)

    def train_step(state: TrainState, batch: dict):
        outputs, hw = forward(batch["images"])
        if hw not in anchors:
            anchors[hw] = torch.tensor(
                anchors_for_shape(hw, anchor_params=anchor_params),
                dtype=torch.float32, device=outputs["regression"].device)
        labels, regression = batched_anchor_targets(
            anchors[hw], batch["gt_boxes"], batch["gt_labels"],
            batch["gt_mask"], batch["image_hw"], num_classes)
        cls_loss = focal_fn(labels, outputs["classification"].float())
        reg_loss = l1_fn(regression, outputs["regression"].float())
        total = cls_loss + reg_loss
        for p in state.model.parameters():
            p.grad = None
        total.backward()
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        state.optimizer.step()
        state.step += 1
        metrics = {
            "loss": total.detach(),
            "classification_loss": cls_loss.detach(),
            "regression_loss": reg_loss.detach(),
            "num_positive": (labels[..., -1] == 1.0).sum(),
            "grad_norm": grad_norm,
        }
        return state, metrics

    return train_step


def make_eval_step(model) -> Callable:
    """Forward-only step: images -> the model's raw outputs (logits)."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor, stem_input: bool = False):
        return model(images, stem_input=stem_input)

    return eval_step

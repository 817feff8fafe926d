"""Pipeline (inter-layer) parallelism: a 2-stage RetinaNet over two
devices, the counterpart of ``tdnet/parallel/pipeline.py``.

- **The stage split** at the architecture's seam: stage 0 is the backbone
  (images -> C3/C4/C5 taps), stage 1 is FPN + the shared subnets
  (``models/retinanet.py`` ``retinanet_tail``, the same function
  ``RetinaNet.forward`` runs after its backbone, so the two cannot drift),
  with target assignment and the losses for training. Each stage's
  parameters AND Adam moments live only on its own device.
- **One process, two devices**: the stages run on ``devices[0]`` and
  ``devices[1]`` (two cards, or the CPU twice; the caller names them, and
  may name one card twice). PyTorch's asynchronous launches on each
  device's stream do the job of the reference's FIFO dispatch: enqueueing
  stage 0's forward of microbatch k+1 BEFORE its backward of microbatch k
  (1F1B) keeps card 0 busy while card 1 runs microbatch k's stage 1. Taps
  and cotangents move with ``.to(device, non_blocking=True)``.
- **The stage-0 backward is rematerialised** from the saved stage input:
  f0 runs under ``no_grad``, b0 recomputes it with grad and calls
  ``torch.autograd.backward(taps, dtaps)``. No graph a microbatch is kept
  in flight; only stage inputs are.
- **Gradient accumulation**: with n microbatches the step optimizes the
  mean of the microbatches' losses; focal's normaliser is each
  MICROBATCH's positive count, as gradient accumulation at that
  microbatch size has it. The gradients are summed, multiplied by 1/n,
  then clipped per tensor and applied. Metrics: the mean loss (and parts)
  and ``num_positive`` summed.

Input contract, the reference's: f32/bf16 NHWC images (the uint8 and
fused-stem ingestion are data-parallel features).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tdnet_torch.models.retinanet import FPN, Subnet, build_backbone, retinanet_tail
from tdnet_torch.ops.anchors import AnchorParameters, anchors_for_shape
from tdnet_torch.ops.losses import focal, smooth_l1
from tdnet_torch.ops.targets import batched_anchor_targets
from tdnet_torch.train.step import TrainState, create_optimizer
from tdnet_torch.weights import (random_variables, torch_state_from_variables,
                                 variables_from_torch_state)

__all__ = [
    "STAGE0_KEYS",
    "split_variables",
    "make_stage_modules",
    "PipelinedForward",
    "PipelineTrainer",
]

# variable-tree keys owned by stage 0; everything else is stage 1
# (RetinaNet's module names)
STAGE0_KEYS = ("backbone",)


def _split_tree(tree) -> Tuple[Dict, Dict]:
    t0 = {k: v for k, v in tree.items() if k in STAGE0_KEYS}
    t1 = {k: v for k, v in tree.items() if k not in STAGE0_KEYS}
    return t0, t1


def split_variables(variables) -> Tuple[Dict, Dict]:
    """A full RetinaNet ``{params, batch_stats}`` tree -> (vars0, vars1),
    each restricted to its stage's modules; their union is the original
    tree."""
    p0, p1 = _split_tree(dict(variables["params"]))
    b0, b1 = _split_tree(dict(variables.get("batch_stats", {})))
    return {"params": p0, "batch_stats": b0}, {"params": p1, "batch_stats": b1}


class _HeadStage(nn.Module):
    """Stage 1: FPN + the shared subnets from the NCHW taps. Its children
    carry RetinaNet's names, so its state dict is the full model's minus
    the backbone."""

    def __init__(self, model):
        super().__init__()
        self.num_classes = model.num_classes
        self.output_dtype = model.output_dtype
        self.fpn = FPN(*model.backbone.channels, feature_size=model.feature_size)
        self.regression_submodel = Subnet(model.num_anchors * 4, model.feature_size)
        self.classification_submodel = Subnet(model.num_anchors * model.num_classes,
                                              model.feature_size)

    def forward(self, c3, c4, c5) -> Dict[str, torch.Tensor]:
        return retinanet_tail(self.fpn, self.regression_submodel,
                              self.classification_submodel, c3, c4, c5,
                              self.num_classes, self.output_dtype)


def make_stage_modules(model) -> Tuple[nn.Module, nn.Module]:
    """(backbone, head) modules for a RetinaNet, new and zero-filled: the
    backbone's state dict is the full model's ``backbone.*`` keys without
    the prefix, the head's the rest."""
    return build_backbone(model.backbone_name, model.dtype), _HeadStage(model)


def _load_stages(backbone, head, variables) -> None:
    v0, v1 = split_variables(variables)
    sd0 = torch_state_from_variables(v0)
    backbone.load_state_dict({k[len("backbone."):]: v for k, v in sd0.items()})
    head.load_state_dict(torch_state_from_variables(v1))


def _host(images) -> torch.Tensor:
    return images if isinstance(images, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(images))


class PipelinedForward:
    """Microbatched 2-stage inference over two devices: ``forward(images)``
    returns RetinaNet's {'regression', 'classification'} on the whole
    batch, concatenated over microbatches on the stage-1 device.
    ``max_in_flight`` bounds the microbatch taps stashed on that device."""

    def __init__(self, model, variables, devices: Sequence, microbatch_size: int = 1,
                 max_in_flight: int = 2):
        if len(devices) != 2:
            raise ValueError(f"2-stage pipeline needs 2 devices, got {len(devices)}")
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        self.devices = tuple(torch.device(d) for d in devices)
        self.microbatch_size = int(microbatch_size)
        self.max_in_flight = int(max_in_flight)
        self.backbone, self.head = make_stage_modules(model)
        _load_stages(self.backbone, self.head, variables)
        for module, dev in zip((self.backbone, self.head), self.devices):
            module.to(device=dev, memory_format=torch.channels_last).eval()

    @torch.no_grad()
    def __call__(self, images) -> Dict[str, torch.Tensor]:
        images = _host(images)
        n, mb = images.shape[0], self.microbatch_size
        if n % mb != 0:
            raise ValueError(f"batch {n} not divisible by microbatch {mb}")
        d0, d1 = self.devices
        outs, pending = [], deque()
        for k in range(n // mb):
            x = images[k * mb:(k + 1) * mb].to(d0, non_blocking=True)
            taps = self.backbone(x.permute(0, 3, 1, 2))
            pending.append([t.to(d1, non_blocking=True) for t in taps])
            if len(pending) >= self.max_in_flight:
                outs.append(self.head(*pending.popleft()))
        while pending:
            outs.append(self.head(*pending.popleft()))
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


class PipelineTrainer:
    """The 2-stage train step over two devices, each stage's state on its
    own:

        trainer = PipelineTrainer(model, num_classes, devices)
        s0, s1 = trainer.states_from_variables(variables)
        (s0, s1), metrics = trainer.step((s0, s1), batch, num_microbatches)

    A state is a ``train.step.TrainState`` of the stage module and its
    ``ClippedAdam`` (``optimizer_factory``, default the reference's
    settings); the full model is never built on a device."""

    def __init__(self, model, num_classes: int, devices: Sequence,
                 anchor_params: Optional[AnchorParameters] = None,
                 focal_alpha: float = 0.25, focal_gamma: float = 2.0,
                 smooth_l1_sigma: float = 3.0,
                 optimizer_factory: Optional[Callable] = None):
        if len(devices) != 2:
            raise ValueError(f"2-stage pipeline needs 2 devices, got {len(devices)}")
        self.model = model
        self.num_classes = num_classes
        self.devices = tuple(torch.device(d) for d in devices)
        self.anchor_params = anchor_params
        self._optimizer_factory = optimizer_factory or create_optimizer()
        self._focal = focal(alpha=focal_alpha, gamma=focal_gamma, from_logits=True)
        self._l1 = smooth_l1(sigma=smooth_l1_sigma)
        self._anchors: Dict[tuple, torch.Tensor] = {}

    def init_states(self, seed: int = 0) -> Tuple[TrainState, TrainState]:
        """Stage states from ``weights.random_variables`` of the model's
        configuration: the shapes of the unpipelined model (the same
        checkpoints)."""
        m = self.model
        return self.states_from_variables(random_variables(
            m.num_classes, m.backbone_name, seed=seed, num_anchors=m.num_anchors,
            feature_size=m.feature_size))

    def states_from_variables(self, variables) -> Tuple[TrainState, TrainState]:
        backbone, head = make_stage_modules(self.model)
        _load_stages(backbone, head, variables)
        states = []
        for module, dev in zip((backbone, head), self.devices):
            module.to(device=dev, memory_format=torch.channels_last).train()
            params = [p for p in module.parameters() if p.requires_grad]
            states.append(TrainState(model=module,
                                     optimizer=self._optimizer_factory(params)))
        return tuple(states)

    @staticmethod
    def merged_state_dict(states) -> dict:
        """The full model's state dict (host tensors) from the stages."""
        s0, s1 = states
        merged = {f"backbone.{k}": v.detach().cpu()
                  for k, v in s0.model.state_dict().items()}
        merged.update({k: v.detach().cpu() for k, v in s1.model.state_dict().items()})
        return merged

    def merged_variables(self, states) -> dict:
        """The full model's ``{params, batch_stats}`` tree (numpy), for
        checkpoints, bundles and the Predictor."""
        return variables_from_torch_state(self.merged_state_dict(states))

    def _anchors_for(self, hw) -> torch.Tensor:
        if hw not in self._anchors:
            self._anchors[hw] = torch.tensor(
                anchors_for_shape(hw, anchor_params=self.anchor_params),
                dtype=torch.float32, device=self.devices[1])
        return self._anchors[hw]

    def step(self, states, batch: dict, num_microbatches: int):
        """One optimizer step: the mean gradient over ``num_microbatches``
        microbatches of ``batch`` (host arrays or tensors: images, gt_boxes,
        gt_labels, gt_mask, image_hw), in the 1F1B order."""
        s0, s1 = states
        d0, d1 = self.devices
        if num_microbatches < 1:
            raise ValueError(f"num_microbatches must be >= 1, got {num_microbatches}")
        images = _host(batch["images"])
        n = images.shape[0]
        if n % num_microbatches != 0:
            raise ValueError(
                f"batch {n} not divisible into {num_microbatches} microbatches")
        mb = n // num_microbatches
        anchors = self._anchors_for(tuple(images.shape[1:3]))
        targets = {k: _host(batch[k]) for k in ("gt_boxes", "gt_labels", "gt_mask",
                                                "image_hw")}
        backbone, head = s0.model, s1.model
        for state in states:
            for p in state.model.parameters():
                p.grad = None

        def mb_slice(k):
            sl = slice(k * mb, (k + 1) * mb)
            return (images[sl].to(d0, non_blocking=True),
                    {key: v[sl].to(d1, non_blocking=True) for key, v in targets.items()})

        def f0(x):
            with torch.no_grad():
                return backbone(x.permute(0, 3, 1, 2))

        def b1(taps, tgt):
            """Stage 1's forward and backward from the taps: its parameter
            gradients accumulate; -> (taps' cotangents, metrics)."""
            taps = [t.requires_grad_(True) for t in taps]
            outputs = head(*taps)
            labels, regression = batched_anchor_targets(
                anchors, tgt["gt_boxes"], tgt["gt_labels"], tgt["gt_mask"],
                tgt["image_hw"], self.num_classes)
            num_positive = (labels[..., -1] == 1.0).sum()
            cls_loss = self._focal(labels, outputs["classification"].float(), num_positive)
            reg_loss = self._l1(regression, outputs["regression"].float(), num_positive)
            total = cls_loss + reg_loss
            total.backward()
            return ([t.grad for t in taps],
                    torch.stack([total.detach(), cls_loss.detach(), reg_loss.detach(),
                                 num_positive.to(torch.float32)]))

        def b0(x, dtaps):
            """Stage 0's backward, rematerialised from its input."""
            torch.autograd.backward(backbone(x.permute(0, 3, 1, 2)), dtaps)

        metrics = []
        # 1F1B: stage 0's forward of microbatch k+1 is enqueued BEFORE its
        # backward of microbatch k, so device 0 runs it while device 1 runs b1(k)
        x0, tgt0 = mb_slice(0)
        pending = (x0, [t.to(d1, non_blocking=True) for t in f0(x0)], tgt0)
        for k in range(1, num_microbatches + 1):
            if k < num_microbatches:
                xk, tgtk = mb_slice(k)
                taps_k = f0(xk)
            x_prev, taps_prev, tgt_prev = pending
            dtaps, m = b1(taps_prev, tgt_prev)
            b0(x_prev, [g.to(d0, non_blocking=True) for g in dtaps])
            metrics.append(m)
            if k < num_microbatches:
                pending = (xk, [t.to(d1, non_blocking=True) for t in taps_k], tgtk)

        inv_n = 1.0 / float(num_microbatches)
        for state in states:
            with torch.no_grad():
                for p in state.model.parameters():
                    if p.grad is not None:
                        p.grad.mul_(inv_n)
            state.optimizer.step()
            state.step += 1
        m = torch.stack(metrics).cpu().numpy().astype(np.float64)
        return states, {
            "loss": float(np.mean(m[:, 0])),
            "classification_loss": float(np.mean(m[:, 1])),
            "regression_loss": float(np.mean(m[:, 2])),
            "num_positive": int(m[:, 3].sum()),
        }

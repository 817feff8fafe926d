"""Checkpoint -> deployable ``.tdn`` conversion, the counterpart of
``tdnet/bin/convert_model.py`` (the training/inference split):

    python -m tdnet_torch.bin.convert_model snapshots/ model.tdn \\
        --backbone resnet50 --num-classes 1 [--no-nms] [--config anchors.ini]

Reads the weights and BatchNorm statistics of one of the port's checkpoint
directories (``train/checkpoint.py``: ``{dir}/{step}/state.pt``, the
latest step unless ``--step``), drops the optimizer state and writes a
``.tdn`` bundle with the inference configuration (NMS settings, anchors,
sides, the backbone's preprocessing) baked in, key for key the
reference's. A reference orbax snapshot converts with the reference's own
``convert_model``, whose ``.tdn`` the port reads.
"""

from __future__ import annotations

import argparse
import os

import torch

from tdnet_torch.bin._common import anchor_params_from_args, ensure_parent_dir
from tdnet_torch.models import backbone as backbone_registry
from tdnet_torch.models.io import save_model
from tdnet_torch.ops.anchors import AnchorParameters
from tdnet_torch.train.checkpoint import Checkpointer
from tdnet_torch.weights import variables_from_torch_state

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert a training snapshot into a deployable .tdn model."
    )
    parser.add_argument("snapshot", help="the port's checkpoint directory")
    parser.add_argument("model_out", help="output .tdn path")
    parser.add_argument("--backbone", default="resnet50", type=str)
    parser.add_argument("--num-classes", default=1, type=int)
    parser.add_argument("--step", default=None, type=int,
                        help="snapshot step (default: latest)")
    parser.add_argument("--no-nms", dest="nms", action="store_false")
    parser.add_argument("--no-class-specific-filter", dest="class_specific_filter",
                        action="store_false")
    parser.add_argument("--score-threshold", default=0.05, type=float)
    parser.add_argument("--nms-threshold", default=0.5, type=float)
    parser.add_argument("--max-detections", default=300, type=int)
    parser.add_argument("--soft-nms-sigma", default=0.0, type=float,
                        help="bake gaussian soft-NMS into the bundle (> 0 replaces hard NMS at inference)")
    parser.add_argument("--image-min-side", default=800, type=int)
    parser.add_argument("--image-max-side", default=1333, type=int)
    parser.add_argument("--config", default=None, type=str)
    return parser.parse_args(argv)


def _checkpointer(path: str) -> Checkpointer:
    """The port's checkpoint directory at ``path``; an orbax snapshot (step
    directories without ``state.pt``) or a missing one raises."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory {path!r}")
    ckpt = Checkpointer(path)
    if not ckpt.steps():
        if any(d.isdigit() for d in os.listdir(path)):
            raise ValueError(
                f"{path!r} holds no checkpoint of the port (step/state.pt): an "
                "orbax snapshot of the reference converts with the reference's "
                "convert_model (python -m tdnet.bin.convert_model), whose .tdn "
                "the port reads")
        raise FileNotFoundError(f"no checkpoints under {path!r}")
    return ckpt


def main(argv=None) -> int:
    args = parse_args(argv)
    anchors = anchor_params_from_args(args)
    bb = backbone_registry(args.backbone)
    ckpt = _checkpointer(args.snapshot)
    step = args.step if args.step is not None else ckpt.latest_step()
    with torch.device("meta"):
        model = bb.retinanet(args.num_classes,
                             num_anchors=(anchors or AnchorParameters.default).num_anchors)
    model = ckpt.restore_weights(model.to_empty(device="cpu"), step=step)

    ensure_parent_dir(args.model_out)
    save_model(
        args.model_out,
        model,
        variables_from_torch_state(model.state_dict()),
        anchor_params=anchors,
        inference_config={
            "nms": args.nms,
            "class_specific_filter": args.class_specific_filter,
            "score_threshold": args.score_threshold,
            "nms_threshold": args.nms_threshold,
            "soft_nms_sigma": args.soft_nms_sigma,
            "max_detections": args.max_detections,
            "min_side": args.image_min_side,
            "max_side": args.image_max_side,
            "preprocess_mode": bb.preprocess_mode,
        },
    )
    print(f"converted step-{step} snapshot -> {args.model_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Evaluation CLI, the counterpart of ``tdnet/bin/evaluate.py``:

    python -m tdnet_torch.bin.evaluate csv annotations.csv classes.csv model.tdn

Prints per-class AP and the (weighted) mAP in the reference's format, and
with ``--coco`` the 12-line COCO summary and the per-class COCO AP.
``model`` is a ``.tdn`` bundle, a checkpoint directory written by
``tdnet_torch/train/checkpoint.py`` or a keras-retinanet ``.h5`` (for
these two, ``--backbone`` and the dataset's classes describe the
architecture). Runs on CUDA unless ``--device cpu``. With
``--distributed coord:port,N,rank`` each of N ranks predicts its strided
slice of the dataset and the detections are all-gathered: every rank holds
the metrics of one process, and rank 0 prints them.
"""

from __future__ import annotations

import argparse
import os

import torch

from tdnet_torch.bin._common import (add_dataset_args, anchor_params_from_args, make_dataset,
                                    maybe_init_distributed)
from tdnet_torch.device import resolve_device
from tdnet_torch.models.io import anchor_params_from_meta, load_model
from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.ops.anchors import AnchorParameters
from tdnet_torch.parallel.mesh import process_count, process_index
from tdnet_torch.train.checkpoint import Checkpointer
from tdnet_torch.train.predictor import Predictor
from tdnet_torch.train.weights import load_initial_weights
from tdnet_torch.utils.coco_eval import evaluate_coco, summarize_coco
from tdnet_torch.utils.eval import evaluate
from tdnet_torch.weights import random_variables

__all__ = ["parse_args", "load_any_model", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a tdnet_torch RetinaNet.")
    add_dataset_args(parser, trailing=[("model", ".tdn bundle, checkpoint directory "
                                                 "or keras .h5")])
    parser.add_argument("--backbone", default="resnet50", type=str)
    parser.add_argument("--score-threshold", default=0.05, type=float)
    parser.add_argument("--iou-threshold", default=0.5, type=float)
    parser.add_argument("--max-detections", default=100, type=int)
    parser.add_argument("--config", default=None, type=str)
    parser.add_argument("--image-min-side", default=800, type=int)
    parser.add_argument("--image-max-side", default=1333, type=int)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--coco", action="store_true",
                        help="also report the COCO 12-metric summary")
    parser.add_argument("--no-pallas", dest="use_pallas", action="store_false",
                        default=None, help="the plain route: CPU only")
    parser.add_argument("--pre-nms-top-k", default=1024, type=int)
    parser.add_argument("--eval-batch-size", default=None, type=int,
                        help="images a predict_batch call (default: 16 on CUDA, "
                             "1 on the CPU)")
    parser.add_argument("--soft-nms-sigma", default=None, type=float,
                        help="gaussian soft-NMS sigma (> 0 replaces hard NMS; "
                             "default: the model bundle's setting)")
    parser.add_argument("--device-normalize", action="store_true",
                        help="ship uint8 canvases and normalize on the device "
                             "(with a ResNet on CUDA: the fused ingest+stem kernel)")
    parser.add_argument("--no-fused-stem", action="store_true",
                        help="with --device-normalize, the flat normalize "
                             "kernel instead of the fused ingest+stem")
    parser.add_argument("--distributed", default=None, type=str,
                        metavar="COORD:PORT,NPROC,RANK",
                        help="sharded evaluation: each rank predicts its slice, "
                             "the detections are all-gathered, rank 0 prints")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.use_pallas is False and torch.device(args.device).type == "cuda":
        parser.error("--no-pallas asks for the plain route, which the port "
                     "runs only on the CPU (--device cpu)")
    return args


def load_any_model(path, args, num_classes, dtype):
    """A .tdn bundle, a checkpoint directory or a keras .h5 -> (model,
    variables or None (the model holds its weights), anchors, meta)."""
    if path.endswith((".h5", ".hdf5")):
        # the template is the port's random init; the file's weights replace
        # what matches by name and shape, as the reference's loader does
        anchors = anchor_params_from_args(args)
        n_anchors = (anchors or AnchorParameters.default).num_anchors
        model = RetinaNet(num_classes, args.backbone, dtype=dtype, num_anchors=n_anchors)
        template = random_variables(num_classes, args.backbone, num_anchors=n_anchors)
        variables = load_initial_weights(path, template, backbone_name=args.backbone)
        return model, variables, anchors, None
    if os.path.isdir(path):
        anchors = anchor_params_from_args(args)
        model = RetinaNet(num_classes, args.backbone, dtype=dtype,
                          num_anchors=(anchors or AnchorParameters.default).num_anchors)
        Checkpointer(path).restore_weights(model)
        return model, None, anchors, None
    model, variables, meta = load_model(path, dtype=dtype)
    anchors = anchor_params_from_args(args) or anchor_params_from_meta(meta)
    return model, variables, anchors, meta


def main(argv=None) -> int:
    args = parse_args(argv)
    maybe_init_distributed(args.distributed, resolve_device(args.device))
    shard = process_count() > 1
    dataset = make_dataset(args, "train")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model, variables, anchors, meta = load_any_model(
        args.model, args, dataset.num_classes(), dtype)
    inference = (meta or {}).get("inference", {})
    predictor = Predictor(
        model, variables,
        anchor_params=anchors,
        min_side=args.image_min_side,
        max_side=args.image_max_side,
        preprocess_mode=inference.get("preprocess_mode", "caffe"),
        score_threshold=args.score_threshold,
        nms_threshold=inference.get("nms_threshold", 0.5),
        nms=inference.get("nms", True),
        class_specific_filter=inference.get("class_specific_filter", True),
        use_pallas=args.use_pallas,
        pre_nms_top_k=args.pre_nms_top_k,
        batch_size=args.eval_batch_size,
        device_preprocess=args.device_normalize,
        fused_stem=False if args.no_fused_stem else None,
        soft_nms_sigma=(args.soft_nms_sigma if args.soft_nms_sigma is not None
                        else inference.get("soft_nms_sigma", 0.0)),
        device=args.device,
    )
    aps = evaluate(dataset, predictor, iou_threshold=args.iou_threshold,
                   score_threshold=args.score_threshold,
                   max_detections=args.max_detections, shard=shard)
    # the reference predicts the dataset a second time for the COCO summary,
    # before the rank gate: the sharded gather is a collective
    coco_res = (evaluate_coco(dataset, predictor, score_threshold=args.score_threshold,
                              max_detections=args.max_detections, shard=shard)
                if args.coco else None)
    if process_index() != 0:
        # every rank holds the same result; one prints
        return 0

    # the reference's output format
    total_instances, weighted, simple_sum, present = 0, 0.0, 0.0, 0
    for label, (ap, n) in sorted(aps.items()):
        print(f"{n} instances of class {dataset.label_to_name(label)} "
              f"with average precision: {ap:.4f}")
        total_instances += n
        weighted += ap * n
        if n > 0:
            simple_sum += ap
            present += 1
    if total_instances == 0:
        print("No test instances found.")
        return 1
    print(f"mAP using the weighted average of precisions among classes: "
          f"{weighted / total_instances:.4f}")
    print(f"mAP: {simple_sum / max(present, 1):.4f}")
    if coco_res is not None:
        print(summarize_coco(coco_res))
        for k, v in coco_res.items():
            if k.startswith("AP_") and k not in ("AP_small", "AP_medium", "AP_large"):
                print(f"{k}: {v:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

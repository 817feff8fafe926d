"""Inference CLI, the counterpart of ``tdnet/bin/predict.py``:

    python -m tdnet_torch.bin.predict model.tdn page1.png page2.png \\
        --output-dir out/ --score-threshold 0.5

Writes ``detections.jsonl`` (one line a page, boxes in page coordinates)
and an annotated ``det_<name>.png`` copy of each page. Pages are PNG, JPEG,
BMP, TIFF or ``.npy``. Runs on CUDA unless ``--device cpu``. ``--device-normalize``
(not in the reference's predict) sends uint8 pages through the fused
ingest+stem kernel, as serve's flag does.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from tdnet_torch.data.image import read_image_bgr, write_image_bgr
from tdnet_torch.models.io import anchor_params_from_meta, load_model
from tdnet_torch.train.predictor import Predictor
from tdnet_torch.utils.visualization import draw_detections

__all__ = ["parse_args", "main", "label_names_from_csv", "predictor_from_bundle"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run tdnet_torch inference on images.")
    parser.add_argument("model", help=".tdn model bundle")
    parser.add_argument("images", nargs="+", help="input image paths (PNG, JPEG, BMP, TIFF or .npy)")
    parser.add_argument("--output-dir", default="./predictions", type=str)
    parser.add_argument("--score-threshold", default=0.5, type=float,
                        help="drawing and report threshold")
    parser.add_argument("--labels", default=None, type=str,
                        help="classes.csv: caption boxes with class names")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device-normalize", action="store_true",
                        help="ship uint8 and normalize on the device (with a "
                             "ResNet on CUDA: the fused ingest+stem kernel), as "
                             "serve's flag does; the reference's predict has "
                             "no such flag")
    parser.add_argument("--no-pallas", dest="use_pallas", action="store_false",
                        default=None, help="the plain route: CPU only")
    parser.add_argument("--pre-nms-top-k", default=1024, type=int)
    parser.add_argument("--soft-nms-sigma", default=None, type=float,
                        help="gaussian soft-NMS sigma (> 0 replaces hard NMS; "
                             "default: the model bundle's setting)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.use_pallas is False and torch.device(args.device).type == "cuda":
        parser.error("--no-pallas asks for the plain route, which the port "
                     "runs only on the CPU (--device cpu)")
    return args


def label_names_from_csv(path):
    """classes.csv -> {id: name}."""
    import csv

    from tdnet_torch.data.csv_dataset import read_classes

    with open(path, newline="") as f:
        classes = read_classes(csv.reader(f))
    return {v: k for k, v in classes.items()}


def predictor_from_bundle(path, args, **overrides) -> Predictor:
    """A Predictor for a .tdn bundle with its inference settings, the
    CLI's --bf16, --no-pallas, --pre-nms-top-k, --soft-nms-sigma and
    --device; ``overrides`` replace any of the Predictor's arguments."""
    model, variables, meta = load_model(
        path, dtype=torch.bfloat16 if args.bf16 else torch.float32)
    inference = meta.get("inference", {})
    kw = dict(
        anchor_params=anchor_params_from_meta(meta),
        min_side=inference.get("min_side", 800),
        max_side=inference.get("max_side", 1333),
        preprocess_mode=inference.get("preprocess_mode", "caffe"),
        score_threshold=inference.get("score_threshold", 0.05),
        nms_threshold=inference.get("nms_threshold", 0.5),
        nms=inference.get("nms", True),
        class_specific_filter=inference.get("class_specific_filter", True),
        max_detections=inference.get("max_detections", 300),
        use_pallas=args.use_pallas,
        pre_nms_top_k=args.pre_nms_top_k,
        soft_nms_sigma=(args.soft_nms_sigma if args.soft_nms_sigma is not None
                        else inference.get("soft_nms_sigma", 0.0)),
        device=args.device,
    )
    kw.update(overrides)
    return Predictor(model, variables, **kw)


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    predictor = predictor_from_bundle(args.model, args,
                                      device_preprocess=args.device_normalize)
    label_to_name = None
    if args.labels:
        names = label_names_from_csv(args.labels)
        label_to_name = lambda label: names.get(label, str(label))  # noqa: E731

    jsonl_path = os.path.join(args.output_dir, "detections.jsonl")
    with open(jsonl_path, "w") as jf:
        for path in args.images:
            image = read_image_bgr(path)
            t0 = time.perf_counter()
            boxes, scores, labels = predictor(image)
            dt = time.perf_counter() - t0
            draw = np.clip(image, 0, 255).astype(np.uint8)
            draw_detections(draw, boxes, scores, labels, label_to_name=label_to_name,
                            score_threshold=args.score_threshold)
            stem = os.path.splitext(os.path.basename(path))[0]
            out_path = os.path.join(args.output_dir, f"det_{stem}.png")
            write_image_bgr(out_path, draw)
            kept = scores > args.score_threshold
            jf.write(json.dumps({
                "image": path,
                "time_s": round(dt, 4),
                "detections": [
                    {"box": [round(float(v), 2) for v in boxes[i]],
                     "score": round(float(scores[i]), 4), "label": int(labels[i])}
                    for i in np.where(kept)[0]],
            }) + "\n")
            print(f"{path}: {int(kept.sum())} detections ({dt * 1000:.1f} ms) -> {out_path}")
    print(f"wrote {jsonl_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Data-pipeline inspection CLI, the counterpart of ``tdnet/bin/debug.py``
("is my data pipeline right"): writes each loader image as an annotated
PNG, ``debug_<index>.png``: green = a ground-truth box that an anchor
matches at IoU >= 0.5, red = one no anchor matches, and with ``--anchors``
the positive anchors in light blue (the first 200).

    python -m tdnet_torch.bin.debug csv annotations.csv classes.csv --output-dir dbg/

Runs on the host only (numpy): no device is used.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tdnet_torch.bin._common import add_dataset_args, anchor_params_from_args, make_dataset
from tdnet_torch.data.generator import BatchLoader, LoaderConfig
from tdnet_torch.data.image import write_image_bgr
from tdnet_torch.ops.anchors import anchors_for_shape
from tdnet_torch.utils.eval import compute_overlap
from tdnet_torch.utils.visualization import draw_box, draw_caption

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Debug the tdnet data pipeline.")
    add_dataset_args(parser)
    parser.add_argument("--output-dir", default="./debug_images", type=str)
    parser.add_argument("--limit", default=10, type=int)
    parser.add_argument("--anchors", action="store_true",
                        help="also draw positive anchors")
    parser.add_argument("--random-transform", action="store_true")
    parser.add_argument("--image-min-side", default=800, type=int)
    parser.add_argument("--image-max-side", default=1333, type=int)
    parser.add_argument("--config", default=None, type=str)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dataset = make_dataset(args, "train")
    anchor_params = anchor_params_from_args(args)
    os.makedirs(args.output_dir, exist_ok=True)

    # device_normalize keeps the canvas as raw uint8 pixels: no
    # un-normalizing, whatever the backbone's preprocess mode
    cfg = LoaderConfig(
        batch_size=1,
        min_side=args.image_min_side,
        max_side=args.image_max_side,
        random_transform=args.random_transform,
        shuffle=False,
        device_normalize=True,
    )
    loader = BatchLoader(dataset, cfg)
    try:
        count = 0
        for batch in loader.epoch():
            if count >= args.limit:
                break
            image = batch["images"][0].copy()
            anchors = anchors_for_shape(image.shape[:2], anchor_params=anchor_params)
            valid = batch["gt_mask"][0]
            boxes = batch["gt_boxes"][0][valid]
            labels = batch["gt_labels"][0][valid]

            if len(boxes):
                overlaps = compute_overlap(anchors, boxes.astype(np.float64))
                max_per_gt = overlaps.max(axis=0)
                pos_anchors = np.where(overlaps.max(axis=1) >= 0.5)[0]
            else:
                max_per_gt = np.zeros((0,))
                pos_anchors = np.array([], dtype=int)

            if args.anchors:
                for ai in pos_anchors[:200]:
                    draw_box(image, anchors[ai], (255, 205, 0), thickness=1)

            for b, lbl, mo in zip(boxes, labels, max_per_gt):
                color = (0, 255, 0) if mo >= 0.5 else (0, 0, 255)
                draw_box(image, b, color)
                draw_caption(image, b, dataset.label_to_name(int(lbl)))

            idx = int(batch["indices"][0])
            out = os.path.join(args.output_dir, f"debug_{idx:05d}.png")
            write_image_bgr(out, image)
            print(f"{out}: {len(boxes)} boxes, {len(pos_anchors)} positive anchors")
            count += 1
    finally:
        loader.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Shared CLI plumbing, the counterpart of ``tdnet/bin/_common.py``: the
dataset subcommands (``csv``, ``pascal``, ``coco``, ``kitti``,
``open_images``), the anchor config and the ``--distributed`` flag."""

from __future__ import annotations

import argparse
import os
from typing import Optional

from tdnet_torch.data.coco import CocoDataset
from tdnet_torch.data.csv_dataset import CSVDataset
from tdnet_torch.data.kitti import KittiDataset
from tdnet_torch.data.open_images import OpenImagesDataset
from tdnet_torch.data.pascal_voc import PascalVocDataset
from tdnet_torch.ops.anchors import AnchorParameters
from tdnet_torch.parallel.mesh import initialize_distributed
from tdnet_torch.utils.config import parse_anchor_parameters, read_config_file

__all__ = ["add_dataset_args", "make_dataset", "anchor_params_from_args",
           "ensure_parent_dir", "maybe_init_distributed"]

# subcommand -> (help, root positional and its help, split options (name,
# default, help))
_OTHER_DATASETS = {
    "pascal": ("Pascal VOC dataset (VOCdevkit)", ("pascal_path", "VOCdevkit directory"),
               (("--set-name", "trainval", None), ("--val-set-name", "test", None))),
    "coco": ("COCO-format dataset", ("coco_path", "COCO root directory"),
             (("--set-name", "train2017", None), ("--val-set-name", "val2017", None))),
    "kitti": ("KITTI dataset", ("kitti_path", "KITTI base directory"),
              (("--subset", "train", None), ("--val-subset", "val", None))),
    "open_images": ("Open Images dataset", ("main_dir", "Open Images root directory"),
                    (("--subset", "train", None), ("--val-subset", "validation", None),
                     ("--labels-filter", None, "comma-separated class names to keep"))),
}


def add_dataset_args(parser: argparse.ArgumentParser, trailing=None) -> None:
    """The reference's positional layout: ``... csv <annotations.csv>
    <classes.csv> [trailing...] [--val-annotations]``; ``trailing`` is a
    list of (name, help) positionals attached inside each subcommand."""
    sub = parser.add_subparsers(help="dataset type", dest="dataset_type", required=True)
    trailing = trailing or []
    csv_parser = sub.add_parser("csv", help="CSV dataset (annotations + classes)")
    csv_parser.add_argument("annotations", help="path to annotations.csv")
    csv_parser.add_argument("classes", help="path to classes.csv")
    for name, help_text in trailing:
        csv_parser.add_argument(name, help=help_text)
    csv_parser.add_argument("--val-annotations", default=None,
                            help="path to validation annotations.csv (optional)")
    for kind, (kind_help, (root, root_help), options) in _OTHER_DATASETS.items():
        p = sub.add_parser(kind, help=kind_help)
        p.add_argument(root, help=root_help)
        for name, help_text in trailing:
            p.add_argument(name, help=help_text)
        for flag, default, help_text in options:
            p.add_argument(flag, default=default, help=help_text)


def make_dataset(args, split: str = "train"):
    """The train or val dataset of the parsed subcommand (``None`` for a csv
    run without ``--val-annotations``)."""
    if split not in ("train", "val"):
        raise ValueError(split)
    train = split == "train"
    t = args.dataset_type
    if t == "csv":
        if train:
            return CSVDataset(args.annotations, args.classes)
        if not getattr(args, "val_annotations", None):
            return None
        return CSVDataset(args.val_annotations, args.classes)
    if t == "pascal":
        return PascalVocDataset(args.pascal_path,
                                args.set_name if train else args.val_set_name)
    if t == "coco":
        return CocoDataset(args.coco_path, args.set_name if train else args.val_set_name)
    if t == "kitti":
        return KittiDataset(args.kitti_path, args.subset if train else args.val_subset)
    if t == "open_images":
        flt = args.labels_filter.split(",") if args.labels_filter else None
        return OpenImagesDataset(args.main_dir, args.subset if train else args.val_subset,
                                 labels_filter=flt)
    raise ValueError(f"unsupported dataset type {t!r}")


def anchor_params_from_args(args) -> Optional[AnchorParameters]:
    config_path = getattr(args, "config", None)
    if not config_path:
        return None
    return parse_anchor_parameters(read_config_file(config_path))


def ensure_parent_dir(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def maybe_init_distributed(spec, device) -> None:
    """Parse --distributed 'coordinator:port,num_processes,process_id' and
    join the process group on ``device`` (the reference's
    ``_maybe_init_distributed``)."""
    if not spec:
        return
    try:
        coord, nproc, rank = spec.rsplit(",", 2)
        nproc, rank = int(nproc), int(rank)
    except ValueError as e:
        raise SystemExit(f"--distributed expects 'coordinator:port,num_processes,"
                         f"process_id', got {spec!r} ({e})")
    initialize_distributed(coord, nproc, rank, device=device)

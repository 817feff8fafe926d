"""Shared CLI plumbing, the counterpart of ``tdnet/bin/_common.py``: the
dataset subcommands and the anchor config. The port reads CSV datasets;
``pascal``, ``coco``, ``kitti`` and ``open_images`` parse as in the
reference and raise (ROADMAP A14)."""

from __future__ import annotations

import argparse
import os
from typing import Optional

from tdnet_torch.data.csv_dataset import CSVDataset
from tdnet_torch.ops.anchors import AnchorParameters
from tdnet_torch.utils.config import parse_anchor_parameters, read_config_file

__all__ = ["add_dataset_args", "make_dataset", "anchor_params_from_args",
           "ensure_parent_dir"]

# subcommand -> (root positional, split options (name, default))
_OTHER_DATASETS = {
    "pascal": ("pascal_path", (("--set-name", "trainval"), ("--val-set-name", "test"))),
    "coco": ("coco_path", (("--set-name", "train2017"), ("--val-set-name", "val2017"))),
    "kitti": ("kitti_path", (("--subset", "train"), ("--val-subset", "val"))),
    "open_images": ("main_dir", (("--subset", "train"), ("--val-subset", "validation"),
                                 ("--labels-filter", None))),
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
    for kind, (root, options) in _OTHER_DATASETS.items():
        p = sub.add_parser(kind, help=f"{kind} dataset (not ported yet)")
        p.add_argument(root)
        for name, help_text in trailing:
            p.add_argument(name, help=help_text)
        for flag, default in options:
            p.add_argument(flag, default=default)


def make_dataset(args, split: str = "train"):
    """The train or val dataset of the parsed subcommand."""
    if split not in ("train", "val"):
        raise ValueError(split)
    if args.dataset_type == "csv":
        if split == "train":
            return CSVDataset(args.annotations, args.classes)
        if not getattr(args, "val_annotations", None):
            return None
        return CSVDataset(args.val_annotations, args.classes)
    raise NotImplementedError(
        f"dataset type {args.dataset_type!r} is not ported yet (ROADMAP A14); "
        "the port reads csv datasets")


def anchor_params_from_args(args) -> Optional[AnchorParameters]:
    config_path = getattr(args, "config", None)
    if not config_path:
        return None
    return parse_anchor_parameters(read_config_file(config_path))


def ensure_parent_dir(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

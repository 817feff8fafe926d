"""INI config reader for anchor overrides, the counterpart of
``tdnet/utils/config.py`` (format-compatible with the reference's
``--config`` files).

Format::

    [anchor_parameters]
    sizes   = 32 64 128 256 512
    strides = 8 16 32 64 128
    ratios  = 0.5 1 2
    scales  = 1 1.26 1.587
"""

from __future__ import annotations

import configparser
import os

from tdnet_torch.ops.anchors import AnchorParameters

__all__ = ["read_config_file", "parse_anchor_parameters"]


def read_config_file(config_path: str) -> configparser.ConfigParser:
    config = configparser.ConfigParser()
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"config file not found: {config_path}")
    config.read(config_path)
    if "anchor_parameters" in config:
        allowed = {"sizes", "strides", "ratios", "scales"}
        extra = set(config["anchor_parameters"].keys()) - allowed
        if extra:
            raise ValueError(f"unknown anchor_parameters keys: {sorted(extra)} "
                             f"(allowed: {sorted(allowed)})")
    return config


def parse_anchor_parameters(config: configparser.ConfigParser) -> AnchorParameters:
    section = config["anchor_parameters"]
    kwargs = {}
    for key, kind in (("sizes", int), ("strides", int), ("ratios", float),
                      ("scales", float)):
        if key in section:
            kwargs[key] = tuple(kind(x) for x in section[key].split())
    params = AnchorParameters(**kwargs)
    if len(params.sizes) != len(params.strides):
        raise ValueError(
            f"sizes ({len(params.sizes)}) and strides ({len(params.strides)}) "
            "must have equal length (one per pyramid level)")
    return params

"""An AV1 still frame, decoded in Python and numpy (``av1_obu.py`` for the
headers, ``av1_block.py`` for the tiles, ``av1_filters.py`` for the in-loop
filters): the 8-bit intra frame of an AVIF image item, equal to libaom's
and dav1d's decode plane by plane.

The frame runs the specification's decoding process: every tile from the
frame's default CDFs, then deblocking, CDEF and loop restoration in that
order (none of them when the frame allows the intra block copy), cropped
to the frame size.
"""

from __future__ import annotations

from typing import List

import numpy as np

from tdnet_torch.data import av1_block, av1_filters, av1_obu

__all__ = ["DecodedFrame", "decode_frame"]


class DecodedFrame:
    """The planes of a decoded frame (uint8; Y, then U and V unless
    monochrome) and what colour conversion needs of the sequence header."""

    def __init__(self, planes: List[np.ndarray], seq):
        self.planes = planes
        self.height, self.width = planes[0].shape
        self.mono = bool(seq.mono)
        self.ss_x, self.ss_y = seq.ss_x, seq.ss_y
        self.color_primaries = seq.color_primaries
        self.matrix = seq.matrix
        self.full_range = bool(seq.color_range)


def decode_frame(obus: bytes, strict: bool = True) -> DecodedFrame:
    """The OBUs of an AV1 image item -> its decoded frame; ``strict``:
    libaom's checks of the bits no symbol or field reads (alignment,
    trailing bits, tile padding), else dav1d's, which skips them."""
    frame = av1_obu.parse_obus(obus, strict)
    fs = av1_block.FrameState(frame)
    h = frame.hdr
    cdfs = av1_block.default_cdfs(h.base_q_idx)
    for tile_row, tile_col, data, start, end in frame.tiles:
        av1_block.decode_tile(fs, tile_row, tile_col, data, start, end, cdfs, strict)
    if not h.allow_intrabc:
        av1_filters.loop_filter(fs)
        av1_filters.cdef(fs)
        av1_filters.loop_restoration(fs)
    planes = []
    for p, plane in enumerate(fs.planes):
        sx = fs.ss_x if p else 0
        sy = fs.ss_y if p else 0
        planes.append(plane[:(h.height + sy) >> sy, :(h.width + sx) >> sx].astype(np.uint8))
    return DecodedFrame(planes, frame.seq)

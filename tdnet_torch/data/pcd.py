"""Kodak Photo CD (PCD) decoding, equal byte for byte to PIL's
``Image.open(path).convert("RGB")`` (``PcdImagePlugin`` and its ``pcd``
decoder), the reference's file route. cv2 does not read PCD, so the
``cv2`` route refuses it.

PCD has no magic number at its start, so PIL offers it every file that
its earlier plugins pass on, and takes one with ``PCD_`` at byte 2048 and
at least 1539 bytes from there (else it passes the file on). It reads the
768 x 512 base image at ``96 * 2048``: rows in pairs, each pair 768 Y
bytes for each row, then 384 Cb and 384 Cr bytes that both rows share (a
chroma sample for every two pixels), converted by PIL's PhotoYCC tables
(``photoycc.py``). The low two bits of byte 3586 turn the image: 1 by 90
degrees, 3 by 270 (counter-clockwise), and then ``.size`` is 512 x 768.
A file that ends before the last pair fails.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tdnet_torch.data import photoycc

__all__ = ["READS", "ROUTES", "is_pcd", "decode_pcd", "pcd_size"]

READS = "PCD (the 768 x 512 base image)"
ROUTES = ("pil", "cv2")

_OFFSET = 96 * 2048
_W, _H = 768, 512
_TABLES = {k: np.asarray(getattr(photoycc, k), np.int32) for k in ("L", "CR", "CB", "GR", "GB")}


def is_pcd(data: bytes) -> bool:
    """PIL's PCD plugin opens it."""
    return len(data) >= 2048 + 1539 and data[2048:2052] == b"PCD_"


def _orientation(data: bytes) -> int:
    if not is_pcd(data):
        raise ValueError(f"not a PCD file PIL opens; this reader takes {READS}")
    return data[2048 + 1538] & 3


def pcd_size(data: bytes) -> Tuple[int, int]:
    """(width, height), as PIL's ``.size``: 512 x 768 where it turns the
    image, else 768 x 512."""
    return (_H, _W) if _orientation(bytes(data)) in (1, 3) else (_W, _H)


def decode_pcd(data: bytes, route: str = "pil") -> np.ndarray:
    """PCD bytes -> (H, W, 3) uint8 RGB of the base image, equal to PIL's
    ``convert("RGB")``; the ``cv2`` route raises (OpenCV does not read
    PCD)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cv2":
        raise ValueError("PCD: OpenCV cannot read it (cv2.imdecode returns None)")
    data = bytes(data)
    orientation = _orientation(data)
    pair = 3 * _W
    if len(data) < _OFFSET + pair * (_H // 2):
        raise ValueError("PCD base image ends early: PIL fails on it (image file is truncated)")
    pairs = np.frombuffer(data, np.uint8, pair * (_H // 2), _OFFSET).reshape(_H // 2, pair)
    y = pairs[:, :2 * _W].reshape(_H, _W).astype(np.intp)
    cb = np.repeat(pairs[:, 2 * _W:2 * _W + _W // 2], 2, axis=1).repeat(2, axis=0)
    cr = np.repeat(pairs[:, 2 * _W + _W // 2:], 2, axis=1).repeat(2, axis=0)
    t = _TABLES
    lum = t["L"][y]
    rgb = np.stack([lum + t["CR"][cr], lum + t["GB"][cb] + t["GR"][cr], lum + t["CB"][cb]],
                   axis=2)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    if orientation in (1, 3):
        rgb = np.rot90(rgb, 1 if orientation == 1 else 3)
    return np.ascontiguousarray(rgb)

"""Device choice shared by the port's entry points (Predictor, the train
state, the prefetcher), and the full-f32 switch of the kernels' plain
versions."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "no_tf32"]


def resolve_device(device=None) -> torch.device:
    """None means CUDA. A CUDA device with no GPU present raises: the port
    never runs on the CPU unless the caller asks for ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but no CUDA GPU is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def no_tf32():
    """Full-f32 cuDNN convolutions and matrix products inside the block
    (cuDNN defaults to TF32 for f32 convolutions)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev

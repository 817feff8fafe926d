"""Device choice shared by the port's entry points (Predictor, the train
state, the prefetcher)."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """None means CUDA. A CUDA device with no GPU present raises: the port
    never runs on the CPU unless the caller asks for ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but no CUDA GPU is "
                           "available; pass device='cpu' to run on the CPU")
    return dev

"""Focal and smooth-L1 losses, the counterpart of ``tdnet/ops/losses.py``.

- ``focal(alpha=0.25, gamma=2)``: over anchors whose state is not -1,
  ``alpha_t * |y - p|^gamma * BCE(y, p)``, summed and divided by
  max(1, #positive anchors). From logits it uses the stable BCE
  ``max(x, 0) - x*y + log1p(exp(-|x|))``; ``from_logits=False`` takes
  probabilities clipped to [1e-7, 1 - 1e-7] like Keras.
- ``smooth_l1(sigma=3)``: positives only, ``0.5 * sigma^2 * x^2`` below
  ``1 / sigma^2`` and ``|x| - 0.5 / sigma^2`` above, same normaliser.

Both are masks over static shapes, as in the reference.
"""

from __future__ import annotations

import torch

__all__ = ["focal", "smooth_l1"]

_KERAS_EPS = 1e-7


def _bce_from_probs(labels: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    p = probs.clamp(_KERAS_EPS, 1.0 - _KERAS_EPS)
    return -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))


def _bce_from_logits(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    return (logits.clamp_min(0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def focal(alpha: float = 0.25, gamma: float = 2.0, from_logits: bool = True):
    """focal_loss(y_true (B, N, K+1) one-hot + anchor state, y_pred (B, N, K)
    logits or probabilities) -> scalar."""

    def _focal(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        labels = y_true[..., :-1]
        anchor_state = y_true[..., -1]
        if from_logits:
            probs = torch.sigmoid(y_pred)
            bce = _bce_from_logits(labels, y_pred)
        else:
            probs = y_pred
            bce = _bce_from_probs(labels, y_pred)
        positive_label = labels == 1.0
        alpha_factor = torch.where(positive_label, alpha, 1.0 - alpha)
        focal_weight = torch.where(positive_label, 1.0 - probs, probs)
        cls_loss = alpha_factor * focal_weight ** gamma * bce
        valid = (anchor_state != -1.0)[..., None]
        cls_loss = torch.where(valid, cls_loss, torch.zeros_like(cls_loss))
        normalizer = (anchor_state == 1.0).sum().to(cls_loss.dtype).clamp_min(1.0)
        return cls_loss.sum() / normalizer

    return _focal


def smooth_l1(sigma: float = 3.0):
    """smooth_l1_loss(y_true (B, N, 4+1) targets + anchor state, y_pred
    (B, N, 4)) -> scalar."""
    sigma_squared = sigma ** 2

    def _smooth_l1(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        target = y_true[..., :-1]
        anchor_state = y_true[..., -1]
        diff = (y_pred - target).abs()
        loss = torch.where(diff < 1.0 / sigma_squared,
                           0.5 * sigma_squared * diff ** 2,
                           diff - 0.5 / sigma_squared)
        positive = (anchor_state == 1.0)[..., None]
        loss = torch.where(positive, loss, torch.zeros_like(loss))
        normalizer = (anchor_state == 1.0).sum().to(loss.dtype).clamp_min(1.0)
        return loss.sum() / normalizer

    return _smooth_l1

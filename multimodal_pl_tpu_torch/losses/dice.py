"""Soft-Dice cores as masked weighted sums, port of
``multimodal_pl_tpu/losses/dice.py`` (reference loss_partial.py:24-57):

    loss = 1 - (2*intersect + s) / (z_sum + y_sum + s),  s = 1e-5
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SMOOTH = 1e-5


def binary_dice_masked(score: torch.Tensor, target: torch.Tensor,
                       mask: torch.Tensor | None = None, axes=None) -> torch.Tensor:
    """1 - soft dice of (score, target) restricted to a 0/1 mask, reduced over
    ``axes`` (default: all)."""
    target = target.to(score.dtype)
    if mask is not None:
        m = mask.to(score.dtype)
        score = score * m
        target = target * m
    if axes is None:
        axes = tuple(range(score.ndim))
    intersect = (score * target).sum(dim=axes)
    y_sum = (target * target).sum(dim=axes)
    z_sum = (score * score).sum(dim=axes)
    return 1.0 - (2.0 * intersect + SMOOTH) / (z_sum + y_sum + SMOOTH)


def dice_per_class(probs: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C,) per-class 1 - dice over batch and space. probs: (B, ..., C)
    channels-last; labels: (B, ...) ints."""
    onehot = F.one_hot(labels.long(), num_classes).to(probs.dtype)
    axes = tuple(range(probs.ndim - 1))
    intersect = (probs * onehot).sum(dim=axes)
    y_sum = (onehot * onehot).sum(dim=axes)
    z_sum = (probs * probs).sum(dim=axes)
    return 1.0 - (2.0 * intersect + SMOOTH) / (z_sum + y_sum + SMOOTH)


def multiclass_dice(probs: torch.Tensor, labels: torch.Tensor, num_classes: int,
                    weight: torch.Tensor | None = None) -> torch.Tensor:
    """sum_i dice_i * weight_i / n_classes."""
    d = dice_per_class(probs, labels, num_classes)
    if weight is None:
        return d.sum() / num_classes
    return (d * weight.to(d.dtype)).sum() / num_classes

"""Soft-Dice cores as masked weighted sums, port of
``multimodal_pl_tpu/losses/dice.py`` (reference loss_partial.py:24-57):

    loss = 1 - (2*intersect + s) / (z_sum + y_sum + s),  s = 1e-5

``space`` (a SpatialGroup, or None): the voxels are this rank's H slab of
the tensors; every sum over the voxels is the slab's, summed over the ranks
(``space.sum``, one all_reduce of the stacked sums, whose backward is the
identity on each rank) before the ratio, so each rank computes the whole
loss. A group of one is no split.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_pl_tpu_torch.ops.norm import split

SMOOTH = 1e-5


def voxel_sums(terms, axes, space=None):
    """Each tensor of ``terms`` summed over ``axes``; under a split of
    ``space`` also over the ranks, all in one ``space.sum``."""
    sums = [t.sum(dim=axes) for t in terms]
    if not split(space):
        return sums
    return list(space.sum(torch.stack(sums)).unbind(0))


def binary_dice_masked(score: torch.Tensor, target: torch.Tensor,
                       mask: torch.Tensor | None = None, axes=None, space=None) -> torch.Tensor:
    """1 - soft dice of (score, target) restricted to a 0/1 mask, reduced over
    ``axes`` (default: all)."""
    target = target.to(score.dtype)
    if mask is not None:
        m = mask.to(score.dtype)
        score = score * m
        target = target * m
    if axes is None:
        axes = tuple(range(score.ndim))
    intersect, y_sum, z_sum = voxel_sums((score * target, target * target, score * score), axes,
                                         space)
    return 1.0 - (2.0 * intersect + SMOOTH) / (z_sum + y_sum + SMOOTH)


def dice_per_class(probs: torch.Tensor, labels: torch.Tensor, num_classes: int,
                   space=None) -> torch.Tensor:
    """(C,) per-class 1 - dice over batch and space. probs: (B, ..., C)
    channels-last; labels: (B, ...) ints."""
    onehot = F.one_hot(labels.long(), num_classes).to(probs.dtype)
    axes = tuple(range(probs.ndim - 1))
    intersect, y_sum, z_sum = voxel_sums((probs * onehot, onehot * onehot, probs * probs), axes,
                                         space)
    return 1.0 - (2.0 * intersect + SMOOTH) / (z_sum + y_sum + SMOOTH)


def multiclass_dice(probs: torch.Tensor, labels: torch.Tensor, num_classes: int,
                    weight: torch.Tensor | None = None, space=None) -> torch.Tensor:
    """sum_i dice_i * weight_i / n_classes."""
    d = dice_per_class(probs, labels, num_classes, space)
    if weight is None:
        return d.sum() / num_classes
    return (d * weight.to(d.dtype)).sum() / num_classes

"""Composite training losses, port of ``multimodal_pl_tpu/losses/compose.py``
(reference loss_functions/losses.py:46-182).

The reference's per-organ loops over ``tlist`` / ``label_t`` are products
with 0/1 organ-weight vectors. The marginal Dice runs over the full batch;
the pseudo-label consistency term uses sample 0, as the reference training
script does (train_amos_atlas_final.py:277, 337).
"""

from __future__ import annotations

from typing import Sequence

import torch

from multimodal_pl_tpu_torch.losses.dice import SMOOTH, binary_dice_masked
from multimodal_pl_tpu_torch.losses.partial import edice_partial
from multimodal_pl_tpu_torch.ops.norm import split
from multimodal_pl_tpu_torch.ops.resize import resize_nearest

DEEP_WEIGHTS = (0.125, 0.25, 0.5, 1.0)  # losses.py:116


def _nearest_labels(labels: torch.Tensor, spatial) -> torch.Tensor:
    """Nearest-downsample an integer label volume (B, D, H, W)."""
    return resize_nearest(labels[..., None], spatial)[..., 0]


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor, sup_mask: torch.Tensor,
                      deep_outs: Sequence[torch.Tensor], attns: Sequence[torch.Tensor],
                      refiner_logits: torch.Tensor | None = None,
                      label_d: torch.Tensor | None = None,
                      weight_feature: torch.Tensor | float = 0.1,
                      confidence: float = 0.10, aux_weight: float = 1.0,
                      space=None) -> torch.Tensor:
    """The reference ``get_loss``, channels-last.

    logits: (B, D, H, W, C); labels: (B, D, H, W) with the unsupervised organs
    zeroed (cmask); sup_mask: (C,) 0/1 class weights ([0] = 0: background
    carries no loss weight); deep_outs: deep-supervision logits (the trained
    configuration passes none); attns: 3 attention maps (B, D', H', W', C-1);
    refiner_logits: (C-1, D, H, W, 2) for every organ, or None in the
    pretrain phase; label_d: (C-1,) per-case organ supervision bits — the
    consistency term covers the organs NOT supervised in this case.
    ``space`` (a SpatialGroup): every voxel tensor, refiner_logits
    included, is this rank's H slab, and every sum over the voxels is
    summed over the ranks (``losses.dice``); each rank gets the whole loss.
    The deep outputs are not split."""
    num_fg = logits.shape[-1] - 1
    loss = edice_partial(logits, labels, sup_mask, uce=True, space=space)

    aux = 0.0
    if deep_outs and split(space):
        raise NotImplementedError("segmentation_loss: deep outputs under an H split")
    for idx, d in enumerate(deep_outs):
        ct = _nearest_labels(labels, d.shape[1:4])
        aux = aux + edice_partial(d, ct, sup_mask, uce=False) * DEEP_WEIGHTS[idx]

    if refiner_logits is None:
        return loss + aux
    if label_d is None:
        raise ValueError("segmentation_loss: refiner_logits given but label_d is None — "
                         "the consistency term needs the per-case organ supervision bits")
    probs = torch.softmax(logits, dim=-1)
    rprob = torch.softmax(refiner_logits.float(), dim=-1)          # (13, D, H, W, 2)
    p1 = rprob[..., 1]
    confi1 = ((rprob > 1.0 - confidence) | (rprob < confidence)).float()[..., 1]

    u = 1.0 - label_d.float()
    denom = torch.clamp(num_fg - label_d.float().sum(), min=1.0)
    maps = list(attns) + [probs[..., 1:]]  # the 4th entry: the prediction itself
    for idx, amap in enumerate(maps):
        organ_maps = amap[0].movedim(-1, 0).float()                # (13, D, H, W)
        scores = torch.sigmoid(organ_maps) if idx != 3 else organ_maps
        d = binary_dice_masked(scores, p1, confi1, axes=(1, 2, 3), space=space)
        aux = aux + (d * u).sum() / denom * DEEP_WEIGHTS[idx] * weight_feature
    return loss + aux * aux_weight


def refine_loss(refiner_logits: torch.Tensor, labels: torch.Tensor,
                organ_weights: torch.Tensor, aug_mask: int = 1,
                organ_ids: torch.Tensor | None = None) -> torch.Tensor:
    """The reference ``get_loss_refine``, vectorized. refiner_logits:
    (L, D, H, W, 2), one binary head per organ; labels: (B, D, H, W) (sample 0
    is used); organ_weights: (L,) 0/1; organ_ids: (L,) 1-based label id of
    each row (default 1..L). aug_mask > 1 scales the loss, which equals the
    reference's sum over identical duplicated inputs."""
    probs = torch.softmax(refiner_logits.float(), dim=-1)
    if organ_ids is None:
        organ_ids = torch.arange(1, refiner_logits.shape[0] + 1, device=labels.device)
    target1 = (labels[0][None] == organ_ids[:, None, None, None]).float()
    onehot = torch.stack([1.0 - target1, target1], dim=-1)
    axes = (1, 2, 3)
    intersect = (probs * onehot).sum(dim=axes)
    y_sum = (onehot * onehot).sum(dim=axes)
    z_sum = (probs * probs).sum(dim=axes)
    dice = 1.0 - (2.0 * intersect + SMOOTH) / (z_sum + y_sum + SMOOTH)  # (L, 2)
    per_organ = dice.sum(-1) / 2.0
    return (per_organ * organ_weights.float()).sum() * max(aug_mask, 1)


def feature_ramp(epoch, pretrain_epoch: int = 20, ramp_until: int = 50,
                 max_weight: float = 0.1) -> torch.Tensor:
    """The pseudo-label weight schedule (train_amos_atlas_final.py:303-311):
    0 before pretrain_epoch, then linear 0 -> max_weight until ramp_until,
    then constant. Returns an f32 scalar tensor."""
    e = torch.as_tensor(epoch, dtype=torch.float32)
    w = torch.where(e < ramp_until, max_weight / ramp_until * e,
                    torch.tensor(max_weight, dtype=torch.float32, device=e.device))
    return torch.where(e < pretrain_epoch, torch.zeros_like(w), w)

"""Per-organ evaluation metrics, port of ``multimodal_pl_tpu/infer/metrics.py``
(reference evaluate_amos.py:92-182).

Dice, sensitivity and specificity on label maps, each with the reference's
+1 denominator smoothing and a per-sample mean, vectorized over the organs.
The atlas-blended variant thresholds (p + 0.15) > (1 - atlas) instead of
taking the argmax (evaluate_amos.py:146); the refiner variant scores its
per-organ binary heads (evaluate_amos.py:156-182).
"""

from __future__ import annotations

import torch

from multimodal_pl_tpu_torch.ops.norm import split


def _flat(pred: torch.Tensor, target: torch.Tensor):
    b = pred.shape[0]
    return pred.reshape(b, -1).float(), target.reshape(b, -1).float()


def dice_score(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """2|pq| / (|p| + |q| + 1), per sample, then the mean."""
    p, t = _flat(pred, target)
    return (2.0 * (p * t).sum(1) / (p.sum(1) + t.sum(1) + 1.0)).mean()


def spec_score(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p, t = _flat(pred, target)
    return ((p * t).sum(1) / (p.sum(1) + 1.0)).mean()


def senc_score(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p, t = _flat(pred, target)
    return ((p * t).sum(1) / (t.sum(1) + 1.0)).mean()


def _organ_scores(p: torch.Tensor, t: torch.Tensor, space=None):
    """p, t: (L, B, S) 0/1 f32 -> (dice, senc, spec), each (L,). ``space``
    (a SpatialGroup): S is this rank's H slab of the voxels, and the sums
    are summed over the ranks first."""
    num, psum, tsum = (p * t).sum(-1), p.sum(-1), t.sum(-1)
    if split(space):
        num, psum, tsum = space.sum(torch.stack([num, psum, tsum])).unbind(0)
    dice = (2.0 * num / (psum + tsum + 1.0)).mean(-1)
    senc = (num / (tsum + 1.0)).mean(-1)
    spec = (num / (psum + 1.0)).mean(-1)
    return dice, senc, spec


def _one_hot_fg(labels: torch.Tensor, num_fg: int) -> torch.Tensor:
    b = labels.shape[0]
    classes = torch.arange(1, num_fg + 1, device=labels.device)
    return (labels.reshape(1, b, -1) == classes[:, None, None]).float()


def label_scores(pred: torch.Tensor, labels: torch.Tensor, num_fg: int = 13, space=None):
    """(dice, senc, spec), each (num_fg,), of a label map pred (B, D, H, W)
    against labels (B, D, H, W) (this rank's H slabs of them under a split
    of ``space``)."""
    return _organ_scores(_one_hot_fg(pred, num_fg), _one_hot_fg(labels, num_fg), space)


def organ_scores(logits: torch.Tensor, labels: torch.Tensor, num_fg: int = 13, space=None):
    """Reference get_dice (evaluate_amos.py:128-154), atlas=None branch.
    logits (B, D, H, W, C) -> (dice, senc, spec, argmax prediction)."""
    pred = logits.argmax(dim=-1)
    return (*label_scores(pred, labels, num_fg, space), pred)


def organ_scores_atlas(logits: torch.Tensor, labels: torch.Tensor,
                       atlas: torch.Tensor, num_fg: int = 13, boost: float = 0.15):
    """Atlas-blended threshold variant (evaluate_amos.py:144-151); atlas:
    (B, D, H, W, num_fg) organ prior probabilities."""
    probs = torch.softmax(logits.float(), dim=-1)
    b = labels.shape[0]
    cpred = (probs[..., 1:] + boost) > (1.0 - atlas)
    p = cpred.movedim(-1, 0).reshape(num_fg, b, -1).float()
    return _organ_scores(p, _one_hot_fg(labels, num_fg))


def refiner_organ_scores(refiner_logits: torch.Tensor, labels: torch.Tensor, num_fg: int = 13):
    """Reference get_dice2 (evaluate_amos.py:156-182): per-organ binary heads.
    refiner_logits: (num_fg, D, H, W, 2); labels: (1, D, H, W). Returns
    (dice, senc, spec), each (num_fg,)."""
    p = (refiner_logits.argmax(dim=-1) == 1).reshape(num_fg, 1, -1).float()
    return _organ_scores(p, _one_hot_fg(labels, num_fg))

"""The EDice loss family, port of ``multimodal_pl_tpu/losses/partial.py``
(reference loss_functions/loss_partial.py):

- ``edice_partial``: marginal masked softmax Dice (+ per-channel BCE), the
  member the train step uses (loss_partial.py:59-99);
- ``edice_full``: softmax Dice over every class + CE (:102-135);
- ``edice_full2``: binary sigmoid Dice (+ BCE) with confidence masks
  (:137-170);
- the torch losses they are made of, ``bce_probs`` (BCELoss),
  ``bce_logits`` (BCEWithLogitsLoss) and ``softmax_cross_entropy``
  (CrossEntropyLoss), all with mean reduction.

Channels-last; labels are integer volumes without a channel axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_pl_tpu_torch.losses.dice import binary_dice_masked, multiclass_dice

_LOG_CLAMP = -100.0  # torch BCELoss clamps log terms at -100


def bce_probs(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.BCELoss on probabilities (mean reduction, log clamped)."""
    p, t = probs.float(), target.float()
    logp = torch.clamp(torch.log(p), min=_LOG_CLAMP)
    lognp = torch.clamp(torch.log1p(-p), min=_LOG_CLAMP)
    return -(t * logp + (1.0 - t) * lognp).mean()


def bce_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.BCEWithLogitsLoss (mean reduction), in the stable form
    max(x, 0) - x t + log1p(exp(-|x|))."""
    x, t = logits.float(), target.float()
    return (torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss (mean) with channels-last logits."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long()).mean()


def edice_partial(logits: torch.Tensor, labels: torch.Tensor, sup_mask: torch.Tensor,
                  uce: bool = True) -> torch.Tensor:
    """Marginal masked softmax Dice (+ per-channel BCE),
    EDiceLoss_partial.forward with soft_max=True, the only form the losses
    use. logits: (B, D, H, W, C); labels: (B, D, H, W); sup_mask: (C,) 0/1
    class weights."""
    nc = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    w = sup_mask.to(probs.dtype)
    loss = multiclass_dice(probs, labels, nc, weight=w)
    if uce:
        onehot = F.one_hot(labels.long(), nc).float()
        p = probs.float()
        logp = torch.clamp(torch.log(p), min=_LOG_CLAMP)
        lognp = torch.clamp(torch.log1p(-p), min=_LOG_CLAMP)
        per_ch = -(onehot * logp + (1.0 - onehot) * lognp).mean(
            dim=tuple(range(logits.ndim - 1)))
        loss = loss + (per_ch * w.float()).sum()
    return loss


def edice_full(logits: torch.Tensor, labels: torch.Tensor, uce: bool = True) -> torch.Tensor:
    """Softmax Dice over all classes + CE, EDiceLoss_full.forward."""
    loss = multiclass_dice(torch.softmax(logits, dim=-1), labels, logits.shape[-1])
    if uce:
        loss = loss + softmax_cross_entropy(logits, labels)
    return loss


def edice_full2(inputs: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None,
                uce: bool = True, sigmoid: bool = True, axes=None) -> torch.Tensor:
    """Binary Dice (+ BCE with logits), EDiceLoss_full2.forward. inputs,
    target and mask broadcast together; ``axes`` is the Dice reduction."""
    scores = torch.sigmoid(inputs) if sigmoid else inputs
    loss = binary_dice_masked(scores, target, mask, axes=axes)
    if uce:
        loss = loss + bce_logits(inputs, target)
    return loss

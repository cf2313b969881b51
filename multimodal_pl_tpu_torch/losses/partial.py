"""The partial-label EDice loss, port of ``edice_partial`` of
``multimodal_pl_tpu/losses/partial.py`` (reference
loss_functions/loss_partial.py), the member of the family the train step
uses. Channels-last; labels are integer volumes without a channel axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_pl_tpu_torch.losses.dice import multiclass_dice

_LOG_CLAMP = -100.0  # torch BCELoss clamps log terms at -100


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


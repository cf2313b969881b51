"""Adversarial losses, port of ``multimodal_pl_tpu/losses/gan.py``
(reference losses.py:441-475)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, smoothing: float = 0.0,
                         weight: torch.Tensor | None = None) -> torch.Tensor:
    """Label-smoothed cross-entropy over (N, n) logits, mean reduction."""
    n = logits.shape[-1]
    onehot = F.one_hot(targets.long(), n).float()
    soft = onehot * (1.0 - smoothing) + (1.0 - onehot) * (smoothing / (n - 1))
    logp = torch.log_softmax(logits.float(), dim=-1)
    if weight is not None:
        logp = logp * weight[None, :]
    return (-(soft * logp).sum(-1)).mean()


def bce_loss(logits: torch.Tensor, label: int, smoothing: float = 0.0) -> torch.Tensor:
    """Cross-entropy against a constant class label."""
    targets = torch.full((logits.shape[0],), label, dtype=torch.long, device=logits.device)
    return smooth_cross_entropy(logits, targets, smoothing)

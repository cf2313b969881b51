"""Class-token state and its EMA, port of ``multimodal_pl_tpu/models/tokens.py``.

Tokens are explicit state passed to the model's forward and updated by the
train step, not parameters: the reference kept them as plain tensors
(unet3D.py:1016-1021) and mutated them in place after every step
(renew_token :1051-1068).

renew semantics per scale s with feature map x_s (B, d, h, w, C_s) and the
agreement mask fmask (B, D, H, W) of labels 1..num_classes-1: for every class
l with at least one voxel at feature resolution,
token[l] <- (1 - alpha) * token[l] + alpha * mean_{masked voxels} x_s. The
mask is nearest-downsampled with the torch floor convention.

Data parallelism (``group``): the per-class sums and voxel counts are summed
over the ranks before the division, as the JAX package's ``psum`` over the
data axis does, so every rank computes the same tokens (the reference let
per-rank tokens drift). Averaging per-rank means instead would weight a rank
with 3 voxels of a class like one with 30 000.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist

from multimodal_pl_tpu_torch.ops.resize import resize_nearest

TOKEN_DIMS = {"t1": 128, "t2": 64, "t3": 32}


def init_class_tokens(generator: torch.Generator, num_classes: int = 14,
                      dims: Dict[str, int] | None = None) -> Dict[str, torch.Tensor]:
    """Standard-normal tokens (num_classes - 1, dim) per scale, as torch.randn
    (unet3D.py:1016-1021), drawn from ``generator``."""
    dims = dims or TOKEN_DIMS
    return {name: torch.randn((num_classes - 1, dim), generator=generator)
            for name, dim in dims.items()}


def masked_class_sums(x: torch.Tensor, mask: torch.Tensor, num_fg: int):
    """x: (B, d, h, w, C); mask: (B, d, h, w) labels (0 = none). Returns
    (sums (num_fg, C) f32, counts (num_fg,) in x.dtype) for labels 1..num_fg."""
    b, c = x.shape[0], x.shape[-1]
    mf = mask.reshape(b, -1)
    classes = torch.arange(1, num_fg + 1, device=mask.device).to(mf.dtype)
    onehot = (mf[None] == classes[:, None, None]).to(x.dtype)  # (L, B, S)
    counts = onehot.sum(dim=(1, 2))
    sums = torch.einsum("lbs,bsc->lc", onehot.float(), x.reshape(b, -1, c).float())
    return sums, counts


def masked_class_means(x: torch.Tensor, mask: torch.Tensor, num_fg: int, group=None):
    """Per-class masked channel means (num_fg, C) in x.dtype, and the counts.
    With a process ``group`` the sums (f32) and the counts (x.dtype, as JAX's
    ``psum`` reduces them) are summed over its ranks first."""
    sums, counts = masked_class_sums(x, mask, num_fg)
    if group is not None:
        sums, counts = sums.detach(), counts.detach()  # EMA statistics: no gradient
        dist.all_reduce(sums, group=group)
        dist.all_reduce(counts, group=group)
    means = sums / torch.clamp(counts.float(), min=1.0)[:, None]
    return means.to(x.dtype), counts


def ema_update_tokens(tok: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                      alpha: float, group=None) -> torch.Tensor:
    """One scale's EMA: tok (L, C) moves by alpha towards the masked class
    means of x (B, d, h, w, C) under mask (B, d, h, w) labels at x's
    resolution (over the ranks of ``group``); a class without a voxel keeps
    its token."""
    means, counts = masked_class_means(x, mask, tok.shape[0], group)
    upd = tok * (1.0 - alpha) + alpha * means.to(tok.dtype)
    return torch.where((counts > 0)[:, None], upd, tok)


def renew_tokens(tokens: Dict[str, torch.Tensor], features: Sequence[torch.Tensor],
                 fmask: torch.Tensor, alpha: float = 0.01,
                 group=None) -> Dict[str, torch.Tensor]:
    """The token EMA (reference model.renew_token). features: the decoder
    feature maps at the three EAM scales, channels-last; fmask: (B, D, H, W)
    labels where the prediction and the supervised label agree; ``group``:
    the data-parallel process group whose ranks' statistics are summed."""
    new = dict(tokens)
    for name, x in zip(list(tokens), features):
        m = resize_nearest(fmask[..., None].to(x.dtype), x.shape[1:4])[..., 0]
        new[name] = ema_update_tokens(tokens[name], x, m, alpha, group)
    return new


def agreement_mask(cmask: torch.Tensor, pred_labels: torch.Tensor,
                   sup_mask: torch.Tensor) -> torch.Tensor:
    """Voxels where the supervised label and the argmax prediction agree
    (train_amos_atlas_final.py:383-389): cmask (B, D, H, W) labels with the
    unsupervised organs zeroed, pred_labels its argmax counterpart, sup_mask
    (num_classes,) 0/1."""
    agree = (cmask == pred_labels) & (cmask > 0)
    supervised = sup_mask[cmask.long()] > 0
    return torch.where(agree & supervised, cmask, torch.zeros_like(cmask))

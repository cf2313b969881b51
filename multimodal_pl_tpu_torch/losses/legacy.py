"""The MOTS-era loss zoo, port of ``multimodal_pl_tpu/losses/legacy.py``
(reference loss_functions/loss.py:11-497).

Binary Dice variants, per-class Dice/BCE for MOTS 2-channel targets (with
the -1 ignore-sample convention), the task-adaptive marginal CE (TAL, TAL5,
TAL6) with its frequency weights, and the marginal + exclusive MargExcLoss.
Channels-last: targets that the reference kept as (B, C, ...) tensors are
(B, ..., C) here. Task ids are Python ints; they select channels.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from multimodal_pl_tpu_torch.losses.partial import bce_logits, softmax_cross_entropy

# task -> foreground class ids of the 12-class MOTS head (loss.py:329-335)
MOTS_TASK_FG: Dict[int, Sequence[int]] = {
    0: (1, 2), 1: (3, 4), 2: (5, 6), 3: (7, 8), 4: (9,), 5: (10,), 6: (11,),
}
# task -> single foreground class id of the 6-class / 5-class heads
# (loss.py:377-386 TAL6, :412-419 TAL5: the MSD-subset experiment heads)
MOTS_TASK_FG6: Dict[int, int] = {0: 1, 1: 2, 2: 3, 3: 4, 6: 5}
MOTS_TASK_FG5: Dict[int, int] = {0: 1, 1: 2, 3: 3, 6: 4}


def _indicators(labels: torch.Tensor, classes, dim: int = -1) -> torch.Tensor:
    """f32 stack of (labels == c) for each c of ``classes`` along ``dim``
    (zero rows for classes that never occur, as JAX's one_hot)."""
    return torch.stack([(labels == c).float() for c in classes], dim=dim)


def _sq_dice_terms(p: torch.Tensor, t: torch.Tensor, axes):
    """(sum p t, sum t t, sum p p) over ``axes``."""
    return (p * t).sum(dim=axes), (t * t).sum(dim=axes), (p * p).sum(dim=axes)


def binary_dice(predict: torch.Tensor, target: torch.Tensor, smooth: float = 1.0,
                reduce_ignore: bool = True) -> torch.Tensor:
    """BinaryDiceLoss (loss.py:11-60): per-sample 1 - 2|pq| / (|p| + |q| + s).
    reduce_ignore=True averages over the samples whose first target voxel
    is not -1 (the MOTS "organ/tumor missing" convention); False returns
    the per-sample losses."""
    b = predict.shape[0]
    p = predict.reshape(b, -1).float()
    t = target.reshape(b, -1).float()
    loss = 1.0 - 2.0 * (p * t).sum(dim=1) / (p.sum(dim=1) + t.sum(dim=1) + smooth)
    if not reduce_ignore:
        return loss
    valid = (t[:, 0] != -1).float()
    return (loss * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def dice_loss_4mots(predict: torch.Tensor, target: torch.Tensor,
                    sigmoid: bool = True) -> torch.Tensor:
    """DiceLoss4MOTS (loss.py:63-90): mean over class channels of binary_dice."""
    if sigmoid:
        predict = torch.sigmoid(predict)
    return torch.stack([binary_dice(predict[..., i], target[..., i], smooth=1.0)
                        for i in range(predict.shape[-1])]).mean()


def ce_loss_4mots(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """CELoss4MOTS (loss.py:93-123): per-class BCE with logits averaged over
    the valid samples (first target voxel != -1), then over classes."""
    b = predict.shape[0]
    total = []
    for i in range(predict.shape[-1]):
        x = predict[..., i].reshape(b, -1).float()
        t = target[..., i].reshape(b, -1).float()
        ce = (torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean(dim=1)
        valid = (t[:, 0] != -1).float()
        total.append((ce * valid).sum() / torch.clamp(valid.sum(), min=1.0))
    return torch.stack(total).mean()


def bce_onehot(predict: torch.Tensor, labels: torch.Tensor, num_classes: int,
               offset: int = 1) -> torch.Tensor:
    """BCELoss (loss.py:126-151): BCE with logits against one-hot(labels ==
    i + offset)."""
    return bce_logits(predict, _indicators(labels, range(offset, num_classes + offset)))


def dice_softmax_fg(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """DiceLoss (loss.py:243-279): softmax, Dice over classes 1..C-1, the
    smooth term in the denominator only."""
    probs = torch.softmax(logits, dim=-1)
    onehot = _indicators(labels, range(num_classes)).to(probs.dtype)
    inter, y, z = _sq_dice_terms(probs, onehot, tuple(range(probs.ndim - 1)))
    dice = 1.0 - (2.0 * inter) / (z + y + 1e-5)
    return dice[1:].sum() / (num_classes - 1)


def dice_sigmoid_shifted(logits: torch.Tensor, labels: torch.Tensor,
                         num_classes: int) -> torch.Tensor:
    """DiceLoss2 (loss.py:282-315): sigmoid per channel, channel i against
    (labels == i + 1)."""
    probs = torch.sigmoid(logits)
    onehot = _indicators(labels, range(1, num_classes + 1)).to(probs.dtype)
    inter, y, z = _sq_dice_terms(probs, onehot, tuple(range(probs.ndim - 1)))
    return (1.0 - (2.0 * inter) / (z + y + 1e-5)).mean()


def _marginal_inputs(logits_or_probs: torch.Tensor, task_id: int, num_classes: int = 12):
    """Collapse the background classes of one sample: (..., C) -> (..., 1 +
    |fg|) with the summed background first. Returns it and the fg ids."""
    fg = list(MOTS_TASK_FG[int(task_id)])
    bg = [i for i in range(num_classes) if i not in fg]
    merged_bg = logits_or_probs[..., bg].sum(dim=-1, keepdim=True)
    return torch.cat([merged_bg, logits_or_probs[..., fg]], dim=-1), fg


def _remap_targets(labels: torch.Tensor, task_id: int) -> torch.Tensor:
    """Global label -> marginal index (loss.py:360-364): the task's fg
    labels become 1..|fg|."""
    tid = int(task_id)
    delta = -2 * tid if tid <= 4 else -(tid + 4)
    return torch.where(labels > 0, labels + delta, torch.zeros_like(labels))


def tal_loss(logits: torch.Tensor, labels: torch.Tensor, task_ids: Sequence[int],
             num_classes: int = 12) -> torch.Tensor:
    """TAL (loss.py:317-370) without the voxel-frequency weights
    (norm=False): the marginal CE of each sample, summed."""
    loss = 0.0
    for i, tid in enumerate(task_ids):
        merged, _ = _marginal_inputs(logits[i], tid, num_classes)
        loss = loss + softmax_cross_entropy(merged[None], _remap_targets(labels[i], tid)[None])
    return loss


def _tal_binary(logits: torch.Tensor, labels: torch.Tensor, task_ids: Sequence[int],
                task_fg: Dict[int, int], num_classes: int) -> torch.Tensor:
    """TAL5/TAL6 (loss.py:388-406, :421-435): every non-task class merged
    into channel 0, the target binarized, CE per sample, summed."""
    loss = 0.0
    for i, tid in enumerate(task_ids):
        fg = task_fg[int(tid)]
        bg = [c for c in range(num_classes) if c != fg]
        merged = torch.cat([logits[i][..., bg].sum(dim=-1, keepdim=True),
                            logits[i][..., fg:fg + 1]], dim=-1)
        loss = loss + softmax_cross_entropy(merged[None], (labels[i] > 0).long()[None])
    return loss


def tal6_loss(logits: torch.Tensor, labels: torch.Tensor, task_ids: Sequence[int]) -> torch.Tensor:
    """TAL6 (loss.py:373-406): 6-class head, one fg class per task."""
    return _tal_binary(logits, labels, task_ids, MOTS_TASK_FG6, 6)


def tal5_loss(logits: torch.Tensor, labels: torch.Tensor, task_ids: Sequence[int]) -> torch.Tensor:
    """TAL5 (loss.py:408-435): 5-class head, one fg class per task."""
    return _tal_binary(logits, labels, task_ids, MOTS_TASK_FG5, 5)


def bce_no_bg5(logits: torch.Tensor, labels: torch.Tensor, task_ids: Sequence[int]) -> torch.Tensor:
    """BCELossNoBG5 (loss.py:185-211): per sample, BCE with logits of the
    task's single fg channel against (label == that class), averaged over
    voxels, then over the batch."""
    per_sample = []
    for i, tid in enumerate(task_ids):
        c = MOTS_TASK_FG5[int(tid)]
        per_sample.append(bce_logits(logits[i][..., c], (labels[i] == c).float()))
    return torch.stack(per_sample).mean()


def tal_update_weights(voxel_sum: torch.Tensor, voxel_count: torch.Tensor, val, dim: int,
                       voxels: int = 64 * 192 * 192):
    """TAL.update_weights (loss.py:337-341): the running per-class
    foreground voxel frequency. Returns new (voxel_sum, voxel_count,
    weights) with weights = log(1 / mean frequency) for every class seen
    and 1 (torch's init) for the others. The reference writes
    ``self.weights[dim]`` on a (1, 12) tensor, an IndexError for dim > 0;
    this is the per-class intent, as the JAX package settled."""
    voxel_count = voxel_count.clone()
    voxel_count[dim] += 1.0
    voxel_sum = voxel_sum.clone()
    voxel_sum[dim] += torch.as_tensor(val, dtype=torch.float32) / voxels
    avg = voxel_sum / torch.clamp(voxel_count, min=1.0)
    weights = torch.where(voxel_count > 0, torch.log(1.0 / avg), torch.ones_like(avg))
    return voxel_sum, voxel_count, weights


def tal_loss_weighted(logits: torch.Tensor, labels: torch.Tensor, task_ids: Sequence[int],
                      weights: torch.Tensor, norm: bool = True,
                      num_classes: int = 12) -> torch.Tensor:
    """TAL with the frequency weights (loss.py:343-368, norm=True): per
    sample, CE over channels [0] + task fg weighted per voxel by its target's
    weight (the weights divided by their mean), divided by the sum of the
    picked weights as torch's weighted CE does; summed over samples."""
    w = weights / weights.mean() if norm else weights
    loss = 0.0
    for i, tid in enumerate(task_ids):
        merged, fg = _marginal_inputs(logits[i], tid, num_classes)
        tgt = _remap_targets(labels[i], tid).long()
        wsel = torch.cat([w[0:1], w[fg]]).float()
        logp = torch.log_softmax(merged.float(), dim=-1)
        picked = -logp.gather(-1, tgt[..., None])[..., 0]
        wv = wsel[tgt]
        loss = loss + (picked * wv).sum() / wv.sum()
    return loss


def marg_exc_loss(logits: torch.Tensor, labels: torch.Tensor, task_ids: Sequence[int],
                  num_classes: int = 12):
    """MargExcLoss (loss.py:437-497): (marginal Dice, marginal CE, exclusive
    Dice, exclusive CE), each averaged over the batch. The marginal CE takes
    the *softmaxed* marginal probabilities as its logits, literally as the
    reference's F.cross_entropy on softmax outputs does (:222-224 of the
    JAX package)."""
    probs = torch.softmax(logits, dim=-1)
    n = logits.shape[0]
    marg_dice = marg_ce = exc_dice = exc_ce = 0.0
    for i, tid in enumerate(task_ids):
        fg = [0] + list(MOTS_TASK_FG[int(tid)])
        p_marg = probs[i][..., fg]
        marg_ce = marg_ce + softmax_cross_entropy(p_marg[None],
                                                  _remap_targets(labels[i], tid)[None])
        pm = p_marg.movedim(-1, 0).float()
        axes = tuple(range(1, pm.ndim))
        inter, y, z = _sq_dice_terms(pm, _indicators(labels[i], fg, dim=0), axes)
        marg_dice = marg_dice + (1.0 - (2 * inter + 1e-5) / (z + y + 1e-5)).sum()
        # exclusive: push probability off the classes known to be absent
        te = 1.0 - _indicators(labels[i], range(num_classes), dim=0)
        te = torch.cat([torch.zeros_like(te[:1]), te[1:]])
        pe = probs[i].movedim(-1, 0).float()
        inter_e, y_e, z_e = _sq_dice_terms(pe, te, axes)
        exc_dice = exc_dice + ((2 * inter_e + 1e-5) / (z_e + y_e + 1e-5)).sum()
        exc_ce = exc_ce + (torch.log(pe + 1.0) * te).mean(dim=axes).sum()
    return marg_dice / n, marg_ce / n, exc_dice / n, exc_ce / n

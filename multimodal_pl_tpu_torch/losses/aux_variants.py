"""Auxiliary composite-loss variants, port of
``multimodal_pl_tpu/losses/aux_variants.py`` (reference losses.py:64-105,
184-438): MSE consistency (get_loss_mse), the fixed-0.1 variant
(get_loss2), hard pseudo-labels from the refiner (get_loss_multiref) and the
mean-teacher semi-supervised loss (get_loss_semi). The same weighted sums
as :mod:`~multimodal_pl_tpu_torch.losses.compose`, channels-last; the
pseudo-label terms use sample 0. Argmax ties take the first index, as in
JAX; nearest resizes go through ``ops.resize.resize_nearest``.
"""

from __future__ import annotations

import torch

from multimodal_pl_tpu_torch.losses.compose import DEEP_WEIGHTS, _nearest_labels
from multimodal_pl_tpu_torch.losses.dice import binary_dice_masked
from multimodal_pl_tpu_torch.losses.partial import edice_partial
from multimodal_pl_tpu_torch.ops.resize import resize_nearest


def _deep_terms(labels, sup_mask, deep_outs, weights=DEEP_WEIGHTS):
    aux = 0.0
    for idx, d in enumerate(deep_outs):
        ct = _nearest_labels(labels, d.shape[1:4])
        aux = aux + edice_partial(d, ct, sup_mask, uce=False) * weights[idx]
    return aux


def _organ_maps(amap: torch.Tensor) -> torch.Tensor:
    """Sample 0 of a channels-last map as (organs, D, H, W) f32."""
    return amap[0].movedim(-1, 0).float()


def _refine_label(hard, labels, label_t, num_fg: int):
    """The composed label volume of sample 0 (losses.py:316-330): organ l
    where its binary head fires (``hard`` (L, D, H, W) == 1) and the organ
    is not supervised; the ground truth where it is. Returns it and the
    organ ids (L, 1, 1, 1)."""
    organ_ids = torch.arange(1, num_fg + 1, device=labels.device)[:, None, None, None]
    u = 1.0 - label_t.float()
    fires = (hard == 1) & (u[:, None, None, None] > 0)
    pseudo = torch.where(fires, organ_ids, torch.zeros_like(organ_ids)).amax(dim=0)
    sup_keep = label_t.float()[torch.clamp(labels[0] - 1, 0, num_fg - 1).long()] * (labels[0] > 0)
    return torch.where(sup_keep > 0, labels[0].long(), pseudo), organ_ids


def segmentation_loss_mse(logits, labels, sup_mask, deep_outs, attns, refiner_logits=None,
                          label_t=None):
    """get_loss_mse (losses.py:64-105): the MSE between the organ-softmaxed
    maps (the attention maps, then the prediction's fg probabilities) and the
    refiner's fg posterior, nearest-resized to each map, over the
    unsupervised organs among the first 8, scaled by 1/7."""
    weights = (0.03, 0.1, 0.2, 0.3)
    loss = edice_partial(logits, labels, sup_mask, uce=True)
    aux = _deep_terms(labels, sup_mask, deep_outs, weights)
    if refiner_logits is not None:
        rprob = torch.softmax(refiner_logits.float(), dim=-1)
        u = 1.0 - label_t.float()
        probs = torch.softmax(logits, dim=-1)
        for idx, amap in enumerate(list(attns) + [probs[..., 1:]]):
            organ_maps = _organ_maps(amap)
            lr = torch.softmax(organ_maps, dim=0)
            p1 = rprob[..., 1]
            if organ_maps.shape[1:] != p1.shape[1:]:
                p1 = resize_nearest(p1[..., None], organ_maps.shape[1:4])[..., 0]
            mse = ((lr - p1) ** 2).mean(dim=(1, 2, 3))
            aux = aux + (mse[:8] * u[:8]).sum() / 7.0 * weights[idx]
    return loss + aux


def segmentation_loss2(logits, labels, sup_mask, deep_outs, attns, refiner_logits=None,
                       label_t=None, confidence=0.10):
    """get_loss2 (losses.py:184-270): get_loss with a fixed 0.1 weight and a
    sigmoid on every map, the raw fg logits included (the idx == 5 branch
    never fires). The maps must be at the refiner's resolution."""
    loss = edice_partial(logits, labels, sup_mask, uce=True)
    aux = _deep_terms(labels, sup_mask, deep_outs)
    if refiner_logits is not None:
        rprob = torch.softmax(refiner_logits.float(), dim=-1)
        p1 = rprob[..., 1]
        confi1 = ((rprob > 1 - confidence) | (rprob < confidence))[..., 1].float()
        u = 1.0 - label_t.float()
        denom = torch.clamp(logits.shape[-1] - 1 - label_t.float().sum(), min=1.0)
        for idx, amap in enumerate(list(attns) + [logits[..., 1:]]):
            d = binary_dice_masked(torch.sigmoid(_organ_maps(amap)), p1, confi1, axes=(1, 2, 3))
            aux = aux + (d * u).sum() / denom * DEEP_WEIGHTS[idx] * 0.1
    return loss + aux


def segmentation_loss_multiref(logits, labels, sup_mask, deep_outs, attns, refiner_logits=None,
                               label_t=None):
    """get_loss_multiref (losses.py:272-367): hard pseudo-labels. The
    refiner's argmax composes a label volume with the supervised organs'
    ground truth; each map (sigmoid) is held by unmasked Dice to that volume
    nearest-resized to its scale."""
    loss = edice_partial(logits, labels, sup_mask, uce=True)
    aux = _deep_terms(labels, sup_mask, deep_outs)
    if refiner_logits is not None:
        num_fg = refiner_logits.shape[0]
        refine_label, organ_ids = _refine_label(refiner_logits.argmax(dim=-1), labels, label_t,
                                                num_fg)
        u = 1.0 - label_t.float()
        denom = torch.clamp(num_fg - label_t.float().sum(), min=1.0)
        for idx, amap in enumerate(list(attns) + [logits[..., 1:]]):
            organ_maps = _organ_maps(amap)
            rl = refine_label
            if organ_maps.shape[1:4] != rl.shape:
                rl = resize_nearest(rl[None, ..., None].float(), organ_maps.shape[1:4])[0, ..., 0]
            targets = (rl[None] == organ_ids).float()
            d = binary_dice_masked(torch.sigmoid(organ_maps), targets, None, axes=(1, 2, 3))
            aux = aux + (d * u).sum() / denom * DEEP_WEIGHTS[idx] * 0.1
    return loss + aux


def segmentation_loss_semi(logits, labels, sup_mask, deep_outs, attns, teacher_logits=None,
                           label_t=None):
    """get_loss_semi (losses.py:370-438): mean-teacher pseudo-labels with a
    0.9 / 0.1 confidence mask; only the final-scale map (the fg logits)
    contributes. Each organ head's mask is the confidence of its channel 1
    (the reference's c_confi_mask[:, gan:gan+1] is out of range for gan >=
    2; the JAX package settled on channel 1)."""
    loss = edice_partial(logits, labels, sup_mask, uce=True)
    aux = _deep_terms(labels, sup_mask, deep_outs)
    if teacher_logits is not None:
        num_fg = logits.shape[-1] - 1
        tprob = torch.softmax(teacher_logits.float(), dim=-1)
        confi = ((tprob > 0.9) | (tprob < 0.1)).float()
        refine_label, organ_ids = _refine_label(tprob.argmax(dim=-1), labels, label_t, num_fg)
        u = 1.0 - label_t.float()
        for idx, amap in enumerate(list(attns) + [logits[..., 1:]]):
            if idx < 3:  # losses.py:422
                continue
            targets = (refine_label[None] == organ_ids).float()
            d = binary_dice_masked(torch.sigmoid(_organ_maps(amap)), targets, confi[..., 1],
                                   axes=(1, 2, 3))
            aux = aux + (d * u).sum() / 7.0 * 0.1
    return loss + aux

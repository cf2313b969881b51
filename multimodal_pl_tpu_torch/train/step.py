"""The training step, port of ``multimodal_pl_tpu/train/step.py:87-279``
(one reference iteration, train_amos_atlas_final.py:209-391).

One call runs the segmenter forward (attention maps and features kept, the
deep heads skipped), the refiner's gradient pass on the K gathered
supervised rows, its gradient-free complement pass on the other rows, the
segmentation loss, the refine loss, the generator term through a frozen
discriminator, one backward for (params, rparams), SGD with the non-finite
guard, the discriminator step on detached probabilities, and the token EMA.

The models run through ``torch.func.functional_call`` with the state's
parameters. Under autograd they take the training route of
:mod:`multimodal_pl_tpu_torch.models.blocks` (``group_norm_relu`` and
``conv3x3_train``); the complement pass runs under ``torch.no_grad`` and so
takes the fused ``conv3x3_gn`` route, the counterpart of the JAX step's
``pallas_inference_scope`` (step.py:132-150). Nothing in the step copies a
value to the host.

The step is deterministic on the card, as the JAX step is on the TPU: the
trilinear upsamples' gradient is the gather-form ``resize3d`` kernel (the
library's gradient adds with atomics), and the hand-written kernels sum in
fixed orders. Two runs from one state and batch give the same bits
(``chip_smoke.py`` phase 9; ``tools/determinism.py``).

Data parallelism (``group``, the JAX package's ``axis_name``): every rank runs
the whole step on its own batch. The gradients of (params, rparams) are
averaged over the ranks before the non-finite guard, so every rank's guard
sees the same gradient and decides alike; the discriminator's gradients, its
loss and the total loss are averaged after its backward; the token EMA sums
its statistics over the ranks. Each average is one ``all_reduce`` of a flat
buffer per dtype, divided by the world size (``pmean``). With ``group=None``
no collective runs and the step is the single-device one.

Spatial parallelism (``space``, a SpatialGroup of which the segmenter was
built with the same; ``parallel.spatial.make_spatial_train_step``): every
rank holds one H slab of the batch's image, label and atlas and the whole
state. The segmenter runs on the slab (its halos, crops and GroupNorms carry
their gradients across the slabs); every sum over the voxels in the losses
and the metrics is the slab's, summed over the ranks, so every rank
computes the whole loss; sample 0's organ probabilities, atlas and labels
are gathered whole, and the refiner and the discriminator run on them on
every rank alike (their losses and gradients are replicated: the gather's
backward takes the rank's own rows, without a sum). The segmenter's
gradients are slab parts, summed over the ranks (one ``all_reduce`` per
dtype) before the guard; the refiner's and the discriminator's are not. The
token EMA sums its class statistics over the ranks. A group of one is the
single-device step.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.func import functional_call

from multimodal_pl_tpu_torch.infer.metrics import organ_scores, refiner_organ_scores
from multimodal_pl_tpu_torch.losses.compose import refine_loss, segmentation_loss
from multimodal_pl_tpu_torch.losses.gan import smooth_cross_entropy
from multimodal_pl_tpu_torch.models.tokens import agreement_mask, renew_tokens
from multimodal_pl_tpu_torch.ops.norm import split
from multimodal_pl_tpu_torch.train.state import (
    StepConfig,
    TrainState,
    all_finite,
    fresh_adam_update,
    select_tree,
    torch_sgd_update,
)


def poly_lr(base_lr: float, epoch, num_epochs: int, power: float = 0.9) -> torch.Tensor:
    """lr_poly (reference utils.py:53-60) as an f32 scalar tensor on the
    device of ``epoch``."""
    e = torch.as_tensor(epoch).to(torch.float32)
    return base_lr * (1.0 - e / num_epochs) ** power


def _weighted_ce_const(logits: torch.Tensor, weights: torch.Tensor, label: int) -> torch.Tensor:
    """bce_loss over a row subset: mean CE over the rows of weight 1."""
    ce = -torch.log_softmax(logits.float(), dim=-1)[:, label]
    w = weights.float()
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def flat_apply(tensors, fn):
    """``fn`` applied to one contiguous buffer per dtype of ``tensors``
    (concatenated in order), its result split back into tensors of the
    input shapes: one collective per dtype instead of one per tensor."""
    out = list(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = fn(torch.cat([tensors[i].reshape(-1) for i in idx]))
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def pmean(flat: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``flat`` over the ranks of ``group``: one ``all_reduce``
    (sum), divided by the world size."""
    dist.all_reduce(flat, group=group)
    return flat / dist.get_world_size(group)


def tree_apply(trees, fn):
    """``flat_apply`` over the leaves of name -> tensor dicts, all in one
    buffer per dtype."""
    keys = [list(t) for t in trees]
    out = iter(flat_apply([t[k] for t, ks in zip(trees, keys) for k in ks], fn))
    return [{k: next(out) for k in ks} for ks in keys]


def tree_sum(trees, space, kind: str):
    """Each leaf of name -> tensor dicts summed over the ranks of a
    SpatialGroup, one ``all_reduce`` per dtype, counted under ``kind``."""
    return tree_apply(trees, lambda flat: space.sum_(flat, kind))


def tree_mean(trees, group):
    """Each leaf of name -> tensor dicts averaged over the ranks of ``group``
    (``pmean``), one ``all_reduce`` per dtype."""
    return tree_apply(trees, functools.partial(pmean, group=group))


def _organs_first(probs: torch.Tensor) -> torch.Tensor:
    """(D, H, W, C) class probabilities -> (C-1, D, H, W) organ planes."""
    return probs[..., 1:].movedim(-1, 0)


class TrainStep:
    """``step(state, batch, lr, weight_feature) -> (state, metrics)``.

    batch (device tensors): image (B, D, H, W, 1); label (B, D, H, W) ints;
    catlas (C-1, D, H, W); sup_mask (C,) 0/1 with [0] = 0; label_t (C-1,)
    modality flags. lr: segmenter/refiner learning rate; weight_feature: the
    pseudo-label ramp weight. Metrics are device scalars.

    group: a data-parallel process group. Every rank passes its own batch
    and the same state, and gets the same new state; the loss and the
    discriminator's loss are the ranks' means, the other metrics this
    rank's.

    space: a SpatialGroup (the segmenter's): every rank passes its H slab
    of image, label and catlas (``parallel.spatial.spatial_batch``) and the
    same state, and gets the same new state and metrics."""

    def __init__(self, model, refiner, disc, cfg: StepConfig, group=None, space=None):
        self.model, self.refiner, self.disc, self.cfg = model, refiner, disc, cfg
        self.group, self.space = group, space
        if split(space):
            if group is not None:
                raise NotImplementedError("the train step splits H or the batch, not both")
            if not cfg.deep_up:
                raise NotImplementedError(
                    "the spatial train step with deep_up=False (the attention maps feed the "
                    "DeepStyleDiscriminator at their own scales): ROADMAP.md queue 1")
            if cfg.remat:
                raise NotImplementedError("the spatial train step with remat: ROADMAP.md queue 1")

    def _organs(self, logits32):
        """Sample 0's organ probabilities (C-1, D, H, W) in the compute
        dtype, differentiable; under a split gathered whole on every rank."""
        organs = _organs_first(torch.softmax(logits32, dim=-1)[0]).to(self.cfg.compute_dtype)
        return self.space.gather_rows(organs) if split(self.space) else organs

    def _disc(self, dparams, organs, catlas, attns):
        """Discriminator logits over all organs of sample 0 from its organ
        probabilities ``organs`` (C-1, D, H, W)."""
        cfg = self.cfg
        din = (organs, catlas.to(cfg.compute_dtype))
        if cfg.deep_up:
            return functional_call(self.disc, dparams, (din,))
        amaps = [torch.softmax(a.float(), -1)[0].movedim(-1, 0)[..., None] for a in attns]
        return functional_call(self.disc, dparams, (din, amaps))

    def losses(self, params, rparams, state: TrainState, batch, weight_feature):
        """(total loss, aux) of the segmenter and refiner, differentiable in
        params and rparams."""
        cfg, space = self.cfg, self.space
        splits = split(space)
        nfg = cfg.num_classes - 1
        images = batch["image"].to(cfg.compute_dtype)
        labels = batch["label"].long()
        sup_mask, label_t = batch["sup_mask"], batch["label_t"]
        catlas_c = batch["catlas"].to(cfg.compute_dtype)

        # cmask: zero out the unsupervised organs (train:252-255)
        cmask = torch.where(sup_mask[labels] > 0, labels, torch.zeros_like(labels))
        logits, attns, _, feats, _ = functional_call(
            self.model, params, (images, state.tokens), {"deep": False})
        logits32 = logits.float()

        # refiner: a gradient pass over the supervised labeled-modality organs
        # (tlist, gathered to a static K rows) and a gradient-free pass over
        # the other rows for the pseudo-labels (train:277-291); under a split
        # on sample 0's whole probabilities, atlas and labels
        if splits:
            organs = self._organs(logits32)
            organ_probs = organs.detach()
            catlas_c, cmask0 = space.gather_rows(catlas_c), space.gather_rows(cmask[:1])
        else:
            probs0 = torch.softmax(logits32[0].detach(), dim=-1)
            organ_probs = _organs_first(probs0).to(cfg.compute_dtype)
            cmask0 = cmask
        tlist_w = label_t * sup_mask[1:]
        k = min(cfg.refine_grad_organs, nfg)
        order = torch.argsort(-tlist_w, stable=True)  # tlist rows first, ties as JAX
        sup_idx, rest_idx = order[:k], order[k:]
        rlogits_sup = functional_call(
            self.refiner, rparams, ((organ_probs[sup_idx], catlas_c[sup_idx]),)).float()
        r_loss = refine_loss(rlogits_sup, cmask0, tlist_w[sup_idx], aug_mask=cfg.augmask,
                             organ_ids=sup_idx + 1)
        if k < nfg:
            with torch.no_grad():
                rest = functional_call(
                    self.refiner, {n: p.detach() for n, p in rparams.items()},
                    ((organ_probs[rest_idx], catlas_c[rest_idx]),)).float()
            rlogits = rest.new_zeros((nfg, *rest.shape[1:]))
            rlogits[sup_idx] = rlogits_sup.detach()
            rlogits[rest_idx] = rest
        else:
            rlogits = rlogits_sup.detach()[torch.argsort(sup_idx)]

        # deep_outs=(): the reference training script passes deep_out=[] (train:305)
        h = logits.shape[2]
        own = rlogits[:, :, space.rank * h:(space.rank + 1) * h] if splits else rlogits
        seg = segmentation_loss(logits32, cmask, sup_mask, (), attns, refiner_logits=own,
                                label_d=sup_mask[1:], weight_feature=weight_feature,
                                space=space)

        # generator term: the frozen discriminator passes gradient to the
        # logits and takes none itself (train:323-347)
        dfrozen = {n: p.detach() for n, p in state.dparams.items()}
        if not splits:
            organs = self._organs(logits32)
        d_out = self._disc(dfrozen, organs, catlas_c, attns)
        loss_d = _weighted_ce_const(d_out, 1.0 - label_t, 1)

        total = seg + r_loss + loss_d * cfg.weight_gan
        aux = {"logits": logits32.detach(), "attns": [a.detach() for a in attns],
               "feats": feats, "cmask": cmask, "rlogits": rlogits, "seg_loss": seg.detach(),
               "refine_loss": r_loss.detach(), "gan_g_loss": loss_d.detach(),
               "organs": organs.detach(), "catlas": catlas_c}
        return total, aux

    def grads(self, state: TrainState, batch, weight_feature):
        """(total, (grads of params, grads of rparams), aux); parameters that
        do not reach the loss get zero gradients, as in JAX."""
        cfg = self.cfg
        params = {n: p.detach().requires_grad_(True) for n, p in state.params.items()}
        rparams = {n: p.detach().requires_grad_(cfg.train_refiner)
                   for n, p in state.rparams.items()}
        total, aux = self.losses(params, rparams, state, batch, weight_feature)
        leaves = list(params.values()) + (list(rparams.values()) if cfg.train_refiner else [])
        got = torch.autograd.grad(total, leaves, allow_unused=True)
        got = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, got)]
        gp = dict(zip(params, got[:len(params)]))
        gr = (dict(zip(rparams, got[len(params):])) if cfg.train_refiner
              else {n: torch.zeros_like(p) for n, p in rparams.items()})
        return total.detach(), (gp, gr), aux

    def disc_grads(self, state: TrainState, aux, batch):
        """(loss, grads) of the discriminator CE on detached inputs over all
        organs (train:349-368)."""
        dparams = {n: p.detach().requires_grad_(True) for n, p in state.dparams.items()}
        d_out = self._disc(dparams, aux["organs"], aux["catlas"], aux["attns"])
        d_loss = smooth_cross_entropy(d_out, batch["label_t"].long())
        g = torch.autograd.grad(d_loss, list(dparams.values()), allow_unused=True)
        return d_loss.detach(), {n: torch.zeros_like(p) if gi is None else gi
                                 for (n, p), gi in zip(dparams.items(), g)}

    def summed_grads(self, state: TrainState, batch, weight_feature):
        """:meth:`grads` with the gradients every rank applies: averaged over
        a data-parallel group; under an H split the segmenter's slab parts
        summed over the ranks (the refiner's are whole on every rank)."""
        total, (gp, gr), aux = self.grads(state, batch, weight_feature)
        if self.group is not None:
            gp, gr = tree_mean([gp, gr], self.group)
        if split(self.space):
            (gp,) = tree_sum([gp], self.space, "grad_sum")
        return total, (gp, gr), aux

    def __call__(self, state: TrainState, batch, lr, weight_feature):
        cfg = self.cfg
        nfg = cfg.num_classes - 1
        space = self.space
        total, (gp, gr), aux = self.summed_grads(state, batch, weight_feature)

        # non-finite-gradient guard: a bad bf16 step is skipped, not applied
        g_ok = all_finite(gp) & all_finite(gr)
        new_p, new_bp = torch_sgd_update(state.params, gp, state.momentum[0], lr,
                                         cfg.momentum, cfg.weight_decay)
        new_r, new_br = torch_sgd_update(state.rparams, gr, state.momentum[1], lr,
                                         cfg.momentum, cfg.weight_decay)
        params = select_tree(g_ok, new_p, state.params)
        rparams = select_tree(g_ok, new_r, state.rparams)
        momentum = (select_tree(g_ok, new_bp, state.momentum[0]),
                    select_tree(g_ok, new_br, state.momentum[1]))

        disc_lr = poly_lr(cfg.disc_lr, state.epoch, cfg.num_epochs)  # train:325
        d_loss, dgrads = self.disc_grads(state, aux, batch)
        if self.group is not None:
            dgrads, losses = tree_mean([dgrads, {"d": d_loss, "t": total}], self.group)
            d_loss, total = losses["d"], losses["t"]
        d_ok = all_finite(dgrads)
        dparams = select_tree(d_ok, fresh_adam_update(state.dparams, dgrads, disc_lr),
                              state.dparams)

        # class-token EMA (train:382-391), guarded like the updates
        fmask = agreement_mask(aux["cmask"], aux["logits"].argmax(dim=-1), batch["sup_mask"])
        new_tokens = renew_tokens(state.tokens, aux["feats"], fmask, cfg.token_alpha,
                                  space.group if split(space) else self.group)
        tokens = select_tree(all_finite(new_tokens), new_tokens, state.tokens)

        new_state = state.replace(params=params, rparams=rparams, dparams=dparams,
                                  momentum=momentum, tokens=tokens, step=state.step + 1)
        labels = batch["label"].long()
        dice = organ_scores(aux["logits"], labels, nfg, space)[0]
        labels0 = space.gather_rows(labels[:1]) if split(space) else labels[:1]
        rdice = refiner_organ_scores(aux["rlogits"], labels0, nfg)[0]
        supw = batch["sup_mask"][1:].float()
        metrics = {
            "loss": total,
            "seg_loss": aux["seg_loss"],
            "refine_loss": aux["refine_loss"],
            "gan_g_loss": aux["gan_g_loss"],
            "disc_loss": d_loss,
            "train_dice_mean": dice.mean(),
            "train_dice_sup": (dice * supw).sum() / torch.clamp(supw.sum(), min=1.0),
            "refiner_dice_mean": rdice.mean(),
            "grads_finite": g_ok.float(),
            "disc_grads_finite": d_ok.float(),
            "lr": torch.as_tensor(lr, dtype=torch.float32),
        }
        return new_state, metrics


def make_train_step(model, refiner, disc, cfg: StepConfig) -> TrainStep:
    return TrainStep(model, refiner, disc, cfg)

"""Data-parallel train step, port of ``multimodal_pl_tpu/parallel/sharded_step.py``.

The JAX package ``shard_map``s its step over a 1-D data mesh; here each rank
is a process (``torchrun``) that runs the whole step on its own batch,
including its own sample-0 refiner and GAN terms, as each rank of the
reference's DDP launch did (run_amos_atlas_final.sh). The averages are
explicit collectives in the step (``TrainStep(group=...)``): the gradients of
(params, rparams) are averaged before the non-finite guard; the
discriminator's gradients, its loss and the total loss after its backward;
the token EMA sums its statistics over the ranks. The new state is the same
on every rank. The loss and the discriminator's loss are the ranks' means;
the other metrics (dice, refiner dice, the guards' flags, lr) are this
rank's, where JAX returns rank 0's.

``torch.nn.parallel.DistributedDataParallel`` does not fit: the step
differentiates with ``torch.autograd.grad`` through ``functional_call`` on
the state's tensors, which DDP's hooks on module parameters never see.

Batch layout: every rank passes its own batch dict (image (B, D, H, W, 1),
label (B, D, H, W), catlas (C-1, D, H, W), sup_mask (C,), label_t (C-1,)),
the single-device layout; the JAX step's global layout
(:func:`multimodal_pl_tpu_torch.parallel.mesh.shard_batch`) is the ranks'
batches concatenated and stacked in rank order.
"""

from __future__ import annotations

import torch.distributed as dist

from multimodal_pl_tpu_torch.train.state import StepConfig, TrainState, map_state
from multimodal_pl_tpu_torch.train.step import TrainStep, flat_apply


def broadcast_state(state: TrainState, group, src: int = 0) -> TrainState:
    """Rank ``src`` of ``group``'s state on every rank: one broadcast of a
    contiguous buffer per dtype."""
    def broadcast(flat):
        dist.broadcast(flat, src=dist.get_global_rank(group, src), group=group)
        return flat

    leaves = []
    map_state(leaves.append, state)
    it = iter(flat_apply(leaves, broadcast))
    return map_state(lambda _: next(it).clone(), state)


class ShardedTrainStep(TrainStep):
    """``TrainStep`` over a process group whose first call takes rank 0's
    state, so a rank that was seeded or reloaded differently cannot drift."""

    def __init__(self, model, refiner, disc, cfg: StepConfig, group):
        if group is None:
            raise ValueError("ShardedTrainStep needs a process group (dist.group.WORLD for "
                             "the default one)")
        super().__init__(model, refiner, disc, cfg, group=group)
        self._synced = False

    def __call__(self, state: TrainState, batch, lr, weight_feature):
        if not self._synced:
            state = broadcast_state(state, self.group)
            self._synced = True
        return super().__call__(state, batch, lr, weight_feature)


def make_sharded_train_step(model, refiner, disc, cfg: StepConfig, group) -> ShardedTrainStep:
    """``step(state, batch, lr, weight_feature) -> (state, metrics)`` over the
    ranks of ``group``; each rank passes its own batch."""
    return ShardedTrainStep(model, refiner, disc, cfg, group)

"""Sliding-window inference with the windows spread over data-parallel ranks,
port of ``multimodal_pl_tpu/parallel/sharded_infer.py``.

Every rank holds the whole volume (a full AMOS volume is 16-64 MB, cheap
next to the window forwards), runs its share of the windows through the
network and adds them into its own f32 accumulators on its card, with the
tile loop of :class:`multimodal_pl_tpu_torch.infer.sliding.SlidingWindowPredictor`.
One ``all_reduce`` (sum) of the accumulators merges the ranks, and every
rank normalizes: ``full / count``, or the argmax label map.

Window layout: the single predictor's batches of ``window_batch`` windows,
its copies of the last window included, dealt out in turn: batch ``j`` goes
to rank ``j % world``. The result is the single predictor's, up to the order
of the f32 sums, on any world size. Where the batch count is a multiple of
the world size this is the JAX predictor's layout. Elsewhere the JAX
predictor pads the list further, to a multiple of ``world * window_batch``,
and adds those extra copies of the last window too: its result then depends
on the number of devices.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor


class ShardedSlidingWindowPredictor(SlidingWindowPredictor):
    """``SlidingWindowPredictor`` over the ranks of a process ``group``: each
    rank calls it on the same volume (in the same order, for
    ``predict_iter``) and gets the same result. No flip TTA (the JAX
    predictor has none). One ``all_reduce`` merges the accumulators."""

    def __init__(self, apply_fn: Callable, tile: Sequence[int], num_classes: int, group,
                 window_batch: int = 2, **kwargs):
        if kwargs.get("tta"):
            raise ValueError("ShardedSlidingWindowPredictor has no flip TTA")
        super().__init__(apply_fn, tile, num_classes, window_batch=window_batch, **kwargs)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)

    def _plan(self, shape):
        """-> (padded shape, this rank's window batches (n, window_batch, 3))."""
        padded, starts = super()._plan(shape)
        return padded, starts[self.rank::self.world]

    def _merge(self, acc: torch.Tensor) -> None:
        dist.all_reduce(acc, group=self.group)

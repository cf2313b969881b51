"""Spatial (H-axis) model parallelism, port of
``multimodal_pl_tpu/parallel/spatial.py``: serving and the train step.

The JAX package compiles the forward with the activations sharded along H
and lets XLA's SPMD partitioner insert the conv halo exchanges and the
GroupNorm cross-slab reductions. PyTorch has no partitioner, so here each
rank of a process group holds one H slab of every tile (:func:`put_spatial`)
and the model, built with ``space=SpatialGroup(...)``, does each cross-slab
operation itself:

- 3x3x3 convs (the stem, the stride-1 convs of ``conv3x3_gn`` with the
  GroupNorm prologue on or off, the stride-2 library convs): the slab with
  its neighbours' boundary rows attached (:meth:`SpatialGroup.halo_rows`:
  one ``all_gather`` of every rank's boundary rows), run with the conv's
  own SAME padding, cropped back to the slab's rows
  (:meth:`SpatialGroup.crop_rows`). A stride-1 conv takes one row each side, and none at a global edge, where
  the conv's zero padding is the right one (after the prologue, so a zero
  row attached before it would be wrong); a stride-2 conv takes one row on
  the low side only (slabs start at even rows), zero at the global edge,
  and pads H by nothing itself;
- GroupNorm (the conv prologue's fold rows and GroupNorm -> ReLU): the
  slab's per-(sample, group) moments, gathered from every rank and merged in
  rank order (:func:`merge_group_stats`; on the card ``gn_moments_bf16`` and
  ``gn_apply_bf16`` of ``csrc/gn_relu.cu`` around the gather);
- the decoder's trilinear x2 upsample: one source row each side, the edge
  row repeated at the global edges (half-pixel sampling clamps there),
  upsampled without the skip, which is added to the slab's rows as they
  are cropped out;
- the rest (weight standardization, the 1x1 convs, the skip adds) is local.

Each exchange carries its gradient (``torch.autograd.Function``s): a halo
row's gradient goes back to the rank that owns the row (a repeated edge
row's into the edge row), a crop's is the incoming gradient zero-padded,
:meth:`SpatialGroup.gather_rows` (the whole tensor on every rank, for the
refiner and the discriminator) takes the rank's own rows, and
:meth:`SpatialGroup.sum` (the losses' sums over the voxels) passes the
gradient through unchanged on each rank, since every rank computes the
same loss from the sum; GroupNorm's gradient sums its per-channel sums over
the ranks (``ops/gn_relu.py``). :func:`make_spatial_train_step` is the train
step on top (``train/step.py``). A group of one rank changes nothing: the
model and the step take today's path bit for bit.

The split must be even at every level: N must divide H / 16
(:func:`check_divisible`, ValueError before any work). The JAX package's
GSPMD pads uneven shards instead.

:class:`SpatialSlidingWindowPredictor` is the counterpart of the JAX
``SlidingWindowPredictor(tile_sharding=spatial_sharding(mesh))``.
``exchanges`` counts the halo exchanges, the crops and the statistics
gathers by kind and shape, and the train step's exchanges: the gathers and
sums of the losses, and in the backward the halo gradients ('halo_bwd'),
the crops' ('crop_bwd'), the GroupNorm sums ('gn_sums') and the segmenter's
gradient sum ('grad_sum').
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from multimodal_pl_tpu_torch.infer.sliding import _FLIPS, SlidingWindowPredictor
from multimodal_pl_tpu_torch.ops.gn_relu import merge_moments
from multimodal_pl_tpu_torch.train.step import TrainStep

H_AXIS = 2      # of an NDHWC tensor (JAX _SPATIAL_AXES["H"])
EDGES = (None, "zero", "repeat")
DEPTH = 16      # the U-Net's total stride: every level's slab must be whole

# ("halo", edge, lo, hi, slab shape, dtype), ("crop", shape, start, rows,
# dtype, with an add), ("stats", shape), ("gather" | "sum" | "gn_sums" |
# "grad_sum", shape, dtype) and the backward's ("halo_bwd", ...) and
# ("crop_bwd", ...) -> calls
exchanges: collections.Counter = collections.Counter()


def reset_exchanges() -> None:
    exchanges.clear()


@dataclasses.dataclass(frozen=True)
class SpatialGroup:
    """This rank's place in the group that splits each tile's H axis:
    process group, rank and size, in H order (rank r holds rows [r * h, (r +
    1) * h) of each tile of H = N * h rows). ``axis`` is 'H', the one axis
    split (JAX ``_SPATIAL_AXES``); any other raises. ``spans``: when a list,
    each exchange, copy and gather on a CUDA tensor appends (tag, start
    event, end event) to it, tags 'exchange' (boundary rows gathered),
    'attach' (the halo copy in), 'crop' (the copy out, with the skip add
    after an upsample), 'stats' (GroupNorm moments gathered), 'merge' (the
    predictor's all_reduce of its accumulators), and in the train step
    'gather', 'sum' and 'exchange_bwd' (the halo gradients sent back)."""

    group: object
    rank: int
    world: int
    axis: str = "H"
    spans: list | None = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.axis != "H":
            raise ValueError(f"SpatialGroup splits the H axis only, got axis={self.axis!r}")

    @classmethod
    def of(cls, group, spans: list | None = None) -> "SpatialGroup":
        return cls(group, dist.get_rank(group), dist.get_world_size(group), spans=spans)

    def gather(self, t: torch.Tensor, kind: str = "stats") -> torch.Tensor:
        """(N, *t.shape): every rank's t in rank order."""
        with _span(self, kind, t.device):
            out = _all_gather(t, self)
        if kind == "stats":
            exchanges[("stats", tuple(t.shape))] += 1
        return out

    def halo_rows(self, x: torch.Tensor, lo: int, hi: int, edge=None):
        """The slab x (NDHWC, this rank's H rows) with ``lo`` rows of the
        slab below and ``hi`` of the slab above attached, from one
        all_gather of every rank's boundary rows. At a global edge ``edge``
        attaches zeros ('zero'), the edge row repeated ('repeat') or nothing
        (None). Returns (the extended slab, contiguous; the number of rows
        attached below). Differentiable in x (:class:`_HaloRows`): the
        gradient of each attached row goes back to the rank that owns the
        row, which adds it to its boundary row; a repeated edge row's
        gradient adds into the edge row, a zero row's goes nowhere."""
        if edge not in EDGES:
            raise ValueError(f"halo edge must be one of {EDGES}, got {edge!r}")
        h = x.shape[H_AXIS]
        if lo > h or hi > h:
            raise ValueError(f"halo of {lo}, {hi} rows exceeds the slab's {h}")
        ext = _HaloRows.apply(x, self, lo, hi, edge)
        return ext, (lo if self.rank > 0 or edge is not None else 0)

    def crop_rows(self, y: torch.Tensor, start: int, rows: int,
                  add: torch.Tensor | None = None) -> torch.Tensor:
        """Rows [start, start + rows) of y's H axis, contiguous (the slab's
        rows of an output computed on a halo-extended slab), plus ``add``
        (of the cropped shape) if given, in the same pass. Differentiable
        (:class:`_CropRows`): y's gradient is the incoming one at those
        rows and zero elsewhere; ``add``'s is the incoming one."""
        exchanges[("crop", tuple(y.shape), start, rows, str(y.dtype)[6:], add is not None)] += 1
        with _span(self, "crop", y.device):
            return _CropRows.apply(y, self, start, rows, add)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's H slab (axis 2) of t, joined in rank order: the whole
        tensor on every rank. Differentiable (:class:`_GatherRows`) for a
        loss that every rank computes alike from the whole tensor: the
        gradient of this rank's slab is the whole gradient's rows of the
        slab, with no sum over the ranks."""
        exchanges[("gather", tuple(t.shape), str(t.dtype)[6:])] += 1
        return _GatherRows.apply(t, self)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the ranks (one all_reduce), the same bits on
        every rank. Differentiable (:class:`_GroupSum`) for a loss that every
        rank computes alike from the sum: the backward is the identity on
        each rank (each rank's partial reaches the sum once), not a second
        all_reduce, which would count the loss once per rank."""
        exchanges[("sum", tuple(t.shape), str(t.dtype)[6:])] += 1
        return _GroupSum.apply(t, self)

    def sum_(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """t summed over the ranks in place (one all_reduce, no autograd),
        counted under ``kind``."""
        exchanges[(kind, tuple(t.shape), str(t.dtype)[6:])] += 1
        with _span(self, "sum", t.device):
            dist.all_reduce(t, group=self.group)
        return t


class _HaloRows(torch.autograd.Function):
    """:meth:`SpatialGroup.halo_rows` with its gradient: the backward sends
    each attached row's gradient to the rank that owns the row (one
    all_gather of every rank's halo gradients, counted as 'halo_bwd') and
    adds the neighbours' into this slab's boundary rows."""

    @staticmethod
    def forward(ctx, x, space, lo, hi, edge):
        h = x.shape[H_AXIS]
        with _span(space, "exchange", x.device):
            rows = _all_gather(torch.cat([x[:, :, :hi], x[:, :, h - lo:]], H_AXIS), space)
        r, n = space.rank, space.world

        def edge_rows(k: int, at: int):
            if edge == "zero":
                return [x.new_zeros((*x.shape[:2], k, *x.shape[3:]))]
            if edge == "repeat":
                return [x[:, :, at:at + 1].expand(-1, -1, k, -1, -1)]
            return []

        below = ([rows[r - 1][:, :, hi:]] if r > 0 else edge_rows(lo, 0)) if lo else []
        above = ([rows[r + 1][:, :, :hi]] if r < n - 1 else edge_rows(hi, h - 1)) if hi else []
        with _span(space, "attach", x.device):
            ext = torch.cat(below + [x] + above, H_AXIS)
        exchanges[("halo", edge, lo, hi, tuple(x.shape), str(x.dtype)[6:])] += 1
        ctx.space, ctx.lo, ctx.hi, ctx.edge, ctx.h = space, lo, hi, edge, h
        ctx.below = ext.shape[H_AXIS] - h - (above[0].shape[H_AXIS] if above else 0)
        return ext

    @staticmethod
    def backward(ctx, g):
        space, lo, hi, edge, h, nb = ctx.space, ctx.lo, ctx.hi, ctx.edge, ctx.h, ctx.below
        r, n = space.rank, space.world
        g_below, gx, g_above = g[:, :, :nb], g[:, :, nb:nb + h], g[:, :, nb + h:]
        gx = gx.clone()
        # rows this rank attached from a neighbour go back to it: the rows
        # above to rank r + 1 (its first hi rows), the rows below to rank
        # r - 1 (its last lo rows); edges send zeros
        send_up = g_above if r < n - 1 else g.new_zeros((*g.shape[:2], hi, *g.shape[3:]))
        send_down = g_below if r > 0 else g.new_zeros((*g.shape[:2], lo, *g.shape[3:]))
        with _span(space, "exchange_bwd", g.device):
            got = _all_gather(torch.cat([send_up, send_down], H_AXIS), space)
        exchanges[("halo_bwd", edge, lo, hi, tuple(gx.shape), str(g.dtype)[6:])] += 1
        if r > 0 and hi:
            gx[:, :, :hi] += got[r - 1][:, :, :hi]
        if r < n - 1 and lo:
            gx[:, :, h - lo:] += got[r + 1][:, :, hi:]
        if edge == "repeat":
            if r == 0 and lo:
                gx[:, :, :1] += g_below.sum(H_AXIS, keepdim=True)
            if r == n - 1 and hi:
                gx[:, :, h - 1:] += g_above.sum(H_AXIS, keepdim=True)
        return gx, None, None, None, None


class _CropRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, space, start, rows, add):
        ctx.space, ctx.shape, ctx.start, ctx.rows = space, y.shape, start, rows
        ctx.has_add = add is not None
        out = y[:, :, start:start + rows]
        return out.clone(memory_format=torch.contiguous_format) if add is None else out + add

    @staticmethod
    def backward(ctx, g):
        gy = g.new_zeros(ctx.shape)
        gy[:, :, ctx.start:ctx.start + ctx.rows] = g
        exchanges[("crop_bwd", tuple(ctx.shape), ctx.start, ctx.rows, str(g.dtype)[6:],
                   ctx.has_add)] += 1
        return gy, None, None, None, (g if ctx.has_add else None)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, space):
        ctx.space, ctx.h = space, t.shape[H_AXIS]
        with _span(space, "gather", t.device):
            return torch.cat(list(_all_gather(t, space).unbind(0)), H_AXIS)

    @staticmethod
    def backward(ctx, g):
        r, h = ctx.space.rank, ctx.h
        return g[:, :, r * h:(r + 1) * h].contiguous(), None


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, space):
        out = t.clone()
        with _span(space, "sum", t.device):
            dist.all_reduce(out, group=space.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


@contextlib.contextmanager
def _span(space: SpatialGroup, tag: str, device: torch.device):
    if space.spans is None or device.type != "cuda":
        yield
        return
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    yield
    end.record()
    space.spans.append((tag, start, end))


def _all_gather(t: torch.Tensor, space: SpatialGroup) -> torch.Tensor:
    out = t.new_empty((space.world, *t.shape))
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=space.group)
    return out


def check_divisible(tile: Sequence[int], space: SpatialGroup) -> None:
    """Raises ValueError unless the ranks split every level of a tile of
    (D, H, W) ``tile`` evenly: N must divide H / 16, so that each rank's slab
    is whole down to the 1/16 scale and the stride-2 convs' slabs start at
    even rows."""
    h, n = int(tile[1]), space.world
    if h % DEPTH or (h // DEPTH) % n:
        raise ValueError(f"space:{n} needs the tile's H ({h}) to be a multiple of {DEPTH} * {n} "
                         f"= {DEPTH * n}: every level's slab must be whole (the JAX package's "
                         "GSPMD pads uneven shards instead)")


def put_spatial(x: torch.Tensor, space: SpatialGroup) -> torch.Tensor:
    """This rank's H slab of an NDHWC tensor (contiguous)."""
    h = x.shape[H_AXIS]
    if h % space.world:
        raise ValueError(f"H = {h} does not split into {space.world} slabs")
    s = h // space.world
    return x[:, :, space.rank * s:(space.rank + 1) * s].contiguous()


def gather_spatial(y: torch.Tensor, space: SpatialGroup) -> torch.Tensor:
    """Every rank's H slab of y, joined in order (the JAX wrapper's
    ``out_sharded=False``)."""
    return torch.cat(list(_all_gather(y, space).unbind(0)), H_AXIS)


def merge_group_stats(partials: torch.Tensor, space: SpatialGroup, count: float) -> torch.Tensor:
    """Per-(sample, group) (mean, M2) of the whole samples from each rank's
    slab moments ``partials`` (B, 2, groups) of ``count`` values (the slabs
    are equal): gathered, and merged in rank order by Chan's formula
    (``ops.gn_relu.merge_moments``, the order of the kernel's merge). No host
    sync."""
    return merge_moments(space.gather(partials, "stats"), count)


def spatial_batch(batch: dict, space: SpatialGroup) -> dict:
    """This rank's part of a train-step batch: its H slab of image (B, D, H,
    W, 1), label (B, D, H, W) and catlas (C-1, D, H, W); sup_mask and label_t
    whole."""
    return {k: put_spatial(v, space) if k in ("image", "label", "catlas") else v
            for k, v in batch.items()}


def make_spatial_train_step(model, refiner, disc, cfg, space: SpatialGroup):
    """The counterpart of the JAX ``make_spatial_train_step(model, refiner,
    disc, cfg, mesh)``: the whole train step (``train.step.TrainStep``) with
    each sample's H axis split over the ranks of ``space``, for B = 1
    patches too large for one card. ``model`` is the segmenter built with
    ``space``; every rank calls the step with the same state and its
    :func:`spatial_batch` of the same batch, and gets the same new state and
    metrics, those of the single-device step up to the order of sums. A
    group of one rank is ``TrainStep`` itself. Under a split the production
    configuration runs (``deep_up=True``); ``deep_up=False`` and ``remat``
    raise NotImplementedError (ROADMAP.md queue 1). Each call raises
    ValueError before any work unless the split is even at every level
    (:func:`check_divisible`)."""
    if getattr(model, "space", None) != space:
        raise ValueError("make_spatial_train_step: the model was not built with this "
                         "SpatialGroup (pass space=... to its constructor)")
    return SpatialTrainStep(model, refiner, disc, cfg, space=space)


class SpatialTrainStep(TrainStep):
    """``TrainStep`` with ``space`` that checks the split of each batch
    (:func:`check_divisible`) before any work."""

    def summed_grads(self, state, batch, weight_feature):
        x, n = batch["image"], self.space.world
        check_divisible((x.shape[1], x.shape[H_AXIS] * n, x.shape[3]), self.space)
        return super().summed_grads(state, batch, weight_feature)


def make_spatial_apply(model: torch.nn.Module, space: SpatialGroup) -> Callable:
    """``apply(x_slab, *rest, **kw) -> model(x_slab, ...)``: the forward of a
    model built with ``space`` on this rank's H slab of a batch
    (:func:`put_spatial`), without autograd, gathered whole on every rank
    (the JAX wrapper's ``out_sharded=False``). Raises ValueError before any
    work unless the split is even at every level (:func:`check_divisible`)."""
    if getattr(model, "space", None) != space:
        raise ValueError("make_spatial_apply: the model was not built with this SpatialGroup "
                         "(pass space=... to its constructor)")

    def apply(x: torch.Tensor, *rest, **kw):
        check_divisible((x.shape[1], x.shape[H_AXIS] * space.world, x.shape[3]), space)
        with torch.inference_mode():
            y = model(x, *rest, **kw)
        return gather_spatial(y, space)

    return apply


class SpatialSlidingWindowPredictor(SlidingWindowPredictor):
    """``SlidingWindowPredictor`` with each window's H axis split over the
    ranks of ``space``: every rank holds the whole volume and runs every
    window batch, stacking only its slab's rows of the windows, through
    ``apply_fn`` (a forward of models built with ``space``). It adds its
    slab's Gaussian-weighted logits (and weights) into its own f32
    accumulators at the slab's rows of each window; one ``all_reduce`` over
    the group merges the ranks, as the data-parallel predictor's does. Every
    rank returns the same result.

    Flip TTA: the slab of rank r of a tile flipped along H is the flip of
    slab N - 1 - r, and the output of those variants goes back to those rows.
    A group of one rank is the single predictor, bit for bit."""

    def __init__(self, apply_fn: Callable, tile: Sequence[int], num_classes: int,
                 space: SpatialGroup, **kwargs):
        super().__init__(apply_fn, tile, num_classes, **kwargs)
        check_divisible(self.tile, space)
        self.space = space

    def _accumulate(self, vol: torch.Tensor, starts: np.ndarray, full: torch.Tensor,
                    count) -> None:
        if self.space.world == 1:
            return super()._accumulate(vol, starts, full, count)
        td, th, tw = self.tile
        n, r = self.space.world, self.space.rank
        s = th // n
        own, mirror = slice(r * s, (r + 1) * s), slice((n - 1 - r) * s, (n - r) * s)

        def slabs(batch, rows):
            return torch.stack([vol[d:d + td, h + rows.start:h + rows.stop, w:w + tw]
                                for d, h, w in batch])

        for batch in starts.tolist():
            tiles = slabs(batch, own)
            if self.tta:
                mirrored = slabs(batch, mirror)
                variants = torch.cat([(mirrored if 2 in ax else tiles).flip(ax) if ax else tiles
                                      for ax in _FLIPS])
                parts = [p.flip(ax) if ax else p
                         for p, ax in zip(self.apply_fn(variants).chunk(len(_FLIPS)), _FLIPS)]
                # the variants flipped along H hold the mirror slab's rows
                adds = [(rows, sum(p for p, ax in zip(parts, _FLIPS) if (2 in ax) == along_h)
                         / len(_FLIPS)) for rows, along_h in ((own, False), (mirror, True))]
            else:
                adds = ((own, self.apply_fn(tiles)),)
            for rows, logits in adds:
                logits = logits.float() * self.gaussian[:, rows]
                for i, (d, h, w) in enumerate(batch):
                    full[d:d + td, h + rows.start:h + rows.stop, w:w + tw] += logits[i]
            if count is not None:
                for d, h, w in batch:
                    count[d:d + td, h + own.start:h + own.stop, w:w + tw] += self.gaussian[:, own]

    def _merge(self, acc: torch.Tensor) -> None:
        if self.space.world > 1:
            with _span(self.space, "merge", acc.device):
                dist.all_reduce(acc, group=self.space.group)

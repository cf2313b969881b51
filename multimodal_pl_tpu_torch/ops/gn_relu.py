"""GroupNorm -> ReLU and its gradient, port of
``multimodal_pl_tpu/ops/pallas/fused_gn_relu.py::fused_group_norm_relu`` and
of its custom VJP (``multimodal_pl_tpu/ops/norm.py:81-102``).

:func:`group_norm_relu` is differentiable in x, scale and bias:

- forward: the CUDA kernel ``gn_relu_fwd_bf16`` (``csrc/gn_relu.cu``) for a
  CUDA tensor, which raises if it cannot launch; for a CPU tensor, or with
  ``impl='plain'``, the plain version :func:`group_norm_relu_reference`.
  Both compute two-pass-accurate f32 statistics per (sample, group), eps
  1e-5, then ``relu(((f32(x) - mean) * inv) * s + t)`` with the affine
  rounded to x.dtype first, cast to x.dtype;
- backward: the CUDA kernel ``gn_relu_bwd_bf16`` for a CUDA tensor, else
  the plain version :func:`group_norm_relu_backward_reference`: the
  GroupNorm -> ReLU gradient in f32 from x, the incoming gradient and the
  forward's per-(sample, group) mean and inv, which are all that is saved
  besides the inputs.

Without autograd recording (inference, the train step's gradient-free
refiner pass) only the forward runs.

Each kernel takes one of two routes (``csrc/gn_relu.cu``): ``'cluster'``,
one launch where a sample (for the backward: all B samples, x and dy) fits
in the shared memory of a thread-block cluster, else ``'grid'``, two
launches. ``launches`` counts forward kernel calls and ``bwd_launches``
backward kernel calls by (C, groups, B, D, H, W), only where a kernel is
launched.

With ``space`` (a SpatialGroup of more than one rank: x is this rank's H
slab of each sample), :func:`split_group_norm` runs instead: the slab
statistics kernel ``gn_moments_bf16`` (:func:`gn_moments`), a gather of
every slab's moments over the group, and ``gn_apply_bf16``
(:func:`gn_apply`), which merges them in rank order and normalizes (or
writes the fold rows) as ``gn_relu_fwd_bf16`` does. Its gradient
(:class:`_SplitGroupNormReLU`) is ``gn_relu_bwd_bf16`` in two calls around a
sum over the ranks: ``gn_bwd_sums_bf16`` (:func:`gn_bwd_sums`, the slab's
per-(sample, channel) sums of gy and gy * xhat) and ``gn_bwd_dx_bf16``
(:func:`gn_bwd_dx`, dx from the whole sample's sums, and the slab's ds and
dt). Each has a plain twin. ``moments_launches``, ``apply_launches``,
``bwd_sums_launches`` and ``bwd_dx_launches`` count those calls.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from multimodal_pl_tpu_torch.ops import _build
from multimodal_pl_tpu_torch.ops.norm import _group_stats, split

EPS = 1e-5
IMPLS = ("kernel", "plain")
PATHS = ("cluster", "grid")
STATS_CLUSTER = 8  # blocks of a statistics launch that merge on chip (csrc)
# 16-byte vectors per block of a grid-route launch: at least the first
# (statistics and elementwise launches), at most the second (elementwise:
# past one wave of about 4 blocks per SM of an H100's 132, shorter blocks in
# more waves stream faster than one wave of long ones)
BLOCK_VECS = (2048, 8192)
BLOCKS = 4 * 132
# shared memory of a cluster block beyond its tiles (csrc FWD_SCRATCH,
# BWD_SCRATCH), and 16 bytes per channel
SCRATCH_BYTES = {False: 4 * 2 * 256 * 8 + 256 * 12, True: 4 * 2 * 256 * 8 + 256 * 8}
CLUSTER_BLOCK_VECS = 2048  # 16-byte vectors per cluster block, where the card allows

launches: collections.Counter = collections.Counter()
bwd_launches: collections.Counter = collections.Counter()
# spatial parallelism: gn_moments_bf16 calls by (C, groups, B, D, H, W) and
# gn_apply_bf16 calls by (mode, C, groups, B, D, H, W), mode 'relu' or 'fold'
moments_launches: collections.Counter = collections.Counter()
apply_launches: collections.Counter = collections.Counter()
# its backward on a slab: gn_bwd_sums_bf16 and gn_bwd_dx_bf16 calls by (C,
# groups, B, D, H, W)
bwd_sums_launches: collections.Counter = collections.Counter()
bwd_dx_launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    for counter in (launches, bwd_launches, moments_launches, apply_launches,
                    bwd_sums_launches, bwd_dx_launches):
        counter.clear()


def _check_groups(x: torch.Tensor, groups: int) -> None:
    if x.shape[-1] % groups:
        raise ValueError(f"channels {x.shape[-1]} not divisible by groups {groups}")


def _reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int):
    """-> (y, stats (B, 2, groups) f32 = the groups' mean and inv)."""
    _check_groups(x, groups)
    cpg = x.shape[-1] // groups
    mean_c, inv_c, dev = _group_stats(x, groups, EPS)
    bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    s, t = scale.to(x.dtype).float(), bias.to(x.dtype).float()
    y = torch.relu(dev * inv_c.view(bshape) * s + t).to(x.dtype)
    return y, torch.stack([mean_c[:, ::cpg], inv_c[:, ::cpg]], 1)


def group_norm_relu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                              groups: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: two-pass f32 statistics
    per (sample, group) (mean, then the mean of squared deviations), then
    relu(((f32(x) - mean) * inv) * s + t) in f32 with s, t the affine cast to
    x.dtype, cast to x.dtype."""
    return _reference(x, scale, bias, groups)[0]


def group_norm_relu_backward_reference(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                                       bias: torch.Tensor, stats: torch.Tensor, groups: int):
    """Plain PyTorch version of the backward kernel, in f32: with xhat =
    (x - mean) * inv and gy = dy where the forward's pre-activation xhat * s
    + t is positive (else 0), dt = sum gy and ds = sum gy * xhat over samples
    and voxels, and per (sample, group) P = sum gy * s, Q = sum gy * s * xhat
    over the group's channels and voxels, dx = inv * (gy * s - (P + xhat *
    Q) / count). stats: the forward's (B, 2, groups) mean and inv. Returns
    (dx in x.dtype, ds, dt in f32): :func:`gn_bwd_dx_reference` of the
    sample's own :func:`gn_bwd_sums_reference`."""
    _check_groups(x, groups)
    sums = gn_bwd_sums_reference(x, dy, scale, bias, stats)
    count = x.numel() // x.shape[0] // groups
    return gn_bwd_dx_reference(x, dy, scale, bias, stats, sums, sums, count)


def _gy_xhat(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             stats: torch.Tensor):
    """(gy, xhat, s) in f32 of the plain backward, (B, S, C) each."""
    b, c = x.shape[0], x.shape[-1]
    cpg = c // stats.shape[-1]
    xf = x.float().reshape(b, -1, c)
    mean_c, inv_c = (stats[:, i].float().repeat_interleave(cpg, -1)[:, None] for i in (0, 1))
    s, t = scale.to(x.dtype).float(), bias.to(x.dtype).float()
    xhat = (xf - mean_c) * inv_c
    gy = torch.where(xhat * s + t > 0, dy.float().reshape(b, -1, c), 0.0)
    return gy, xhat, s, inv_c


def gn_bwd_sums_reference(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gn_bwd_sums`: per (sample, channel) the sums
    of gy and gy * xhat over x's voxels, (B, 2, C) f32, from the forward's
    (B, 2, groups) mean and inv."""
    gy, xhat, _, _ = _gy_xhat(x, dy, scale, bias, stats)
    return torch.stack([gy.sum(1), (gy * xhat).sum(1)], 1)


def gn_bwd_dx_reference(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, stats: torch.Tensor, slab_sums: torch.Tensor,
                        sums: torch.Tensor, count: int):
    """Plain version of :func:`gn_bwd_dx`: dx of x from ``sums`` (B, 2, C),
    the whole sample's sums of gy and gy * xhat, P and Q per group over
    ``count`` values; ds, dt (C,) f32 from ``slab_sums``, x's own sums,
    summed over the samples. Returns (dx in x.dtype, ds, dt)."""
    b, c = x.shape[0], x.shape[-1]
    cpg = c // stats.shape[-1]
    gy, xhat, s, inv_c = _gy_xhat(x, dy, scale, bias, stats)
    dt_nc, ds_nc = sums.unbind(1)
    p, q = ((v * s).reshape(b, -1, cpg).sum(-1).repeat_interleave(cpg, -1)[:, None]
            for v in (dt_nc, ds_nc))
    dx = inv_c * (gy * s - (p + xhat * q) / float(count))
    return dx.to(x.dtype).reshape(x.shape), slab_sums[:, 1].sum(0), slab_sums[:, 0].sum(0)


@functools.cache
def _lib():
    lib = _build.load("gn_relu")
    i64, i32, ptr, f32 = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.gn_relu_fwd_bf16.argtypes = ([ptr] * 6 + [i32, i64, i32, i32, f32, i32, i64, i32, i64,
                                                  i32, i64, ptr])
    lib.gn_relu_fwd_bf16.restype = i32
    lib.gn_relu_bwd_bf16.argtypes = ([ptr] * 8 + [i32, i64, i32, i32, i32, i64, i32, i64, i32,
                                                  i64, ptr])
    lib.gn_relu_bwd_bf16.restype = i32
    lib.gn_moments_bf16.argtypes = [ptr] * 3 + [i32, i64, i32, i32, i64, i32, ptr]
    lib.gn_moments_bf16.restype = i32
    lib.gn_apply_bf16.argtypes = ([ptr, ptr, i32] + [ptr] * 4
                                  + [i32, i64, i32, i32, f32, i64, i32, ptr])
    lib.gn_apply_bf16.restype = i32
    lib.gn_bwd_sums_bf16.argtypes = ([ptr] * 3 + [i32] + [ptr] * 5
                                     + [i32, i64, i32, i32, f32, i64, i32, i32, ptr])
    lib.gn_bwd_sums_bf16.restype = i32
    lib.gn_bwd_dx_bf16.argtypes = [ptr] * 9 + [i32, i64, i32, i32, i64, i64, i32, ptr]
    lib.gn_bwd_dx_bf16.restype = i32
    lib.gn_relu_limits.argtypes = [ctypes.POINTER(i32)] * 3
    lib.gn_relu_limits.restype = i32
    lib.gn_relu_error_string.argtypes = [i32]
    lib.gn_relu_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: {_lib().gn_relu_error_string(err).decode()} ({err})")


class Limits(NamedTuple):
    max_cluster: int     # blocks of the largest cluster at full shared memory
    smem: int            # shared memory bytes per block
    stats_clusters: tuple  # co-resident clusters of STATS_CLUSTER blocks: fwd, bwd, fold


@functools.cache
def limits(device_index: int) -> Limits:
    """What the card schedules, from the CUDA occupancy queries."""
    mc, smem, stats = ctypes.c_int(0), ctypes.c_int(0), (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        _raise_on(_lib().gn_relu_limits(ctypes.byref(mc), ctypes.byref(smem), stats),
                  "gn_relu_limits")
    return Limits(mc.value, smem.value, tuple(stats))


def stats_plan(b: int, s: int, c: int, clusters: int):
    """A statistics launch's (rows per block, blocks per sample): one wave of
    the card's co-resident clusters of STATS_CLUSTER blocks (a cluster more
    would wait for a second wave) shared among the B samples, with at least
    BLOCK_VECS[0] 16-byte vectors per block."""
    per_sample = STATS_CLUSTER * max(1, clusters // b)
    rows = max(-(-BLOCK_VECS[0] // (c // 8)), -(-s // per_sample))
    return rows, -(-s // rows)


def sums_plan(b: int, s: int, c: int, clusters: int):
    """gn_bwd_sums_bf16's (rows per block, blocks per sample, cluster):
    ``stats_plan``'s blocks (``clusters``: co-resident clusters of the
    backward's statistics launch), in one launch through one cluster of
    STATS_CLUSTER per sample where they fit one, else cluster 0 (two
    launches: the clusters' partials, then their merge)."""
    rows, nblk = stats_plan(b, s, c, clusters)
    return rows, nblk, STATS_CLUSTER if nblk <= STATS_CLUSTER else 0


def cluster_plan(b: int, s: int, c: int, backward: bool, max_cluster: int, smem: int):
    """The cluster route's (blocks per sample, rows per block, shared memory
    bytes), or None where a sample (backward: all B samples, x and dy) does
    not fit in one cluster's shared memory. Blocks per sample: the fewest
    that hold it, raised towards CLUSTER_BLOCK_VECS vectors per block (more
    SMs at a small sample) as far as the cluster allows."""
    overhead = SCRATCH_BYTES[backward] + 16 * c
    tensors = 2 if backward else 1
    cap = (smem - overhead) // (2 * tensors * c)
    if cap < 1:
        return None
    most = max_cluster // (b if backward else 1)
    m = -(-s // cap)
    if m > most:
        return None
    m = max(m, min(most, -(-s * (c // 8) // CLUSTER_BLOCK_VECS)))
    rows = -(-s // m)
    m = -(-s // rows)
    return m, rows, rows * c * 2 * tensors + overhead


def grid_plan(numel: int, s: int, c: int):
    """The elementwise launch's (rows per block, blocks per sample): about 4
    blocks per SM, within BLOCK_VECS 16-byte vectors per block."""
    lo, hi = BLOCK_VECS
    rows = -(-min(hi, max(lo, numel // 8 // BLOCKS)) // (c // 8))
    return rows, -(-s // rows)


def _check_kernel_input(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    c = t.shape[-1]
    if t.device.type != "cuda":
        raise ValueError(f"gn_relu kernel: no kernel for device {t.device}")
    if t.dtype != torch.bfloat16 or c % 8 or c > 2048 or t.shape != like.shape:
        raise ValueError(f"gn_relu kernel: {name} must be bf16 of x's shape with C a multiple of "
                         f"8 and <= 2048, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"gn_relu kernel: {name} must be contiguous and 16-byte aligned")


def _route(x: torch.Tensor, backward: bool, path):
    if path not in (None, *PATHS):
        raise ValueError(f"gn_relu path must be one of {PATHS} or None, got {path!r}")
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    plan = None
    lim = limits(x.device.index)
    if path != "grid":
        plan = cluster_plan(b, s, c, backward, lim.max_cluster, lim.smem)
        if plan is None and path == "cluster":
            raise ValueError(f"gn_relu kernel: {tuple(x.shape)} does not fit one cluster")
    return b, s, c, plan, lim.stats_clusters[int(backward)]


def gn_relu_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                    path=None):
    """The forward kernel on a CUDA tensor: (y, stats (B, 2, groups) f32).
    path: 'cluster', 'grid' or None (cluster where it fits)."""
    _check_kernel_input("x", x, x)
    _check_groups(x, groups)
    b, s, c, plan, clusters = _route(x, False, path)
    scale, bias = (t.to(device=x.device, dtype=torch.float32).contiguous() for t in (scale, bias))
    out = torch.empty_like(x)
    stats = torch.empty((b, 2, groups), dtype=torch.float32, device=x.device)
    if plan is not None:
        m, rows, smem = plan
        nblk = norm_rows = norm_nblk = 0
        workspace = stats  # unused by the cluster route
    else:
        m, smem = 0, 0
        rows, nblk = stats_plan(b, s, c, clusters)
        norm_rows, norm_nblk = grid_plan(x.numel(), s, c)
        workspace = torch.empty(b * nblk * 2 * c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().gn_relu_fwd_bf16(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
            workspace.data_ptr(), b, s, c, groups, EPS, m, rows, nblk, norm_rows, norm_nblk, smem,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "gn_relu forward launch")
    launches[(c, groups, b, *x.shape[1:-1])] += 1
    return out, stats


def gn_relu_backward(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     stats: torch.Tensor, groups: int, path=None):
    """The backward kernel on CUDA tensors: (dx bf16, ds, dt f32 (C,)).
    path: 'cluster', 'grid' or None (cluster where it fits)."""
    _check_kernel_input("x", x, x)
    _check_kernel_input("dy", dy, x)
    _check_groups(x, groups)
    b, s, c, plan, clusters = _route(x, True, path)
    if stats.shape != (b, 2, groups) or stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError(f"gn_relu backward: stats must be contiguous f32 {(b, 2, groups)}, got "
                         f"{stats.dtype} {tuple(stats.shape)}")
    scale, bias = (t.to(device=x.device, dtype=torch.float32).contiguous() for t in (scale, bias))
    dx = torch.empty_like(x)
    dsdt = torch.empty((2, c), dtype=torch.float32, device=x.device)
    if plan is not None:
        m, rows, smem = plan
        nblk = dx_rows = dx_nblk = 0
        workspace = dsdt  # unused by the cluster route
    else:
        m, smem = 0, 0
        rows, nblk = stats_plan(b, s, c, clusters)
        dx_rows, dx_nblk = grid_plan(x.numel(), s, c)
        workspace = torch.empty(b * nblk * 2 * c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().gn_relu_bwd_bf16(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            dx.data_ptr(), dsdt.data_ptr(), workspace.data_ptr(), b, s, c, groups, m, rows, nblk,
            dx_rows, dx_nblk, smem, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "gn_relu backward launch")
    bwd_launches[(c, groups, b, *x.shape[1:-1])] += 1
    return dx, dsdt[0], dsdt[1]


# ---- spatial parallelism: each sample's H axis split over ranks -----------
#
# A rank holds a slab of every sample. GroupNorm statistics are the whole
# sample's: each rank computes its slab's per-(sample, group) moments, the
# ranks gather them (``space.gather``, one collective of (N, B, 2, groups)
# f32), and each rank merges the N sets in rank order by Chan's formula and
# normalizes or folds its slab from the merged statistics. The slabs hold
# the same number of voxels (the split is even), so each set has the same
# count.


def group_moments_reference(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Plain version of :func:`gn_moments`: per (sample, group) the mean and
    M2 (sum of squared deviations from the mean) in f32, two-pass, as (B, 2,
    groups)."""
    _check_groups(x, groups)
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3))
    m2 = (xf - mean[:, None, :, None]).square().sum(dim=(1, 3))
    return torch.stack([mean, m2], 1)


def merge_moments(moments: torch.Tensor, count: float) -> torch.Tensor:
    """N slabs' (mean, M2) sets (N, B, 2, groups), each of ``count`` values,
    merged in rank order as the kernel merges them (Chan's formula over all
    sets at once: the mean as the first set's plus the mean offset of all
    from it, then M2 = sum(M2_i + count * (mean_i - mean)^2)): (B, 2,
    groups) (mean, M2) of the N * count values."""
    means, m2s = moments[:, :, 0], moments[:, :, 1]
    off = torch.zeros_like(means[0])
    for m in means:
        off = off + count * (m - means[0])
    mean = means[0] + off / (count * moments.shape[0])
    m2 = torch.zeros_like(mean)
    for m, q in zip(means, m2s):
        m2 = m2 + (q + count * (m - mean).square())
    return torch.stack([mean, m2], 1)


def merge_moments_reference(moments: torch.Tensor, count: float,
                            eps: float = EPS) -> torch.Tensor:
    """Plain version of the merge in :func:`gn_apply`: :func:`merge_moments`,
    then (B, 2, groups) (mean, inv = rsqrt(M2 / total + eps))."""
    mean, m2 = merge_moments(moments, count).unbind(1)
    return torch.stack([mean, torch.rsqrt(m2 / (count * moments.shape[0]) + eps)], 1)


def _per_channel(stats: torch.Tensor, c: int):
    cpg = c // stats.shape[-1]
    return (stats[:, i].float().repeat_interleave(cpg, -1) for i in (0, 1))


def group_norm_relu_from_stats_reference(x: torch.Tensor, stats: torch.Tensor,
                                         scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gn_apply`'s normalize from (mean, inv) stats
    (B, 2, groups): relu(((f32(x) - mean) * inv) * s + t) with s, t the affine
    cast to x.dtype, cast to x.dtype."""
    mean_c, inv_c = _per_channel(stats, x.shape[-1])
    bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    s, t = scale.to(x.dtype).float(), bias.to(x.dtype).float()
    return torch.relu((x.float() - mean_c.view(bshape)) * inv_c.view(bshape) * s + t).to(x.dtype)


def fold_from_stats_reference(stats: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """Plain version of :func:`gn_apply`'s fold from (mean, inv) stats (B, 2,
    groups): rows a = inv * scale, b = bias - mean * a, (B, C) f32 each."""
    mean_c, inv_c = _per_channel(stats, scale.shape[0])
    a = inv_c * scale.float()[None]
    return a, bias.float()[None] - mean_c * a


def gn_moments(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The slab statistics kernel (``gn_moments_bf16``) on a CUDA tensor:
    per (sample, group) (mean, M2) f32 as (B, 2, groups), from one read of x."""
    _check_kernel_input("x", x, x)
    _check_groups(x, groups)
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    rows, nblk = stats_plan(b, s, c, limits(x.device.index).stats_clusters[2])
    moments = torch.empty((b, 2, groups), dtype=torch.float32, device=x.device)
    workspace = torch.empty(b * nblk * 2 * c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().gn_moments_bf16(x.data_ptr(), moments.data_ptr(), workspace.data_ptr(), b, s,
                                     c, groups, rows, nblk,
                                     torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "gn_moments launch")
    moments_launches[(c, groups, b, *x.shape[1:-1])] += 1
    return moments


def gn_apply(x: torch.Tensor, moments: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             groups: int, fold: bool = False, eps: float = EPS):
    """GroupNorm of a CUDA slab x from given statistics (``gn_apply_bf16``):
    ``moments`` (N, B, 2, groups) f32 holds the N slabs' (mean, M2), merged
    in rank order in the kernel's prologue, or (B, 2, groups) (mean, inv)
    used as they are. Returns relu(GroupNorm(x)) like x, computed as
    :func:`gn_relu_forward` computes it, or with ``fold`` the fold rows (a,
    b), (B, C) f32 each."""
    _check_kernel_input("x", x, x)
    _check_groups(x, groups)
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    nslab = moments.shape[0] if moments.ndim == 4 else 0
    if (tuple(moments.shape[-3:]) != (b, 2, groups) or moments.dtype != torch.float32
            or not moments.is_contiguous() or moments.device != x.device):
        raise ValueError(f"gn_apply: moments must be contiguous f32 (N, {b}, 2, {groups}) or "
                         f"({b}, 2, {groups}) on {x.device}, got {moments.dtype} "
                         f"{tuple(moments.shape)} on {moments.device}")
    scale, bias = (t.to(device=x.device, dtype=torch.float32).contiguous() for t in (scale, bias))
    out = rows = None
    norm_rows = norm_nblk = 0
    if fold:
        rows = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    else:
        out = torch.empty_like(x)
        norm_rows, norm_nblk = grid_plan(x.numel(), s, c)
    with torch.cuda.device(x.device):
        err = _lib().gn_apply_bf16(
            x.data_ptr(), moments.data_ptr(), nslab, scale.data_ptr(), bias.data_ptr(),
            None if out is None else out.data_ptr(), None if rows is None else rows.data_ptr(),
            b, s, c, groups, eps, norm_rows, norm_nblk, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "gn_apply launch")
    apply_launches[("fold" if fold else "relu", c, groups, b, *x.shape[1:-1])] += 1
    return (rows[0], rows[1]) if fold else out


def gn_bwd_sums(x: torch.Tensor, dy: torch.Tensor, moments: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, groups: int, eps: float = EPS):
    """The slab backward's first kernel (``gn_bwd_sums_bf16``) on CUDA
    tensors: from ``moments`` as :func:`gn_apply` takes them, (stats (B, 2,
    groups) f32, the (mean, inv) used; sums (B, 2, C) f32, this slab's sums
    of gy and gy * xhat per sample and channel). One launch where
    :func:`sums_plan` puts a sample's blocks in one cluster, else two."""
    _check_kernel_input("x", x, x)
    _check_kernel_input("dy", dy, x)
    _check_groups(x, groups)
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    nslab = moments.shape[0] if moments.ndim == 4 else 0
    if (tuple(moments.shape[-3:]) != (b, 2, groups) or moments.dtype != torch.float32
            or not moments.is_contiguous() or moments.device != x.device):
        raise ValueError(f"gn_bwd_sums: moments must be contiguous f32 (N, {b}, 2, {groups}) or "
                         f"({b}, 2, {groups}) on {x.device}, got {moments.dtype} "
                         f"{tuple(moments.shape)} on {moments.device}")
    scale, bias = (t.to(device=x.device, dtype=torch.float32).contiguous() for t in (scale, bias))
    rows, nblk, cluster = sums_plan(b, s, c, limits(x.device.index).stats_clusters[1])
    stats = torch.empty((b, 2, groups), dtype=torch.float32, device=x.device)
    sums = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    workspace = None
    if not cluster:
        workspace = torch.empty(b * nblk * 2 * c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().gn_bwd_sums_bf16(
            x.data_ptr(), dy.data_ptr(), moments.data_ptr(), nslab, scale.data_ptr(),
            bias.data_ptr(), stats.data_ptr(), sums.data_ptr(),
            None if workspace is None else workspace.data_ptr(), b, s, c, groups, eps, rows,
            nblk, cluster, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "gn_bwd_sums launch")
    bwd_sums_launches[(c, groups, b, *x.shape[1:-1])] += 1
    return stats, sums


def gn_bwd_dx(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, slab_sums: torch.Tensor, sums: torch.Tensor, groups: int,
              count: int):
    """The slab backward's second kernel (``gn_bwd_dx_bf16``) on CUDA
    tensors: (dx bf16 like x, from the whole sample's ``sums`` (B, 2, C)
    over ``count`` values per group; ds, dt f32 (C,), this slab's, from its
    own ``slab_sums``)."""
    _check_kernel_input("x", x, x)
    _check_kernel_input("dy", dy, x)
    _check_groups(x, groups)
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    for name, t, shape in (("stats", stats, (b, 2, groups)), ("slab_sums", slab_sums, (b, 2, c)),
                           ("sums", sums, (b, 2, c))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"gn_bwd_dx: {name} must be contiguous f32 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    scale, bias = (t.to(device=x.device, dtype=torch.float32).contiguous() for t in (scale, bias))
    dx = torch.empty_like(x)
    dsdt = torch.empty((2, c), dtype=torch.float32, device=x.device)
    dx_rows, dx_nblk = grid_plan(x.numel(), s, c)
    with torch.cuda.device(x.device):
        err = _lib().gn_bwd_dx_bf16(
            x.data_ptr(), dy.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            slab_sums.data_ptr(), sums.data_ptr(), dx.data_ptr(), dsdt.data_ptr(), b, s, c,
            groups, int(count), dx_rows, dx_nblk, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "gn_bwd_dx launch")
    bwd_dx_launches[(c, groups, b, *x.shape[1:-1])] += 1
    return dx, dsdt[0], dsdt[1]


def split_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                     space, kernel: bool, fold: bool = False, eps: float = EPS):
    """relu(GroupNorm(x)) (or with ``fold`` the fold rows a, b) of this
    rank's slab x with the statistics of the whole samples: the slab's
    moments, gathered over ``space`` (a SpatialGroup), merged in rank order.
    ``kernel``: gn_moments and gn_apply (CUDA tensors), else their plain
    versions. No gradient (:class:`_SplitGroupNormReLU` has one)."""
    return _split_forward(x, scale, bias, groups, space, kernel, fold, eps)[0]


def _split_forward(x, scale, bias, groups, space, kernel: bool, fold: bool = False,
                   eps: float = EPS):
    """(:func:`split_group_norm`'s result, the statistics its backward
    reads: the gathered moments (kernel) or the merged (mean, inv))."""
    _check_groups(x, groups)
    if kernel:
        moments = space.gather(gn_moments(x, groups), "stats")
        return gn_apply(x, moments, scale, bias, groups, fold, eps), moments
    count = float(x.numel() // (x.shape[0] * groups))
    stats = merge_moments_reference(space.gather(group_moments_reference(x, groups), "stats"),
                                    count, eps)
    if fold:
        return fold_from_stats_reference(stats, scale, bias), stats
    return group_norm_relu_from_stats_reference(x, stats, scale, bias), stats


class _SplitGroupNormReLU(torch.autograd.Function):
    """relu(GroupNorm) of an H slab with the whole samples' statistics, and
    its gradient: the slab's sums of gy and gy * xhat (``gn_bwd_sums``),
    summed over the ranks (one all_reduce of (B, 2, C) f32, counted as
    'gn_sums'), then dx from the sums and this slab's ds, dt
    (``gn_bwd_dx``); ds and dt are the slab's parts of the parameter
    gradients, which the train step sums over the ranks."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, space, kernel):
        y, stats = _split_forward(x, scale, bias, groups, space, kernel)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.groups, ctx.space, ctx.kernel = groups, space, kernel
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, stats = ctx.saved_tensors
        groups, space = ctx.groups, ctx.space
        count = x.numel() // x.shape[0] // groups * space.world
        g = g.contiguous()
        if ctx.kernel:
            stats, slab = gn_bwd_sums(x, g, stats, scale, bias, groups)
            total = space.sum_(slab.clone(), "gn_sums")
            dx, ds, dt = gn_bwd_dx(x, g, stats, scale, bias, slab, total, groups, count)
        else:
            slab = gn_bwd_sums_reference(x, g, scale, bias, stats)
            total = space.sum_(slab.clone(), "gn_sums")
            dx, ds, dt = gn_bwd_dx_reference(x, g, scale, bias, stats, slab, total, count)
        return dx, ds.to(scale.dtype), dt.to(bias.dtype), None, None, None


def _forward(x, scale, bias, groups, kernel: bool):
    if kernel:
        return gn_relu_forward(x, scale, bias, groups)
    return _reference(x, scale, bias, groups)


class _GroupNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, kernel):
        y, stats = _forward(x, scale, bias, groups, kernel)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.groups, ctx.kernel = groups, kernel
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, stats = ctx.saved_tensors
        if ctx.kernel:
            dx, ds, dt = gn_relu_backward(x, g.contiguous(), scale, bias, stats, ctx.groups)
        else:
            dx, ds, dt = group_norm_relu_backward_reference(x, g, scale, bias, stats, ctx.groups)
        return dx, ds.to(scale.dtype), dt.to(bias.dtype), None, None


def group_norm_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                    impl: str = "kernel", space=None) -> torch.Tensor:
    """relu(GroupNorm(x)) over an N...C tensor (contiguous channel groups,
    eps 1e-5), differentiable in x, scale and bias. impl='kernel' launches
    the CUDA kernels for a CUDA tensor (bf16, C a multiple of 8) and runs the
    plain versions for a CPU tensor; impl='plain' runs the plain versions.
    ``space``: a SpatialGroup of which x is this rank's H slab
    (:func:`split_group_norm`, differentiable through
    :class:`_SplitGroupNormReLU`), or None."""
    if impl not in IMPLS:
        raise ValueError(f"gn_relu impl must be one of {IMPLS}, got {impl!r}")
    _check_groups(x, groups)
    x = x.contiguous()
    kernel = impl == "kernel" and x.device.type != "cpu"
    recording = torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias))
    if split(space):
        if recording:
            return _SplitGroupNormReLU.apply(x, scale, bias, groups, space, kernel)
        return split_group_norm(x, scale, bias, groups, space, kernel)
    if recording:
        return _GroupNormReLU.apply(x, scale, bias, groups, kernel)
    return _forward(x, scale, bias, groups, kernel)[0]

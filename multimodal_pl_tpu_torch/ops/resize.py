"""Spatial resizing ops, port of ``multimodal_pl_tpu/ops/resize.py``.

- ``upsample_trilinear`` / ``resize_trilinear``: half-pixel-center linear
  interpolation == ``F.interpolate(mode='trilinear', align_corners=False)``;
- ``resize_nearest``: torch's ``mode='nearest'`` floor convention
  (src = floor(dst * in / out)). It carries no gradient in the model or the
  train step (it resizes labels and masks) and stays ``index_select``.

All ops are channels-last: (N, D, H, W, C).

:func:`upsample_trilinear` (x ``factor`` in {2, 4, 8}, optionally + skip)
is differentiable in x and skip:

- forward: the CUDA kernel ``resize3d_fwd`` (``csrc/resize3d.cu``) for a
  CUDA tensor with ``impl='kernel'``, which raises if it cannot launch;
  else the plain version :func:`upsample_trilinear_reference`
  (``F.interpolate``, then the add);
- backward: the CUDA kernel ``resize3d_bwd`` (gather form, no atomics: the
  same bits on every run; one launch, nothing allocated but dx) for a CUDA
  tensor with ``impl='kernel'``; else the plain version
  :func:`upsample_trilinear_backward_reference`, the gradient autograd takes
  for ``F.interpolate`` (deterministic on the CPU). The skip's gradient is
  the incoming gradient itself.

Each launch takes its tiling from :func:`fwd_plan` / :func:`bwd_plan`,
computed here from the shape, dtype and factor; :func:`fwd_block` and
:func:`bwd_block` give the index ranges a block covers, as the kernels
compute them, so that the CPU tests can check the plans.

``launches`` and ``bwd_launches`` count forward and backward kernel calls by
(factor, C, dtype, B, D, H, W, skip) and (factor, C, dtype, B, D, H, W) of
the input x, only where a kernel is launched.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from multimodal_pl_tpu_torch.ops import _build

IMPLS = ("kernel", "plain")
FACTORS = (2, 4, 8)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches: collections.Counter = collections.Counter()
bwd_launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()
    bwd_launches.clear()


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def upsample_trilinear_reference(x: torch.Tensor, factor: int,
                                 skip: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: ``F.interpolate`` by
    ``factor`` (in x.dtype), then ``+ skip``."""
    _, d, h, w, _ = x.shape
    y = _channels_last(F.interpolate(_channels_first(x), size=(d * factor, h * factor, w * factor),
                                     mode="trilinear", align_corners=False))
    return y if skip is None else y + skip


def upsample_trilinear_backward_reference(dy: torch.Tensor, factor: int) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: the gradient that
    autograd takes for ``F.interpolate`` (``upsample_trilinear3d_backward``),
    in dy.dtype."""
    n, do, ho, wo, c = dy.shape
    dx = torch.ops.aten.upsample_trilinear3d_backward(
        _channels_first(dy), [do, ho, wo], [n, c, do // factor, ho // factor, wo // factor],
        False)
    return _channels_last(dx)


# ---- launch plans -----------------------------------------------------------
# csrc/resize3d.cu takes its tiling from these plans and refuses a plan whose
# shared-memory bytes differ from its own layout; the functions below mirror
# the kernels' index ranges so that the CPU tests can check them.

SMEM_MAX = 232448           # shared memory one block may use on an H100 (227 KB)
SMEM_SM = 233472            # shared memory of one SM; each block also takes 1 KB
SMS = 132                   # streaming multiprocessors of an H100 SXM
NT = 256                    # threads per block (csrc NT)
# output bytes a forward block aims to write, with and without the skip (the
# best of tools/resize_plans.py --sweep on an H100 at the model's shapes)
FWD_BLOCK_BYTES = {True: 24 << 10, False: 160 << 10}
FWD_MIN_GRID = 640          # staged forward blocks wanted: some 1.6 waves of 3 blocks per SM
FWD_WAVE = 3 * SMS          # forward blocks resident at once (csrc launch bounds: 3 per SM)
FWD_PART_CHUNKS = 64        # 16-byte chunks of an output row a block part keeps at least
# backward blocks: tiles within 56 KB (4 blocks per SM) at f = 2, 113 KB (2
# per SM) at f = 4 and 180 KB (1 per SM) at f = 8, whose halo planes grow
# with f^2
BWD_SMEM = {2: 56 << 10, 4: 113 << 10, 8: 180 << 10}
# D is split into runs of at least BWD_MIN_DT input planes, or, where dy fits
# in L2 (L2_BYTES) or the grid fills under half the block slots so that the
# halo planes a split re-reads cost little, of D / 2 planes (1 to 4)
BWD_MIN_DT = 5
L2_BYTES = 50 << 20
TILES = (1, 2, 4, 8, 16, 32)


class FwdPlan(NamedTuple):
    hs: int        # input rows h0 per block (their output segments)
    dgroups: int   # groups the output planes od of one input plane's segment fall into
    csplit: int    # parts each output row's 16-byte chunks fall into
    staged: int    # 1: the source rows are staged in shared memory; 0: read through L1
    hblocks: int   # blocks along H: ceil(H / hs)
    grid: int      # N * D * dgroups * hblocks * csplit
    smem: int      # shared-memory bytes per block


class BwdPlan(NamedTuple):
    th: int        # input rows h per block
    tw: int        # input columns w per block
    dt: int        # input planes d per block (the D split)
    hblocks: int
    wblocks: int
    dblocks: int
    grid: int      # N * dblocks * hblocks * wblocks
    smem: int      # shared-memory bytes per block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(v: int, m: int) -> int:
    return _cdiv(v, m) * m


def segment(i: int, n: int, f: int) -> tuple:
    """The outputs [lo, hi) whose first tap i0 is input i of n (csrc seg)."""
    return (0 if i == 0 else f * i + f // 2), (f * n if i == n - 1 else f * i + f + f // 2)


def taps(o: int, n: int, f: int) -> tuple:
    """(i0, i1, l) of output o on an axis of n inputs (csrc taps, exact for
    f in FACTORS)."""
    s = max((o + 0.5) / f - 0.5, 0.0)
    i0 = int(s)
    return i0, min(i0 + 1, n - 1), s - i0


def fwd_smem(h: int, w: int, c: int, f: int, hs: int, esz: int) -> int:
    """Two staged planes of min(hs + 1, H) source rows (each rounded up to 16
    bytes) and the W tap table (8 bytes per output column)."""
    return 2 * _round_up(min(hs + 1, h) * w * c * esz, 16) + 8 * w * f


def bwd_smem(c: int, f: int, th: int, tw: int, esz: int) -> int:
    """Two halo buffers (csrc RING) of f*th + f rows of round_up((f*tw + f) * C, 8)
    + 8 elements, the W-reduced rows and two accumulator planes in f32 (each
    part rounded up to 16 bytes) and the H and W tap tables."""
    n_oh = f * th + f
    pitch = _round_up((f * tw + f) * c, 8) + 8
    return (2 * _round_up(n_oh * pitch * esz, 16) + _round_up(n_oh * tw * c * 4, 16)
            + _round_up(2 * th * tw * c * 4, 16) + (th + tw) * 2 * f * 4)


@functools.cache
def fwd_plan(b: int, d: int, h: int, w: int, c: int, f: int, esz: int, skip: bool) -> FwdPlan:
    """Forward tiling (tuned on an H100 by ``tools/resize_plans.py
    --sweep``). Without a skip, the source rows are staged in shared memory
    and a block writes about FWD_BLOCK_BYTES[False] (fewer od per block
    first, then a power of two of input rows), and the grid has at least
    FWD_MIN_GRID blocks where the shape allows (fewer input rows, then fewer
    od, then more row parts). With a skip, where the skip's reads and the
    stores set the pace, staging only adds its latency: the taps are read
    through L1, a block takes 2 input rows and every od of their segments,
    and its rows are cut into parts of about FWD_BLOCK_BYTES[True]; a small
    call's rows are cut further only while the grid stays within one wave
    (FWD_WAVE): past it, the blocks' fixed costs outweigh the parallelism.
    Parts keep FWD_PART_CHUNKS 16-byte chunks or more."""
    row = w * f * c * esz
    nchunks = _cdiv(row, 16)
    target = FWD_BLOCK_BYTES[skip]
    dgroups, hs, csplit = 1, 1, 1
    if skip:
        hs = min(2, h)
        while (csplit * 2 * target <= hs * f * f * row
               and nchunks // (2 * csplit) >= FWD_PART_CHUNKS):
            csplit *= 2
        while (2 * b * d * _cdiv(h, hs) * csplit <= FWD_WAVE
               and nchunks // (2 * csplit) >= FWD_PART_CHUNKS):
            csplit *= 2
    else:
        while dgroups < f and (f // dgroups) * f * row > target:
            dgroups *= 2
        while 2 * hs <= min(h, target // ((f // dgroups) * f * row)):
            hs *= 2
        while hs > 1 and fwd_smem(h, w, c, f, hs, esz) > SMEM_MAX // 4:
            hs //= 2
    while not skip and b * d * dgroups * _cdiv(h, hs) * csplit < FWD_MIN_GRID:
        if hs > 1:
            hs //= 2
        elif dgroups < f:
            dgroups *= 2
        elif nchunks // (2 * csplit) >= FWD_PART_CHUNKS:
            csplit *= 2
        else:
            break
    hblocks = _cdiv(h, hs)
    staged = int(not skip)
    return FwdPlan(hs, dgroups, csplit, staged, hblocks, b * d * dgroups * hblocks * csplit,
                   fwd_smem(h, w, c, f, hs, esz) if staged else 0)


def _halo(lo: int, hi: int, n: int, f: int) -> tuple:
    """The outputs [lo', hi') that read the inputs [lo, hi) of n."""
    return max(0, f * lo - f // 2), min(f * n, f * hi + f // 2)


def _halo_sum(n: int, t: int, f: int) -> int:
    return sum(b - a for a, b in (_halo(i, min(n, i + t), n, f) for i in range(0, n, t)))


@functools.cache
def bwd_plan(b: int, d: int, h: int, w: int, c: int, f: int, esz: int) -> BwdPlan:
    """Backward tiling (tuned on an H100 by ``tools/resize_plans.py
    --sweep``): the tile of most input positions, squarest first with th >=
    tw and at most NT columns (tw x channel runs: a thread keeps one),
    within BWD_SMEM[f]; then D split into
    the fewest runs that fill the card's block slots (132 SMs times the
    blocks its shared memory lets share one), in runs of at least
    BWD_MIN_DT planes (fewer where the re-read halo planes come from L2)."""
    cv = 16 // esz if c % (16 // esz) == 0 else 1  # channels a thread takes (csrc CV)
    tiles = {(min(th, h), min(tw, w)) for th in TILES for tw in TILES
             if tw <= th and min(tw, w) * (c // cv) <= NT}
    fits = [t for t in tiles if bwd_smem(c, f, *t, esz) <= BWD_SMEM[f]] or [(1, 1)]
    th, tw = max(fits, key=lambda t: (t[0] * t[1], -t[0] / t[1]))
    smem = bwd_smem(c, f, th, tw, esz)
    slots = SMS * max(1, min(8, SMEM_SM // (smem + 1024)))
    hb, wb = _cdiv(h, th), _cdiv(w, tw)

    def runs(k):  # blocks along D when D is split into k runs
        return _cdiv(d, _cdiv(d, k))

    k = 1
    while k < d and b * runs(k) * hb * wb < slots:
        near = b * d * h * w * c * f ** 3 * esz <= L2_BYTES or b * runs(k) * hb * wb < slots // 2
        if _cdiv(d, k + 1) < (max(1, min(4, d // 2)) if near else min(d, BWD_MIN_DT)):
            break
        k += 1
    dt = _cdiv(d, k)
    db = runs(k)
    return BwdPlan(th, tw, dt, hb, wb, db, b * db * hb * wb, smem)


def fwd_block(plan: FwdPlan, shape, f: int, esz: int, blk: int) -> dict:
    """What forward block ``blk`` of ``plan`` does on x of ``shape`` (N, D,
    H, W, C), as the kernel computes it: sample n, planes d0, d1, output
    planes [od_lo, od_hi) (empty: the block returns at once), input rows
    [j_lo, j_hi) with staged source rows [j_lo, j_lo + nrows), and output
    rows [oh_lo, oh_hi), and the 16-byte chunks [lo, hi) of each output row
    it writes."""
    _, d, h, w, c = shape
    nchunks = _cdiv(w * f * c * esz, 16)
    cp = blk % plan.csplit
    blk //= plan.csplit
    hb = blk % plan.hblocks
    blk //= plan.hblocks
    g = blk % plan.dgroups
    blk //= plan.dgroups
    d0, n = blk % d, blk // d
    lo, hi = segment(d0, d, f)
    j_lo = hb * plan.hs
    j_hi = min(h, j_lo + plan.hs)
    return {"n": n, "d0": d0, "d1": min(d0 + 1, d - 1),
            "od": (lo + g * (hi - lo) // plan.dgroups, lo + (g + 1) * (hi - lo) // plan.dgroups),
            "j": (j_lo, j_hi), "nrows": min(j_hi, h - 1) - j_lo + 1,
            "oh": (segment(j_lo, h, f)[0], segment(j_hi - 1, h, f)[1]),
            "chunks": (cp * nchunks // plan.csplit, (cp + 1) * nchunks // plan.csplit)}


def bwd_block(plan: BwdPlan, shape, f: int, blk: int) -> dict:
    """What backward block ``blk`` of ``plan`` does for dx of ``shape`` (N,
    D, H, W, C), as the kernel computes it: sample n, the input ranges d, h,
    w it writes, and the output ranges od, oh, ow it reads ([lo, hi))."""
    _, d, h, w, _ = shape
    wb = blk % plan.wblocks
    blk //= plan.wblocks
    hb = blk % plan.hblocks
    blk //= plan.hblocks
    db, n = blk % plan.dblocks, blk // plan.dblocks
    rng = {"d": (db * plan.dt, min(d, (db + 1) * plan.dt)),
           "h": (hb * plan.th, min(h, (hb + 1) * plan.th)),
           "w": (wb * plan.tw, min(w, (wb + 1) * plan.tw))}
    out = {"n": n, **rng}
    for ax, size in (("d", d), ("h", h), ("w", w)):
        out["o" + ax] = _halo(*rng[ax], size, f)
    return out


def moved_bytes(shape, f: int, esz: int, backward: bool, skip: bool = False) -> int:
    """Bytes a kernel call on x (dx) of ``shape`` (N, D, H, W, C) moves under
    its plan: forward, y (and the skip) once and the source rows each block
    stages or reads; backward, dx once and the dy halo each block reads (rows
    widened to 16-byte copies where they are 16-byte multiples)."""
    b, d, h, w, c = shape
    if backward:
        p = bwd_plan(b, d, h, w, c, f, esz)
        vec = 16 // esz if (w * f * c * esz) % 16 == 0 else 1
        span = sum(min(w * f * c, _cdiv(hi * c, vec) * vec) - lo * c // vec * vec
                   for lo, hi in (_halo(i, min(w, i + p.tw), w, f) for i in range(0, w, p.tw)))
        return (b * _halo_sum(d, p.dt, f) * _halo_sum(h, p.th, f) * span + b * d * h * w * c) * esz
    p = fwd_plan(b, d, h, w, c, f, esz, skip)
    groups = sum(lo + g * (hi - lo) // p.dgroups < lo + (g + 1) * (hi - lo) // p.dgroups
                 for lo, hi in (segment(i, d, f) for i in range(d)) for g in range(p.dgroups))
    rows = sum(min(j + p.hs, h - 1) - j + 1 for j in range(0, h, p.hs))  # staged per plane
    parts = p.csplit if p.staged else 1  # each part stages whole rows; unstaged, its taps
    return (b * groups * rows * 2 * w * c * parts + (1 + skip) * b * d * h * w * c * f ** 3) * esz


@functools.cache
def _lib():
    lib = _build.load("resize3d")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.resize3d_fwd.argtypes = [ptr] * 3 + [i32] * 11 + [i64, ptr]
    lib.resize3d_fwd.restype = i32
    lib.resize3d_bwd.argtypes = [ptr] * 2 + [i32] * 10 + [i64, ptr]
    lib.resize3d_bwd.restype = i32
    lib.resize3d_kernel_launches.argtypes = []
    lib.resize3d_kernel_launches.restype = i64
    lib.resize3d_error_string.argtypes = [i32]
    lib.resize3d_error_string.restype = ctypes.c_char_p
    return lib


def kernel_launches() -> int:
    """Kernel launches the resize3d library has made in this process."""
    return _lib().resize3d_kernel_launches()


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: {_lib().resize3d_error_string(err).decode()} ({err})")


def _check_kernel_input(name: str, t: torch.Tensor, shape, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"resize3d kernel: no kernel for device {t.device}")
    if t.dtype not in _DTYPES or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"resize3d kernel: {name} must be f32 or bf16 {tuple(shape)} of one "
                         f"dtype, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"resize3d kernel: {name} must be contiguous")


def _check_factor(factor: int) -> None:
    if factor not in FACTORS:
        raise ValueError(f"resize3d kernel: factor must be one of {FACTORS}, got {factor}")


def upsample_forward(x: torch.Tensor, factor: int, skip: torch.Tensor | None = None):
    """The forward kernel on CUDA tensors: up_factor(x) [+ skip] in x.dtype,
    the taps and the add in f32, rounded once; one launch on fwd_plan's
    tiling."""
    _check_factor(factor)
    b, d, h, w, c = x.shape
    out_shape = (b, d * factor, h * factor, w * factor, c)
    _check_kernel_input("x", x, x.shape, x.dtype)
    if skip is not None:
        _check_kernel_input("skip", skip, out_shape, x.dtype)
    if x.data_ptr() % 16:  # an unstaged plan reads 16-byte runs of x
        x = x.clone()
    plan = fwd_plan(b, d, h, w, c, factor, x.element_size(), skip is not None)
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().resize3d_fwd(x.data_ptr(), None if skip is None else skip.data_ptr(),
                                  y.data_ptr(), _DTYPES[x.dtype], b, d, h, w, c, factor, plan.hs,
                                  plan.dgroups, plan.csplit, plan.staged, plan.smem,
                                  torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "resize3d forward launch")
    launches[(factor, c, str(x.dtype)[6:], b, d, h, w, skip is not None)] += 1
    return y


def upsample_backward(dy: torch.Tensor, factor: int) -> torch.Tensor:
    """The backward kernel on a CUDA tensor: dx of up_factor at dy, in
    dy.dtype, each element summed in a fixed order in f32 and rounded once;
    one launch on bwd_plan's tiling, nothing allocated but dx."""
    _check_factor(factor)
    b, do, ho, wo, c = dy.shape
    if do % factor or ho % factor or wo % factor:
        raise ValueError(f"resize3d kernel: dy {tuple(dy.shape)} is not x{factor} of an input")
    d, h, w = do // factor, ho // factor, wo // factor
    _check_kernel_input("dy", dy, dy.shape, dy.dtype)
    if dy.data_ptr() % 16:  # the plan takes 16-byte runs of channels
        dy = dy.clone()
    plan = bwd_plan(b, d, h, w, c, factor, dy.element_size())
    dx = torch.empty((b, d, h, w, c), dtype=dy.dtype, device=dy.device)
    with torch.cuda.device(dy.device):
        err = _lib().resize3d_bwd(dy.data_ptr(), dx.data_ptr(), _DTYPES[dy.dtype], b, d, h, w, c,
                                  factor, plan.th, plan.tw, plan.dt, plan.smem,
                                  torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "resize3d backward launch")
    bwd_launches[(factor, c, str(dy.dtype)[6:], b, d, h, w)] += 1
    return dx


def _forward(x, skip, factor, kernel: bool):
    if kernel:
        return upsample_forward(x, factor, skip)
    return upsample_trilinear_reference(x, factor, skip)


class _Upsample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, skip, factor, kernel):
        ctx.factor, ctx.kernel, ctx.has_skip = factor, kernel, skip is not None
        return _forward(x, skip, factor, kernel)

    @staticmethod
    def backward(ctx, g):
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.kernel:
                dx = upsample_backward(g.contiguous(), ctx.factor)
            else:
                dx = upsample_trilinear_backward_reference(g, ctx.factor)
        return dx, (g if ctx.has_skip else None), None, None


def upsample_trilinear(x: torch.Tensor, factor: int = 2, skip: torch.Tensor | None = None,
                       impl: str = "kernel") -> torch.Tensor:
    """x{factor} trilinear upsampling (align_corners=False) of an NDHWC
    tensor, plus ``skip`` (the output's shape) if given; differentiable in x
    and skip. impl='kernel' launches the CUDA kernels for a CUDA tensor (f32
    or bf16, factor 2, 4 or 8; skip of x's dtype) and runs the plain
    versions for a CPU tensor; impl='plain' runs the plain versions."""
    if impl not in IMPLS:
        raise ValueError(f"resize impl must be one of {IMPLS}, got {impl!r}")
    kernel = impl == "kernel" and x.device.type != "cpu"
    x = x.contiguous()
    skip = None if skip is None else skip.contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, skip)):
        return _Upsample.apply(x, skip, factor, kernel)
    return _forward(x, skip, factor, kernel)


def resize_trilinear(x: torch.Tensor, out_spatial: Sequence[int]) -> torch.Tensor:
    """Trilinear resize (plain ``F.interpolate``) of an NDHWC tensor to
    ``out_spatial``. Only growing axes are supported: ``jax.image.resize``
    antialiases when it shrinks. The model's resizes are integer factors
    and go through :func:`upsample_trilinear`."""
    out_spatial = tuple(int(s) for s in out_spatial)
    if any(o < i for o, i in zip(out_spatial, x.shape[1:4])):
        raise ValueError(f"resize_trilinear shrinks {tuple(x.shape[1:4])} -> {out_spatial}")
    return _channels_last(F.interpolate(_channels_first(x), size=out_spatial, mode="trilinear",
                                        align_corners=False))


def _nearest_indices(in_size: int, out_size: int, device) -> torch.Tensor:
    idx = (torch.arange(out_size, device=device) * in_size) // out_size
    return idx.clamp(0, in_size - 1)


def resize_nearest(x: torch.Tensor, out_spatial: Sequence[int]) -> torch.Tensor:
    """Nearest resize (torch floor convention) of the NDHWC spatial axes."""
    for ax, out in zip((1, 2, 3), out_spatial):
        x = x.index_select(ax, _nearest_indices(x.shape[ax], int(out), x.device))
    return x

"""Normalization ops (channels-last), port of ``multimodal_pl_tpu/ops/norm.py``
and of the voxel case of the GroupNorm fold in ``ops/bd.py:422-472``.

GroupNorm statistics are per (sample, group) over (spatial, channels of the
group), eps 1e-5, contiguous channel groups (torch semantics). They are
always f32 and two-pass (mean, then the mean of squared deviations), also for
a bf16 input: ``F.group_norm`` on bf16 would not give the reference's
numbers.

:func:`group_norm_fold` with ``impl='kernel'`` computes the fold rows of a
CUDA tensor with the statistics kernels of ``csrc/gn_relu.cu`` (the port of
the XLA reduction ``ops/bd.py:439 bd_gn_fold``): one read of x, per-block
(count, mean, M2) merged by Chan's formula in a fixed order, which is the
two-pass f32 formula up to summation order. ``fold_launches`` counts its
calls (two launches each) by (C, groups, B, D, H, W), only where the kernel
runs.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from multimodal_pl_tpu_torch.ops import _build

FOLD_IMPLS = ("kernel", "plain")

fold_launches: collections.Counter = collections.Counter()


def _group_stats(x: torch.Tensor, num_groups: int, eps: float):
    """-> (mean, inv_std, x - mean): the first two (B, C) f32, repeated over
    each group's channels; the deviations f32 in the shape of x."""
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    cpg = c // num_groups
    sp = tuple(range(1, x.ndim - 1))
    bshape = (n,) + (1,) * (x.ndim - 2) + (c,)
    cnt = float(math.prod(x.shape[1:-1]) * cpg)
    xf = x.float()
    gmean = xf.sum(dim=sp).view(n, num_groups, cpg).sum(-1) / cnt
    mean_c = gmean.repeat_interleave(cpg, dim=-1)
    dev = xf - mean_c.view(bshape)
    gvar = dev.square().sum(dim=sp).view(n, num_groups, cpg).sum(-1) / cnt
    inv_c = torch.rsqrt(gvar + eps).repeat_interleave(cpg, dim=-1)
    return mean_c, inv_c, dev


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over an N...C tensor. The normalized value is cast to
    x.dtype before the affine, which runs in x.dtype (as the JAX package)."""
    _, inv_c, dev = _group_stats(x, num_groups, eps)
    bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    out = (dev * inv_c.view(bshape)).to(x.dtype)
    return out * scale.to(x.dtype) + bias.to(x.dtype)


def group_norm_relu(x, scale, bias, num_groups: int, eps: float = 1e-5):
    return torch.relu(group_norm(x, scale, bias, num_groups, eps))


def split(space) -> bool:
    """A SpatialGroup of more than one rank (None or one rank: no split)."""
    return space is not None and space.world > 1


def group_norm_fold(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float = 1e-5, impl: str = "plain", space=None):
    """GroupNorm statistics and affine folded into per-sample rows:
    ``normalize(x) * scale + bias == x * a + b``, with a, b of shape (B, C)
    f32 (``a = inv * scale``, ``b = bias - mean * a``). These are the
    prologue rows of :func:`multimodal_pl_tpu_torch.ops.conv3x3.conv3x3_gn`.
    impl='kernel' launches the statistics kernel for a CUDA tensor (bf16, C
    a multiple of 8 and at most 2048) and runs the plain version for a CPU
    tensor; impl='plain' runs the plain version. ``space``: a SpatialGroup
    of which x is this rank's H slab: the statistics are the whole samples'
    (:func:`multimodal_pl_tpu_torch.ops.gn_relu.split_group_norm`)."""
    if impl not in FOLD_IMPLS:
        raise ValueError(f"group_norm_fold impl must be one of {FOLD_IMPLS}, got {impl!r}")
    if split(space):
        from multimodal_pl_tpu_torch.ops.gn_relu import split_group_norm

        return split_group_norm(x.contiguous(), scale, bias, num_groups, space,
                                impl == "kernel" and x.device.type != "cpu", fold=True, eps=eps)
    if impl == "kernel" and x.device.type != "cpu":
        if x.device.type != "cuda":
            raise ValueError(f"group_norm_fold: no kernel for device {x.device}")
        return _fold_kernel(x, scale, bias, num_groups, eps)
    mean_c, inv_c, _ = _group_stats(x, num_groups, eps)
    a = inv_c * scale.float()[None]
    b = bias.float()[None] - mean_c * a
    return a, b


def _fold_lib():
    lib = _build.load("gn_relu")
    fn = lib.gn_fold_bf16
    if fn.argtypes is None:
        i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [ptr] * 5 + [i32, i64, i32, i32, ctypes.c_float, i64, i32, ptr]
        fn.restype = i32
        lib.gn_relu_error_string.argtypes = [i32]
        lib.gn_relu_error_string.restype = ctypes.c_char_p
    return lib


def _fold_kernel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                 eps: float):
    """The statistics kernels: (a, b) as two contiguous (B, C) f32 rows of one
    (2, B, C) tensor, from one ctypes call of two launches."""
    b, c = x.shape[0], x.shape[-1]
    if x.dtype != torch.bfloat16 or c % 8 or c > 2048 or c % groups:
        raise ValueError(f"group_norm_fold kernel: x must be bf16 with C a multiple of 8, "
                         f"at most 2048 and of groups={groups}; got {x.dtype} C={c}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm_fold kernel: x must be contiguous and 16-byte aligned")
    scale, bias = (t.to(device=x.device, dtype=torch.float32).contiguous() for t in (scale, bias))
    from multimodal_pl_tpu_torch.ops.gn_relu import limits, stats_plan

    s = x.numel() // (b * c)
    rows_per_block, nblk = stats_plan(b, s, c, limits(x.device.index).stats_clusters[2])
    rows = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    workspace = torch.empty(b * nblk * 2 * c, dtype=torch.float32, device=x.device)
    lib = _fold_lib()
    with torch.cuda.device(x.device):
        err = lib.gn_fold_bf16(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), rows.data_ptr(),
                               workspace.data_ptr(), b, s, c, groups, eps, rows_per_block, nblk,
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"group_norm_fold launch failed: "
                           f"{lib.gn_relu_error_string(err).decode()} ({err})")
    fold_launches[(c, groups, b, *x.shape[1:-1])] += 1
    return rows[0], rows[1]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis (torch nn.LayerNorm default eps)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias

"""Normalization ops (channels-last), port of ``multimodal_pl_tpu/ops/norm.py``
and of the voxel case of the GroupNorm fold in ``ops/bd.py:422-472``.

GroupNorm statistics are per (sample, group) over (spatial, channels of the
group), eps 1e-5, contiguous channel groups (torch semantics). They are
always f32 and two-pass (mean, then the mean of squared deviations), also for
a bf16 input: ``F.group_norm`` on bf16 would not give the reference's
numbers.
"""

from __future__ import annotations

import math

import torch


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


def group_norm_fold(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float = 1e-5):
    """GroupNorm statistics and affine folded into per-sample rows:
    ``normalize(x) * scale + bias == x * a + b``, with a, b of shape (B, C)
    f32 (``a = inv * scale``, ``b = bias - mean * a``). These are the
    prologue rows of :func:`multimodal_pl_tpu_torch.ops.conv3x3.conv3x3_gn`."""
    mean_c, inv_c, _ = _group_stats(x, num_groups, eps)
    a = inv_c * scale.float()[None]
    b = bias.float()[None] - mean_c * a
    return a, b


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis (torch nn.LayerNorm default eps)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias

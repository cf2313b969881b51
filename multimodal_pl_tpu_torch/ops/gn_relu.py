"""GroupNorm -> ReLU for training, port of
``multimodal_pl_tpu/ops/pallas/fused_gn_relu.py::fused_group_norm_relu`` and
of its custom VJP (``multimodal_pl_tpu/ops/norm.py:81-102``).

:func:`group_norm_relu` is an autograd function:

- forward: the CUDA kernel (``csrc/gn_relu.cu``) for a CUDA tensor, which
  raises if it cannot launch; for a CPU tensor, or with ``impl='plain'``, the
  plain version :func:`group_norm_relu_reference`. Both compute the kernel's
  formula: one-pass f32 moments ``E[x^2] - mean^2`` per (sample, group),
  eps 1e-5, the affine in f32 before the cast to x.dtype;
- backward: recomputes the reference formula (the two-pass
  :func:`~multimodal_pl_tpu_torch.ops.norm.group_norm` followed by ReLU)
  under autograd, as ``_gn_relu_bwd`` does. Only the inputs are saved.

``launches`` counts kernel calls by (C, groups, B, D, H, W), only where the
kernel is launched (one call = its statistics, moments and normalize
launches).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from multimodal_pl_tpu_torch.ops import _build
from multimodal_pl_tpu_torch.ops.norm import group_norm

EPS = 1e-5
IMPLS = ("kernel", "plain")
STATS_VECS = 16384  # 16-byte vectors per statistics block (64 per thread)
NORM_VECS = 8192    # 16-byte vectors per normalize block (32 per thread)

launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()


def _check_groups(x: torch.Tensor, groups: int) -> None:
    if x.shape[-1] % groups:
        raise ValueError(f"channels {x.shape[-1]} not divisible by groups {groups}")


def group_norm_relu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                              groups: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one-pass f32 moments per (sample,
    group) (fused_gn_relu.py:84-94), then relu((f32(x) - mean) * inv * scale
    + bias) in f32 with the affine cast to x.dtype first, cast to x.dtype."""
    _check_groups(x, groups)
    b, c = x.shape[0], x.shape[-1]
    cpg = c // groups
    xf = x.float().reshape(b, -1, c)
    count = float(xf.shape[1] * cpg)
    gmean = xf.sum(1).reshape(b, groups, cpg).sum(-1) / count
    gvar = xf.square().sum(1).reshape(b, groups, cpg).sum(-1) / count - gmean * gmean
    mean = gmean.repeat_interleave(cpg, dim=-1)
    inv = torch.rsqrt(gvar + EPS).repeat_interleave(cpg, dim=-1)
    s, t = scale.to(x.dtype).float(), bias.to(x.dtype).float()
    y = (xf - mean[:, None]) * inv[:, None] * s + t
    return torch.relu(y).to(x.dtype).reshape(x.shape)


def _lib():
    lib = _build.load("gn_relu")
    if lib.gn_relu_bf16.argtypes is None:
        i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        lib.gn_relu_bf16.argtypes = [ptr] * 5 + [i32, i64, i32, i32, i64, i32, i64, i32, ptr]
        lib.gn_relu_bf16.restype = i32
        lib.gn_relu_error_string.argtypes = [i32]
        lib.gn_relu_error_string.restype = ctypes.c_char_p
    return lib


def _kernel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            groups: int) -> torch.Tensor:
    """The CUDA kernel: statistics, moments and normalize launches from one
    call, with the partials and moments in one f32 workspace."""
    b, c = x.shape[0], x.shape[-1]
    if x.dtype != torch.bfloat16 or c % 8 or c > 2048:
        raise ValueError(f"gn_relu kernel: x must be bf16 with C a multiple of 8 "
                         f"and <= 2048, got {x.dtype} C={c}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("gn_relu kernel: x must be contiguous and 16-byte aligned")
    scale, bias = (t.to(device=x.device, dtype=torch.float32).contiguous() for t in (scale, bias))
    s = x.numel() // (b * c)
    v = c // 8
    s_rows = -(-STATS_VECS // v)
    s_blk = -(-s // s_rows)
    n_rows = -(-NORM_VECS // v)
    n_blk = -(-s // n_rows)
    workspace = torch.empty(b * (s_blk + 1) * 2 * c, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.gn_relu_bf16(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                               workspace.data_ptr(), b, s, c, groups, s_rows, s_blk, n_rows,
                               n_blk, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gn_relu launch failed: {lib.gn_relu_error_string(err).decode()} "
                           f"({err})")
    launches[(c, groups, b, *x.shape[1:-1])] += 1
    return out


class _GroupNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, impl):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups = groups
        if impl == "plain" or x.device.type == "cpu":
            return group_norm_relu_reference(x, scale, bias, groups)
        if x.device.type != "cuda":
            raise ValueError(f"gn_relu: no kernel for device {x.device}")
        return _kernel(x, scale, bias, groups)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            xs, ss, bs = (t.detach().requires_grad_(need)
                          for t, need in zip((x, scale, bias), ctx.needs_input_grad[:3]))
            y = torch.relu(group_norm(xs, ss, bs, ctx.groups, EPS))
            inputs = [t for t in (xs, ss, bs) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, inputs, g.to(y.dtype)))
        return (*(next(grads) if need else None for need in ctx.needs_input_grad[:3]),
                None, None)


def group_norm_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                    impl: str = "kernel") -> torch.Tensor:
    """relu(GroupNorm(x)) over an N...C tensor (contiguous channel groups,
    eps 1e-5), differentiable in x, scale and bias. impl='kernel' launches
    the CUDA kernel for a CUDA tensor (bf16, C a multiple of 8) and runs the
    plain version for a CPU tensor; impl='plain' runs the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"gn_relu impl must be one of {IMPLS}, got {impl!r}")
    _check_groups(x, groups)
    return _GroupNormReLU.apply(x.contiguous(), scale, bias, groups, impl)

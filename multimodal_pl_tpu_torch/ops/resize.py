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
  same bits on every run) for a CUDA tensor with ``impl='kernel'``; else the
  plain version :func:`upsample_trilinear_backward_reference`, the
  gradient autograd takes for ``F.interpolate`` (deterministic on the CPU).
  The skip's gradient is the incoming gradient itself.

``launches`` and ``bwd_launches`` count forward and backward kernel calls by
(factor, C, dtype, B, D, H, W, skip) and (factor, C, dtype, B, D, H, W) of
the input x, only where a kernel is launched.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Sequence

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


@functools.cache
def _lib():
    lib = _build.load("resize3d")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.resize3d_fwd.argtypes = [ptr] * 3 + [i32] * 7 + [ptr]
    lib.resize3d_fwd.restype = i32
    lib.resize3d_bwd.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    lib.resize3d_bwd.restype = i32
    lib.resize3d_error_string.argtypes = [i32]
    lib.resize3d_error_string.restype = ctypes.c_char_p
    return lib


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
    the taps and the add in f32, rounded once."""
    _check_factor(factor)
    b, d, h, w, c = x.shape
    out_shape = (b, d * factor, h * factor, w * factor, c)
    _check_kernel_input("x", x, x.shape, x.dtype)
    if skip is not None:
        _check_kernel_input("skip", skip, out_shape, x.dtype)
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().resize3d_fwd(x.data_ptr(), None if skip is None else skip.data_ptr(),
                                  y.data_ptr(), _DTYPES[x.dtype], b, d, h, w, c, factor,
                                  torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "resize3d forward launch")
    launches[(factor, c, str(x.dtype)[6:], b, d, h, w, skip is not None)] += 1
    return y


def upsample_backward(dy: torch.Tensor, factor: int) -> torch.Tensor:
    """The backward kernel on a CUDA tensor: dx of up_factor at dy, in
    dy.dtype, each element summed in a fixed order in f32 and rounded once
    (three launches through f32 scratch)."""
    _check_factor(factor)
    b, do, ho, wo, c = dy.shape
    if do % factor or ho % factor or wo % factor:
        raise ValueError(f"resize3d kernel: dy {tuple(dy.shape)} is not x{factor} of an input")
    d, h, w = do // factor, ho // factor, wo // factor
    _check_kernel_input("dy", dy, dy.shape, dy.dtype)
    t1 = torch.empty((b, do, ho, w, c), dtype=torch.float32, device=dy.device)
    t2 = torch.empty((b, do, h, w, c), dtype=torch.float32, device=dy.device)
    dx = torch.empty((b, d, h, w, c), dtype=dy.dtype, device=dy.device)
    with torch.cuda.device(dy.device):
        err = _lib().resize3d_bwd(dy.data_ptr(), t1.data_ptr(), t2.data_ptr(), dx.data_ptr(),
                                  _DTYPES[dy.dtype], b, d, h, w, c, factor,
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

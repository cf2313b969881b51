"""Fused GroupNorm-apply -> ReLU -> stride-1 3x3x3 SAME conv (+ residual),
and the training conv built on it.

One CUDA kernel (``csrc/conv3x3_gn.cu``) with two specializations replaces
four Pallas kernels of the JAX package:

- prologue on (``a``, ``b`` given): ``ops/pallas/bdx.py::bdx_gn_conv`` on the
  inference path and ``ops/pallas/k2_conv.py::k2_gn_conv`` in the train
  step's gradient-free refiner pass;
- prologue off: ``ops/pallas/bk3_conv.py::bk3_impl`` on the inference path,
  and ``ops/pallas/k2_conv.py::k2_conv`` as :func:`conv3x3_train`, whose
  forward and dx both launch it (dx on flipped taps with the channels
  swapped, as ``_k2_bwd`` does).

:func:`conv3x3_gn` launches the kernel for a CUDA tensor and raises if it
cannot, or if autograd is recording (the kernel has no backward; use
:func:`conv3x3_train`); for a CPU tensor it runs the plain version
:func:`conv3x3_gn_reference`. ``launches`` counts kernel launches by
(spec, Cin, Cout, B, D, H, W, has_res), only where the kernel is launched.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from multimodal_pl_tpu_torch.ops import _build

FUSED = "fused"                # prologue on (bdx, k2_gn)
PROLOGUE_OFF = "prologue_off"  # plain conv (bk3)
TRAIN_FWD = "train_fwd"        # conv3x3_train forward (k2)
TRAIN_DX = "train_dx"          # conv3x3_train dx (k2 backward)
SPECS = (FUSED, PROLOGUE_OFF, TRAIN_FWD, TRAIN_DX)

# key: (specialization, Cin, Cout, B, D, H, W, has_res) -> kernel launches
launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()


def launch_totals() -> dict:
    """Launches per specialization since the last reset."""
    out = dict.fromkeys(SPECS, 0)
    for key, n in launches.items():
        out[key[0]] += n
    return out


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> (27, Cin, Cout), tap index kd*9 + kh*3 + kw."""
    cout, cin = w.shape[0], w.shape[1]
    return w.permute(2, 3, 4, 1, 0).reshape(27, cin, cout).contiguous()


def conv3x3_gn_reference(x: torch.Tensor, w: torch.Tensor,
                         a: torch.Tensor | None = None,
                         b: torch.Tensor | None = None,
                         res: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv3x3_gn`, in f32:
    t = x.dtype(relu(f32(x) * a + b)) (or x), zero-padded AFTER the prologue,
    y = conv3d_SAME(t, w) (+ f32(res)), returned in x.dtype."""
    t = x.float()
    if a is not None:
        t = torch.relu(t * a.float()[:, None, None, None, :]
                       + b.float()[:, None, None, None, :]).to(x.dtype).float()
    y = F.conv3d(t.permute(0, 4, 1, 2, 3), w.float(), padding=1).permute(0, 2, 3, 4, 1)
    if res is not None:
        y = y + res.float()
    return y.to(x.dtype)


def _lib():
    lib = _build.load("conv3x3_gn")
    fn = lib.conv3x3_gn_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.conv3x3_gn_error_string.argtypes = [ctypes.c_int]
        lib.conv3x3_gn_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"conv3x3_gn: {name} is {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}, expected {tuple(shape)} {dtype} on {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"conv3x3_gn: {name} must be contiguous and 16-byte aligned")


def _launch(spec: str, x: torch.Tensor, w: torch.Tensor, a=None, b=None,
            res=None) -> torch.Tensor:
    bsz, d, h, wd, cin = x.shape
    cout = w.shape[0]
    if cin % 8 or cout % 8:
        raise ValueError(f"conv3x3_gn: Cin={cin}, Cout={cout} must be multiples of 8")
    bf16 = torch.bfloat16
    _check("x", x, (bsz, d, h, wd, cin), bf16, x.device)
    wp = pack_weight(w)
    _check("w", wp, (27, cin, cout), bf16, x.device)
    if a is not None:
        _check("a", a, (bsz, cin), torch.float32, x.device)
        _check("b", b, (bsz, cin), torch.float32, x.device)
    if res is not None:
        _check("res", res, (bsz, d, h, wd, cout), bf16, x.device)
    out = torch.empty((bsz, d, h, wd, cout), dtype=bf16, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv3x3_gn_bf16(
            x.data_ptr(), wp.data_ptr(),
            None if a is None else a.data_ptr(), None if b is None else b.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(),
            bsz, d, h, wd, cin, cout, stream)
    if err:
        msg = lib.conv3x3_gn_error_string(err).decode()
        raise RuntimeError(f"conv3x3_gn launch failed: {msg} ({err})")
    launches[(spec, cin, cout, bsz, d, h, wd, res is not None)] += 1
    return out


def conv3x3_gn(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor | None = None,
               b: torch.Tensor | None = None,
               res: torch.Tensor | None = None) -> torch.Tensor:
    """relu(x * a + b) -> 3x3x3 SAME conv with w (Cout, Cin, 3, 3, 3) -> + res.

    x: (B, D, H, W, Cin); a, b: (B, Cin) f32 folded GroupNorm rows
    (:func:`~multimodal_pl_tpu_torch.ops.norm.group_norm_fold`) or both None
    for no prologue; res: (B, D, H, W, Cout) or None. On CUDA: x, w and res
    bf16, Cin and Cout multiples of 8, no input requiring grad while grad
    mode is on; the output is bf16."""
    if (a is None) != (b is None):
        raise ValueError("conv3x3_gn: pass both fold rows a and b, or neither")
    if x.device.type == "cpu":
        return conv3x3_gn_reference(x, w, a, b, res)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_gn: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, w, a, b, res)):
        raise RuntimeError("conv3x3_gn: the CUDA kernel has no backward and an input "
                           "requires grad; use conv3x3_train under autograd")
    return _launch(FUSED if a is not None else PROLOGUE_OFF, x, w, a, b, res)


def _conv_plain_or_kernel(spec: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv3x3_gn_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_train: no kernel for device {x.device}")
    return _launch(spec, x, w)


def weight_grad(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dw of the stride-1 SAME conv: the library's convolution backward with
    output mask (False, True, False). The JAX package computes this dw in XLA,
    outside any Pallas kernel (k2_conv.py:371-383)."""
    return torch.ops.aten.convolution_backward(
        g.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), w, None, [1, 1, 1],
        [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1, [False, True, False])[1]


class _Conv3x3Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv_plain_or_kernel(TRAIN_FWD, x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # full correlation == pad-1 conv with the taps flipped and the
            # channels swapped (k2_conv.py:354-366)
            dx = _conv_plain_or_kernel(TRAIN_DX, g, w.flip((2, 3, 4)).transpose(0, 1))
        if ctx.needs_input_grad[1]:
            dw = weight_grad(x, g, w)
        return dx, dw


def conv3x3_train(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable stride-1 3x3x3 SAME conv, (B, D, H, W, Cin) x
    (Cout, Cin, 3, 3, 3) -> (B, D, H, W, Cout): the port of TPU kernel
    ``k2_conv``. Forward and dx launch the conv3x3_gn kernel with the prologue
    off for a CUDA tensor (bf16, channels multiples of 8) and run its plain
    version for a CPU tensor; dw is :func:`weight_grad`."""
    return _Conv3x3Train.apply(x.contiguous(), w)

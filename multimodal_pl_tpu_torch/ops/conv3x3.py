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
:func:`conv3x3_gn_reference`. ``launches`` counts kernel calls by
(spec, Cin, Cout, B, D, H, W, has_res), only where the kernel runs. One call
is one launch of the conv kernel, plus one of the split-K reduction when
:func:`plan` splits K across blocks (shapes with fewer than 2 x 132 output
tiles).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from multimodal_pl_tpu_torch.ops import _build

FUSED = "fused"                # prologue on (bdx, k2_gn)
PROLOGUE_OFF = "prologue_off"  # plain conv (bk3)
TRAIN_FWD = "train_fwd"        # conv3x3_train forward (k2)
TRAIN_DX = "train_dx"          # conv3x3_train dx (k2 backward)
SPECS = (FUSED, PROLOGUE_OFF, TRAIN_FWD, TRAIN_DX)

N_SIZES = (16, 24, 32, 48, 64, 96, 128, 192, 256)  # wgmma widths the kernel is built for
TILE = (2, 4, 16)   # the kernel's output tile (D, H, W) at N > 128; D is 4 at N <= 128
MAX_SMEM = 232448   # shared memory of one block (227 KB)
SMS = 132           # streaming multiprocessors of an H100 SXM

# key: (specialization, Cin, Cout, B, D, H, W, has_res) -> kernel calls
launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()


def launch_totals() -> dict:
    """Launches per specialization since the last reset."""
    out = dict.fromkeys(SPECS, 0)
    for key, n in launches.items():
        out[key[0]] += n
    return out


def smem_bytes(kc: int, n: int, chunks: int) -> int:
    """Shared memory of one block, as the kernel lays it out
    (``csrc/conv3x3_gn.cu::smem_bytes``, which refuses a plan that does not
    fit): up to two halo stages, two weight stages of 9 taps (or the f32
    epilogue tile, if larger), and the sample's a, b rows."""
    mt = 2 if n <= 128 else 1
    halo = min(2, chunks) * (2 * mt + 2) * (TILE[1] + 2) * (TILE[2] + 2) * (kc + 8) * 2
    main = max(halo + 2 * 9 * kc * n * 2, 128 * mt * (n + 4) * 4)
    return main + 2 * chunks * kc * 4


@functools.lru_cache(maxsize=None)
def plan(bsz: int, d: int, h: int, w: int, cin: int, cout: int) -> tuple[int, int, int]:
    """(KC, N, split) of one kernel call: KC, the Cin chunk of one pipeline
    stage, is the widest of 64, 48, 32, 16 (the wgmma K step) that divides
    Cin, or holds all of a Cin below it zero-padded, and whose stages fit
    the 227 KB of shared memory (half of it at N <= 64, where two blocks
    share an SM, if any KC fits there); N, the wgmma width, is the narrowest of
    ``N_SIZES`` that holds Cout, so a block holds every output channel up to
    256; split is the number of blocks K = 27 * Cin is split across, in
    (chunk, kd) planes, when the output tiles give fewer than 2 x 132 blocks
    (at least 2 planes per split)."""
    n = next((v for v in N_SIZES if v >= cout), N_SIZES[-1])
    cands = [k for k in (64, 48, 32, 16) if cin % k == 0 or cin < k <= cin + 15] + [16]
    # at N <= 64 the kernel holds two blocks per SM where their stages fit
    budgets = (MAX_SMEM // 2, MAX_SMEM) if n <= 64 else (MAX_SMEM,)
    kc = next(k for budget in budgets for k in cands
              if smem_bytes(k, n, -(-cin // k)) <= budget)
    tile = (4 if n <= 128 else 2,) + TILE[1:]
    tiles = math.prod(-(-s // t) for s, t in zip((d, h, w), tile))
    blocks = bsz * tiles * -(-cout // n)
    planes = 3 * -(-cin // kc)
    split = 1 if blocks >= 2 * SMS else max(1, min(-(-2 * SMS // blocks), planes // 2))
    return kc, n, split


def pack_weight(w: torch.Tensor, kc: int, n: int) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> the kernel's tile order
    [Cin chunk][N block][tap][N/8][KC/8][8][8] (tap index kd*9 + kh*3 + kw):
    per (chunk, N block, tap) a KC x N matrix in wgmma's K-major core-matrix
    order, so that the 9 taps of a depth plane are one contiguous stage;
    zero-padded to whole chunks of KC and blocks of N."""
    cout, cin = w.shape[0], w.shape[1]
    chunks, nblocks = -(-cin // kc), -(-cout // n)
    wk = w.reshape(cout, cin, 27)  # a view: one copy below, two when padded
    if chunks * kc != cin or nblocks * n != cout:
        wk = F.pad(wk, (0, 0, 0, chunks * kc - cin, 0, nblocks * n - cout))
    wk = wk.view(nblocks, n // 8, 8, chunks, kc // 8, 8, 27)
    return wk.permute(3, 0, 6, 1, 4, 2, 5).contiguous()


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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
    kc, n, split = plan(bsz, d, h, wd, cin, cout)
    if w.dtype != bf16 or w.device != x.device:
        raise ValueError(f"conv3x3_gn: w is {w.dtype} on {w.device}, expected {bf16} on "
                         f"{x.device}")
    wp = pack_weight(w, kc, n)
    if a is not None:
        _check("a", a, (bsz, cin), torch.float32, x.device)
        _check("b", b, (bsz, cin), torch.float32, x.device)
    if res is not None:
        _check("res", res, (bsz, d, h, wd, cout), bf16, x.device)
    out = torch.empty((bsz, d, h, wd, cout), dtype=bf16, device=x.device)
    ws = None  # split-K partials, summed in split order by the second launch
    if split > 1:
        ws = torch.empty(split * out.numel(), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv3x3_gn_bf16(
            x.data_ptr(), wp.data_ptr(),
            None if a is None else a.data_ptr(), None if b is None else b.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            bsz, d, h, wd, cin, cout, kc, n, split, stream)
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

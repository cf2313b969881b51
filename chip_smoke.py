#!/usr/bin/env python3
"""Drive the PyTorch port (multimodal_pl_tpu_torch) on one NVIDIA GPU and
check it. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on any failed check:

1. the card's name and power limit; build csrc/conv3x3_gn.cu and
   csrc/gn_relu.cu with nvcc for sm_90a, one nvcc per source started
   together (timed, ptxas report kept);
2. the conv3x3_gn kernel vs its plain PyTorch version (f32, TF32 off) on the
   same bf16 inputs, at every shape one 4 x 64 x 192 x 192 tile batch of the
   flagship UNet3DFEAM gives it: max|k - p| <= 1e-2 * max|p|; kernel, plain
   and library (cuDNN bf16 conv) times and the bound; then the GroupNorm
   fold statistics kernel vs the plain fold at every fused conv's input:
   rows a, b within rel 1e-5;
3. the whole model on one bf16 tile batch, conv_impl='kernel' vs 'plain'
   with the same weights: relative L2 error of the logits <= 3e-2, 22 conv
   calls (18 fused, 4 prologue-off) and 18 fold calls, every launched shape
   covered by phase 2;
4. the serving path: SlidingWindowPredictor(output='argmax', window_batch=4,
   bf16) over seeded 128 x 256 x 256 volumes (12 windows): a uint8 label map
   of labels < 14, 66 conv and 54 fold calls per volume, agreement with the
   plain model's label map; then predict_iter over 5 volumes (s/vol);
5. the evaluation entry point: mpl-evaluate-torch's main() on 2 synthetic
   cases with random weights written as .npz; its CSV;
6. the training kernels vs their plain versions at every shape one
   full-geometry train step (B = 1, 64 x 192 x 192, bf16) launches, derived
   from the architecture: gn_relu at every GroupNorm width of the segmenter
   and the refiner; conv3x3_train forward and dx at every stride-1 conv (dw,
   the library's, by relative Frobenius norm); conv3x3_gn at the refiner's
   gradient-free shapes (B = 11); kernel ms, plain ms, TFLOP/s;
7. the training path: the train step at the full geometry from one seeded
   state and batch, kernel vs plain (total loss, segmenter gradients), then
   3 kernel steps: finite losses, moving parameters, finite tokens, the exact
   calls per step of every kernel (the fold's 10 included), ms/step, peak
   memory;
8. the training entry point: mpl-train-torch's main() on synthetic cases at
   64 x 192 x 192 for 2 epochs with validation after each (through the
   serving kernel), a checkpoint, and a resumed epoch.

Kernel "launches" are calls of a wrapper (a conv3x3_gn call split across
blocks launches a second, reduction kernel; a fold call launches two).
Kernel, plain and library times are device times per call (CUDA graph
replays); bounds are max(FLOP / 989e12, bytes / 3.35e12) per call (H100 SXM
dense bf16 and HBM3 peaks), with every input read once and every output
written once. Prints the kernels' JSON line, the card line, and as the last line
{"ok": true, "device": {...}}. Weights are random from fixed seeds. Details
go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

VOL = (128, 256, 256)
TILE = (64, 192, 192)
NC = 14
WINDOW_BATCH = 4
N_STREAM = 5
BDX = "multimodal_pl_tpu/ops/pallas/bdx.py:247"
BK3 = "multimodal_pl_tpu/ops/pallas/bk3_conv.py:163"
K2 = "multimodal_pl_tpu/ops/pallas/k2_conv.py:338"
K2_GN = "multimodal_pl_tpu/ops/pallas/k2_conv.py:277"
GN_RELU = "multimodal_pl_tpu/ops/pallas/fused_gn_relu.py:54"
GN_FOLD = "multimodal_pl_tpu/ops/bd.py:439 bd_gn_fold (XLA)"
PEAK_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
FOLD_REL = 1e-5       # fold rows kernel vs plain: f32 summation order only
SOURCE = "multimodal_pl_tpu_torch/csrc/conv3x3_gn.cu"
GN_SOURCE = "multimodal_pl_tpu_torch/csrc/gn_relu.cu"
PATCH = (64, 192, 192)      # the training patch (StepConfig / cli/train.py defaults)
# Kernel vs plain train step. In bf16 the segmenter gradients of the plain
# step and of the kernel step each sit 0.22 (relative Frobenius norm) from
# the f32 plain step's at random init, so two bf16 routes differ by ~0.13
# (H100 runs) and 5e-2 cannot hold for the whole tree: GRAD_REL_LIMIT holds it
# at 0.2. The check that separates a wrong kernel is per leaf, over the
# segmenter's and the refiner's 227 gradients: each leaf of the kernel step
# may be at most LEAF_RATIO times as far from the f32 step as the plain bf16
# step's leaf is, plus LEAF_FLOOR. With this floor a clean step needs a
# ratio of 1.17; each of 7 dx faults planted at one conv (taps unflipped,
# dx x 1.1, half the channels zeroed; in the segmenter or the refiner) needs
# 1.49 to 28, while the whole-tree checks catch only 2 of them.
GRAD_REL_LIMIT = 0.2
LEAF_RATIO = 1.4
LEAF_FLOOR = 1e-2

# (Cin, Cout, (D, H, W), prologue, residual) of every conv3x3_gn call in one
# forward of a 4 x 64 x 192 x 192 tile batch
FUSED_RES = [(32, 32, (64, 192, 192)), (64, 64, (32, 96, 96)), (128, 128, (16, 48, 48)),
             (256, 256, (8, 24, 24)), (256, 256, (4, 12, 12))]
FUSED_NO_RES = [(256, 128, (8, 24, 24)), (128, 128, (8, 24, 24)), (128, 64, (16, 48, 48)),
                (64, 64, (16, 48, 48)), (64, 32, (32, 96, 96)), (32, 32, (32, 96, 96))]
PROLOGUE_OFF = [(64, 64, (32, 96, 96)), (128, 128, (16, 48, 48)),
                (256, 256, (8, 24, 24)), (256, 256, (4, 12, 12))]
SHAPES = ([(ci, co, s, True, True) for ci, co, s in FUSED_RES]
          + [(ci, co, s, True, False) for ci, co, s in FUSED_RES + FUSED_NO_RES]
          + [(ci, co, s, False, False) for ci, co, s in PROLOGUE_OFF])


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bound(flop: float, nbytes: float) -> dict:
    """The least time of one call: op_ms and byte_ms at the card's peaks,
    bound_ms the larger."""
    op_ms, byte_ms = flop / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"op_ms": op_ms, "byte_ms": byte_ms, "bound_ms": max(op_ms, byte_ms)}


def conv_bound(b, d, h, w, cin, cout, prologue, res) -> dict:
    """3x3x3 conv: 2*27*Cin*Cout FLOP per output voxel; x, w, out (+ res, +
    the a, b rows) moved once."""
    vox = b * d * h * w
    nbytes = 2 * vox * (cin + cout) + 2 * 27 * cin * cout
    nbytes += 2 * vox * cout if res else 0
    nbytes += 2 * 4 * b * cin if prologue else 0
    return bound(2 * 27 * cin * cout * vox, nbytes)


def sum_bound(rows) -> dict:
    """Bound of a sequence of calls, (count, row with op_ms/byte_ms): the sum
    of each call's bound, bound by what dominates the sum."""
    rows = list(rows)
    op = sum(n * r["op_ms"] for n, r in rows)
    by = sum(n * r["byte_ms"] for n, r in rows)
    return {"bound_ms": sum(n * max(r["op_ms"], r["byte_ms"]) for n, r in rows),
            "bound_by": "operations" if op >= by else "bytes"}


def time_ms(fn, reps: int) -> float:
    """Device time of one fn() call (CUDA-graph replays)."""
    from multimodal_pl_tpu_torch.tools.timing import graph_ms

    return graph_ms(fn, reps)


def wall_ms(fn, reps: int) -> float:
    """Time of one fn() call as the host issues it (launches included)."""
    from multimodal_pl_tpu_torch.tools.timing import event_ms

    return event_ms(fn, reps)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_kernels(dev, results, shapes=SHAPES, batch=WINDOW_BATCH, groups=16):
    """Phases 2 and 6: conv3x3_gn kernel vs plain at each of ``shapes``,
    (Cin, Cout, (D, H, W), prologue, residual), at batch ``batch`` with the
    GroupNorm fold of ``groups`` groups. The library time is one cuDNN bf16
    conv on the channels-last input, already normalized where the kernel
    has a prologue (so a lower bound on the library's time for the fused
    function, which also normalizes and adds the residual)."""
    import torch.nn.functional as F

    from multimodal_pl_tpu_torch.ops.conv import standardize_kernel
    from multimodal_pl_tpu_torch.ops.conv3x3 import (
        FUSED, PROLOGUE_OFF as OFF, conv3x3_gn, conv3x3_gn_reference)
    from multimodal_pl_tpu_torch.ops.norm import group_norm_fold

    g = torch.Generator().manual_seed(1)
    table = {}
    for cin, cout, (d, h, w_), prologue, with_res in shapes:
        x = torch.randn((batch, d, h, w_, cin), generator=g).to(dev, torch.bfloat16)
        w = standardize_kernel(torch.randn((cout, cin, 3, 3, 3), generator=g)).to(
            dev, torch.bfloat16)
        a = b = res = None
        t = x  # the conv's input as the library takes it
        if prologue:
            a, b = group_norm_fold(x, (1 + 0.1 * torch.randn(cin, generator=g)).to(dev),
                                   (0.1 * torch.randn(cin, generator=g)).to(dev), groups)
            t = torch.relu(x.float() * a[:, None, None, None] + b[:, None, None, None]).to(
                x.dtype)
        if with_res:
            res = torch.randn((batch, d, h, w_, cout), generator=g).to(dev, torch.bfloat16)
        k = conv3x3_gn(x, w, a, b, res)
        torch.cuda.synchronize()
        p = conv3x3_gn_reference(x, w, a, b, res)
        err = (k.float() - p.float()).abs().max().item()
        scale = p.float().abs().max().item()
        reps = 5 if d * h * w_ * max(cin, cout) > 2 ** 26 else 20
        t_cl = t.permute(0, 4, 1, 2, 3)  # NDHWC memory: channels_last_3d
        row = {
            "spec": FUSED if prologue else OFF, "b": batch, "cin": cin, "cout": cout,
            "dhw": [d, h, w_],
            "res": with_res, "max_abs_err": err, "max_abs_plain": scale,
            "ms": time_ms(lambda: conv3x3_gn(x, w, a, b, res), reps),
            "plain_ms": time_ms(lambda: conv3x3_gn_reference(x, w, a, b, res), reps),
            "library_ms": time_ms(lambda: F.conv3d(t_cl, w, padding=1), reps),
            **conv_bound(batch, d, h, w_, cin, cout, prologue, with_res),
        }
        row["tflops"] = 2 * 27 * cin * cout * batch * d * h * w_ / row["ms"] / 1e9
        print(f"  {row['spec']:12s} B={batch} {cin:3d}->{cout:3d} @{d}x{h}x{w_} res={with_res!s:5s} "
              f"max|k-p|={err:.3g} (max|p|={scale:.3g})  kernel {row['ms']:.3f} ms "
              f"({row['tflops']:.1f} TFLOP/s)  plain f32 {row['plain_ms']:.3f} ms  "
              f"library {row['library_ms']:.3f} ms  bound {row['bound_ms']:.3f} ms",
              flush=True)
        check(err <= 1e-2 * scale, f"kernel disagrees with plain at {row}")
        table[(row["spec"], cin, cout, batch, d, h, w_, with_res)] = row
        results["kernels"].append(row)
        del x, w, a, b, res, k, p, t, t_cl
    torch.cuda.empty_cache()
    return table


def phase_fold(dev, results, keys):
    """Phases 2 and 6: the GroupNorm fold statistics kernel vs the plain
    two-pass fold at each (C, groups, B, D, H, W) of ``keys``: both rows
    within FOLD_REL of the plain rows' largest magnitude. No single library
    call gives GroupNorm statistics alone, so there is no library time."""
    from multimodal_pl_tpu_torch.ops.norm import group_norm_fold

    g = torch.Generator().manual_seed(6)
    table = {}
    for c, groups, batch, d, h, w in sorted(keys):
        x = (torch.randn((batch, d, h, w, c), generator=g) * 2 + 0.5).to(dev, torch.bfloat16)
        sc = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
        bi = (0.1 * torch.randn(c, generator=g)).to(dev)
        ka, kb = group_norm_fold(x, sc, bi, groups, impl="kernel")
        torch.cuda.synchronize()
        pa, pb = group_norm_fold(x, sc, bi, groups)
        rel = max(((k - q).abs().max() / q.abs().max()).item() for k, q in ((ka, pa), (kb, pb)))
        err = max((k - q).abs().max().item() for k, q in ((ka, pa), (kb, pb)))
        reps = 5 if x.numel() > 2 ** 26 else 20
        row = {"c": c, "groups": groups, "b": batch, "dhw": [d, h, w], "rel": rel,
               "max_abs_err": err,
               "ms": time_ms(lambda: group_norm_fold(x, sc, bi, groups, impl="kernel"), reps),
               "plain_ms": time_ms(lambda: group_norm_fold(x, sc, bi, groups), reps),
               "library_ms": None,
               **bound(0.0, 2 * x.numel() + 4 * (2 * batch * c + 2 * c))}
        print(f"  fold B={batch} C={c:3d} G={groups:2d} @{d}x{h}x{w} rel {rel:.3g}  kernel "
              f"{row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms  bound {row['bound_ms']:.3f} ms",
              flush=True)
        check(rel <= FOLD_REL, f"fold kernel disagrees with plain at {row}")
        table[(c, groups, batch, d, h, w)] = row
        results["fold"].append(row)
        del x, ka, kb, pa, pb
    torch.cuda.empty_cache()
    return table


def fold_keys(conv_keys, groups):
    """The fold calls of fused conv3x3_gn calls: one per call, on its input
    (C = its Cin)."""
    from collections import Counter

    from multimodal_pl_tpu_torch.ops import conv3x3

    out = Counter()
    for key, n in conv_keys.items():
        if key[0] == conv3x3.FUSED:
            out[(key[1], groups, *key[3:7])] += n
    return out


def _half(dhw):
    return tuple(v // 2 for v in dhw)


def unet_shapes(dhw, widths, layers, group, fusion_groups, precls_groups):
    """The stride-1 conv and GroupNorm shapes one training forward of a
    voxel U-Net launches (UNet3DFEAM, or RefinerUNet3D after its stride-2
    stem): encoder stages of ``widths`` with ``layers`` blocks (stride 2 from
    the second), the GN-ReLU fusion head, four one-block decoder stages, the
    GN-ReLU classifier head. Returns (train convs [(Cin, Cout, DHW)], GNs
    [(C, groups, DHW)], gradient-free convs [(Cin, Cout, DHW, prologue,
    residual)]). Per block: GN1 (and the projection's GN) on the input, GN2
    and conv2 on the output, conv1 through conv3x3_train at stride 1 and the
    library at stride 2; without grad, stride-1 convs are fused (conv2 adds
    an identity residual) and a stride-2 block's conv2 is prologue-off."""
    convs, gns, nograd = [], [], []

    def block(cin, cout, d_in, stride):
        d_out = d_in if stride == 1 else _half(d_in)
        proj = stride != 1 or cin != cout
        gns.extend([(cin, group, d_in), (cout, group, d_out)] + [(cin, group, d_in)] * proj)
        if stride == 1:
            convs.extend([(cin, cout, d_out), (cout, cout, d_out)])
            nograd.extend([(cin, cout, d_out, True, False), (cout, cout, d_out, True, not proj)])
        else:
            convs.append((cout, cout, d_out))
            nograd.append((cout, cout, d_out, False, False))
        return d_out

    def stage(cin, cout, blocks, stride, d):
        for i in range(blocks):
            d = block(cin if i == 0 else cout, cout, d, stride if i == 0 else 1)
        return d

    d = [dhw]
    chans = [widths[0]] + list(widths)
    for i in range(5):
        d.append(stage(chans[i], widths[i], layers[i], 1 if i == 0 else 2, d[-1]))
    gns.append((widths[4], fusion_groups, d[5]))
    for cin, cout, scale in ((widths[4], widths[2], d[4]), (widths[2], widths[1], d[3]),
                             (widths[1], widths[0], d[2]), (widths[0], widths[0], d[1])):
        stage(cin, cout, 1, 1, scale)
    gns.append((widths[0], precls_groups, d[1]))
    return convs, gns, nograd


def training_shapes(cfg):
    """-> {kernel key: launches per train step} for conv3x3 (train fwd/dx,
    fused, prologue-off) and gn_relu, from the architecture of ``cfg``."""
    from collections import Counter

    from multimodal_pl_tpu_torch.ops import conv3x3

    b, f, k = cfg.base, cfg.refiner_filter, cfg.refine_grad_organs
    rest = cfg.num_classes - 1 - k
    seg_convs, seg_gns, _ = unet_shapes(PATCH, [b, 2 * b, 4 * b, 8 * b, 8 * b], cfg.layers,
                                        16, 16, 16)
    half = _half(PATCH)  # the refiner runs at half resolution after its stride-2 stem
    ref_convs, ref_gns, ref_nograd = unet_shapes(half, [f, 2 * f, 4 * f, 8 * f, 8 * f],
                                                 (1, 1, 1, 1, 1), 4, f // 2, f // 4)
    ref_convs.append((f, f, half))                       # the refiner's conv1
    ref_nograd.append((f, f, half, False, False))
    conv = Counter()
    for batch, convs in ((1, seg_convs), (k, ref_convs)):
        for cin, cout, (d, h, w) in convs:
            conv[(conv3x3.TRAIN_FWD, cin, cout, batch, d, h, w, False)] += 1
            conv[(conv3x3.TRAIN_DX, cout, cin, batch, d, h, w, False)] += 1
    for cin, cout, (d, h, w), prologue, res in ref_nograd:
        conv[(conv3x3.FUSED if prologue else conv3x3.PROLOGUE_OFF, cin, cout, rest, d, h, w,
              res)] += 1
    gn = Counter()
    for batch, gns in ((1, seg_gns), (k, ref_gns)):
        for c, groups, dhw in gns:
            gn[(c, groups, batch, *dhw)] += 1
    return conv, gn


def phase_gn(dev, results, gn_keys):
    """Phase 6: gn_relu kernel vs plain at every training GroupNorm shape;
    the library time is F.group_norm then an in-place ReLU on the bf16
    channels-last input."""
    import torch.nn.functional as F

    from multimodal_pl_tpu_torch.ops.gn_relu import group_norm_relu, group_norm_relu_reference

    def library(x_cl, groups, sc, bi):
        return F.relu(F.group_norm(x_cl, groups, sc, bi, 1e-5), inplace=True)

    g = torch.Generator().manual_seed(3)
    table = {}
    for c, groups, batch, d, h, w in sorted(gn_keys):
        x = (torch.randn((batch, d, h, w, c), generator=g) * 2 + 0.5).to(dev, torch.bfloat16)
        sc = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
        bi = (0.1 * torch.randn(c, generator=g)).to(dev)
        x_cl = x.permute(0, 4, 1, 2, 3)
        sc16, bi16 = sc.to(torch.bfloat16), bi.to(torch.bfloat16)
        with torch.no_grad():
            k = group_norm_relu(x, sc, bi, groups)
            torch.cuda.synchronize()
            p = group_norm_relu_reference(x, sc, bi, groups)
            err = (k.float() - p.float()).abs().max().item()
            scale = p.float().abs().max().item()
            reps = 5 if x.numel() > 2 ** 26 else 20
            row = {"c": c, "groups": groups, "b": batch, "dhw": [d, h, w], "max_abs_err": err,
                   "max_abs_plain": scale,
                   "ms": time_ms(lambda: group_norm_relu(x, sc, bi, groups), reps),
                   "plain_ms": time_ms(lambda: group_norm_relu_reference(x, sc, bi, groups), reps),
                   "library_ms": time_ms(lambda: library(x_cl, groups, sc16, bi16), reps),
                   **bound(0.0, 4 * x.numel() + 2 * 4 * c)}
        row["gb_s"] = 3 * x.numel() * 2 / row["ms"] / 1e6  # reads x twice, writes once
        print(f"  gn_relu B={batch} C={c:3d} G={groups:2d} @{d}x{h}x{w} max|k-p|={err:.3g} "
              f"(max|p|={scale:.3g})  kernel {row['ms']:.3f} ms ({row['gb_s']:.0f} GB/s)  "
              f"plain {row['plain_ms']:.3f} ms  library {row['library_ms']:.3f} ms  bound "
              f"{row['bound_ms']:.3f} ms", flush=True)
        check(err <= 1e-2 * scale, f"gn_relu kernel disagrees with plain at {row}")
        table[(c, groups, batch, d, h, w)] = row
        results["gn_relu"].append(row)
    torch.cuda.empty_cache()
    return table


def phase_train_conv(dev, results, conv_keys):
    """Phase 6: conv3x3_train forward and dx (the kernel) and dw (the
    library's convolution backward) vs f32 autograd of the plain version at
    every training stride-1 conv shape. The library time of forward and dx
    is one cuDNN bf16 conv each (dx: on the flipped, transposed taps)."""
    import torch.nn.functional as F

    from multimodal_pl_tpu_torch.ops import conv3x3
    from multimodal_pl_tpu_torch.ops.conv import standardize_kernel
    from multimodal_pl_tpu_torch.ops.conv3x3 import (
        conv3x3_gn, conv3x3_gn_reference, conv3x3_train, weight_grad)

    g = torch.Generator().manual_seed(4)
    table = {}
    fwd = sorted(k for k in conv_keys if k[0] == conv3x3.TRAIN_FWD)
    for _, cin, cout, batch, d, h, w_, _ in fwd:
        x = torch.randn((batch, d, h, w_, cin), generator=g).to(dev, torch.bfloat16)
        w = standardize_kernel(torch.randn((cout, cin, 3, 3, 3), generator=g)).to(
            dev, torch.bfloat16)
        gy = torch.randn((batch, d, h, w_, cout), generator=g).to(dev, torch.bfloat16)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = conv3x3_train(xr, wr)
        dx, dw = torch.autograd.grad(y, (xr, wr), gy)
        torch.cuda.synchronize()
        xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
        yf = conv3x3_gn_reference(xf, wf)
        dxf, dwf = torch.autograd.grad(yf, (xf, wf), gy.float())
        wt = w.flip((2, 3, 4)).transpose(0, 1).contiguous()  # dx's weights
        reps = 5 if d * h * w_ * max(cin, cout) * batch > 2 ** 26 else 20
        flop = 2 * 27 * cin * cout * batch * d * h * w_
        row = {"b": batch, "cin": cin, "cout": cout, "dhw": [d, h, w_],
               "fwd_err": (y.float() - yf).abs().max().item(), "fwd_max": yf.abs().max().item(),
               "dx_err": (dx.float() - dxf).abs().max().item(), "dx_max": dxf.abs().max().item(),
               "dw_rel": ((dw.float() - dwf).norm() / dwf.norm()).item()}
        cb = conv_bound(batch, d, h, w_, cin, cout, False, False)
        row.update({f"{k}_{f}": v for k in ("fwd", "dx") for f, v in cb.items()})
        x_cl, gy_cl = x.permute(0, 4, 1, 2, 3), gy.permute(0, 4, 1, 2, 3)
        with torch.no_grad():
            row.update(
                fwd_library_ms=time_ms(lambda: F.conv3d(x_cl, w, padding=1), reps),
                dx_library_ms=time_ms(lambda: F.conv3d(gy_cl, wt, padding=1), reps),
                fwd_ms=time_ms(lambda: conv3x3_train(x, w), reps),
                fwd_plain_ms=time_ms(lambda: conv3x3_gn_reference(x, w), reps),
                dx_ms=time_ms(lambda: conv3x3_gn(gy, wt), reps),
                dx_plain_ms=time_ms(lambda: conv3x3_gn_reference(gy, wt), reps),
                dw_ms=time_ms(lambda: weight_grad(x, gy, w), reps),
                dw_plain_ms=time_ms(lambda: weight_grad(x.float(), gy.float(), w.float()), reps))
        row["fwd_tflops"] = flop / row["fwd_ms"] / 1e9
        row["dx_tflops"] = flop / row["dx_ms"] / 1e9
        row["dw_tflops"] = flop / row["dw_ms"] / 1e9
        print(f"  conv3x3_train B={batch} {cin:3d}->{cout:3d} @{d}x{h}x{w_}: fwd "
              f"{row['fwd_err']:.3g}/{row['fwd_max']:.3g} {row['fwd_ms']:.3f} ms "
              f"({row['fwd_tflops']:.1f} TFLOP/s, plain {row['fwd_plain_ms']:.3f}, library "
              f"{row['fwd_library_ms']:.3f}); dx "
              f"{row['dx_err']:.3g}/{row['dx_max']:.3g} {row['dx_ms']:.3f} ms "
              f"({row['dx_tflops']:.1f}, plain {row['dx_plain_ms']:.3f}, library "
              f"{row['dx_library_ms']:.3f}); bound {row['fwd_bound_ms']:.3f}; dw rel "
              f"{row['dw_rel']:.2e} library {row['dw_ms']:.3f} ms ({row['dw_tflops']:.1f}, "
              f"f32 {row['dw_plain_ms']:.3f})", flush=True)
        check(row["fwd_err"] <= 1e-2 * row["fwd_max"], f"conv3x3_train forward disagrees: {row}")
        check(row["dx_err"] <= 1e-2 * row["dx_max"], f"conv3x3_train dx disagrees: {row}")
        check(row["dw_rel"] <= 1e-2, f"conv3x3_train dw disagrees: {row}")
        table[(cin, cout, batch, d, h, w_)] = row
        results["conv3x3_train"].append(row)
        del x, w, gy, xr, wr, y, dx, dw, xf, wf, yf, dxf, dwf, wt, x_cl, gy_cl
    torch.cuda.empty_cache()
    return table


def train_batch(dev, cfg):
    """A seeded batch at the training patch, as the loop ships it: bf16
    image and atlas, uint8 labels; organ 5 is supervised and in the labeled
    modality, so the refiner's gradient pass has a row."""
    rng = np.random.default_rng(5)
    nc = cfg.num_classes
    sup = np.zeros(nc, np.float32)
    sup[5] = 1
    host = {"image": rng.standard_normal((1, *PATCH, 1)).astype(np.float32),
            "label": rng.integers(0, nc, (1, *PATCH)).astype(np.uint8),
            "catlas": rng.random((nc - 1, *PATCH)).astype(np.float32), "sup_mask": sup,
            "label_t": np.array([0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1], np.float32)}
    from multimodal_pl_tpu_torch.train.loop import to_device

    return to_device(host, cfg, dev)


def phase_step(dev, results, conv_expected, gn_expected, fold_expected):
    """Phase 7: the train step at the full geometry. Returns the kernel
    calls of the 3 timed steps (conv3x3 keys, gn_relu keys, fold keys)."""
    import dataclasses
    from collections import Counter

    from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu, norm
    from multimodal_pl_tpu_torch.train.state import StepConfig, build_models, create_train_state
    from multimodal_pl_tpu_torch.train.step import make_train_step

    cfg = StepConfig(compute_dtype=torch.bfloat16)
    state = create_train_state(torch.Generator().manual_seed(0), cfg).to(dev)
    batch = train_batch(dev, cfg)
    lr = torch.tensor(5e-4, device=dev)
    wf = torch.tensor(0.05, device=dev)  # past the pretrain epochs: the consistency term runs

    def make(c):
        return make_train_step(*(m.to(dev) for m in build_models(c)), c)

    # kernel vs plain from one state and batch; the f32 plain step shows the
    # size of the bf16 gap itself
    variants = {"kernel": cfg,
                "plain": dataclasses.replace(cfg, conv_impl="plain", gn_impl="plain"),
                "plain_f32": dataclasses.replace(cfg, conv_impl="plain", gn_impl="plain",
                                                 compute_dtype=torch.float32)}
    losses, grads = {}, {}
    for name, c in variants.items():
        total, (gp, gr), _ = make(c).grads(state, batch, wf)
        losses[name] = float(total)
        grads[name] = {**{"params." + k: g.detach().float() for k, g in gp.items()},
                       **{"rparams." + k: g.detach().float() for k, g in gr.items()}}
        del total, gp, gr
        torch.cuda.empty_cache()
    seg = [k for k in grads["plain"] if k.startswith("params.")]

    def rel(a, b, keys=seg):
        x, y = (torch.cat([grads[v][k].flatten() for k in keys]) for v in (a, b))
        return ((x - y).norm() / y.norm().clamp_min(1e-30)).item()

    kf, pf = ({k: rel(a, "plain_f32", [k]) for k in grads["plain"]} for a in ("kernel", "plain"))
    ratio = {k: kf[k] / max(pf[k], 1e-30) for k in kf}
    worst = max(kf, key=lambda k: kf[k] - LEAF_RATIO * pf[k])
    cmp = {"loss": losses, "loss_rel_kernel_plain": abs(losses["kernel"] - losses["plain"])
           / abs(losses["plain"]), "grad_rel_kernel_plain": rel("kernel", "plain"),
           "grad_rel_kernel_f32": rel("kernel", "plain_f32"),
           "grad_rel_plain_f32": rel("plain", "plain_f32"),
           "leaf_ratio_worst": [max(ratio, key=ratio.get), max(ratio.values())],
           "leaf_ratio_median": float(np.median(list(ratio.values()))),
           "leaf_rel_kernel_f32": kf, "leaf_rel_plain_f32": pf}
    del grads
    print(f"[7] step kernel vs plain: loss {losses}; rel loss {cmp['loss_rel_kernel_plain']:.3e}; "
          f"segmenter-gradient rel Frobenius kernel-plain {cmp['grad_rel_kernel_plain']:.3e}, "
          f"kernel-f32 {cmp['grad_rel_kernel_f32']:.3e}, plain-f32 {cmp['grad_rel_plain_f32']:.3e}; "
          f"per leaf ({len(kf)} segmenter and refiner leaves) kernel-f32 / plain-f32: median "
          f"{cmp['leaf_ratio_median']:.3f}, worst {cmp['leaf_ratio_worst'][1]:.3f} "
          f"({cmp['leaf_ratio_worst'][0]})", flush=True)
    check(cmp["loss_rel_kernel_plain"] <= 3e-2, f"step loss kernel vs plain: {cmp}")
    check(cmp["grad_rel_kernel_plain"] <= GRAD_REL_LIMIT, f"step gradients kernel vs plain: {cmp}")
    check(cmp["grad_rel_kernel_f32"] <= 1.25 * cmp["grad_rel_plain_f32"],
          f"kernel step farther from the f32 step than the plain bf16 step: {cmp}")
    check(kf[worst] <= LEAF_RATIO * pf[worst] + LEAF_FLOOR,
          f"gradient leaf {worst}: kernel-f32 {kf[worst]:.3e} > {LEAF_RATIO} x plain-f32 "
          f"{pf[worst]:.3e} + {LEAF_FLOOR}")

    step = make(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    conv_total, gn_total, fold_total, step_ms, metrics = Counter(), Counter(), Counter(), [], []
    first = state
    for _ in range(3):
        conv3x3.reset_launches()
        gn_relu.reset_launches()
        norm.fold_launches.clear()
        t0 = time.perf_counter()
        state, m = step(state, batch, lr, wf)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(Counter(conv3x3.launches) == conv_expected,
              f"conv3x3 launches per step {dict(conv3x3.launches)} != {dict(conv_expected)}")
        check(Counter(gn_relu.launches) == gn_expected,
              f"gn_relu launches per step {dict(gn_relu.launches)} != {dict(gn_expected)}")
        check(Counter(norm.fold_launches) == fold_expected,
              f"fold calls per step {dict(norm.fold_launches)} != {dict(fold_expected)}")
        conv_total.update(conv3x3.launches)
        gn_total.update(gn_relu.launches)
        fold_total.update(norm.fold_launches)
        metrics.append({k: float(v) for k, v in m.items()})
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = dict.fromkeys(conv3x3.SPECS, 0)
    for key, n in conv_expected.items():
        per_step[key[0]] += n
    steady, timed = [], state  # steady-state time: 5 more steps after the warm-up
    for _ in range(5):
        t0 = time.perf_counter()
        timed, _ = step(timed, batch, lr, wf)
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t0) * 1e3)
    del timed
    for m in metrics:
        check(all(np.isfinite(v) for v in m.values()), f"non-finite metrics {m}")
        check(m["grads_finite"] == 1.0 and m["disc_grads_finite"] == 1.0, f"guard fired: {m}")
    for group, keys in (("params", ("conv1.weight", "layer4.1.conv2.weight",
                                    "precls_conv.2.weight")),
                        ("rparams", ("conv0.weight", "x1_resb.0.conv2.weight")),
                        ("dparams", ("block1.weight", "head.weight"))):
        for k in keys:
            check(not torch.equal(getattr(first, group)[k], getattr(state, group)[k]),
                  f"{group}.{k} did not move in 3 steps")
    check(all(bool(torch.isfinite(t).all()) for t in state.tokens.values()), "tokens not finite")
    results["step"] = dict(cmp, step_ms=step_ms, steady_step_ms=steady,
                           steady_median_ms=float(np.median(steady)), peak_gib=peak_gib,
                           metrics=metrics,
                           launches_per_step=per_step,
                           gn_relu_launches_per_step=sum(gn_expected.values()),
                           fold_launches_per_step=sum(fold_expected.values()))
    print(f"[7] 3 kernel steps at B=1 x {PATCH}, bf16: {[round(t, 1) for t in step_ms]} ms/step "
          f"(then 5 more: median {np.median(steady):.1f} ms), peak {peak_gib:.2f} GiB; losses "
          f"{[round(m['loss'], 5) for m in metrics]}; calls per step {per_step} + gn_relu "
          f"{sum(gn_expected.values())} + fold {sum(fold_expected.values())}", flush=True)
    del state, first, step, batch
    torch.cuda.empty_cache()
    return conv_total, gn_total, fold_total


def phase_train_cli(tmp):
    """Phase 8: mpl-train-torch on synthetic cases at the training patch:
    epochs 5 and 6 of 7 with validation after each (the loop validates from
    epoch 5), a checkpoint, then epoch 7 resumed from it."""
    from multimodal_pl_tpu_torch.cli import train
    from multimodal_pl_tpu_torch.ops import conv3x3
    from multimodal_pl_tpu_torch.train.checkpoint import latest_checkpoint
    from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

    img_dir, atlas_path, csv_path = make_synthetic_amos(os.path.join(tmp, "train_data"), n_ct=3,
                                                        n_mri=1, shape=(96, 96, 80), seed=1)
    snap = os.path.join(tmp, "snap")
    args = ["--data_dir", img_dir, "--atlas_path", atlas_path, "--supervision_csv", csv_path,
            "--snapshot_dir", snap, "--log_every", "1", "--val_pred_every", "1"]
    t0 = time.perf_counter()
    conv3x3.reset_launches()
    state = train.main(args + ["--start_epoch", "5", "--num_epochs", "7"])
    path = latest_checkpoint(snap)
    check(path is not None and int(state.step) > 0, f"no checkpoint in {snap}")
    resumed = train.main(args + ["--num_epochs", "8", "--start_epoch", "7",
                                 "--reload_from_checkpoint", "true"])
    check(int(resumed.step) == int(state.step) * 3 // 2,
          f"resume from step {int(state.step)} ended at {int(resumed.step)}")
    with open(os.path.join(snap, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    check(len(losses) == int(resumed.step) and all(np.isfinite(losses)), f"losses {losses}")
    vals = [r for r in recs if "val/val_dice_ct_mean" in r]
    check([r["step"] for r in vals] == [5, 6, 7]
          and all(np.isfinite(v) for r in vals for v in r.values() if isinstance(v, float)),
          f"validation records {vals}")
    # validation serves through the fused kernel; the train step launches it
    # only in the refiner's gradient-free pass, at half resolution, so a fused
    # launch at the full tile is the segmenter's validation forward
    serving = {k: n for k, n in conv3x3.launches.items()
               if k[0] == conv3x3.FUSED and tuple(k[4:7]) == TILE}
    check(serving, f"validation launched no fused conv3x3_gn: {dict(conv3x3.launches)}")
    print(f"[8] mpl-train-torch: {int(state.step)} steps in epochs 5-6, validation after each "
          f"(sup dice sum {[round(r['val/val_dice_sup_sum'], 4) for r in vals]}, "
          f"{sum(serving.values())} fused launches at the full tile), checkpoint "
          f"{os.path.basename(path)}, resumed to step {int(resumed.step)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"steps": int(resumed.step), "losses": losses, "validation": vals}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from multimodal_pl_tpu_torch.cli import evaluate
    from multimodal_pl_tpu_torch.convert import save_npz
    from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
    from multimodal_pl_tpu_torch.models import UNet3DFEAM
    from collections import Counter

    from multimodal_pl_tpu_torch.ops import _build, conv3x3, gn_relu, norm
    from multimodal_pl_tpu_torch.train.state import StepConfig
    from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "cuda": torch.version.cuda, "kernels": [],
               "fold": [], "gn_relu": [], "conv3x3_train": [], "phase_s": {}}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        results["phase_s"][name] = now - t_phase
        print(f"    ({name}: {now - t_phase:.1f} s)", flush=True)
        t_phase = now

    # ---- phase 1: build, one nvcc per source, all started together ----------
    print(f"[1] card: {card}", flush=True)
    t0 = time.perf_counter()
    names = ("conv3x3_gn", "gn_relu")
    with ThreadPoolExecutor(len(names)) as pool:
        lib_paths = dict(zip(names, pool.map(_build.build, names)))
    conv3x3._lib()
    gn_relu._lib()
    results["build_s"] = time.perf_counter() - t0
    print(f"[1] built {', '.join(p.name for p in lib_paths.values())} in "
          f"{results['build_s']:.1f} s", flush=True)
    results["ptxas"] = {name: [ln for ln in (path.parent / "build.log").read_text().splitlines()
                               if "registers" in ln or "spill" in ln]
                        for name, path in lib_paths.items()}
    phase_done("build")

    # ---- phase 2: kernel vs plain at every main-path shape ------------------
    print("[2] conv3x3_gn kernel vs plain (bf16 inputs; plain in f32, TF32 off)", flush=True)
    table = phase_kernels(dev, results)
    print("[2] GroupNorm fold statistics kernel vs plain at every fused conv's input", flush=True)
    fold_table = phase_fold(dev, results, fold_keys(Counter(table.keys()), 16))
    phase_done("serving kernels")

    # ---- phase 3: whole model, kernel vs plain -----------------------------
    model = UNet3DFEAM(deep_up=True, conv_impl="kernel",
                       generator=torch.Generator().manual_seed(0)).to(dev).eval()
    plain = UNet3DFEAM(deep_up=True, conv_impl="plain").to(dev).eval()
    plain.load_state_dict(model.state_dict())
    x = torch.randn((WINDOW_BATCH, *TILE, 1), generator=torch.Generator().manual_seed(2)).to(
        dev, torch.bfloat16)
    with torch.inference_mode():
        conv3x3.reset_launches()
        norm.fold_launches.clear()
        lk = model(x, aux=False)
        torch.cuda.synchronize()
        per_forward = dict(conv3x3.launches)
        per_forward_fold = dict(norm.fold_launches)
        totals = conv3x3.launch_totals()
        lp = plain(x, aux=False)
        rel = ((lk.float() - lp.float()).norm() / lp.float().norm()).item()
        fwd_ms = wall_ms(lambda: model(x, aux=False), 3)
        plain_fwd_ms = wall_ms(lambda: plain(x, aux=False), 3)
    check(lk.shape == (WINDOW_BATCH, *TILE, NC) and bool(torch.isfinite(lk).all()),
          f"logits {tuple(lk.shape)} not finite / wrong shape")
    results.update(model_rel_l2=rel, model_launches=totals, forward_ms=fwd_ms,
                   plain_forward_ms=plain_fwd_ms)
    print(f"[3] tile batch {WINDOW_BATCH}x{TILE}: logits rel L2 kernel vs plain = {rel:.3e}; "
          f"launches {totals}; forward {fwd_ms:.1f} ms (plain {plain_fwd_ms:.1f} ms)",
          flush=True)
    check(rel <= 3e-2, f"whole-model relative L2 error {rel} > 3e-2")
    check(totals == {conv3x3.FUSED: 18, conv3x3.PROLOGUE_OFF: 4, conv3x3.TRAIN_FWD: 0,
                     conv3x3.TRAIN_DX: 0}, f"launches {totals} != 18 + 4")
    check(sum(per_forward_fold.values()) == 18, f"fold calls {per_forward_fold} != 18")
    missing = sorted(set(per_forward) - set(table)) + sorted(set(per_forward_fold) - set(fold_table))
    check(not missing, f"shapes launched by the model but not checked in phase 2: {missing}")
    del lk, lp, x
    torch.cuda.empty_cache()

    # ---- phase 4: the main path, end to end --------------------------------
    def predictor(net):
        return SlidingWindowPredictor(lambda t: net(t, aux=False), TILE, NC,
                                      window_batch=WINDOW_BATCH, compute_dtype=torch.bfloat16,
                                      device=dev, output="argmax")

    rng = np.random.default_rng(0)
    vol = rng.standard_normal(VOL).astype(np.float32)
    vols = [rng.standard_normal(VOL).astype(np.float32) for _ in range(N_STREAM)]
    pred = predictor(model)
    pred(vol)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    conv3x3.reset_launches()
    norm.fold_launches.clear()
    t0 = time.perf_counter()
    labels = pred(vol)
    torch.cuda.synchronize()
    one_shot_s = time.perf_counter() - t0
    main_launches = conv3x3.launch_totals()
    main_folds = sum(norm.fold_launches.values())
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(labels.dtype == torch.uint8 and tuple(labels.shape) == VOL,
          f"label map {labels.dtype} {tuple(labels.shape)}")
    check(int(labels.max()) < NC, "label out of range")
    check(main_launches == {conv3x3.FUSED: 54, conv3x3.PROLOGUE_OFF: 12, conv3x3.TRAIN_FWD: 0,
                            conv3x3.TRAIN_DX: 0},
          f"main-path launches {main_launches} != 54 + 12 (66)")
    check(main_folds == 54, f"main-path fold calls {main_folds} != 54")
    agree = (predictor(plain)(vol) == labels).float().mean().item()
    check(agree >= 0.95, f"label agreement with the plain model {agree} < 0.95")
    t0 = time.perf_counter()
    streamed = [out.cpu() for out in pred.predict_iter(vols)]
    stream_s = (time.perf_counter() - t0) / N_STREAM
    check(len(streamed) == N_STREAM, "predict_iter lost a volume")
    # the side-stream copies must deliver each volume intact: streamed ==
    # one-shot on the same volume (a race would scramble whole windows)
    stream_agree = min((s == pred(v).cpu()).float().mean().item()
                       for s, v in zip(streamed, vols))
    check(stream_agree >= 0.999, f"predict_iter vs one-shot agreement {stream_agree}")
    results.update(main_path_launches=main_launches, main_path_folds=main_folds,
                   one_shot_s_per_vol=one_shot_s,
                   stream_s_per_vol=stream_s, label_agreement=agree,
                   stream_vs_one_shot=stream_agree, peak_gib=peak_gib)
    print(f"[4] {VOL} volume, {TILE} tiles, window batch {WINDOW_BATCH}, bf16, argmax: "
          f"launches {main_launches} + fold {main_folds}; label agreement with plain {agree:.5f}; "
          f"one-shot {one_shot_s:.3f} s/vol; predict_iter {stream_s:.3f} s/vol "
          f"({1 / stream_s:.3f} vol/s, agrees with one-shot {stream_agree:.6f}); "
          f"peak {peak_gib:.2f} GiB", flush=True)

    # ---- phase 5: the entry point ------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        img_dir, atlas_path, _ = make_synthetic_amos(os.path.join(tmp, "data"), n_ct=8,
                                                     n_mri=2, shape=(96, 96, 80), seed=0)
        ckpt = os.path.join(tmp, "weights.npz")
        save_npz(ckpt, model.state_dict())
        csv_path = evaluate.main(["--data_dir", img_dir, "--reload_path", ckpt,
                                  "--save_path", os.path.join(tmp, "out"),
                                  "--atlas_path", atlas_path])
        with open(csv_path) as f:
            rows = f.read().strip().splitlines()
    check(len(rows) == 3, f"CLI CSV has {len(rows)} lines, expected header + 2 cases")
    print(f"[5] mpl-evaluate-torch: {len(rows) - 1} cases written to per_case_dice.csv",
          flush=True)

    check(not gn_relu.launches, f"gn_relu launched on the serving path: {dict(gn_relu.launches)}")
    phase_done("serving")

    # ---- phase 6: the training kernels vs plain at every train-step shape ----
    conv_expected, gn_expected = training_shapes(StepConfig())
    print(f"[6] training kernels vs plain at every shape of one B=1 x {PATCH} train step "
          f"(bf16 inputs; plain in f32, TF32 off)", flush=True)
    gn_table = phase_gn(dev, results, gn_expected)
    train_table = phase_train_conv(dev, results, conv_expected)
    rest = sorted({k for k in conv_expected if k[0] in (conv3x3.FUSED, conv3x3.PROLOGUE_OFF)})
    nograd_table = {}
    for batch in sorted({k[3] for k in rest}):
        nograd_table.update(phase_kernels(
            dev, results, [(k[1], k[2], k[4:7], k[0] == conv3x3.FUSED, k[7])
                           for k in rest if k[3] == batch], batch=batch, groups=4))
    fold_expected = fold_keys(conv_expected, 4)
    phase_fold(dev, results, fold_expected)
    phase_done("training kernels")

    # ---- phase 7: the training path ------------------------------------------
    # every step launches exactly the derived shapes (checked per step), and
    # phase 6 held the kernels against their plain versions at each of them
    conv_run, gn_run, fold_run = phase_step(dev, results, conv_expected, gn_expected,
                                            fold_expected)
    phase_done("train step")

    # ---- phase 8: the training entry point -----------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        results["train_cli"] = phase_train_cli(tmp)
    phase_done("train entry point")

    def entry(name, source, replaces, launches, rows):
        """One kernels-line entry from (calls, per-shape row) pairs."""
        libs = [n * r["library_ms"] for n, r in rows if r["library_ms"] is not None]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max(r["max_abs_err"] for _, r in rows),
                "ms": sum(n * r["ms"] for n, r in rows),
                "plain_ms": sum(n * r["plain_ms"] for n, r in rows),
                **sum_bound(rows), "library_ms": sum(libs) if libs else None}

    # serving: per 4-tile forward (times) and per volume (calls)
    serving = {k: r for k, r in table.items() if r["b"] == WINDOW_BATCH}
    kernels = [entry(name, SOURCE, replaces, main_launches[spec],
                     [(n, serving[k]) for k, n in per_forward.items() if k[0] == spec])
               for spec, name, replaces in (
                   (conv3x3.FUSED, "conv3x3_gn fused GN-ReLU prologue", BDX),
                   (conv3x3.PROLOGUE_OFF, "conv3x3_gn prologue off", BK3))]
    kernels.append(entry("group_norm_fold statistics (gn_fold_bf16)", GN_SOURCE, GN_FOLD,
                         main_folds, [(n, fold_table[k]) for k, n in per_forward_fold.items()]))

    # per train step: each call's per-shape row from phase 6
    def step_rows(specs):
        out = []
        for key, n in conv_expected.items():
            if key[0] not in specs:
                continue
            if key[0] == conv3x3.TRAIN_FWD:
                row, pre = train_table[(key[1], key[2], *key[3:7])], "fwd_"
            elif key[0] == conv3x3.TRAIN_DX:
                row, pre = train_table[(key[2], key[1], *key[3:7])], "dx_"
            else:
                row, pre = nograd_table[key], ""
            out.append((n, {f: row[pre + f] for f in ("ms", "plain_ms", "library_ms", "op_ms",
                                                       "byte_ms")}
                        | {"max_abs_err": row[pre + "err" if pre else "max_abs_err"]}))
        return out

    train_specs = (conv3x3.TRAIN_FWD, conv3x3.TRAIN_DX, conv3x3.PROLOGUE_OFF)
    kernels.append(entry(
        "conv3x3_train: conv3x3_gn prologue off (forward, dx; gradient-free refiner)", SOURCE,
        K2, sum(n for k, n in conv_run.items() if k[0] in train_specs), step_rows(train_specs)))
    kernels.append(entry(
        "conv3x3_gn fused GN-ReLU prologue, refiner gradient-free pass", SOURCE, K2_GN,
        sum(n for k, n in conv_run.items() if k[0] == conv3x3.FUSED),
        step_rows((conv3x3.FUSED,))))
    kernels.append(entry("gn_relu", GN_SOURCE, GN_RELU, sum(gn_run.values()),
                         [(n, gn_table[k]) for k, n in gn_expected.items()]))
    results["fold_calls_per_step"] = sum(fold_run.values()) // 3
    # conv3x3_gn calls per key, for per-row sums of other timings of the shapes
    results["serving_calls"] = [[*k, n] for k, n in per_forward.items()]
    results["step_calls"] = [[*k, n] for k, n in conv_expected.items()]
    results["train_step_library_dw_ms"] = sum(
        n * train_table[(k[1], k[2], *k[3:7])]["dw_ms"] for k, n in conv_expected.items()
        if k[0] == conv3x3.TRAIN_FWD)
    results["kernels_line"] = kernels
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

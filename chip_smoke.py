#!/usr/bin/env python3
"""Drive the PyTorch port (multimodal_pl_tpu_torch) on one NVIDIA GPU and
check it. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on any failed check:

1. the card's name and power limit; build csrc/conv3x3_gn.cu,
   csrc/gn_relu.cu and csrc/resize3d.cu with nvcc for sm_90a, one nvcc per
   source started together (timed, ptxas report kept);
2. the conv3x3_gn kernel vs its plain PyTorch version (f32, TF32 off) on the
   same bf16 inputs, at every shape one 4 x 64 x 192 x 192 tile batch of the
   flagship UNet3DFEAM gives it: max|k - p| <= 1e-2 * max|p|; kernel, plain
   and library (cuDNN bf16 conv) times and the bound; then the GroupNorm
   fold statistics kernel vs the plain fold at every fused conv's input:
   rows a, b within rel 1e-5; then the gn_relu forward kernel vs plain at
   every gradient-free GroupNorm -> ReLU of the tile batch (the stride-2
   blocks' three, the decoder projections, fusionConv, precls_conv):
   max|k - p| <= 1e-2 * max|p|, with kernel, plain and library
   (F.group_norm + ReLU) times and the bound; then the resize3d forward
   kernel (x2 upsample + skip) vs plain at the decoder's 4 shapes, with the
   same limit, and a summary line of the resize shapes below half their
   bound or slower than the library (printed, not checked);
3. the whole model on one bf16 tile batch, kernels vs plain (conv_impl and
   gn_impl 'plain') with the same weights: relative L2 error of the logits
   <= 3e-2, 22 conv calls (18 fused, 4 prologue-off), 18 fold calls, 17
   gn_relu calls and 4 resize3d calls, every launched shape covered by
   phase 2; then feam2, UNet3DFEAM(token_update='pre', deep_up=True), on one
   bf16 tile with a seeded label mask, kernels vs plain: logits rel L2
   <= 3e-2, the token updates (new - old) rel L2 <= 3e-2 (alpha times masked
   means of bf16 features), 7 resize3d calls;
4. the serving path: SlidingWindowPredictor(output='argmax', window_batch=4,
   bf16) over seeded 128 x 256 x 256 volumes (12 windows): a uint8 label map
   of labels < 14, 66 conv, 54 fold, 51 gn_relu and 12 resize3d calls per
   volume, agreement with the plain model's label map; then predict_iter
   over 5 volumes (s/vol);
5. the evaluation entry point: mpl-evaluate-torch's main() on 2 synthetic
   cases with random weights written as .npz; its CSV;
6. the training kernels vs their plain versions at every shape one
   full-geometry train step (B = 1, 64 x 192 x 192, bf16) launches, derived
   from the architecture: the gn_relu forward at every GroupNorm width of
   the segmenter and the refiner (and the refiner's gradient-free pass,
   B = 11), the gn_relu backward at every GroupNorm under autograd (dx by
   the forward's rule, ds and dt by relative norm <= 1e-3; library:
   autograd of F.group_norm + ReLU); conv3x3_train forward and dx at every
   stride-1 conv (dw, the library's, by relative Frobenius norm);
   conv3x3_gn at the refiner's gradient-free shapes (B = 11); the resize3d
   forward and backward at every upsample of the step (the segmenter's
   decoder + skip, the x8/x4/x2 attention maps in f32, the refiner's 4
   upsamples + skip and its logits' x2, at its K gradient rows and its 11
   gradient-free rows): y and dx within 1e-2 * max|plain| of the plain
   versions in f32, the backward the same bits twice; kernel ms, plain ms,
   TFLOP/s or GB/s; then the same at every shape of a B = 3 step that
   B = 1 does not launch (the segmenter's at batch 3), and the resize's
   summary line as in phase 2;
7. the training path: the train step at the full geometry from one seeded
   state and batch, kernel vs plain (total loss, segmenter gradients), then
   3 kernel steps: finite losses, moving parameters, finite tokens, the exact
   calls per step of every kernel (the fold's 10, gn_relu's 79 forward and
   62 backward, resize3d's 17 forward and 12 backward included), ms/step,
   peak memory;
8. the training entry point: mpl-train-torch's main() on synthetic cases at
   64 x 192 x 192 on host batches (--device_data false) for 2 epochs with
   validation after each (through the serving kernel), a checkpoint, and a
   resumed epoch; then mpl-evaluate-torch on the checkpoint it wrote
   (ckpt_<step>.pt), with the default flags and with --pallas_k2 false
   --fused_gn false --bd true: label maps that agree (>= 0.95, phase 4's
   limit); then the default evaluation through ``torchrun --nproc_per_node 1``
   with --mesh data:1 (NCCL, the sharded predictor): the same label maps bit
   for bit;
9. the production step (run_amos_atlas_final.sh: B = 3, 64 x 192 x 192,
   bf16, the StepConfig defaults) from a state one step past the init:
   torch's deterministic mode as a detector (warn_only) over one gradient
   pass reports no operation on the kernels, and reports the library's
   trilinear backward on the plain route (the control); a second run of
   the step gives the same loss and gradients bit for bit; remat vs no
   remat: total loss rel <= 1e-6, every gradient leaf within rel 1e-3;
   kernel vs plain bf16 (phase 7's limits); then 3 + 5 steps
   each without and with remat: the exact calls per step of every kernel
   (remat adds the recompute of the 22 segmenter stage convs and 33 stage
   GroupNorms), ms/step, peak memory, logical-FLOP MFU
   (utils/flops.train_step_flops against 989 TFLOP/s);
10. the device data pipeline and the production entry point on 16
   synthetic cases at the AMOS grid (256 x 256 x 128; made by a worker
   process while phases 1-9 run): DeviceDataPipeline batches on the card
   equal the host path's crops at the same corners, its intensity recipe
   at fixed parameters is within 1 bf16 ulp of numpy/scipy f32; then
   mpl-train-torch --batch_size 3 --device_data true --remat true for 2
   epochs with validation after each, a checkpoint and a resumed epoch
   (every step's train-conv and gn_relu-backward calls as in phase 9), and
   the same epochs with --device_data false: patches/s of both; then the
   first --device_data true run again through ``torchrun --nproc_per_node 1``
   with --mesh data:1 (NCCL; the data-parallel step over one rank): its final
   checkpoint bit-equal to the run without --mesh, and its patches/s;
11. the re-profile: tools/profile_chip.py over one serving tile batch and
   the B = 1, B = 3 and B = 3 remat steps, device ms by kernel category; no
   library trilinear-resize kernel runs in any of them, and resize3d
   launches 4 kernels per serving tile batch and 29 per step (17 forward,
   12 backward);
12. data parallelism on the one card: the device ms of one step's two
   gradient averages over a one-rank NCCL group (flatten, all_reduce,
   unflatten) at the flagship's widths and the B = 3 step's ms with and
   without that group (in turns); two ranks spawned on the card over
   gloo (NCCL takes one rank per card; gloo stages CUDA tensors through the
   host, so its times are not NCCL's), one step each at B = 3 per rank and
   the flagship defaults on shards of different data and supervised organs
   from one seeded state: both ranks' new states bit-equal to the reference
   built in this process ((g0 + g1) / 2 of the per-shard gradients, the step's
   updates, tokens from the summed class statistics), the loss the shards'
   mean, each rank's kernel calls one step's; then the two ranks' sharded
   predictor over phase 4's volume against the one-rank predictor: blended
   logits within 1e-5, argmax agreement >= 0.9999, rank 0's kernel calls
   those of 2 tile batches and rank 1's of one (its batch of pad duplicates
   is skipped);
13. the ablation U-Nets at full width (base 32, 14 classes; seeded weights,
   with phase 3's FEAM weights on every parameter they share with it):
   UNet3DBaseline, UNet3DDeepSup, UNet3DEAM (num_eams 3 and 2) and
   UNet3DDynHead on phase 3's bf16 tile batch: the logits kernel vs plain
   within rel L2 3e-2, and every output (logits, deep maps, the EAM
   cascade's tokens and attention maps, DynHead's 2-channel logits) of the
   kernel route at most 1.05 times as far from an f32 forward as the plain
   bf16 route's (kernel vs plain reported); the exact kernel calls per
   tile batch (18 fused + 4 prologue-off conv3x3_gn, 18 folds, 4 resize3d;
   gn_relu 17 for the trunk, 20 for UNet3DDeepSup(aux=True), 18 for
   UNet3DDynHead), each shape checked in phase 2 or here (the deep heads'
   gn_relu shapes); the Baseline's, DeepSup(aux=False)'s and the EAM
   ablations' (aux=False) logits the bits of the FEAM's aux=False logits;
   UNet3DBaseline and UNet3DDynHead (one task id) serve phase 4's volume
   through SlidingWindowPredictor(output='argmax'): label maps kernel vs
   plain agree >= 0.95, calls per volume 3 tile batches', s/vol (median
   of 3, beside the FEAM's timed alike); a
   utils/profiling.trace of one UNet3DBaseline forward holds device kernel
   events of the port's kernels; the loss zoo: every aux_variants function
   on FEAM-shaped f32 outputs of one tile on the card, and on a 32 x 96 x 96
   crop of it, every legacy function on 12-, 6- and 5-class MOTS logits and
   on DynHead's 2-channel logits, card vs CPU: value and gradient with
   respect to the logits within rel 1e-4;
14. spatial serving (``--mesh space:N``: each tile's H axis split over the
   ranks of a group, halo rows exchanged, GroupNorm statistics merged across
   slabs) with phase 3's weights: mpl-evaluate-torch through ``torchrun
   --nproc_per_node 1`` with --mesh space:1 (NCCL) writes the label maps of
   the run without --mesh bit for bit, and the spatial predictor over a
   one-rank NCCL group gives the plain predictor's label map over phase 4's
   volume bit for bit (s/vol of both, in turns); two gloo ranks spawned on
   the card split phase 3's bf16 tile batch (space:2): the ranks' logits
   bit-equal, within rel L2 3e-2 and label agreement 0.95 of the one-rank
   kernel forward, and at most 1.05 times as far from an f32 forward as the
   one-rank kernel forward; the plain f32 route split vs whole within rel L2
   1e-5; each level's output (layer0-4, fusionConv, x8/x4/x2/x1_resb), the
   two ranks' slabs against the one-rank forward's rows, within rel L2 0.1;
   rank 0's calls per tile batch 18 fused + 4 prologue-off conv3x3_gn,
   35 gn_moments, 18 fold and 17 normalize gn_apply, 4 resize3d, no unsplit
   gn_relu or fold call, 31 halo exchanges and 35 statistics gathers, with
   the stream ms of the exchanges, the halo copies and crops and the
   statistics gathers (CUDA events in the run, host gaps included) and the
   device ms of those copies (CUDA-graph replays); the planted faults of
   tools/spatial_fault.py (rank 1's low halo zeroed at layer0.0, and at
   layer4.1, the 1/16 scale, which the logits' checks miss) each fail those
   criteria; the spatial predictor over phase 4's volume on the two ranks:
   blended logits within rel L2 3e-2 and argmax agreement 0.95 of the
   one-rank predictor, ranks bit-equal, 3 tile batches' calls per volume,
   s/vol (two ranks on one card over gloo: not a scaling figure); in the
   same spawn UNet3DDeepSup, UNet3DEAM (num_eams 3, aux=True) and
   UNet3DDynHead split (phase 13's weights; the EAM cascade's softmax over
   the voxels and DynHead's mean over the tile merged across the ranks):
   ranks bit-equal, logits within rel L2 3e-2 and agreement 0.95 of the
   one-rank kernel forward, every output (logits, deep maps, the EAM tokens
   and attention maps) at most 1.05 times as far from an f32 forward as the
   one-rank kernel forward's, rank 0's calls and exchanges per tile batch
   (the trunk's, plus one moments gather and normalize per head
   GroupNorm -> ReLU, 3 softmax merges, DynHead's one mean), the split and
   one-rank forward ms; then the slab entry points gn_moments_bf16 and
   gn_apply_bf16 against their plain twins at every slab shape of the FEAM
   and the ablations (statistics rel 1e-5, y 1e-2 * max|plain|, the
   normalize given gn_relu_fwd_bf16's own statistics that kernel's y bit
   for bit), and conv3x3_gn and resize3d at the halo-extended slab shapes as
   in phase 2, all timed;
15. the partial-label campaign (tools/campaign.py on its default fixture,
   28 synthetic cases at 96 x 96 x 80 made by the worker process): the
   chunked runner trains epochs 0-3 and 3-6 (64 x 96 x 96, B = 3,
   --device_data true, validation at epoch 5) through mpl-train-torch's
   main; chunk 2 resumes chunk 1's checkpoint (the trainer says so, and the
   run ends at 36 steps), every logged loss is finite, and training launches
   every training kernel (conv3x3_train forward and dx, the fused and
   prologue-off conv3x3_gn, gn_relu forward and backward, the fold,
   resize3d forward and backward); then tools/campaign_eval.py on the final
   checkpoint by the kernel route (bf16 tiles; every serving kernel
   launched), the plain route (f32; none launched) and the plain versions on
   bf16 tiles: 9 held-out cases (3 valid, 6 test), each case's label map of
   the kernel route agreeing with the plain versions' on bf16 tiles on
   >= 0.95 of the voxels (phase 8's limit, two routes at one dtype; the
   agreement of both with the f32 route printed), the tables printed; the
   route probes of tools/route_probe.py from the 6-epoch state at the
   campaign's shape (a few seconds): every kernel call of one kernel-route
   gradient step against its plain version on its own inputs, the signed
   bias |mean(kernel - f32)| / rms(f32) <= 1e-3 for each of the nine
   kernels, and the refiner's gradient-free pass over 8 batches, kernel
   against plain bf16, its pooled foreground shift within 5 standard errors;
   the forks of tools/campaign.py run --fork_from: the 6-epoch state
   copied into a fresh snapshot directory per route and trained one epoch
   at seed 10 on the kernel route and on the plain bf16 route, with the
   counts set to 0 before each: both resume at step 36 and log steps 37-42
   only, their first total loss within rel 3e-2 (phase 7's route limit),
   their held-out label maps by the kernel evaluator agreeing on >= 0.95 of
   each case's voxels, every training kernel launched by the kernel fork
   and none by the plain fork, each route's s/epoch printed;
   then every kernel at every shape a path launched against its plain
   version, timed, as in phases 2 and 6;
16. the spatial train step (parallel/spatial.py make_spatial_train_step:
   a B = 1 patch's H axis split over ranks through the forward, the losses
   and the backward) at 64 x 192 x 192, bf16, the StepConfig defaults, from
   one seeded state and batch: over a one-rank NCCL group (space:1) the new
   state and metrics of TrainStep bit for bit, without and with remat, and
   TrainStep(deep_up=False) raising ValueError split or not (the JAX step
   fails to trace it); in one spawned rank the
   gradients of the kernel, plain bf16 and plain f32 (TF32 off) steps; on
   two gloo ranks on the card (space:2) the same gradient passes split:
   ranks bit-equal, the loss within rel 3e-2 of the one-rank kernel and f32
   steps, each segmenter and refiner gradient leaf at most 1.4 x as far from
   the f32 step as the plain bf16 step's plus 1e-2 (phase 7's rule), the
   plain f32 route split against whole, both against the whole step in
   float64: the split's median leaf at most 2 x as far from float64 as the
   whole's (+ 1e-6), every leaf within 0.1 of the whole's (a ReLU whose
   pre-activation sits within rounding of 0 flips with the order of sums),
   and a planted fault
   (tools/spatial_fault.py: no halo row's gradient returned) failing the
   per-leaf rule; then one kernel step on each rank: its metrics finite,
   the loss within rel 3e-2 of the one-rank step's, as many gn_bwd_sums_bf16
   and gn_bwd_dx_bf16 calls as slab GroupNorms, every halo but the stem's
   returning its gradient, the calls and exchanges per step, each rank's
   peak GiB and wall ms against one rank's, at 64 x 192 x 192 and at
   1 x 128^3 (gloo stages through the host: no scaling figure); the same
   with remat on the two ranks: its gradients against the split step's
   without remat (loss rel 1e-6, every leaf rel 1e-3, phase 9's rule) and
   phase 7's per-leaf rule, and the calls and exchanges the recompute adds
   exactly as derived from the architecture (``remat_recompute``: 22
   conv3x3_train forwards, 33 gn_moments and normalize gn_apply, 26 halo
   exchanges, 16 crops, 33 statistics gathers), peak GiB and wall ms; then
   gn_bwd_sums_bf16 and gn_bwd_dx_bf16 against their plain twins at every
   slab shape (sums, ds and dt rel 1e-3; dx 1e-2 * max|plain|; the sums in
   one launch where one cluster holds the sample's blocks, else two), and
   every other kernel at every slab shape the step launched, timed;
17. raw NIfTI to label maps with the port alone: 10 raw synthetic scans
   (8 CT with ids up to 430, 2 MRI) stored in a non-RAS layout (index axes
   along world y, z, x, two of them reversed) at a voxel size of 0.8 x 0.8 x
   2.5 go through mpl-preprocess-torch and mpl-atlas-torch (host work,
   numpy and scipy); every written case at spacing (1, 1, 2), the first
   case stored RAS preprocessing to the same bytes, the atlas (13, D, H, W)
   within the cases' shapes, the csv one row per case; then 2 epochs of
   mpl-train-torch (kernel route, full width, 64 x 64 x 64 patches, B = 2)
   launching every training kernel, and mpl-evaluate-torch on its
   checkpoint writing a label map per test case (every serving kernel
   launched); no module of JAX or of the JAX package is loaded.

The kernels line gives per path the calls of a volume or a step (for the
campaign, of its whole training run and of its kernel-route evaluation)
and their device time from the per-shape tables. Kernel "launches" are
calls of a wrapper (a conv3x3_gn call split across
blocks launches a second, reduction kernel; a fold call launches two; a
gn_relu call one where a sample fits a thread-block cluster, else two; a
resize3d call, forward or backward, one).
Kernel, plain and library times are device times per call (CUDA graph
replays); bounds are max(FLOP / peak, bytes / 3.35e12) per call (H100 SXM
dense bf16 989e12 for the convs and GroupNorm, f32 67e12 for the resize's
f32 arithmetic; HBM3 bytes), with every input read once and every output
written once. Prints each phase's seconds, the kernels' JSON line, the card line, and as the
last line {"ok": true, "device": {...}}. Weights are random from fixed seeds. Details
go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

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
GN_BWD_REL = 1e-3     # gn_relu backward ds, dt kernel vs plain: f32 summation order
GN_BWD = "multimodal_pl_tpu/ops/norm.py:95 _gn_relu_bwd (XLA; the VJP of row 5)"
RESIZE = "multimodal_pl_tpu/ops/resize.py:21 resize_trilinear / upsample_trilinear (XLA)"
RESIZE_BWD = "multimodal_pl_tpu/ops/resize.py:21 (XLA: the transpose of the resize)"
SOURCE = "multimodal_pl_tpu_torch/csrc/conv3x3_gn.cu"
GN_SOURCE = "multimodal_pl_tpu_torch/csrc/gn_relu.cu"
RESIZE_SOURCE = "multimodal_pl_tpu_torch/csrc/resize3d.cu"
PEAK_F32 = 67e12      # H100 SXM f32 outside the tensor cores (the resize's arithmetic)
PATCH = (64, 192, 192)      # the training patch (StepConfig / cli/train.py defaults)
REPO = os.path.dirname(os.path.abspath(__file__))
DP_PRED_ABS = 1e-5           # two-rank vs one-rank blended logits: f32 sum order only
DP_PRED_AGREE = 0.9999       # two-rank vs one-rank argmax agreement
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
PROD_B = 3                  # run_amos_atlas_final.sh's --batch_size
# remat vs no remat on the kernels: the step is deterministic (a rerun gives
# the same bits), so the recompute reproduces the forward and each gradient
# leaf may differ by at most REMAT_LEAF_REL relative (0 expected); a
# recompute on wrong weights moves the gradients by O(1).
REMAT_LOSS_REL = 1e-6
REMAT_LEAF_REL = 1e-3
RESIZE_TAP_FLOP = 16         # 8 weighted taps per output element (forward and gradient)
# the attention maps' channels (num_classes - 1) and dtype (f32 scores)
AMAP_C, AMAP_DTYPE = NC - 1, "float32"
# resize3d kernels per profiled call (phase 11): 4 upsamples per serving tile
# batch; 17 forward and 12 backward calls per train step, one launch each
PROFILE_RESIZE_LAUNCHES = {"serving_tile_batch": 4, "train_step": 29, "train_step_b3": 29,
                           "train_step_b3_remat": 29}
AMOS_GRID = (256, 256, 128)  # (H, W, D) of an AMOS case after preprocessing
AMOS_CASES = (14, 2)         # synthetic CT, MRI cases: 11 train (3 steps of B = 3), 1 valid

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


def bound(flop: float, nbytes: float, peak: float = PEAK_FLOPS) -> dict:
    """The least time of one call: op_ms and byte_ms at the card's peaks
    (``peak`` FLOP/s for the call's arithmetic), bound_ms the larger."""
    op_ms, byte_ms = flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
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


def torchrun(module: str, argv, cwd: str, timeout: float = 900) -> str:
    """``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    module argv`` from ``cwd`` with this repository on PYTHONPATH (one rank,
    NCCL on the card); raises unless it exits 0. Returns its output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", module, *argv]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    check(proc.returncode == 0, f"torchrun -m {module} exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


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
    residual)], gradient-free gn_relu calls [(C, groups, DHW)], the GNs of
    the stages alone (without the two heads')). Per block:
    GN1 (and the projection's GN) on the input, GN2 and conv2 on the output,
    conv1 through conv3x3_train at stride 1 and the library at stride 2;
    without grad, stride-1 convs are fused (conv2 adds an identity residual,
    the GNs fold into their prologues), a stride-2 block's GN1, GN2 and
    projection GN run gn_relu and its conv2 is prologue-off, and every
    projection and head runs gn_relu before its 1x1 conv."""
    convs, stage_gns, nograd, nograd_gns = [], [], [], []

    def block(cin, cout, d_in, stride):
        d_out = d_in if stride == 1 else _half(d_in)
        proj = stride != 1 or cin != cout
        stage_gns.extend([(cin, group, d_in), (cout, group, d_out)] + [(cin, group, d_in)] * proj)
        nograd_gns.extend([(cin, group, d_in)] * proj)
        if stride == 1:
            convs.extend([(cin, cout, d_out), (cout, cout, d_out)])
            nograd.extend([(cin, cout, d_out, True, False), (cout, cout, d_out, True, not proj)])
        else:
            convs.append((cout, cout, d_out))
            nograd.append((cout, cout, d_out, False, False))
            nograd_gns.extend([(cin, group, d_in), (cout, group, d_out)])
        return d_out

    def stage(cin, cout, blocks, stride, d):
        for i in range(blocks):
            d = block(cin if i == 0 else cout, cout, d, stride if i == 0 else 1)
        return d

    d = [dhw]
    chans = [widths[0]] + list(widths)
    for i in range(5):
        d.append(stage(chans[i], widths[i], layers[i], 1 if i == 0 else 2, d[-1]))
    heads = [(widths[4], fusion_groups, d[5])]
    nograd_gns.append((widths[4], fusion_groups, d[5]))
    for cin, cout, scale in ((widths[4], widths[2], d[4]), (widths[2], widths[1], d[3]),
                             (widths[1], widths[0], d[2]), (widths[0], widths[0], d[1])):
        stage(cin, cout, 1, 1, scale)
    heads.append((widths[0], precls_groups, d[1]))
    nograd_gns.append((widths[0], precls_groups, d[1]))
    return convs, stage_gns + heads, nograd, nograd_gns, stage_gns


def serving_gn_keys():
    """gn_relu calls of one forward of a 4-tile batch of the flagship
    UNet3DFEAM: {(C, groups, B, D, H, W): calls}."""
    from collections import Counter

    sites = unet_shapes(TILE, [32, 64, 128, 256, 256], (1, 2, 2, 2, 2), 16, 16, 16)[3]
    return Counter((c, groups, WINDOW_BATCH, *dhw) for c, groups, dhw in sites)


def _scale(dhw, k):
    return tuple(v // k for v in dhw)


def decoder_upsamples(dhw, widths):
    """(C, DHW of the input) of each of the four x2 upsamples (+ skip) of a
    voxel U-Net's decoder at full resolution ``dhw`` and stage ``widths``:
    the fusion output at dhw / 16, then the x8, x4, x2 stages' outputs."""
    return [(widths[4], _scale(dhw, 16)), (widths[2], _scale(dhw, 8)),
            (widths[1], _scale(dhw, 4)), (widths[0], _scale(dhw, 2))]


def serving_resize_keys():
    """resize3d forward calls of one forward of a 4-tile batch of the
    flagship UNet3DFEAM (aux=False: the decoder's upsamples alone):
    {(factor, C, dtype, B, D, H, W, skip): calls}."""
    from collections import Counter

    return Counter((2, c, "bfloat16", WINDOW_BATCH, *dhw, True)
                   for c, dhw in decoder_upsamples(TILE, [32, 64, 128, 256, 256]))


def resize_shapes(cfg, batch: int = 1):
    """-> ({forward key: calls per step}, {backward key: calls per step}) of
    resize3d in one bf16 train step of ``cfg`` at ``batch``: the segmenter's
    four decoder upsamples + skip, its x8/x4/x2 attention-map resizes (f32,
    num_classes - 1 channels; deep_up), and the refiner's four upsamples +
    skip and its logits' x2 (2 channels) at half resolution, for its K
    gradient rows (forward and backward) and its other rows (forward only).
    Keys as the wrapper counts them: forward (factor, C, dtype, B, D, H, W,
    skip), backward without the skip. Remat does not recompute them: they
    lie outside the checkpointed stages."""
    from collections import Counter

    b, f, k = cfg.base, cfg.refiner_filter, cfg.refine_grad_organs
    rest = cfg.num_classes - 1 - k
    keys = [(2, c, "bfloat16", batch, *dhw, True)
            for c, dhw in decoder_upsamples(PATCH, [b, 2 * b, 4 * b, 8 * b, 8 * b])]
    if cfg.deep_up:
        keys += [(s, AMAP_C, AMAP_DTYPE, batch, *_scale(PATCH, s), False) for s in (8, 4, 2)]
    half = _half(PATCH)

    def refiner(n):
        return ([(2, c, "bfloat16", n, *dhw, True)
                 for c, dhw in decoder_upsamples(half, [f, 2 * f, 4 * f, 8 * f, 8 * f])]
                + [(2, 2, "bfloat16", n, *half, False)])

    fwd = Counter(keys + refiner(k) + refiner(rest))
    bwd = Counter(key[:7] for key in keys + refiner(k))
    return fwd, bwd


def training_shapes(cfg, batch: int = 1):
    """-> ({kernel key: launches per train step} for conv3x3 (train fwd/dx,
    fused, prologue-off), the same for gn_relu under autograd (one forward
    and one backward call each), gn_relu calls without autograd (the
    refiner's gradient-free pass), and the forward calls that ``cfg.remat``
    adds for conv3x3 (train fwd) and gn_relu), from the architecture of
    ``cfg``. The segmenter runs at ``batch``; the refiner takes sample 0's
    organ rows whatever the batch. Under remat the backward recomputes
    every segmenter stage (the encoder's five, the decoder's four): each
    stride-1 conv's and each stage GroupNorm's forward launches once more;
    the fusion and classifier heads are not recomputed."""
    from collections import Counter

    from multimodal_pl_tpu_torch.ops import conv3x3

    b, f, k = cfg.base, cfg.refiner_filter, cfg.refine_grad_organs
    rest = cfg.num_classes - 1 - k
    seg_convs, seg_gns, _, _, seg_stage_gns = unet_shapes(
        PATCH, [b, 2 * b, 4 * b, 8 * b, 8 * b], cfg.layers, 16, 16, 16)
    half = _half(PATCH)  # the refiner runs at half resolution after its stride-2 stem
    ref_convs, ref_gns, ref_nograd, ref_nograd_gns, _ = unet_shapes(
        half, [f, 2 * f, 4 * f, 8 * f, 8 * f], (1, 1, 1, 1, 1), 4, f // 2, f // 4)
    ref_convs.append((f, f, half))                       # the refiner's conv1
    ref_nograd.append((f, f, half, False, False))
    conv = Counter()
    for n, convs in ((batch, seg_convs), (k, ref_convs)):
        for cin, cout, (d, h, w) in convs:
            conv[(conv3x3.TRAIN_FWD, cin, cout, n, d, h, w, False)] += 1
            conv[(conv3x3.TRAIN_DX, cout, cin, n, d, h, w, False)] += 1
    for cin, cout, (d, h, w), prologue, res in ref_nograd:
        conv[(conv3x3.FUSED if prologue else conv3x3.PROLOGUE_OFF, cin, cout, rest, d, h, w,
              res)] += 1
    gn = Counter()
    for n, gns in ((batch, seg_gns), (k, ref_gns)):
        for c, groups, dhw in gns:
            gn[(c, groups, n, *dhw)] += 1
    gn_nograd = Counter((c, groups, rest, *dhw) for c, groups, dhw in ref_nograd_gns)
    conv_remat, gn_remat = Counter(), Counter()
    if cfg.remat:
        conv_remat.update((conv3x3.TRAIN_FWD, cin, cout, batch, *dhw, False)
                          for cin, cout, dhw in seg_convs)
        gn_remat.update((c, groups, batch, *dhw) for c, groups, dhw in seg_stage_gns)
    return conv, gn, gn_nograd, conv_remat, gn_remat


def _gn_library(x_cl, groups, sc, bi):
    """The library's GroupNorm -> ReLU: F.group_norm, then an in-place ReLU."""
    import torch.nn.functional as F

    return F.relu(F.group_norm(x_cl, groups, sc, bi, 1e-5), inplace=True)


def phase_gn(dev, results, gn_keys, name="gn_relu"):
    """Phases 2 and 6: the gn_relu forward kernel vs plain at each (C,
    groups, B, D, H, W) of ``gn_keys``; the library time is F.group_norm
    then an in-place ReLU on the bf16 channels-last input. Bound: read x,
    write y."""
    from multimodal_pl_tpu_torch.ops.gn_relu import group_norm_relu, group_norm_relu_reference

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
                   "library_ms": time_ms(lambda: _gn_library(x_cl, groups, sc16, bi16), reps),
                   **bound(0.0, 4 * x.numel() + 2 * 4 * c)}
        row["gb_s"] = 2 * x.numel() * 2 / row["ms"] / 1e6  # one read of x, one write
        print(f"  gn_relu B={batch} C={c:3d} G={groups:2d} @{d}x{h}x{w} max|k-p|={err:.3g} "
              f"(max|p|={scale:.3g})  kernel {row['ms']:.3f} ms ({row['gb_s']:.0f} GB/s at the "
              f"one-read bound)  plain {row['plain_ms']:.3f} ms  library {row['library_ms']:.3f} "
              f"ms  bound {row['bound_ms']:.3f} ms", flush=True)
        check(err <= 1e-2 * scale, f"gn_relu kernel disagrees with plain at {row}")
        table[(c, groups, batch, d, h, w)] = row
        results[name].append(row)
    torch.cuda.empty_cache()
    return table


def resize_bound(key) -> dict:
    """One resize3d call (forward key, or backward key without the skip):
    RESIZE_TAP_FLOP f32 FLOP per element of the upsampled tensor; bytes: x
    (dx) and the upsampled y (dy) once each, and the skip once."""
    factor, c, dtype, b, d, h, w = key[:7]
    small = b * d * h * w * c
    big = small * factor ** 3
    el = 2 if dtype == "bfloat16" else 4
    nbytes = el * (small + big + (big if len(key) > 7 and key[7] else 0))
    return {**bound(RESIZE_TAP_FLOP * big, nbytes, PEAK_F32), "bytes": nbytes}


def phase_resize(dev, results, fwd_keys, bwd_keys=()):
    """Phases 2 and 6: the resize3d forward kernel vs its plain version at
    every forward key (factor, C, dtype, B, D, H, W, skip), and the backward
    kernel vs its plain version at every backward key, with the plain
    versions in f32 on the same inputs: max|k - p| <= 1e-2 * max|p| (bf16
    output rounding, 2^-8 relative, plus f32 summation order); the backward
    gives the same bits twice (gather form). Times: the kernel; the plain
    version in the working dtype (forward: F.interpolate, then the add;
    backward: the library's interpolation gradient, the call autograd takes,
    so also the library time); library forward: one F.interpolate on the
    channels-last input, without the skip add (a lower bound where the
    kernel fuses the skip). Returns ({forward key: row}, {backward key:
    row})."""
    import torch.nn.functional as F

    from multimodal_pl_tpu_torch.ops import resize

    g = torch.Generator().manual_seed(9)
    tables = ({}, {})
    for backward, keys in ((False, fwd_keys), (True, bwd_keys)):
        for key in sorted(keys, key=str):
            factor, c, dtype, b, d, h, w = key[:7]
            dt = getattr(torch, dtype)
            out = (b, d * factor, h * factor, w * factor, c)
            reps = 5 if b * d * h * w * c * factor ** 3 > 2 ** 26 else 20
            if backward:
                dy = torch.randn(out, generator=g).to(dev, dt)
                k1, k2 = (resize.upsample_backward(dy, factor) for _ in range(2))
                torch.cuda.synchronize()
                p = resize.upsample_trilinear_backward_reference(dy.float(), factor)
                bits = torch.equal(k1, k2)
                kernel_ms = time_ms(lambda: resize.upsample_backward(dy, factor), reps)
                plain_ms = library_ms = time_ms(
                    lambda: resize.upsample_trilinear_backward_reference(dy, factor), reps)
                del dy, k2
            else:
                x = torch.randn((b, d, h, w, c), generator=g).to(dev, dt)
                sk = torch.randn(out, generator=g).to(dev, dt) if key[7] else None
                k1 = resize.upsample_forward(x, factor, sk)
                torch.cuda.synchronize()
                p = resize.upsample_trilinear_reference(x.float(), factor,
                                                        None if sk is None else sk.float())
                bits = True
                x_cf = x.permute(0, 4, 1, 2, 3)
                kernel_ms = time_ms(lambda: resize.upsample_forward(x, factor, sk), reps)
                plain_ms = time_ms(lambda: resize.upsample_trilinear_reference(x, factor, sk),
                                   reps)
                library_ms = time_ms(lambda: F.interpolate(x_cf, scale_factor=factor,
                                                           mode="trilinear"), reps)
                del x, sk, x_cf
            err = (k1.float() - p).abs().max().item()
            scale = p.abs().max().item()
            row = {"factor": factor, "c": c, "dtype": dtype, "b": b, "dhw": [d, h, w],
                   "skip": bool(not backward and key[7]), "backward": backward,
                   "max_abs_err": err, "max_abs_plain": scale, "bits_equal": bits,
                   "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   **resize_bound(key),
                   "moved_bytes": resize.moved_bytes((b, d, h, w, c), factor, dt.itemsize,
                                                     backward, bool(not backward and key[7]))}
            row["gb_s"] = row["bytes"] / row["ms"] / 1e6
            print(f"  resize3d {'backward' if backward else 'forward '} x{factor} B={b} C={c:3d} "
                  f"{dtype} @{d}x{h}x{w}{' + skip' if row['skip'] else ''}: max|k-p|={err:.3g} "
                  f"(max|p|={scale:.3g}){', same bits twice' if backward and bits else ''}  "
                  f"kernel {row['ms']:.3f} ms ({row['gb_s']:.0f} GB/s at the one-read bound; "
                  f"moves {row['moved_bytes'] / row['bytes']:.2f}x those bytes)  "
                  f"plain {row['plain_ms']:.3f} ms  library {row['library_ms']:.3f} ms  bound "
                  f"{row['bound_ms']:.3f} ms", flush=True)
            check(err <= 1e-2 * scale and bits, f"resize3d kernel disagrees with plain at {row}")
            tables[backward][key] = row
            results["resize"].append(row)
            del k1, p
    torch.cuda.empty_cache()
    return tables


def resize_summary(tag, tables):
    """Phases 2 and 6: one line naming the resize3d shapes that run below half
    their bound (bound_ms / ms < 0.5) and those slower than the library's
    call; informational, no check."""
    rows = [r for table in tables for r in table.values()]

    def name(r):
        return (f"{'bwd' if r['backward'] else 'fwd'} x{r['factor']} B={r['b']} C={r['c']} "
                f"{r['dtype']} @{'x'.join(map(str, r['dhw']))}")

    slow = [f"{name(r)} ({r['bound_ms'] / r['ms']:.2f})" for r in rows
            if r["bound_ms"] < 0.5 * r["ms"]]
    lost = [f"{name(r)} ({r['ms']:.3f} vs {r['library_ms']:.3f} ms)" for r in rows
            if r["ms"] > r["library_ms"]]
    print(f"  resize3d {tag}: {len(rows)} shapes; below half the bound (share of it): "
          f"{'; '.join(slow) or 'none'}; slower than the library: {'; '.join(lost) or 'none'}",
          flush=True)


def phase_gn_bwd(dev, results, gn_keys):
    """Phase 6: the gn_relu backward kernel vs its plain version at every
    GroupNorm shape of the train step, both from the forward kernel's
    statistics: dx within 1e-2 * max|dx| (bf16 output rounding), ds and dt
    by relative norm <= GN_BWD_REL (f32 summation order). The library time
    is autograd's backward of F.group_norm + ReLU (its forward and backward
    replayed, less its forward). Bound: read x and dy, write dx."""
    from multimodal_pl_tpu_torch.ops.gn_relu import (
        gn_relu_backward, gn_relu_forward, group_norm_relu_backward_reference)

    g = torch.Generator().manual_seed(8)
    table = {}
    for c, groups, batch, d, h, w in sorted(gn_keys):
        x = (torch.randn((batch, d, h, w, c), generator=g) * 2 + 0.5).to(dev, torch.bfloat16)
        dy = torch.randn((batch, d, h, w, c), generator=g).to(dev, torch.bfloat16)
        sc = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
        bi = (0.1 * torch.randn(c, generator=g)).to(dev)
        _, stats = gn_relu_forward(x, sc, bi, groups)
        kdx, kds, kdt = gn_relu_backward(x, dy, sc, bi, stats, groups)
        torch.cuda.synchronize()
        pdx, pds, pdt = group_norm_relu_backward_reference(x, dy, sc, bi, stats, groups)
        err = (kdx.float() - pdx.float()).abs().max().item()
        scale = pdx.float().abs().max().item()
        rel = max(((k - q).norm() / q.norm().clamp_min(1e-30)).item()
                  for k, q in ((kds, pds), (kdt, pdt)))
        reps = 5 if x.numel() > 2 ** 26 else 20
        x_cl = x.permute(0, 4, 1, 2, 3).requires_grad_()
        dy_cl = dy.permute(0, 4, 1, 2, 3)
        sc16, bi16 = (t.to(torch.bfloat16).requires_grad_() for t in (sc, bi))

        def lib_fwd():
            return _gn_library(x_cl, groups, sc16, bi16)

        def lib_fwd_bwd():
            return torch.autograd.grad(lib_fwd(), (x_cl, sc16, bi16), dy_cl)

        row = {"c": c, "groups": groups, "b": batch, "dhw": [d, h, w], "max_abs_err": err,
               "max_abs_plain": scale, "dsdt_rel": rel,
               "ms": time_ms(lambda: gn_relu_backward(x, dy, sc, bi, stats, groups), reps),
               "plain_ms": time_ms(lambda: group_norm_relu_backward_reference(
                   x, dy, sc, bi, stats, groups), reps),
               "library_ms": time_ms(lib_fwd_bwd, reps) - time_ms(lib_fwd, reps),
               **bound(0.0, 6 * x.numel() + 4 * (2 * batch * groups + 4 * c))}
        print(f"  gn_relu backward B={batch} C={c:3d} G={groups:2d} @{d}x{h}x{w} "
              f"max|dx k-p|={err:.3g} (max|p|={scale:.3g}) ds/dt rel {rel:.3g}  kernel "
              f"{row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms  library "
              f"{row['library_ms']:.3f} ms  bound {row['bound_ms']:.3f} ms", flush=True)
        check(err <= 1e-2 * scale and rel <= GN_BWD_REL,
              f"gn_relu backward kernel disagrees with plain at {row}")
        table[(c, groups, batch, d, h, w)] = row
        results["gn_relu_backward"].append(row)
        del x, dy, x_cl, dy_cl, kdx, pdx
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


def train_batch(dev, cfg, batch=1, patch=PATCH):
    """A seeded batch of ``batch`` samples at the training ``patch``, as the
    loop ships it: bf16 image and atlas, uint8 labels; organ 5 is
    supervised and in the labeled modality, so the refiner's gradient pass
    has a row."""
    rng = np.random.default_rng(5)
    nc = cfg.num_classes
    sup = np.zeros(nc, np.float32)
    sup[5] = 1
    host = {"image": rng.standard_normal((batch, *patch, 1)).astype(np.float32),
            "label": rng.integers(0, nc, (batch, *patch)).astype(np.uint8),
            "catlas": rng.random((nc - 1, *patch)).astype(np.float32), "sup_mask": sup,
            "label_t": np.array([0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1], np.float32)}
    from multimodal_pl_tpu_torch.train.loop import to_device

    return to_device(host, cfg, dev)


def make_step(dev, cfg):
    """The train step of ``cfg`` on ``dev``, its modules' own parameters
    overwritten with noise: the step runs on the state's parameters alone
    (a recompute that read the modules' would go wrong visibly)."""
    from multimodal_pl_tpu_torch.train.state import build_models
    from multimodal_pl_tpu_torch.train.step import make_train_step

    models = build_models(cfg)
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for m in models:
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=g))
    return make_train_step(*(m.to(dev) for m in models), cfg)


def step_grads(dev, variants, state, batch, wf):
    """{name: (total loss, {'params.'/'rparams.' + leaf: f32 gradient})}
    of one gradient step per StepConfig of ``variants``, freeing each
    step's memory before the next."""
    out = {}
    for name, c in variants.items():
        total, (gp, gr), _ = make_step(dev, c).grads(state, batch, wf)
        out[name] = (float(total),
                     {**{"params." + k: g.detach().float() for k, g in gp.items()},
                      **{"rparams." + k: g.detach().float() for k, g in gr.items()}})
        del total, gp, gr
        torch.cuda.empty_cache()
    return out


def rel_tree(a, b, keys):
    """Relative Frobenius norm of gradient trees a - b over ``keys``."""
    x, y = (torch.cat([t[k].flatten() for k in keys]) for t in (a, b))
    return ((x - y).norm() / y.norm().clamp_min(1e-30)).item()


def run_steps(dev, step, state, batch, lr, wf, expected, n_check=3, n_time=5):
    """n_check steps, each launching exactly ``expected`` kernel calls
    ({'conv3x3', 'gn_relu', 'gn_relu_backward', 'fold', 'resize',
    'resize_backward'}: Counter), then
    n_time more timed. Returns (the state after the checked steps, a record:
    ms of every step, the timed steps' median, peak GiB over all of them,
    metrics, the kernel calls of the checked steps)."""
    from collections import Counter

    from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu, norm, resize

    counters = {"conv3x3": conv3x3.launches, "gn_relu": gn_relu.launches,
                "gn_relu_backward": gn_relu.bwd_launches, "fold": norm.fold_launches,
                "resize": resize.launches, "resize_backward": resize.bwd_launches}
    totals = {k: Counter() for k in counters}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, metrics = [], []
    for _ in range(n_check):
        conv3x3.reset_launches()
        gn_relu.reset_launches()
        norm.fold_launches.clear()
        resize.reset_launches()
        t0 = time.perf_counter()
        state, m = step(state, batch, lr, wf)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for name, got in counters.items():
            check(Counter(got) == expected[name],
                  f"{name} calls per step {dict(got)} != {dict(expected[name])}")
            totals[name].update(got)
        metrics.append({k: float(v) for k, v in m.items()})
    steady, timed = [], state
    for _ in range(n_time):
        t0 = time.perf_counter()
        timed, _ = step(timed, batch, lr, wf)
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t0) * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del timed
    for m in metrics:
        check(all(np.isfinite(v) for v in m.values()), f"non-finite metrics {m}")
        check(m["grads_finite"] == 1.0 and m["disc_grads_finite"] == 1.0, f"guard fired: {m}")
    return state, {"step_ms": step_ms, "steady_step_ms": steady,
                   "steady_median_ms": float(np.median(steady)), "peak_gib": peak_gib,
                   "metrics": metrics, "calls": totals}


def step_expected(cfg, batch=1):
    """Kernel calls of one train step of ``cfg`` at ``batch`` (run_steps'
    ``expected``), from the architecture."""
    conv, gn, gn_nograd, conv_remat, gn_remat = training_shapes(cfg, batch)
    rfwd, rbwd = resize_shapes(cfg, batch)
    return {"conv3x3": conv + conv_remat, "gn_relu": gn + gn_nograd + gn_remat,
            "gn_relu_backward": gn, "fold": fold_keys(conv, 4), "resize": rfwd,
            "resize_backward": rbwd}


def mfu(batch, ms):
    """Logical-FLOP MFU of one train step at ``batch`` taking ``ms``,
    against the H100 SXM dense-bf16 peak."""
    from multimodal_pl_tpu_torch.utils.flops import H100_BF16_PEAK, train_step_flops

    return train_step_flops(PATCH, batch=batch)["total"] / (ms * 1e-3) / H100_BF16_PEAK


def phase_step(dev, results):
    """Phase 7: the train step at the full geometry, B = 1. Returns the
    kernel calls of the 3 checked steps ({'conv3x3', 'gn_relu',
    'gn_relu_backward', 'fold'}: Counter)."""
    import dataclasses

    from multimodal_pl_tpu_torch.ops import conv3x3
    from multimodal_pl_tpu_torch.train.state import StepConfig, create_train_state

    cfg = StepConfig(compute_dtype=torch.bfloat16)
    state = create_train_state(torch.Generator().manual_seed(0), cfg).to(dev)
    batch = train_batch(dev, cfg)
    lr = torch.tensor(5e-4, device=dev)
    wf = torch.tensor(0.05, device=dev)  # past the pretrain epochs: the consistency term runs

    # kernel vs plain from one state and batch; the f32 plain step shows the
    # size of the bf16 gap itself
    plain = dataclasses.replace(cfg, conv_impl="plain", gn_impl="plain")
    got = step_grads(dev, {"kernel": cfg, "plain": plain,
                           "plain_f32": dataclasses.replace(plain, compute_dtype=torch.float32)},
                     state, batch, wf)
    losses = {name: v[0] for name, v in got.items()}
    grads = {name: v[1] for name, v in got.items()}
    seg = [k for k in grads["plain"] if k.startswith("params.")]

    def rel(a, b, keys=seg):
        return rel_tree(grads[a], grads[b], keys)

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
    del grads, got
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

    expected = step_expected(cfg)
    first = state
    state, rec = run_steps(dev, make_step(dev, cfg), state, batch, lr, wf, expected)
    per_step = dict.fromkeys(conv3x3.SPECS, 0)
    for key, n in expected["conv3x3"].items():
        per_step[key[0]] += n
    for group, keys in (("params", ("conv1.weight", "layer4.1.conv2.weight",
                                    "precls_conv.2.weight")),
                        ("rparams", ("conv0.weight", "x1_resb.0.conv2.weight")),
                        ("dparams", ("block1.weight", "head.weight"))):
        for k in keys:
            check(not torch.equal(getattr(first, group)[k], getattr(state, group)[k]),
                  f"{group}.{k} did not move in 3 steps")
    check(all(bool(torch.isfinite(t).all()) for t in state.tokens.values()), "tokens not finite")
    calls = rec.pop("calls")
    results["step"] = dict(cmp, **rec, mfu=mfu(1, rec["steady_median_ms"]),
                           launches_per_step=per_step,
                           gn_relu_launches_per_step=sum(expected["gn_relu"].values()),
                           gn_relu_backward_launches_per_step=sum(
                               expected["gn_relu_backward"].values()),
                           fold_launches_per_step=sum(expected["fold"].values()),
                           resize_launches_per_step=sum(expected["resize"].values()),
                           resize_backward_launches_per_step=sum(
                               expected["resize_backward"].values()))
    print(f"[7] 3 kernel steps at B=1 x {PATCH}, bf16: {[round(t, 1) for t in rec['step_ms']]} "
          f"ms/step (then 5 more: median {rec['steady_median_ms']:.1f} ms, MFU "
          f"{results['step']['mfu']:.4f}), peak {rec['peak_gib']:.2f} GiB; losses "
          f"{[round(m['loss'], 5) for m in rec['metrics']]}; calls per step {per_step} + gn_relu "
          f"{sum(expected['gn_relu'].values())} forward, "
          f"{sum(expected['gn_relu_backward'].values())} backward + fold "
          f"{sum(expected['fold'].values())} + resize3d {sum(expected['resize'].values())} "
          f"forward, {sum(expected['resize_backward'].values())} backward", flush=True)
    del state, first, batch
    torch.cuda.empty_cache()
    return calls


def phase_production(dev, results):
    """Phase 9: the production step, B = PROD_B x 64 x 192 x 192, bf16, from
    a state one step away from the init. The detector: torch's deterministic
    mode (warn_only) over one gradient pass on the kernels reports no
    operation, and on the plain route reports the library's trilinear
    backward (the control: the detector sees the operation the kernel
    replaced). A second run of the step gives the same loss and gradients
    bit for bit. Remat vs no remat (kernels): total loss rel <=
    REMAT_LOSS_REL, every gradient leaf within rel REMAT_LEAF_REL; kernel vs
    plain bf16 without remat: phase 7's limits.
    Then 3 + 5 steps each without and with remat, the calls per step of
    every kernel asserted. Returns {remat: kernel calls of the 3 checked
    steps}."""
    import dataclasses

    from multimodal_pl_tpu_torch.tools.determinism import reported_ops, rerun_distance
    from multimodal_pl_tpu_torch.train.state import StepConfig, create_train_state

    cfg = StepConfig(compute_dtype=torch.bfloat16)
    rcfg = dataclasses.replace(cfg, remat=True)
    pcfg = dataclasses.replace(cfg, conv_impl="plain", gn_impl="plain")
    batch = train_batch(dev, cfg, PROD_B)
    lr, wf = torch.tensor(5e-4, device=dev), torch.tensor(0.05, device=dev)
    state = create_train_state(torch.Generator().manual_seed(0), cfg).to(dev)
    state, _ = make_step(dev, cfg)(state, batch, lr, wf)
    reported = {}
    for name, c in (("kernel", cfg), ("plain", pcfg)):
        step = make_step(dev, c)
        reported[name] = reported_ops(lambda: step.grads(state, batch, wf))
        del step
        torch.cuda.empty_cache()
    print(f"[9] deterministic mode (warn_only) over one B={PROD_B} gradient pass reports: "
          f"kernels {reported['kernel']}; plain route {reported['plain']}", flush=True)
    check(reported["kernel"] == [], f"nondeterministic operations on the kernels: {reported}")
    check(any("upsample_trilinear3d_backward" in m for m in reported["plain"]),
          f"the detector missed the library's trilinear backward on the plain route: {reported}")
    got = step_grads(dev, {"kernel": cfg, "rerun": cfg, "remat": rcfg, "plain": pcfg},
                     state, batch, wf)
    losses = {name: v[0] for name, v in got.items()}
    grads = {name: v[1] for name, v in got.items()}
    leaves = [k for k in grads["kernel"] if grads["kernel"][k].norm() > 0]
    seg = [k for k in leaves if k.startswith("params.")]
    remat_leaf = {k: rel_tree(grads["remat"], grads["kernel"], [k]) for k in leaves}
    worst = max(remat_leaf, key=remat_leaf.get)
    rerun = rerun_distance(got["rerun"], got["kernel"])
    cmp = {"loss": losses, "detector": reported, "rerun": rerun,
           "loss_rel_remat": abs(losses["remat"] - losses["kernel"]) / abs(losses["kernel"]),
           "remat_leaf_rel_worst": [worst, remat_leaf[worst]],
           "remat_leaf_rel_median": float(np.median(list(remat_leaf.values()))),
           "remat_tree_rel": rel_tree(grads["remat"], grads["kernel"], leaves),
           "zero_leaves": len(grads["kernel"]) - len(leaves),
           "loss_rel_kernel_plain": abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"]),
           "grad_rel_kernel_plain": rel_tree(grads["kernel"], grads["plain"], seg)}
    del grads, got
    print(f"[9] B={PROD_B} step rerun: loss difference {rerun['loss_diff']:.3e}, leaves with other "
          f"bits {len(rerun['differing_leaves'])} of {len(leaves) + cmp['zero_leaves']} (worst "
          f"|diff| {rerun['worst_abs']:.3e}); remat vs without: loss rel "
          f"{cmp['loss_rel_remat']:.3e}, worst leaf rel {remat_leaf[worst]:.3e} ({worst}), "
          f"tree rel {cmp['remat_tree_rel']:.3e}; kernel vs plain bf16: loss rel "
          f"{cmp['loss_rel_kernel_plain']:.3e}, segmenter-gradient rel "
          f"{cmp['grad_rel_kernel_plain']:.3e}; losses {losses}", flush=True)
    check(rerun["loss_diff"] == 0 and not rerun["differing_leaves"],
          f"two runs of the B={PROD_B} step differ: {rerun}")
    check(cmp["loss_rel_remat"] <= REMAT_LOSS_REL, f"remat step loss: {cmp}")
    check(remat_leaf[worst] <= REMAT_LEAF_REL,
          f"remat step gradient leaf {worst} rel {remat_leaf[worst]} > {REMAT_LEAF_REL}")
    check(cmp["loss_rel_kernel_plain"] <= 3e-2, f"B={PROD_B} step loss kernel vs plain: {cmp}")
    check(cmp["grad_rel_kernel_plain"] <= GRAD_REL_LIMIT,
          f"B={PROD_B} step gradients kernel vs plain: {cmp}")

    runs, calls = {}, {}
    for remat, c in ((False, cfg), (True, rcfg)):
        _, rec = run_steps(dev, make_step(dev, c), state, batch, lr, wf,
                           step_expected(c, PROD_B))
        calls[remat] = rec.pop("calls")
        rec["mfu"] = mfu(PROD_B, rec["steady_median_ms"])
        rec["calls_per_step"] = {k: sum(v.values()) // 3 for k, v in calls[remat].items()}
        runs["remat" if remat else "no_remat"] = rec
        print(f"[9] B={PROD_B} x {PATCH} bf16, remat {remat}: "
              f"{[round(t, 1) for t in rec['step_ms']]} ms/step, then 5 more: median "
              f"{rec['steady_median_ms']:.1f} ms ({[round(t, 1) for t in rec['steady_step_ms']]}),"
              f" MFU {rec['mfu']:.4f}, peak {rec['peak_gib']:.2f} GiB; losses "
              f"{[round(m['loss'], 5) for m in rec['metrics']]}; calls per step "
              f"{rec['calls_per_step']}", flush=True)
        torch.cuda.empty_cache()
    results["production_step"] = dict(cmp, **runs)
    del state, batch
    torch.cuda.empty_cache()
    return calls


def phase_train_cli(tmp):
    """Phase 8: mpl-train-torch on synthetic cases at the training patch,
    host batches (``--device_data false``): epochs 5 and 6 of 7 with
    validation after each (the loop validates from epoch 5), a checkpoint,
    then epoch 7 resumed from it. Then mpl-evaluate-torch on the checkpoint
    it wrote, over the train split's cases, with the default flags and with
    --pallas_k2 false --fused_gn false --bd true: the two label maps agree
    on >= 0.95 of the voxels (phase 4's limit); then the default evaluation
    through torchrun with --mesh data:1: the same label maps bit for bit."""
    from multimodal_pl_tpu_torch.cli import evaluate, train
    from multimodal_pl_tpu_torch.data.nifti import read_nifti
    from multimodal_pl_tpu_torch.ops import conv3x3
    from multimodal_pl_tpu_torch.train.checkpoint import latest_checkpoint
    from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

    img_dir, atlas_path, csv_path = make_synthetic_amos(os.path.join(tmp, "train_data"), n_ct=3,
                                                        n_mri=1, shape=(96, 96, 80), seed=1)
    snap = os.path.join(tmp, "snap")
    args = ["--data_dir", img_dir, "--atlas_path", atlas_path, "--supervision_csv", csv_path,
            "--snapshot_dir", snap, "--log_every", "1", "--val_pred_every", "1",
            "--device_data", "false"]
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

    trained = latest_checkpoint(snap)
    check(trained.endswith(f"ckpt_{int(resumed.step)}.pt"), f"latest checkpoint {trained}")
    maps = {}
    for tag, flags in (("kernels", []),
                       ("plain", ["--pallas_k2", "false", "--fused_gn", "false", "--bd", "true"])):
        out_dir = os.path.join(tmp, f"eval_{tag}")
        conv3x3.reset_launches()
        evaluate.main(["--data_dir", img_dir, "--atlas_path", atlas_path, "--reload_path",
                       trained, "--save_path", out_dir, "--usage", "train", "--print", "true"]
                      + flags)
        check(bool(conv3x3.launches) == (tag == "kernels"),
              f"mpl-evaluate-torch {flags}: conv3x3 calls {dict(conv3x3.launches)}")
        maps[tag] = {f: read_nifti(os.path.join(out_dir, f)).data
                     for f in sorted(os.listdir(out_dir)) if f.endswith("_pred.nii.gz")}
    check(maps["kernels"] and sorted(maps["kernels"]) == sorted(maps["plain"]),
          f"label maps {sorted(maps['kernels'])} vs {sorted(maps['plain'])}")
    agree = min(float((maps["kernels"][f] == maps["plain"][f]).mean()) for f in maps["kernels"])
    print(f"[8] mpl-evaluate-torch on {os.path.basename(trained)}: {len(maps['kernels'])} label "
          f"maps, kernels vs --pallas_k2 false --fused_gn false --bd true agree on {agree:.5f} "
          f"of the voxels (worst case)", flush=True)
    check(agree >= 0.95, f"evaluator label maps kernels vs plain agree on {agree} < 0.95")

    # the same evaluation through torchrun with --mesh data:1 (one NCCL rank,
    # the sharded predictor): the label maps of the run without --mesh, bit
    # for bit
    out_dir = os.path.join(tmp, "eval_mesh")
    t0 = time.perf_counter()
    torchrun("multimodal_pl_tpu_torch.cli.evaluate",
             ["--data_dir", img_dir, "--atlas_path", atlas_path, "--reload_path", trained,
              "--save_path", out_dir, "--usage", "train", "--print", "true", "--mesh", "data:1"],
             tmp)
    mesh_s = time.perf_counter() - t0
    mesh_maps = {f: read_nifti(os.path.join(out_dir, f)).data
                 for f in sorted(os.listdir(out_dir)) if f.endswith("_pred.nii.gz")}
    same = sorted(mesh_maps) == sorted(maps["kernels"]) and all(
        np.array_equal(mesh_maps[f], maps["kernels"][f]) for f in mesh_maps)
    print(f"[8] torchrun mpl-evaluate-torch --mesh data:1 (NCCL): {len(mesh_maps)} label maps, "
          f"bit-equal to the run without --mesh: {same} ({mesh_s:.1f} s)", flush=True)
    check(same, "mpl-evaluate-torch --mesh data:1 label maps differ from the run without --mesh")
    return {"steps": int(resumed.step), "losses": losses, "validation": vals,
            "evaluated_checkpoint": os.path.basename(trained), "eval_label_agreement": agree,
            "mesh_eval_bit_equal": same, "mesh_eval_s": mesh_s}


def _ulp_bf16(x):
    """The bf16 spacing at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


def phase_pipeline(dev, results, data):
    """Phase 10, first part: DeviceDataPipeline on the card over the
    synthetic AMOS-grid cases ``data`` (images dir, atlas path, csv path).
    Augmentation off, mirror on: every batch of an epoch equals the host
    path's crops at the same corners (host layout (H, W, D), cropped,
    transposed, flipped), sample 0's catlas, sup_mask and label_t. Then the
    recipe on the card with fixed parameters per sample (noise off) against
    numpy and scipy in f32 on the same bf16-stored crops: within 1 bf16 ulp
    of the plain value plus 1e-6 of the largest (the blur's f32 summation
    order); scipy's blur radius is round(4 sigma), the card's 4, equal at the
    sigmas used."""
    from scipy.ndimage import gaussian_filter

    from multimodal_pl_tpu_torch.data.dataset import AMOSDataset
    from multimodal_pl_tpu_torch.data.device_cache import _AUG_KEYS, DeviceDataPipeline
    from multimodal_pl_tpu_torch.data.supervision import label_t_of

    img_dir, atlas_path, csv_path = data
    ds = AMOSDataset(img_dir, crop_size=PATCH, usage="train", atlas=np.load(atlas_path),
                     supervision_csv=csv_path)
    t0 = time.perf_counter()
    pipe = DeviceDataPipeline(ds, compute_dtype=torch.bfloat16, augment=False, mirror=True,
                              seed=0, device=dev)
    load_s = time.perf_counter() - t0
    resident = sum(t.nbytes for t in (pipe.images, pipe.labels, pipe.catlas)) / 2 ** 30
    cd, ch, cw = PATCH
    bf = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)  # noqa: E731
    draws = list(pipe.draws(PROD_B))
    for idxs, starts, flips, p, n in draws:
        got = pipe.assemble(idxs, starts, flips, p, n)
        for j, (i, (a, b, c), f) in enumerate(zip(idxs, starts, flips)):
            cid, image, label, catlas = ds._prepared(int(i))
            axes = [ax for ax in range(3) if f[ax]]
            crop = (slice(b, b + ch), slice(c, c + cw), slice(a, a + cd))
            img = np.flip(image[crop].transpose(2, 0, 1), axes)
            lab = np.flip(label[crop].transpose(2, 0, 1), axes)
            check(torch.equal(got["image"][j, ..., 0].cpu(), bf(img)),
                  f"pipeline image of case {cid} at {(a, b, c)} differs from the host crop")
            check(torch.equal(got["label"][j].cpu(), torch.from_numpy(lab.astype(np.uint8))),
                  f"pipeline label of case {cid} differs from the host crop")
            if j == 0:
                cat = np.flip(catlas[(slice(None),) + crop].transpose(0, 3, 1, 2),
                              [ax + 1 for ax in axes])
                check(torch.equal(got["catlas"].cpu(), bf(cat)), "pipeline catlas differs")
                check(np.array_equal(got["sup_mask"].cpu().numpy(), ds._sup_mask(cid))
                      and np.array_equal(got["label_t"].cpu().numpy(), label_t_of(cid)),
                      "pipeline sup_mask / label_t differ")
    # the recipe at fixed parameters, noise off: every stage on some sample
    fixed = {k: np.zeros(PROD_B, np.float32) for k in _AUG_KEYS}
    fixed.update(blur_on=np.float32([1, 0, 1]), blur_sig=np.float32([1.0, 0.75, 0.875]),
                 bm_on=np.float32([1, 0, 1]), bm_f=np.float32([1.1, 1.0, 0.9]),
                 ba_on=np.float32([0, 1, 1]), ba_sh=np.float32([0.0, 0.05, -0.03]),
                 ct_on=np.float32([0, 1, 1]), ct_f=np.float32([1.0, 1.2, 0.85]))
    idxs, starts, flips, _, n = draws[0]
    plain_in = pipe.assemble(idxs, starts, flips, fixed, n)["image"][..., 0].float().cpu()
    pipe.augment = True
    aug = pipe.assemble(idxs, starts, flips, fixed, n)["image"][..., 0].float().cpu()
    worst = 0.0
    for j in range(PROD_B):
        x = plain_in[j].numpy().copy()
        q = {k: v[j] for k, v in fixed.items()}
        if q["blur_on"]:
            x = gaussian_filter(x, float(q["blur_sig"]))
        if q["bm_on"]:
            x = x * q["bm_f"]
        if q["ba_on"]:
            x = x + q["ba_sh"]
        if q["ct_on"]:
            mn, mx, mean = x.min(), x.max(), x.mean()
            x = np.clip((x - mean) * q["ct_f"] + mean, mn, mx)
        want = torch.from_numpy(x.astype(np.float32))
        excess = (aug[j] - want).abs() - _ulp_bf16(want) - 1e-6 * want.abs().max()
        worst = max(worst, excess.max().item())
    check(worst <= 0, f"device augmentation exceeds 1 bf16 ulp of the f32 recipe by {worst}")
    results["pipeline"] = {"cases": pipe.n, "resident_gib": resident, "load_s": load_s,
                           "batches_checked": len(draws), "recipe_excess_over_ulp": worst}
    print(f"[10] DeviceDataPipeline on {dev}: {pipe.n} cases of {pipe.vol_shape} resident "
          f"({resident:.2f} GiB, loaded in {load_s:.1f} s); {len(draws)} batches of {PROD_B} equal "
          f"the host crops; the recipe within 1 bf16 ulp of numpy/scipy f32", flush=True)
    del pipe, got, aug
    torch.cuda.empty_cache()


def phase_feam2(dev, results, weights):
    """Phase 3, second part: feam2, UNet3DFEAM(token_update='pre',
    deep_up=True), with the phase-3 model's ``weights``, on one bf16 tile
    with a seeded label mask and seeded tokens, kernels vs plain: logits rel
    L2 <= 3e-2 (phase 3's limit); the token updates (new - old: alpha times
    the masked class means of bf16 features) rel L2 <= 3e-2, the same limit
    for the same features; the 4 decoder upsamples and the 3 attention-map
    resizes through resize3d."""
    from multimodal_pl_tpu_torch.models import UNet3DFEAM, init_class_tokens
    from multimodal_pl_tpu_torch.ops import resize

    nets = {}
    for impl in ("kernel", "plain"):
        nets[impl] = UNet3DFEAM(deep_up=True, token_update="pre", conv_impl=impl,
                                gn_impl=impl).to(dev).eval()
        nets[impl].load_state_dict(weights)
    g = torch.Generator().manual_seed(12)
    tokens = {k: v.to(dev) for k, v in init_class_tokens(g, NC).items()}
    x = torch.randn((1, *TILE, 1), generator=g).to(dev, torch.bfloat16)
    mask = torch.randint(0, NC, (1, *TILE), generator=g).to(dev)
    with torch.inference_mode():
        resize.reset_launches()
        lk, ak, _, _, tk = nets["kernel"](x, tokens, mask)
        torch.cuda.synchronize()
        calls = sum(resize.launches.values())
        lp, ap, _, _, tp = nets["plain"](x, tokens, mask)

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    out = {"logits_rel_l2": rel(lk, lp), "attn_rel_l2": [rel(a, b) for a, b in zip(ak, ap)],
           "token_update_rel": {k: rel(tk[k] - tokens[k], tp[k] - tokens[k]) for k in tokens},
           "tokens_moved": {k: bool((tk[k] != tokens[k]).any()) for k in tokens},
           "resize_calls": calls}
    results["feam2"] = out
    print(f"[3] feam2 (token_update='pre', deep_up) on one {TILE} bf16 tile, kernels vs plain: "
          f"logits rel L2 {out['logits_rel_l2']:.3e}, attention maps "
          f"{[round(v, 5) for v in out['attn_rel_l2']]}, token updates rel "
          f"{ {k: round(v, 5) for k, v in out['token_update_rel'].items()} }, resize3d calls "
          f"{calls}", flush=True)
    check(lk.shape == (1, *TILE, NC) and bool(torch.isfinite(lk).all()), "feam2 logits")
    check(all(a.shape == (1, *TILE, NC - 1) for a in ak), "feam2 attention maps")
    check(out["logits_rel_l2"] <= 3e-2, f"feam2 logits kernel vs plain: {out}")
    check(all(out["tokens_moved"].values()) and max(out["token_update_rel"].values()) <= 3e-2,
          f"feam2 token updates kernel vs plain: {out}")
    check(calls == 7, f"feam2 resize3d calls {calls} != 7")
    del nets, lk, lp, ak, ap
    torch.cuda.empty_cache()


def phase_production_cli(tmp, data, step_calls):
    """Phase 10, second part: mpl-train-torch with the production flags
    (--batch_size 3 --device_data true --remat true) on the synthetic AMOS
    cases: epochs 5 and 6 of 7 with validation after each, a checkpoint,
    epoch 7 resumed; every step launched exactly phase 9's calls of the
    remat step (conv3x3 train and gn_relu backward). Then the same epochs on
    host batches (--device_data false, no validation). Patches/s of both
    from the epoch records. Then the first run again through torchrun with
    --mesh data:1 (``phase_mesh_train``)."""
    from collections import Counter

    from multimodal_pl_tpu_torch.cli import train
    from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu

    img_dir, atlas_path, csv_path = data
    base = ["--data_dir", img_dir, "--atlas_path", atlas_path, "--supervision_csv", csv_path,
            "--input_size", ",".join(map(str, PATCH)), "--batch_size", str(PROD_B),
            "--remat", "true", "--log_every", "1"]
    out = {}
    for path in ("true", "false"):
        snap = os.path.join(tmp, f"snap_{path}")
        args = base + ["--device_data", path, "--snapshot_dir", snap,
                       "--val_pred_every", "1" if path == "true" else "1000"]
        t0 = time.perf_counter()
        conv3x3.reset_launches()
        gn_relu.reset_launches()
        state = train.main(args + ["--start_epoch", "5", "--num_epochs", "7"])
        steps = int(state.step)
        check(steps > 0, f"--device_data {path}: no step")
        train_specs = (conv3x3.TRAIN_FWD, conv3x3.TRAIN_DX)
        per_step = Counter({k: n // 3 for k, n in step_calls["conv3x3"].items()
                            if k[0] in train_specs})
        got = Counter({k: n for k, n in conv3x3.launches.items() if k[0] in train_specs})
        check(got == Counter({k: n * steps for k, n in per_step.items()}),
              f"--device_data {path}: conv3x3 train calls {dict(got)} != {steps} x the remat step's")
        bwd = Counter({k: n // 3 * steps for k, n in step_calls["gn_relu_backward"].items()})
        check(Counter(gn_relu.bwd_launches) == bwd,
              f"--device_data {path}: gn_relu backward calls {dict(gn_relu.bwd_launches)}")
        rec = {"steps": steps}
        if path == "true":
            resumed = train.main(args + ["--num_epochs", "8", "--start_epoch", "7",
                                         "--reload_from_checkpoint", "true"])
            check(int(resumed.step) == steps * 3 // 2,
                  f"resume from step {steps} ended at {int(resumed.step)}")
            rec["steps"] = int(resumed.step)
        with open(os.path.join(snap, "train.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss"] for r in recs if "loss" in r]
        check(len(losses) == rec["steps"] and all(np.isfinite(losses)), f"losses {losses}")
        rec["patches_per_sec"] = [r["epoch/patches_per_sec"] for r in recs
                                  if "epoch/patches_per_sec" in r]
        vals = [r for r in recs if "val/val_dice_ct_mean" in r]
        if path == "true":
            check([r["step"] for r in vals] == [5, 6, 7]
                  and all(np.isfinite(v) for r in vals for v in r.values()
                          if isinstance(v, float)), f"validation records {vals}")
        rec.update(losses=losses, validation=vals, s=time.perf_counter() - t0,
                   first_run_steps=steps)
        out[f"device_data_{path}"] = rec
        print(f"[10] mpl-train-torch --batch_size {PROD_B} --remat true --device_data {path}: "
              f"{rec['steps']} steps, patches/s per epoch {[round(v, 3) for v in rec['patches_per_sec']]}"
              f"{', validation after epochs 5-7, checkpoint, resumed' if path == 'true' else ''} "
              f"({rec['s']:.1f} s)", flush=True)
    out["mesh_data_1"] = phase_mesh_train(tmp, base, out["device_data_true"])
    return out


def phase_mesh_train(tmp, base, plain):
    """Phase 10, last part: the --device_data true run's first part (epochs 5
    and 6 of 7, validation after each) through torchrun with --mesh data:1
    (one NCCL rank: the data-parallel step, its gradient averages an
    all_reduce over one rank): its final checkpoint holds the bits of the
    run without --mesh. Patches/s of both."""
    from multimodal_pl_tpu_torch.tools.spawn import states_unequal
    from multimodal_pl_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint

    snap = os.path.join(tmp, "snap_mesh")
    t0 = time.perf_counter()
    torchrun("multimodal_pl_tpu_torch.cli.train",
             base + ["--device_data", "true", "--snapshot_dir", snap, "--val_pred_every", "1",
                     "--start_epoch", "5", "--num_epochs", "7", "--mesh", "data:1"], tmp)
    secs = time.perf_counter() - t0
    got = restore_checkpoint(latest_checkpoint(snap))
    steps = plain["first_run_steps"]
    want = restore_checkpoint(os.path.join(tmp, "snap_true", f"ckpt_{steps}.pt"))
    bad = states_unequal(got, want)
    with open(os.path.join(snap, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    pps = [r["epoch/patches_per_sec"] for r in recs if "epoch/patches_per_sec" in r]
    print(f"[10] torchrun mpl-train-torch --mesh data:1 (NCCL) --batch_size {PROD_B} --remat true "
          f"--device_data true, epochs 5-6: step {int(got.step)}, final state bit-equal to the "
          f"run without --mesh: {not bad}; patches/s per epoch {[round(v, 3) for v in pps]} "
          f"(without --mesh {[round(v, 3) for v in plain['patches_per_sec'][:2]]}) ({secs:.1f} s)",
          flush=True)
    check(int(got.step) == steps and not bad,
          f"--mesh data:1 ended at step {int(got.step)} (want {steps}); leaves that differ "
          f"from the run without --mesh: {bad[:10]}")
    return {"steps": int(got.step), "bit_equal": not bad, "patches_per_sec": pps, "s": secs}


def dp_shard(cfg, seed: int, organ: int, batch: int = PROD_B) -> dict:
    """A seeded batch at the training patch in the loop's layout and dtypes,
    on the CPU; ``organ`` supervised."""
    from multimodal_pl_tpu_torch.train.loop import to_device

    rng = np.random.default_rng(seed)
    nc = cfg.num_classes
    sup = np.zeros(nc, np.float32)
    sup[organ] = 1
    host = {"image": rng.standard_normal((batch, *PATCH, 1)).astype(np.float32),
            "label": rng.integers(0, nc, (batch, *PATCH)).astype(np.uint8),
            "catlas": rng.random((nc - 1, *PATCH)).astype(np.float32), "sup_mask": sup,
            "label_t": np.array([0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1], np.float32)}
    return to_device(host, cfg, "cpu")


def phase_data_parallel(dev, results, weights, vol, serving_calls):
    """Phase 12: data parallelism on the one card.

    NCCL over one rank: the device ms of one step's two gradient averages
    (flatten, all_reduce, unflatten) at the flagship's widths, and the B = 3
    step with and without the group in turns (5 timed steps each of P C C
    P). Two spawned
    ranks on the card over gloo (NCCL takes one rank per card): one step
    each at the production B = 3 per rank and the flagship defaults
    (64 x 192 x 192, bf16, kernels, no remat) from
    one seeded state on shards with different data and supervised organs,
    both bit-equal to the reference built here before the spawn (per-shard
    gradients (g0 + g1) / 2, the step's updates, tokens from the summed
    class statistics), the loss the mean of the two shards', each rank's
    kernel calls those of one step; then the sharded predictor over phase 4's
    volume (12 windows in 3 batches of 4: rank 0 runs batches 0 and 2, rank
    1 batch 1) against the one-rank predictor: blended
    logits within DP_PRED_ABS, argmax agreement >= DP_PRED_AGREE, rank 0's
    kernel calls those of 2 tile batches, rank 1's of one. gloo stages CUDA
    tensors through the host: its times are not a measure of NCCL."""
    from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
    from multimodal_pl_tpu_torch.models import UNet3DFEAM
    from multimodal_pl_tpu_torch.parallel import init_data_parallel, make_sharded_train_step
    from multimodal_pl_tpu_torch.tools import spawn
    from multimodal_pl_tpu_torch.train.state import StepConfig, create_train_state

    out = {}
    cfg = StepConfig(compute_dtype=torch.bfloat16)
    state = create_train_state(torch.Generator().manual_seed(0), cfg)
    with init_data_parallel("data:1", dev) as dp:
        check(torch.distributed.get_backend(dp.group) == "nccl", "one-rank group is not NCCL")
        out["nccl_one_rank"] = spawn.collective_times(spawn.grad_trees(state.to(dev)), 20)
        # the B = 3 step with and without the one-rank group, in turns
        single = make_step(dev, cfg)
        sharded = make_sharded_train_step(single.model, single.refiner, single.disc, cfg,
                                          dp.group)
        args = (state.to(dev), {k: v.to(dev) for k, v in dp_shard(cfg, 23, 5).items()},
                torch.tensor(5e-4, device=dev), torch.tensor(0.05, device=dev))
        step_ms = {"without": [], "one_rank": []}
        for name in ("without", "one_rank", "one_rank", "without"):
            fn = single if name == "without" else sharded
            for i in range(6):
                t0 = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                if i:
                    step_ms[name].append((time.perf_counter() - t0) * 1e3)
        out["nccl_one_rank_step_ms"] = step_ms
        del single, sharded, args
        torch.cuda.empty_cache()
    for name, t in zip(("(params, rparams) gradients", "discriminator gradients + 2 losses"),
                       out["nccl_one_rank"]):
        print(f"[12] NCCL, one rank, per step: {name}: {t['mb']:.2f} MB in {t['leaves']} leaves; "
              f"all_reduce and divide {t['all_reduce_ms']:.4f} ms, flatten and unflatten "
              f"{t['flatten_unflatten_ms']:.4f} ms (the step's tree_mean; stream time, host "
              f"gaps included)", flush=True)
    print(f"[12] B={PROD_B} step, P C C P x 5: median {np.median(step_ms['without']):.1f} ms "
          f"without a group, {np.median(step_ms['one_rank']):.1f} ms over a one-rank NCCL "
          f"group", flush=True)

    lr, wf = 5e-4, 0.05
    shards = [dp_shard(cfg, 21, 5), dp_shard(cfg, 22, 3)]
    t0 = time.perf_counter()
    step = make_step(dev, cfg)
    on_dev = [{k: v.to(dev) for k, v in b.items()} for b in shards]
    ref, rm = spawn.reference_step(step, state.to(dev), on_dev,
                                   torch.tensor(lr, device=dev), torch.tensor(wf, device=dev))
    ref = spawn._cpu(ref)
    shard_losses = [float(step.grads(state.to(dev), b, torch.tensor(wf, device=dev))[0])
                    for b in on_dev]
    del step, on_dev
    torch.cuda.empty_cache()
    ranks = spawn.run(spawn.dp_step, 2, cfg, state, shards, lr, wf, "cuda:0", 10,
                      backend="gloo", timeout=600)
    secs = time.perf_counter() - t0
    expected = step_expected(cfg, PROD_B)
    for r, (got, m, launches, _) in enumerate(ranks):
        bad = spawn.states_unequal(got, ref)
        check(not bad, f"rank {r}: leaves that differ from the averaged reference: {bad[:10]}")
        check(m["loss"] == float(rm["loss"]), f"rank {r} loss {m['loss']} != {float(rm['loss'])}")
        check(abs(m["loss"] - float(np.mean(shard_losses))) <= 1e-6 * abs(m["loss"]),
              f"rank {r} loss {m['loss']} is not the shards' mean {shard_losses}")
        for k, want in expected.items():
            check(launches[k] == want, f"rank {r} {k} calls {dict(launches[k])} != one step's")
    gloo = ranks[0][3]
    print(f"[12] 2 gloo ranks on one card, one B={PROD_B} step each at {PATCH}, bf16, kernels: "
          f"both ranks bit-equal to the (g0 + g1) / 2 reference; loss {ranks[0][1]['loss']:.6f} = "
          f"mean of the shards' {[round(v, 6) for v in shard_losses]}; kernel calls per rank = "
          f"one step's ({sum(sum(c.values()) for c in expected.values())}); gloo all_reduce of "
          f"{gloo[0]['mb']:.2f} MB {gloo[0]['all_reduce_ms']:.2f} ms (host-staged, not NCCL) "
          f"({secs:.1f} s)", flush=True)
    out["two_rank_step"] = {"bit_equal": True, "loss": ranks[0][1]["loss"],
                            "shard_losses": shard_losses, "gloo_times": gloo, "s": secs,
                            "launches": {k: sum(v.values()) for k, v in ranks[0][2].items()}}
    rank0_step_calls = ranks[0][2]
    del ranks, ref
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = UNet3DFEAM(deep_up=True).to(dev).eval()
    model.load_state_dict(weights)
    single = SlidingWindowPredictor(lambda t: model(t, aux=False), TILE, NC,
                                    window_batch=WINDOW_BATCH, compute_dtype=torch.bfloat16,
                                    device=dev, output="logits")(vol).cpu()
    del model
    torch.cuda.empty_cache()
    run_key = ("logits", WINDOW_BATCH)
    (outs, same0, l0), (_, same1, l1) = spawn.run(
        spawn.dp_predict, 2, {"deep_up": True}, {k: v.cpu() for k, v in weights.items()},
        [vol], TILE, (run_key,), "cuda:0", torch.bfloat16, backend="gloo", timeout=600)
    secs = time.perf_counter() - t0
    got = outs[run_key][0]
    err = (got - single).abs().max().item()
    agree = (got.argmax(-1) == single.argmax(-1)).float().mean().item()
    print(f"[12] 2 gloo ranks on one card, sharded predictor over {VOL} (12 windows, batches of "
          f"{WINDOW_BATCH}, bf16 tiles): blended logits max |2 ranks - 1| {err:.3e}, argmax "
          f"agreement {agree:.6f}, ranks bit-equal {same0 and same1} ({secs:.1f} s)", flush=True)
    check(same0 and same1, "the sharded predictor's ranks returned different bits")
    check(tuple(got.shape) == (*VOL, NC) and err <= DP_PRED_ABS,
          f"sharded vs single blended logits: max abs {err} > {DP_PRED_ABS}")
    check(agree >= DP_PRED_AGREE, f"sharded vs single argmax agreement {agree} < {DP_PRED_AGREE}")
    for r, (launches, batches) in enumerate(((l0[run_key], 2), (l1[run_key], 1))):
        for k, per_batch in serving_calls.items():
            want = {key: n * batches for key, n in per_batch.items()}
            check(dict(launches[k]) == want, f"sharded serving rank {r} {k} calls "
                  f"{dict(launches[k])} != {batches} tile batches' {want}")
    out["two_rank_serving"] = {"max_abs_err": err, "argmax_agreement": agree, "s": secs,
                               "launches": {k: sum(v.values()) for k, v in l0[run_key].items()}}
    results["data_parallel"] = out
    return rank0_step_calls, l0[run_key]


def phase_profile():
    """Phase 11: tools/profile_chip.py (a serving tile batch; the B = 1, B = 3
    and B = 3 remat steps), and the resize categories of each: resize3d's
    device ms and launches, and no kernel of the library's trilinear resize."""
    from multimodal_pl_tpu_torch.tools import profile_chip

    prof = profile_chip.main()
    out = {}
    for name, r in prof.items():
        if not isinstance(r, dict):
            continue
        cats = r["categories"]
        out[name] = {"resize3d": cats.get(profile_chip.RESIZE_KERNEL, {"ms": 0.0, "launches": 0}),
                     "library_resize": cats.get(profile_chip.LIBRARY_RESIZE),
                     "device_busy_ms": r["device_busy_ms"], "launches": r["launches"],
                     "wall_ms": r["wall_ms"]}
        rz = out[name]["resize3d"]
        print(f"[11] {name}: resize3d {rz['ms']:.3f} ms in {rz['launches']:.0f} launches of "
              f"{r['device_busy_ms']:.2f} ms device busy ({r['launches']:.0f} launches)",
              flush=True)
        check(out[name]["library_resize"] is None,
              f"{name} ran the library's trilinear resize: {out[name]['library_resize']}")
        want = PROFILE_RESIZE_LAUNCHES[name]
        check(round(rz["launches"]) == want,
              f"{name} launched {rz['launches']} resize3d kernels per call, not {want}")
    return out


# phase 13: the ablation U-Nets at full width
ABLATION_TASKS = (0, 3, 5, 6)   # DynHead task ids of the tile batch's four tiles
ABLATION_VOL_TASK = 3           # DynHead task id over the volume
LOSS_CROP = (32, 96, 96)        # the loss zoo's card-vs-CPU comparison crop of the tile
MOTS_SHAPE = (16, 48, 48)       # the legacy losses' 12-class MOTS volumes (7 tasks)
LOSS_REL = 1e-4                 # loss zoo, card vs CPU in f32: value and gradient
# Ablation outputs against an f32 forward (the plain route on f32 input):
# both bf16 routes sit 0.070-0.073 (rel L2) from it at the 1/8-scale deep map
# and attention maps, so the two differ there by 0.030-0.031 (H100 runs) and
# phase 3's 3e-2 holds only the logits; every output of the kernel route may
# be at most F32_RATIO times as far from the f32 forward as the plain bf16
# route's (measured 0.83-1.011). A planted fault, the GroupNorm -> ReLU
# before DeepSup's 1/8-scale head scaled by 1.03 on the kernel route, reads
# 1.095 there (scaled by 1.01: 1.014, passes).
F32_RATIO = 1.05
TIMED_VOLS = 3                  # one-shot predictor runs timed per model (median)


def ablation_models():
    """name -> (class, constructor keywords, number of classes of the
    logits) of each ablation phase 13 runs."""
    from multimodal_pl_tpu_torch import models

    return {"baseline": (models.UNet3DBaseline, {}, NC), "deepsup": (models.UNet3DDeepSup, {}, NC),
            "eam3": (models.UNet3DEAM, {"num_eams": 3}, NC),
            "eam2": (models.UNet3DEAM, {"num_eams": 2}, NC),
            "dynhead": (models.UNet3DDynHead, {}, 2)}


def ablation_gn_keys(name: str, aux: bool = True):
    """gn_relu calls of one forward of a 4-tile batch of ablation ``name``,
    from the architecture: the trunk's 17 (``serving_gn_keys``); with aux,
    UNet3DDeepSup's three deep heads (at the x8, x4, x2 decoder outputs, of
    4, 2, 1 x base channels); UNet3DDynHead's gap_gn on the fusion output
    (8 x base channels at 1/16 scale)."""
    keys = serving_gn_keys()
    b = 32
    if name == "deepsup" and aux:
        keys.update((c, 16, WINDOW_BATCH, *_scale(TILE, k)) for c, k in ((4 * b, 8), (2 * b, 4),
                                                                          (b, 2)))
    if name == "dynhead":
        keys[(8 * b, 16, WINDOW_BATCH, *_scale(TILE, 16))] += 1
    return keys


def _flat(out):
    """Every tensor of a model's output, the logits first."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _value_grad(fn, logits, rest):
    """fn(logits, *rest) and its gradient with respect to the logits; a
    tuple of values is differentiated through its sum weighted 1, 2, ..."""
    x = logits.detach().clone().requires_grad_(True)
    out = fn(x, *rest)
    vals = list(out) if isinstance(out, tuple) else [out]
    (grad,) = torch.autograd.grad(sum((k + 1) * v for k, v in enumerate(vals)), x)
    return torch.stack([torch.as_tensor(v).detach().float() for v in vals]), grad


def loss_zoo_cases(dyn_logits):
    """(name, fn, logits, rest) of every aux_variants function on FEAM-shaped
    f32 outputs (14 classes; deep maps at 1/8, 1/4, 1/2; attention maps at
    those scales, or full size for segmentation_loss2, which needs the
    refiner's resolution; refiner or teacher logits (13, ..., 2) given and
    None), ``at`` the tile or its crop, and of every legacy function on
    12-, 6- and 5-class MOTS logits (a sample for every task of each table)
    and on UNet3DDynHead's 2-channel logits ``dyn_logits`` (f32, CPU) with a
    2-channel target whose sample 1 is -1 (ignored). All CPU tensors from a
    seeded generator. Returns (cases at the tile, cases at the crop)."""
    from multimodal_pl_tpu_torch.losses import aux_variants, legacy

    g = torch.Generator().manual_seed(14)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=g)

    def aux_cases(sp):
        logits, labels = randn(1, *sp, NC, scale=2.0), randint(NC, (1, *sp))
        sup = torch.tensor([0, 1, 0, 1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1], dtype=torch.float32)
        deep = [randn(1, *_scale(sp, k), NC) for k in (8, 4, 2)]
        small = [randn(1, *_scale(sp, k), NC - 1) for k in (8, 4, 2)]
        full = [randn(1, *sp, NC - 1) for _ in range(3)]
        ref, label_t = randn(NC - 1, *sp, 2, scale=3.0), (randint(2, (NC - 1,))).float()
        out = []
        for name in ("segmentation_loss_mse", "segmentation_loss2", "segmentation_loss_multiref",
                     "segmentation_loss_semi"):
            kw = "teacher_logits" if name.endswith("semi") else "refiner_logits"
            attns = full if name == "segmentation_loss2" else small
            for given in (True, False):
                extra = {kw: ref, "label_t": label_t} if given else {}

                def fn(x, labels, sup, deep, attns, extra, name=name):
                    return getattr(aux_variants, name)(x, labels, sup, deep, attns, **extra)

                out.append((f"{name}({kw if given else 'None'})", fn, logits,
                            (labels, sup, deep, attns, extra)))
        return out

    def mots_labels(tasks):
        rows = []
        for tid in tasks:
            classes = torch.tensor((0,) + tuple(legacy.MOTS_TASK_FG[tid]))
            rows.append(classes[randint(len(classes), MOTS_SHAPE)])
        return torch.stack(rows)

    tasks = tuple(legacy.MOTS_TASK_FG)
    mots, mlab = randn(len(tasks), *MOTS_SHAPE, 12, scale=2.0), mots_labels(tasks)
    weights = legacy.tal_update_weights(torch.zeros(12), torch.zeros(12), 1200.0, 3)[2]
    legacy_cases = [
        ("tal_loss", legacy.tal_loss, mots, (mlab, tasks)),
        ("marg_exc_loss", legacy.marg_exc_loss, mots, (mlab, tasks)),
        ("tal_loss_weighted", legacy.tal_loss_weighted, mots, (mlab, tasks, weights)),
        ("bce_onehot(11)", lambda x, y: legacy.bce_onehot(x[..., :11], y, 11), mots,
         (randint(12, mlab.shape),)),
        ("dice_softmax_fg(12)", lambda x, y: legacy.dice_softmax_fg(x, y, 12), mots,
         (randint(12, mlab.shape),)),
        ("dice_sigmoid_shifted(11)", lambda x, y: legacy.dice_sigmoid_shifted(x[..., :11], y, 11),
         mots, (randint(12, mlab.shape),))]
    for name, nc, table in (("tal6_loss", 6, legacy.MOTS_TASK_FG6),
                            ("tal5_loss", 5, legacy.MOTS_TASK_FG5),
                            ("bce_no_bg5", 5, legacy.MOTS_TASK_FG5)):
        t = tuple(table)
        legacy_cases.append((name, getattr(legacy, name), randn(len(t), *MOTS_SHAPE, nc),
                             (randint(nc, (len(t), *MOTS_SHAPE)), t)))
    dyn_lab = randint(2, dyn_logits.shape[:-1])
    target = torch.stack([1 - dyn_lab, dyn_lab], -1).float()
    target[1] = -1
    legacy_cases += [
        ("binary_dice(DynHead)", lambda x, t: legacy.binary_dice(torch.sigmoid(x[..., 1]),
                                                                 t[..., 1]),
         dyn_logits, (target,)),
        ("dice_loss_4mots(DynHead)", legacy.dice_loss_4mots, dyn_logits, (target,)),
        ("ce_loss_4mots(DynHead)", legacy.ce_loss_4mots, dyn_logits, (target,)),
        ("bce_onehot(DynHead)", lambda x, y: legacy.bce_onehot(x, y, 2, offset=0), dyn_logits,
         (dyn_lab,)),
        ("dice_softmax_fg(DynHead)", lambda x, y: legacy.dice_softmax_fg(x, y, 2), dyn_logits,
         (dyn_lab,)),
        ("dice_sigmoid_shifted(DynHead)", lambda x, y: legacy.dice_sigmoid_shifted(x, y, 2),
         dyn_logits, (dyn_lab,))]
    return aux_cases(TILE), aux_cases(LOSS_CROP) + legacy_cases


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and any(isinstance(t, (torch.Tensor, list, dict))
                                               for t in tree):
        return type(tree)(_to(t, dev) for t in tree)
    return tree


def phase_loss_zoo(dev, dyn_logits):
    """Phase 13, the loss zoo on the card: every aux_variants function at
    the full tile in f32 (finite value and gradient), then every case of
    ``loss_zoo_cases`` on the card and on the CPU (aux_variants on the
    LOSS_CROP crop of the tile, to keep the CPU side short): value and
    gradient with respect to the logits within LOSS_REL relative."""
    full, crop = loss_zoo_cases(dyn_logits)
    out = {}
    for name, fn, logits, rest in full:
        val, grad = _value_grad(fn, logits.to(dev), _to(rest, dev))
        check(bool(torch.isfinite(val).all()) and bool(torch.isfinite(grad).all()),
              f"loss zoo {name} at the full tile: not finite")
        out[f"{name} @ tile"] = {"value": val.tolist()}
    for name, fn, logits, rest in crop:
        val, grad = _value_grad(fn, logits.to(dev), _to(rest, dev))
        cval, cgrad = _value_grad(fn, logits, rest)
        rel_v = ((val.cpu() - cval).abs() / cval.abs().clamp(min=1e-30)).max().item()
        rel_g = _rel(grad.cpu(), cgrad)
        out[name] = {"value": cval.tolist(), "value_rel": rel_v, "grad_rel": rel_g}
        check(rel_v <= LOSS_REL and rel_g <= LOSS_REL and float(cgrad.abs().max()) > 0,
              f"loss zoo {name}: card vs CPU value rel {rel_v}, gradient rel {rel_g}")
    print(f"[13] loss zoo: {len(full)} aux_variants cases at the {TILE} tile on the card; "
          f"{len(crop)} cases card vs CPU (aux_variants at {LOSS_CROP}): worst value rel "
          f"{max(v['value_rel'] for k, v in out.items() if 'value_rel' in v):.3g}, gradient "
          f"rel {max(v['grad_rel'] for k, v in out.items() if 'grad_rel' in v):.3g}", flush=True)
    return out


def phase_ablations(dev, results, feam, vol, tables):
    """Phase 13: the ablation U-Nets at full width (base 32, 14 classes) on
    the card, each with seeded weights and the phase-3 FEAM's weights on
    every parameter it shares with it by name and shape (the trunk, precls,
    deep heads, EAMs).

    New gn_relu shapes (UNet3DDeepSup's deep heads) are first held against
    the plain version (phase 2's check); then per model, on phase 3's bf16
    tile batch: the logits kernel vs plain (conv_impl, gn_impl 'plain')
    within rel L2 3e-2 (phase 3's limit), every output (logits, deep maps,
    the EAM cascade's tokens and attention maps) of the kernel route at most
    F32_RATIO times as far from an f32 forward (the plain route on the f32
    input) as the plain bf16 route's, the kernel calls of the forward exactly (18 fused and
    4 prologue-off conv3x3_gn, 18 folds, 4 resize3d and ablation_gn_keys'
    gn_relu calls, each shape one that phase 2 or this phase checked), and
    for UNet3DBaseline, UNet3DDeepSup(aux=False) and UNet3DEAM(aux=False) the
    bits of the FEAM's aux=False logits; UNet3DBaseline and UNet3DDynHead
    (task ABLATION_VOL_TASK) then serve phase 4's volume through
    SlidingWindowPredictor(output='argmax'): label maps of the kernel and
    the plain model agree on >= 0.95 of the voxels, the calls per volume (3
    tile batches), s/vol (median of TIMED_VOLS one-shot runs, the FEAM's
    aux=False predictor timed alike). utils/profiling.trace around one UNet3DBaseline
    forward writes a Chrome trace with device kernel events, at least one
    per wrapper call of each of the port's kernels (into a temporary
    directory). Last, the loss zoo (``phase_loss_zoo``). Returns
    {model: {kernel: Counter of calls per volume}} for the serving runs."""
    from collections import Counter

    from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
    from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu, norm, resize
    from multimodal_pl_tpu_torch.tools import profile_chip
    from multimodal_pl_tpu_torch.utils import profiling

    TRACE_KERNELS = {"conv3x3_gn kernel": 22, "GroupNorm fold statistics kernel": 18,
                     "gn_relu forward kernel": 17, profile_chip.RESIZE_KERNEL: 4}

    def reset():
        conv3x3.reset_launches()
        norm.fold_launches.clear()
        gn_relu.reset_launches()
        resize.reset_launches()

    def calls():
        return {"conv3x3": Counter(conv3x3.launches), "fold": Counter(norm.fold_launches),
                "gn_relu": Counter(gn_relu.launches), "resize": Counter(resize.launches)}

    zoo = ablation_models()
    expected_gn = {(name, aux): ablation_gn_keys(name, aux) for name in zoo
                   for aux in (True, False)}
    new = set().union(*expected_gn.values()) - set(tables["gn_relu"])
    print(f"[13] gn_relu forward kernel vs plain at the ablations' {len(new)} further shapes",
          flush=True)
    tables["gn_relu"].update(phase_gn(dev, results, new, "gn_relu_ablation"))
    x = torch.randn((WINDOW_BATCH, *TILE, 1), generator=torch.Generator().manual_seed(2)).to(
        dev, torch.bfloat16)
    tasks = torch.tensor(ABLATION_TASKS, device=dev)
    feam_sd = feam.state_dict()
    with torch.inference_mode():
        feam_logits = feam(x, aux=False)

    def predictor(fn, nc):
        return SlidingWindowPredictor(fn, TILE, nc, window_batch=WINDOW_BATCH,
                                      compute_dtype=torch.bfloat16, device=dev, output="argmax")

    def s_per_vol(pred):
        """Median seconds of TIMED_VOLS one-shot runs after a warm-up."""
        pred(vol)
        times = []
        for _ in range(TIMED_VOLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred(vol)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)), times

    feam_s, feam_times = s_per_vol(predictor(lambda t: feam(t, aux=False), NC))
    out = {"feam_s_per_vol": feam_s, "feam_times": feam_times}
    serving, dyn_logits = {}, None
    for name, (cls, kw, nc) in zoo.items():
        nets = {impl: cls(**kw, conv_impl=impl, gn_impl=impl,
                          generator=torch.Generator().manual_seed(13)) for impl in ("kernel",
                                                                                    "plain")}
        sd = nets["kernel"].state_dict()
        shared = sorted(k for k in sd if k in feam_sd and feam_sd[k].shape == sd[k].shape)
        sd.update({k: feam_sd[k] for k in shared})
        for net in nets.values():
            net.load_state_dict(sd)
            net.to(dev).eval()

        def run(net, aux=True, x32=False, name=name):
            xin = x.float() if x32 else x
            if name == "dynhead":
                return net(xin, tasks)
            return net(xin) if name == "baseline" else net(xin, aux=aux)

        row = {"shared_params": len(shared), "params": len(sd)}
        with torch.inference_mode():
            reset()
            got = _flat(run(nets["kernel"]))
            torch.cuda.synchronize()
            launched = calls()
            want = _flat(run(nets["plain"]))
            row["rel_l2"] = [_rel(a, b) for a, b in zip(got, want, strict=True)]
            row["shapes"] = [list(t.shape) for t in got]
            check(all(bool(torch.isfinite(t).all()) for t in got), f"{name}: outputs not finite")
            check(tuple(got[0].shape) == (WINDOW_BATCH, *TILE, nc), f"{name} logits {got[0].shape}")
            check(row["rel_l2"][0] <= 3e-2, f"{name} logits kernel vs plain rel L2 "
                  f"{row['rel_l2'][0]} > 3e-2")
            f32 = _flat(run(nets["plain"], x32=True))
            row["kernel_vs_f32"] = [_rel(a, b) for a, b in zip(got, f32, strict=True)]
            row["plain_vs_f32"] = [_rel(a, b) for a, b in zip(want, f32, strict=True)]
            check(all(k <= F32_RATIO * p for k, p in zip(row["kernel_vs_f32"], row["plain_vs_f32"])),
                  f"{name} kernel route further from the f32 forward than {F32_RATIO} x the plain "
                  f"route's: {row['kernel_vs_f32']} vs {row['plain_vs_f32']}")
            del f32
            totals = {spec: sum(n for k, n in launched["conv3x3"].items() if k[0] == spec)
                      for spec in conv3x3.SPECS}
            row["calls"] = {"conv3x3": totals, "fold": sum(launched["fold"].values()),
                            "gn_relu": sum(launched["gn_relu"].values()),
                            "resize": sum(launched["resize"].values())}
            check(totals == {conv3x3.FUSED: 18, conv3x3.PROLOGUE_OFF: 4, conv3x3.TRAIN_FWD: 0,
                             conv3x3.TRAIN_DX: 0}, f"{name} conv3x3_gn calls {totals} != 18 + 4")
            check(sum(launched["fold"].values()) == 18, f"{name} fold calls {launched['fold']}")
            check(launched["gn_relu"] == expected_gn[(name, True)],
                  f"{name} gn_relu calls {dict(launched['gn_relu'])} != the derived "
                  f"{dict(expected_gn[(name, True)])}")
            check(launched["resize"] == serving_resize_keys(), f"{name} resize3d calls "
                  f"{dict(launched['resize'])}")
            missing = (sorted(set(launched["conv3x3"]) - set(tables["conv3x3"]))
                       + sorted(set(launched["fold"]) - set(tables["fold"]))
                       + sorted(set(launched["gn_relu"]) - set(tables["gn_relu"]))
                       + sorted(set(launched["resize"]) - set(tables["resize"])))
            check(not missing, f"{name} launched shapes no phase checked: {missing}")
            if name in ("baseline", "deepsup", "eam3", "eam2"):
                reset()
                trunk = run(nets["kernel"], aux=False)
                torch.cuda.synchronize()
                check(calls()["gn_relu"] == expected_gn[(name, False)],
                      f"{name}(aux=False) gn_relu calls {dict(calls()['gn_relu'])}")
                row["trunk_bits_equal"] = bool(torch.equal(trunk, feam_logits))
                check(row["trunk_bits_equal"], f"{name}(aux=False) logits are not the FEAM's "
                      f"aux=False logits: max diff {(trunk.float() - feam_logits.float()).abs().max()}")
            if name == "dynhead":
                dyn_logits = got[0][:, :LOSS_CROP[0], :LOSS_CROP[1], :LOSS_CROP[2]].float().cpu()
            del got, want
        if name in ("baseline", "dynhead"):
            if name == "dynhead":
                vt = ABLATION_VOL_TASK

                def fns(net):
                    return lambda t: net(t, torch.full((t.shape[0],), vt, device=t.device))
            else:
                def fns(net):
                    return net
            preds = {impl: predictor(fns(net), nc) for impl, net in nets.items()}
            secs, times = s_per_vol(preds["kernel"])
            reset()
            labels = preds["kernel"](vol)
            torch.cuda.synchronize()
            per_vol = calls()
            check(labels.dtype == torch.uint8 and tuple(labels.shape) == VOL
                  and int(labels.max()) < nc, f"{name} label map {labels.dtype} {labels.shape}")
            tile_batch = {"conv3x3": launched["conv3x3"], "fold": launched["fold"],
                          "gn_relu": expected_gn[(name, True)],
                          "resize": serving_resize_keys()}
            for k, per_batch in tile_batch.items():
                want_vol = Counter({key: 3 * n for key, n in per_batch.items()})
                check(per_vol[k] == want_vol, f"{name} {k} calls per volume {dict(per_vol[k])}"
                      f" != 3 tile batches' {dict(want_vol)}")
            agree = (preds["plain"](vol) == labels).float().mean().item()
            check(agree >= 0.95, f"{name} label agreement with the plain model {agree} < 0.95")
            row.update(s_per_vol=secs, times=times, label_agreement=agree,
                       calls_per_volume={k: sum(v.values()) for k, v in per_vol.items()})
            serving[name] = (per_vol, tile_batch)
            print(f"[13] {name} over the {VOL} volume: {secs:.4f} s/vol (FEAM {feam_s:.4f}; median "
                  f"of {TIMED_VOLS}),"
                  f" label agreement with plain {agree:.5f}, calls per volume "
                  f"{row['calls_per_volume']}", flush=True)
        if name == "baseline":
            with tempfile.TemporaryDirectory() as tdir, torch.inference_mode():
                with profiling.trace(tdir):
                    nets["kernel"](x)
                    torch.cuda.synchronize()
                (path,) = [os.path.join(tdir, f) for f in os.listdir(tdir)]
                size = os.path.getsize(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            kern = Counter(profile_chip._category(e["name"]) for e in events
                           if e.get("cat") == "kernel")
            ours = {cat: kern[cat] for cat, calls in TRACE_KERNELS.items()}
            row["trace"] = {"device_kernel_events": sum(kern.values()), "by_category": dict(kern),
                            "bytes": size}
            check(all(ours[cat] >= calls for cat, calls in TRACE_KERNELS.items()),
                  f"trace of a UNet3DBaseline forward: device kernel events {dict(kern)}, "
                  f"wanted at least {TRACE_KERNELS}")
            print(f"[13] trace of one UNet3DBaseline forward ({size} bytes): "
                  f"{sum(kern.values())} device kernel events, the port's {ours}", flush=True)
        print(f"[13] {name}: outputs {row['shapes']} kernel vs plain rel L2 "
              f"{[round(v, 5) for v in row['rel_l2']]}, kernel / plain vs f32 "
              f"{[round(k, 5) for k in row['kernel_vs_f32']]} / "
              f"{[round(p, 5) for p in row['plain_vs_f32']]}; calls per tile batch {row['calls']}"
              + (f"; trunk == FEAM aux=False bits: {row['trunk_bits_equal']}"
                 if "trunk_bits_equal" in row else ""), flush=True)
        out[name] = row
        del nets
        torch.cuda.empty_cache()
    out["loss_zoo"] = phase_loss_zoo(dev, dyn_logits)
    results["ablations"] = out
    return serving


SPACE_N = 2                 # phase 14: ranks that split each tile's H axis
SPACE_PLAIN_REL = 1e-5      # plain f32 route, H-split vs whole: f32 summation order only
SPACE_REPLACES = {
    "moments": "multimodal_pl_tpu/ops/pallas/fused_gn_relu.py:73 (the statistics pallas_call; "
               "and the statistics of ops/bd.py:439 bd_gn_fold), on an H slab",
    "apply": "multimodal_pl_tpu/ops/pallas/fused_gn_relu.py:96 (the normalize pallas_call; and "
             "the rows of ops/bd.py:439 bd_gn_fold), from merged slab statistics"}


def phase_gn_split(dev, results, moments_keys, apply_keys, n=SPACE_N):
    """Phase 14: the slab entry points of csrc/gn_relu.cu against their plain
    twins at every shape an H-split tile batch launches them. gn_moments_bf16:
    (mean, M2) within rel FOLD_REL of group_moments_reference. gn_apply_bf16
    from n slabs' moments (this slab's and n - 1 other slabs' of its shape),
    against merge_moments_reference and the plain normalize (y within 1e-2 *
    max|plain|) or fold (rows within rel FOLD_REL); at each normalize shape,
    given gn_relu_fwd_bf16's own statistics it returns that kernel's y bit
    for bit. Bounds: moments, one read of x; normalize, one read of x and
    one write of y; fold, the moments read and the rows written. No library
    call computes either function (library_ms null). Returns ({moments key:
    row}, {apply key: row})."""
    from multimodal_pl_tpu_torch.ops import gn_relu as G

    g = torch.Generator().manual_seed(14)

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def slab(c, b, d, h, w):
        return (torch.randn((b, d, h, w, c), generator=g) * 2 + 0.5).to(dev, torch.bfloat16)

    tables = ({}, {})
    for key in sorted(moments_keys):
        c, groups, b, d, h, w = key
        x = slab(c, b, d, h, w)
        k, p = G.gn_moments(x, groups), G.group_moments_reference(x, groups)
        err = max(rel(k[:, i], p[:, i]) for i in (0, 1))
        reps = 5 if x.numel() > 2 ** 26 else 20
        row = {"c": c, "groups": groups, "b": b, "dhw": [d, h, w], "rel": err,
               "max_abs_err": (k - p).abs().max().item(),
               "ms": time_ms(lambda: G.gn_moments(x, groups), reps),
               "plain_ms": time_ms(lambda: G.group_moments_reference(x, groups), reps),
               "library_ms": None, **bound(0.0, 2 * x.numel() + 4 * 2 * b * groups)}
        print(f"  gn_moments B={b} C={c:3d} G={groups:2d} @{d}x{h}x{w}: rel {err:.2e}  kernel "
              f"{row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms  bound {row['bound_ms']:.3f} ms",
              flush=True)
        check(err <= FOLD_REL, f"gn_moments kernel disagrees with plain at {row}")
        tables[0][key] = row
        results["gn_split"].append(row)
    for key in sorted(apply_keys):
        mode, c, groups, b, d, h, w = key
        fold = mode == "fold"
        x = slab(c, b, d, h, w)
        sc = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
        bi = (0.1 * torch.randn(c, generator=g)).to(dev)
        moments = torch.stack([G.gn_moments(x, groups)]
                              + [G.gn_moments(slab(c, b, d, h, w), groups) for _ in range(n - 1)])
        count = float(d * h * w * (c // groups))

        def plain():
            st = G.merge_moments_reference(moments, count)
            if fold:
                return G.fold_from_stats_reference(st, sc, bi)
            return G.group_norm_relu_from_stats_reference(x, st, sc, bi)

        k, p = G.gn_apply(x, moments, sc, bi, groups, fold), plain()
        if fold:
            err = max(rel(a, b_) for a, b_ in zip(k, p))
            abs_err = max((a - b_).abs().max().item() for a, b_ in zip(k, p))
            ok = err <= FOLD_REL
            nbytes = 4 * (moments.numel() + 2 * b * c + 2 * c)
            bits = None
        else:
            abs_err = (k.float() - p.float()).abs().max().item()
            err = abs_err / p.float().abs().max().item()
            y_own, own = G.gn_relu_forward(x, sc, bi, groups)
            bits = torch.equal(G.gn_apply(x, own, sc, bi, groups), y_own)
            ok = err <= 1e-2 and bits
            nbytes = 4 * x.numel() + 4 * (moments.numel() + 2 * c)
        reps = 5 if x.numel() > 2 ** 26 else 20
        row = {"mode": mode, "c": c, "groups": groups, "b": b, "dhw": [d, h, w], "slabs": n,
               "rel": err, "max_abs_err": abs_err, "own_stats_bit_equal": bits,
               "ms": time_ms(lambda: G.gn_apply(x, moments, sc, bi, groups, fold), reps),
               "plain_ms": time_ms(plain, reps), "library_ms": None, **bound(0.0, nbytes)}
        print(f"  gn_apply {mode:4s} B={b} C={c:3d} G={groups:2d} @{d}x{h}x{w} from {n} slabs: "
              f"rel {err:.2e}{'' if fold else f', given its own statistics = gn_relu_fwd: {bits}'}"
              f"  kernel {row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms  bound "
              f"{row['bound_ms']:.4f} ms", flush=True)
        check(ok, f"gn_apply kernel disagrees with plain at {row}")
        tables[1][key] = row
        results["gn_split"].append(row)
    torch.cuda.empty_cache()
    return tables


def conv_rows(specs, calls, train_table, conv_table):
    """(calls, per-shape row) of the conv3x3 ``calls`` ({key: n}) whose spec
    is in ``specs``: a train forward or dx call from ``train_table``
    (phase_train_conv's), a gradient-free call from ``conv_table``
    (phase_kernels')."""
    from multimodal_pl_tpu_torch.ops import conv3x3

    out = []
    for key, n in calls.items():
        if key[0] not in specs:
            continue
        if key[0] == conv3x3.TRAIN_FWD:
            row, pre = train_table[(key[1], key[2], *key[3:7])], "fwd_"
        elif key[0] == conv3x3.TRAIN_DX:
            row, pre = train_table[(key[2], key[1], *key[3:7])], "dx_"
        else:
            row, pre = conv_table[key], ""
        out.append((n, {f: row[pre + f] for f in ("ms", "plain_ms", "library_ms", "op_ms",
                                                   "byte_ms")}
                    | {"max_abs_err": row[pre + "err" if pre else "max_abs_err"]}))
    return out


def kernel_entry(name, source, replaces, launches, rows, own=None):
    """One kernels-line entry from (calls, per-shape row) pairs. ``own``:
    (calls, bound row) pairs of the work the path keeps where the calls run
    on halo-extended slabs; the bound is then theirs, and the bound of the
    launched shapes is ``bound_launched_ms``."""
    libs = [n * r["library_ms"] for n, r in rows if r["library_ms"] is not None]
    bounds = sum_bound(rows)
    if own is not None:
        bounds = dict(sum_bound(own), bound_launched_ms=bounds["bound_ms"])
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for _, r in rows),
            "ms": sum(n * r["ms"] for n, r in rows),
            "plain_ms": sum(n * r["plain_ms"] for n, r in rows),
            **bounds, "library_ms": sum(libs) if libs else None}


def slab_rows(d: int) -> int:
    """Phase 14: the H rows of one rank's own slab at the level of a tile
    whose D is ``d`` (D is not split: the level is TILE[0] / d)."""
    return TILE[1] // SPACE_N // (TILE[0] // d)


def spatial_entries(run, tile_calls=None, path=None) -> list:
    """The kernels-line entries of the H-split serving path (phase 14):
    rank 0's calls per volume; per-shape times at the slab shapes of one
    tile batch, summed over its calls. The conv and resize calls run on
    halo-extended slabs: their bound is that of the slab's own output rows
    (the work the path keeps), the launched shapes' is bound_launched_ms.
    With ``tile_calls`` and ``path``: the entries of that path instead (a
    split ablation's tile batch), its launches those of the tile batch."""
    from multimodal_pl_tpu_torch.ops import conv3x3

    tag = (f"{path or 'spatial serving'} --mesh space:{SPACE_N}, rank 0 of {SPACE_N} (gloo, "
           "one card)")
    vol_calls = run["volume"] if tile_calls is None else tile_calls
    tile_calls = run["tile_batch"] if tile_calls is None else tile_calls

    def conv_own(k):
        spec, cin, cout, b, d, _, w, res = k
        return conv_bound(b, d, slab_rows(d), w, cin, cout, spec == conv3x3.FUSED, res)

    def resize_own(k):
        return resize_bound((*k[:5], slab_rows(k[4]), *k[6:]))

    out = []
    for spec, label, replaces in ((conv3x3.FUSED, "conv3x3_gn fused GN-ReLU prologue", BDX),
                                  (conv3x3.PROLOGUE_OFF, "conv3x3_gn prologue off", BK3)):
        calls = [(n, k) for k, n in tile_calls["conv3x3"].items() if k[0] == spec]
        out.append(kernel_entry(
            f"{label}, halo-extended slabs, {tag}", SOURCE, replaces,
            sum(n for k, n in vol_calls["conv3x3"].items() if k[0] == spec),
            [(n, run["conv3x3"][k]) for n, k in calls], [(n, conv_own(k)) for n, k in calls]))
    out.append(kernel_entry(
        f"resize3d forward (x2 upsample; the skip added as the slab is cropped out), "
        f"halo-extended slabs, {tag}", RESIZE_SOURCE, RESIZE, sum(vol_calls["resize"].values()),
        [(n, run["resize"][k]) for k, n in tile_calls["resize"].items()],
        [(n, resize_own(k)) for k, n in tile_calls["resize"].items()]))
    for key, label in (("gn_moments", "gn_moments_bf16 (slab statistics)"),
                       ("gn_apply", "gn_apply_bf16 (normalize and fold rows from merged "
                                    "statistics)")):
        out.append(kernel_entry(f"{label}, {tag}", GN_SOURCE,
                                SPACE_REPLACES[key[3:]], sum(vol_calls[key].values()),
                                [(n, run[key][k]) for k, n in tile_calls[key].items()]))
    return out


def halo_copy_times(dev, exchanges) -> dict:
    """Phase 14: device ms (CUDA-graph replays) of the halo copies of one
    H-split tile batch as rank 0 of 2 made them (``parallel.spatial.exchanges``):
    each attach (the slab and its neighbour rows joined by ``torch.cat``) and
    each crop (the slab's rows copied out of a conv's output, or out of an
    upsample's with the skip added in the same pass), summed over their
    calls, beside their bytes bound (every element read once and written
    once; the skip read once)."""
    out = {"attach_ms": 0.0, "attach_bound_ms": 0.0, "crop_ms": 0.0, "crop_bound_ms": 0.0,
           "crops_with_skip": 0}
    for key, n in exchanges.items():
        if key[0] == "halo":
            _, edge, lo, hi, shape, dtype = key
            x = torch.randn(shape, device=dev).to(getattr(torch, dtype))
            # rank 0 sits at the low global edge: rows below only for zero or repeat edges
            parts = [x[:, :, :lo if edge else 0], x, x[:, :, :hi]]
            ms = time_ms(lambda: torch.cat(parts, 2), 10)
            rows = shape[2] + (lo if edge else 0) + hi
            tag = "attach"
        elif key[0] == "crop":
            _, shape, start, rows, dtype, with_skip = key
            x = torch.randn(shape, device=dev).to(getattr(torch, dtype))
            if with_skip:
                skip = torch.randn_like(x[:, :, :rows])
                ms = time_ms(lambda: x[:, :, start:start + rows] + skip, 10)
                out["crops_with_skip"] += n
                del skip
            else:
                ms = time_ms(lambda: x[:, :, start:start + rows].contiguous(), 10)
            tag = "crop"
        else:
            continue
        moved = (2 + (tag == "crop" and with_skip)) * x.element_size() * x.numel() \
            * rows / shape[2]
        out[tag + "_ms"] += n * ms
        out[tag + "_bound_ms"] += n * moved / PEAK_BYTES * 1e3
        del x
    torch.cuda.empty_cache()
    return out


SPACE_ABLATIONS = ("deepsup", "eam3", "dynhead")  # phase 14: the ablations split over ranks
# DynHead's logits are a function of its 4 x 256 pooled task features
# (UNet3DDynHead.task_features) and of the decoder's maps, and nearly all of
# a bf16 route's distance from f32 there comes from the pooled vector: the
# logits' distance follows the direction of that vector's rounding error, not
# only its size, so two routes whose pooled vectors sit equally far from f32
# can give logits tens of percent apart in their distance from f32 (on an
# H100, phase 14's split read 0.9997 times the one-rank forward's distance
# at the pooled vector and 1.236 times at the logits, which sit 5.6e-3 from
# the one-rank logits with agreement 0.99999). Phase 14 holds the 1.05 rule
# on the pooled vector, where the split computes differently (the merged
# GroupNorm and mean), and prints the logits' ratio; the logits keep the rel
# L2 and agreement limits.


def spatial_ablation_cases(dev, weights, x):
    """Phase 14: the ablations of SPACE_ABLATIONS at full width with phase
    13's weights (seeded, phase 3's FEAM weights on every parameter they
    share with it), on phase 3's bf16 tile batch ``x`` (CPU): each one's
    one-rank kernel forward and f32 forward (the plain route on the f32
    input), every output on the CPU, and the one-rank forward's wall ms
    (median of 3), and DynHead's pooled task features of both. Returns
    ({name: those}, the spawn calls of their H-split kernel forwards,
    timed, then of the split DynHead's task features)."""
    from multimodal_pl_tpu_torch.tools import spawn

    zoo, refs, calls = ablation_models(), {}, []
    wcpu = {k: v.cpu() for k, v in weights.items()}
    tasks = torch.tensor(ABLATION_TASKS)
    xd = x.to(dev)
    for name in SPACE_ABLATIONS:
        cls, kw, _ = zoo[name]
        net = cls(**kw, generator=torch.Generator().manual_seed(13))
        sd = net.state_dict()
        sd.update({k: v for k, v in wcpu.items() if k in sd and sd[k].shape == v.shape})
        plain = cls(**kw, conv_impl="plain", gn_impl="plain")
        for m in (net, plain):
            m.load_state_dict(sd)
            m.to(dev).eval()
        args = (tasks,) if name == "dynhead" else ()
        dargs = [a.to(dev) for a in args]
        with torch.inference_mode():
            refs[name] = {"one_rank": [t.float().cpu() for t in _flat(net(xd, *dargs))],
                          "f32": [t.float().cpu() for t in _flat(plain(xd.float(), *dargs))],
                          "one_rank_ms": wall_ms(lambda: net(xd, *dargs), 3)}
            if name == "dynhead":
                refs[name]["pooled"] = [m.task_features(m.encode(xin)[1]).float().cpu()
                                        for m, xin in ((net, xd), (plain, xd.float()))]
                pooled_call = (spawn.sp_task_features, (kw, sd, x, "cuda:0"))
        calls.append((spawn.sp_forward, (kw, sd, x, "cuda:0", cls.__name__, True, None, args,
                                         {})))
        del net, plain
        torch.cuda.empty_cache()
    return refs, calls + [pooled_call]


def check_spatial_ablations(refs, ranks, first) -> dict:
    """Phase 14: the H-split ablation forwards of ``ranks`` (each rank's
    results of the spawn from index ``first``, in SPACE_ABLATIONS' order)
    against ``refs`` (:func:`spatial_ablation_cases`): the ranks' outputs
    bit-equal; the logits within rel L2 3e-2 and label agreement 0.95 of the
    one-rank kernel forward; every output (logits, deep maps, the EAM
    cascade's tokens and attention maps) at most 1.05 times as far from the
    f32 forward as the one-rank kernel forward's (for DynHead its pooled task
    features in place of its logits, whose ratio is printed); rank 0's calls
    per tile
    batch the trunk's (18 fused + 4 prologue-off conv3x3_gn, 4 resize3d, 18
    fold gn_apply, no unsplit gn_relu or fold call) with one gn_moments and
    one normalize gn_apply per GroupNorm -> ReLU (the trunk's 17, DeepSup's
    three deep heads, DynHead's gap_gn), 31 halo exchanges and 27 crops (the
    4 stride-2 convs crop nothing), one statistics gather per gn_moments,
    one softmax merge per EAM and DynHead's one mean.
    Returns {name: readings} and, under 'launches', rank 0's calls."""
    from multimodal_pl_tpu_torch.ops import conv3x3
    from multimodal_pl_tpu_torch.tools import spatial_fault

    out, launches = {}, {}
    heads = {"deepsup": 3, "eam3": 0, "dynhead": 1}
    for i, name in enumerate(SPACE_ABLATIONS):
        (y, calls, exchanges, spans), others = ranks[0][first + i], [r[first + i] for r in
                                                                     ranks[1:]]
        got = [t.float() for t in _flat(y)]
        check(all(torch.equal(a, b) for r in others for a, b in zip(got, _flat(r[0]))),
              f"{name}: the ranks' split outputs differ")
        ref = refs[name]
        crit = spatial_fault.criteria(got[0], ref["one_rank"][0], ref["f32"][0])
        ratios = [((g - f).norm() / (o - f).norm()).item()
                  for g, o, f in zip(got, ref["one_rank"], ref["f32"], strict=True)]
        held = ratios
        if name == "dynhead":
            pooled = ranks[0][first + len(SPACE_ABLATIONS)]
            check(all(torch.equal(pooled, r[first + len(SPACE_ABLATIONS)]) for r in ranks[1:]),
                  "dynhead: the ranks' pooled task features differ")
            one, f32 = ref["pooled"]
            held = [((pooled.float() - f32).norm() / (one - f32).norm()).item()]
        kinds = {}
        for key, n in exchanges.items():
            kinds[key[0]] = kinds.get(key[0], 0) + n
        totals = {spec: sum(n for k, n in calls["conv3x3"].items() if k[0] == spec)
                  for spec in conv3x3.SPECS}
        gn = 17 + heads[name]
        counts = {"conv3x3": totals, "gn_moments": sum(calls["gn_moments"].values()),
                  "gn_apply": {m: sum(n for k, n in calls["gn_apply"].items() if k[0] == m)
                               for m in ("fold", "relu")},
                  "resize": sum(calls["resize"].values()),
                  "unsplit_gn": sum(calls["gn_relu"].values()) + sum(calls["fold"].values()),
                  "exchanges": kinds}
        want = {"conv3x3": {conv3x3.FUSED: 18, conv3x3.PROLOGUE_OFF: 4, conv3x3.TRAIN_FWD: 0,
                            conv3x3.TRAIN_DX: 0}, "gn_moments": 18 + gn,
                "gn_apply": {"fold": 18, "relu": gn}, "resize": 4, "unsplit_gn": 0,
                "exchanges": {"halo": 31, "crop": 27, "stats": 18 + gn,
                              **({"softmax": 3} if name == "eam3" else {}),
                              **({"mean": 1} if name == "dynhead" else {})}}
        row = dict(crit, output_f32_ratios=ratios, held_f32_ratios=held,
                   shapes=[list(t.shape) for t in got],
                   calls=counts, split_forward_ms=spans["forward_ms"],
                   one_rank_forward_ms=ref["one_rank_ms"], span_ms=spans)
        print(f"[14] {name} split over {SPACE_N} gloo ranks, {WINDOW_BATCH}x{TILE} bf16 kernels: "
              f"logits rel L2 vs the one-rank forward {crit['rel_l2']:.3e}, agreement "
              f"{crit['agreement']:.5f}; each output's rel L2 to f32 / the one-rank forward's "
              f"{[round(r, 4) for r in ratios]}"
              + (f" (pooled task features {held[0]:.4f})" if name == "dynhead" else "")
              + f"; forward {spans['forward_ms']:.1f} ms split "
              f"(gloo through the host), {ref['one_rank_ms']:.1f} ms one rank; calls per tile "
              f"batch {counts}", flush=True)
        check(crit["rel_ok"] and crit["agree_ok"],
              f"{name} split logits outside the serving limits: {crit}")
        check(all(r <= spatial_fault.F32_RATIO for r in held),
              f"{name} split outputs further from f32 than {spatial_fault.F32_RATIO} x the "
              f"one-rank forward's: {held}")
        check(counts == want, f"{name} split calls per tile batch {counts} != {want}")
        out[name] = row
        launches[name] = calls
    return out, launches


def phase_spatial(dev, results, weights, vol):
    """Phase 14: spatial serving (each tile's H axis split over ranks,
    ``--mesh space:N``) at phase 3's width. Returns what the kernels line
    needs: the per-shape tables of the slab-shaped calls and rank 0's calls
    per tile batch and per volume."""
    from multimodal_pl_tpu_torch.cli import evaluate
    from multimodal_pl_tpu_torch.convert import save_npz
    from multimodal_pl_tpu_torch.data.nifti import read_nifti
    from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
    from multimodal_pl_tpu_torch.models import UNet3DFEAM
    from multimodal_pl_tpu_torch.ops import conv3x3
    from multimodal_pl_tpu_torch.parallel import init_mesh
    from multimodal_pl_tpu_torch.parallel.spatial import SpatialSlidingWindowPredictor
    from multimodal_pl_tpu_torch.tools import spawn, spatial_fault

    out = {}
    t0 = time.perf_counter()
    # 1. --mesh space:1 under torchrun (one NCCL rank): the label maps of the
    # run without --mesh, bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

        img_dir, atlas_path, _ = make_synthetic_amos(os.path.join(tmp, "data"), n_ct=3,
                                                     n_mri=1, shape=(96, 96, 80), seed=6)
        ckpt = os.path.join(tmp, "weights.npz")
        save_npz(ckpt, weights)
        common = ["--data_dir", img_dir, "--atlas_path", atlas_path, "--reload_path", ckpt,
                  "--usage", "train", "--print", "true"]
        evaluate.main(common + ["--save_path", os.path.join(tmp, "one")])
        torchrun("multimodal_pl_tpu_torch.cli.evaluate",
                 common + ["--save_path", os.path.join(tmp, "space1"), "--mesh", "space:1"], tmp)
        maps = [{f: read_nifti(os.path.join(tmp, d, f)).data
                 for f in sorted(os.listdir(os.path.join(tmp, d))) if f.endswith("_pred.nii.gz")}
                for d in ("one", "space1")]
    same = bool(maps[0]) and sorted(maps[0]) == sorted(maps[1]) and all(
        np.array_equal(maps[0][f], maps[1][f]) for f in maps[0])
    print(f"[14] torchrun mpl-evaluate-torch --mesh space:1 (NCCL): {len(maps[1])} label maps, "
          f"bit-equal to the run without --mesh: {same} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(same, "mpl-evaluate-torch --mesh space:1 label maps differ from the run without --mesh")
    out["space1_cli_bit_equal"] = same

    # s/vol over the serving volume: the predictor without a mesh and the
    # spatial one over a one-rank NCCL group (the path of --mesh space:1), in
    # turns; their label maps bit for bit
    def feam(**kw):
        net = UNet3DFEAM(deep_up=True, **kw).to(dev).eval()
        net.load_state_dict(weights)
        return net

    single_model = feam()
    kwargs = dict(window_batch=WINDOW_BATCH, compute_dtype=torch.bfloat16, device=dev,
                  output="argmax")
    with init_mesh("space:1", dev) as mesh:
        check(torch.distributed.get_backend(mesh.space.group) == "nccl",
              "space:1 group is not NCCL")
        split_model = feam(space=mesh.space)
        preds = {"without": SlidingWindowPredictor(lambda t: single_model(t, aux=False), TILE,
                                                   NC, **kwargs),
                 "space:1": SpatialSlidingWindowPredictor(lambda t: split_model(t, aux=False),
                                                          TILE, NC, mesh.space, **kwargs)}
        labels, secs = {}, {name: [] for name in preds}
        for name in ("without", "space:1", "space:1", "without"):
            preds[name](vol)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            labels[name] = preds[name](vol)
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t1)
        bits = torch.equal(labels["without"], labels["space:1"])
        del split_model, preds
    print(f"[14] {VOL} volume, argmax, P C C P: without --mesh {secs['without']} s/vol, spatial "
          f"predictor over a one-rank NCCL group {secs['space:1']} s/vol; label maps bit-equal "
          f"{bits}", flush=True)
    check(bits, "space:1 predictor label map differs from the predictor without a mesh")
    out.update(space1_s_per_vol=secs["space:1"], without_s_per_vol=secs["without"])

    # 2. two gloo ranks on the card, space:2, on phase 3's tile batch and the
    # serving volume; 3. the planted halo fault, in the same spawn
    x = torch.randn((WINDOW_BATCH, *TILE, 1), generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16)
    plain_kw = {"deep_up": True, "conv_impl": "plain", "gn_impl": "plain"}
    with torch.inference_mode():
        one_rank = single_model(x.to(dev), aux=False).float().cpu()
        plain_model = feam(conv_impl="plain", gn_impl="plain")
        f32 = plain_model(x.to(dev).float(), aux=False).float().cpu()
        one_rank_vol = SlidingWindowPredictor(
            lambda t: single_model(t, aux=False), TILE, NC, **dict(kwargs, output="logits"))(
            vol).cpu()
    del single_model, plain_model
    torch.cuda.empty_cache()
    abl_refs, abl_calls = spatial_ablation_cases(dev, weights, x)
    wcpu = {k: v.cpu() for k, v in weights.items()}
    run_key = (False, "logits", WINDOW_BATCH)
    faults = ("layer0.0", "layer4.1")  # the planted halo faults: full and 1/16 scale
    calls = [(spawn.sp_forward, ({"deep_up": True}, wcpu, x, "cuda:0", "UNet3DFEAM", True)),
             (spawn.sp_forward, (plain_kw, wcpu, x.float(), "cuda:0")),
             (spawn.sp_predict, ({"deep_up": True}, wcpu, [vol, vol], TILE, (run_key,),
                                 "cuda:0", torch.bfloat16))]
    calls += [(spatial_fault.level_sums, (wcpu, x, "cuda:0", m and {"rank": 1, "module": m}))
              for m in (None, *faults)]
    first_ablation = len(calls)
    calls += abl_calls
    t1 = time.perf_counter()
    ranks = spawn.run(spawn.dp_calls, SPACE_N, calls, backend="gloo", timeout=600)
    spawn_s = time.perf_counter() - t1
    (kern, launches, exchanges, spans), (plain, _, _), predicted = ranks[0][:3]
    for r, rank in enumerate(ranks[1:], 1):
        check(all(torch.equal(ranks[0][i][0], rank[i][0]) for i in (0, 1))
              and all(torch.equal(ranks[0][i][1], rank[i][1])
                      for i in range(3, first_ablation)),
              f"rank {r}'s forwards differ from rank 0's")
    crit = spatial_fault.criteria(kern, one_rank, f32)
    plain_rel = ((plain - f32).norm() / f32.norm()).item()
    levels = [spatial_fault.readings([rank[3 + i] for rank in ranks], one_rank, f32)
              for i in range(len(faults) + 1)]
    print(f"[14] {SPACE_N} gloo ranks on one card, {WINDOW_BATCH}x{TILE} bf16 tile batch split "
          f"along H, kernels: logits rel L2 vs the one-rank forward {crit['rel_l2']:.3e}, label "
          f"agreement {crit['agreement']:.5f}, rel L2 to f32 {crit['f32_ratio']:.4f} x the "
          f"one-rank forward's; plain f32 route split vs whole rel L2 {plain_rel:.2e}; ranks "
          f"bit-equal; per-level rel L2 of the slabs vs the one-rank forward's rows: "
          + " ".join(f"{k} {v:.2e}" for k, v in levels[0]["levels"].items()), flush=True)
    check(crit["rel_ok"] and crit["agree_ok"] and crit["ratio_ok"],
          f"H-split kernel forward outside the serving limits: {crit}")
    check(plain_rel <= SPACE_PLAIN_REL, f"plain f32 H-split vs whole rel L2 {plain_rel}")
    check(levels[0]["levels_ok"],
          f"H-split level outputs vs the one-rank forward's above {spatial_fault.LEVEL_REL}: "
          f"{levels[0]}")
    fault_crit = {}
    for m, c in zip(faults, levels[1:]):
        caught = not (c["rel_ok"] and c["agree_ok"] and c["ratio_ok"] and c["levels_ok"])
        print(f"[14] planted fault (rank 1's low halo zeroed at {m}, tools/spatial_fault.py): "
              f"rel L2 {c['rel_l2']:.3e}, agreement {c['agreement']:.5f}, rel L2 to f32 "
              f"{c['f32_ratio']:.3f} x the one-rank forward's; per level "
              + " ".join(f"{k} {v:.2e}" for k, v in c["levels"].items())
              + f": {'caught' if caught else 'MISSED'}", flush=True)
        check(caught, f"the planted halo fault at {m} passed phase 14's criteria: {c}")
        fault_crit[m] = c
    totals = {spec: sum(n for k, n in launches["conv3x3"].items() if k[0] == spec)
              for spec in conv3x3.SPECS}
    apply_modes = {m: sum(n for k, n in launches["gn_apply"].items() if k[0] == m)
                   for m in ("fold", "relu")}
    counts = {"conv3x3": totals, "gn_moments": sum(launches["gn_moments"].values()),
              "gn_apply": apply_modes, "resize": sum(launches["resize"].values()),
              "gn_relu": sum(launches["gn_relu"].values()), "fold": sum(launches["fold"].values()),
              "halo_exchanges": sum(n for k, n in exchanges.items() if k[0] == "halo"),
              "stats_gathers": sum(n for k, n in exchanges.items() if k[0] == "stats")}
    print(f"[14] calls per tile batch on rank 0: {counts}", flush=True)
    check(counts == {"conv3x3": {conv3x3.FUSED: 18, conv3x3.PROLOGUE_OFF: 4, conv3x3.TRAIN_FWD: 0,
                                 conv3x3.TRAIN_DX: 0},
                     "gn_moments": 35, "gn_apply": {"fold": 18, "relu": 17}, "resize": 4,
                     "gn_relu": 0, "fold": 0, "halo_exchanges": 31, "stats_gathers": 35},
          f"H-split calls per tile batch {counts}")
    print(f"[14] stream ms per tile batch on rank 0 (CUDA events): halo rows gathered "
          f"{spans['exchange_ms']:.3f} ({spans['exchange_n']}), halo copies in "
          f"{spans['attach_ms']:.3f} ({spans['attach_n']}), crops out {spans['crop_ms']:.3f} "
          f"({spans['crop_n']}), GroupNorm moments gathered {spans['stats_ms']:.3f} "
          f"({spans['stats_n']}); gloo stages CUDA tensors through the host", flush=True)
    copies = halo_copy_times(dev, exchanges)
    print(f"[14] halo copies per tile batch, device ms of rank 0's calls (CUDA-graph replays): "
          f"attach {copies['attach_ms']:.3f} (bytes bound {copies['attach_bound_ms']:.3f}), "
          f"crop {copies['crop_ms']:.3f} (bound {copies['crop_bound_ms']:.3f}; "
          f"{copies['crops_with_skip']} of them add the decoder's skip)", flush=True)

    outs, same, vol_launches, vol_secs, vol_spans = predicted
    got = outs[run_key][0]
    vol_rel = ((got - one_rank_vol).norm() / one_rank_vol.norm()).item()
    vol_agree = (got.argmax(-1) == one_rank_vol.argmax(-1)).float().mean().item()
    same = same and all(r[2][1] for r in ranks[1:]) and torch.equal(outs[run_key][0],
                                                                    outs[run_key][1])
    vol_calls, vol_exchanges = vol_launches[run_key]
    print(f"[14] {SPACE_N} gloo ranks, spatial predictor over {VOL} (12 windows, batches of "
          f"{WINDOW_BATCH}): blended logits rel L2 vs the one-rank predictor {vol_rel:.3e}, "
          f"argmax agreement {vol_agree:.5f}, ranks bit-equal {same}; "
          f"{vol_secs[run_key]:.3f} s/vol (two ranks share one card and gloo stages through the "
          f"host: not a scaling figure) ({spawn_s:.1f} s for the spawn)", flush=True)
    vs = vol_spans[run_key]
    print(f"[14] of rank 0's {vol_secs[run_key]:.3f} s/vol, stream ms per volume (CUDA events, "
          f"host gaps included): halo rows gathered {vs['exchange_ms']:.1f} ({vs['exchange_n']}), "
          f"copies in {vs['attach_ms']:.1f}, crops out {vs['crop_ms']:.1f}, GroupNorm moments "
          f"gathered {vs['stats_ms']:.1f} ({vs['stats_n']}), the blend's all_reduce "
          f"{vs['merge_ms']:.1f} ({vs['merge_n']})", flush=True)
    check(same, "the spatial predictor's ranks returned different bits")
    check(vol_rel <= spatial_fault.REL_LIMIT and vol_agree >= spatial_fault.AGREE_LIMIT,
          f"spatial predictor vs one-rank: rel L2 {vol_rel}, agreement {vol_agree}")
    for k in ("conv3x3", "gn_moments", "gn_apply", "resize"):
        want = {key: 3 * n for key, n in launches[k].items()}
        check(dict(vol_calls[k]) == want, f"spatial predictor {k} calls per volume "
              f"{dict(vol_calls[k])} != 3 tile batches' {want}")
    check(not sum(vol_calls["gn_relu"].values()) and not sum(vol_calls["fold"].values()),
          "the spatial predictor launched the unsplit GroupNorm kernels")
    out.update(
        two_rank=crit, plain_rel=plain_rel, levels=levels[0]["levels"], fault=fault_crit,
        calls_per_tile_batch=counts,
        span_ms_per_tile_batch=spans, halo_copy_device_ms=copies, predictor_rel=vol_rel,
        predictor_agreement=vol_agree, two_rank_s_per_vol=vol_secs[run_key],
        two_rank_span_ms_per_vol=vs, spawn_s=spawn_s)

    # 4. the ablations split, from the same spawn
    out["ablations"], abl_launches = check_spatial_ablations(abl_refs, ranks, first_ablation)

    # 5. the slab-shaped calls against their plain versions, timed
    print("[14] the slab-shaped calls of one H-split tile batch, kernel vs plain", flush=True)
    every = [launches, *abl_launches.values()]
    gn_tables = phase_gn_split(dev, results, set().union(*(c["gn_moments"] for c in every)),
                               set().union(*(c["gn_apply"] for c in every)))
    conv_table = phase_kernels(dev, results, sorted(
        {(k[1], k[2], tuple(k[4:7]), k[0] == conv3x3.FUSED, k[7]) for k in launches["conv3x3"]}))
    resize_table = phase_resize(dev, results, set(launches["resize"]))[0]
    missing = [k for c in every for kind, table in (("conv3x3", conv_table),
                                                    ("resize", resize_table))
               for k in c[kind] if k not in table]
    check(not missing, f"the split ablations launched shapes phase 14 did not check: {missing}")
    results["spatial"] = out
    return {"tile_batch": launches, "volume": vol_calls, "ablations": abl_launches,
            "gn_moments": gn_tables[0], "gn_apply": gn_tables[1], "conv3x3": conv_table,
            "resize": resize_table}

# phase 15: the partial-label campaign (tools/campaign.py, tools/campaign_eval.py)
CAMPAIGN_EPOCHS, CAMPAIGN_CHUNK = 6, 3   # chunks of epochs 0-3 and 3-6
CAMPAIGN_TILE = (64, 96, 96)            # the campaign's patch and evaluation tile
CAMPAIGN_AGREE = 0.95                   # kernel vs plain label maps per case (phase 8's)
# phase 15's route probes from the 6-epoch state (tools/route_probe.py): every
# kernel call of one gradient step at the campaign's shape on its own inputs,
# |mean(kernel - f32)| / rms(f32) <= CAMPAIGN_BIAS per kernel, shape and output
# (clean calls read <= 2e-5 at epochs 0-1200 of a campaign, the plain route's
# bf16 upsample gradient up to 8.2e-4; a +0.1%-of-rms shift reads 1e-3); the
# refiner's gradient-free pass over CAMPAIGN_REST_BATCHES batches, kernel
# against plain bf16, the pooled foreground-probability shift within
# CAMPAIGN_REST_Z of its standard error (clean |z| <= 1.6 at those states; a
# +0.5%-of-rms plant at its last GroupNorm -> ReLU reads 262 at tiny widths)
CAMPAIGN_BIAS, CAMPAIGN_REST_Z, CAMPAIGN_REST_BATCHES = 1e-3, 5.0, 8
# phase 15's forks (tools/campaign.py run --fork_from): the 6-epoch state
# continued for one epoch at seed CAMPAIGN_FORK_SEED on the kernel route and
# on the plain bf16 route; both resume at step 36, their first logged total
# loss within CAMPAIGN_FORK_LOSS (phase 7's route limit, relative) and their
# held-out label maps, by the kernel evaluator, within CAMPAIGN_AGREE
CAMPAIGN_FORK_SEED, CAMPAIGN_FORK_LOSS = 10, 3e-2
ROUTE_PROBE_KERNELS = sorted(["conv3x3 train_fwd", "conv3x3 train_dx", "conv3x3 fused",
                              "conv3x3 prologue_off", "fold", "gn_relu forward",
                              "gn_relu backward", "resize3d forward", "resize3d backward"])


def make_campaign(root: str) -> str:
    """Phase 15's fixture, tools/campaign.py's default (28 cases at 96 x 96 x
    80, seed 7), written without its per-case lines; returns ``root``."""
    import contextlib
    import io

    from multimodal_pl_tpu_torch.tools import campaign

    with contextlib.redirect_stdout(io.StringIO()):
        campaign.generate(root)
    return root


def phase_campaign(dev, results, root):
    """Phase 15: the campaign through its entry points on the fixture at
    ``root``: ``run_chunks`` for epochs 0-3 and 3-6 of 6 (64 x 96 x 96, B =
    3, --device_data true, validation at epoch 5), then ``evaluate`` on the
    final checkpoint by the kernel route (bf16 tiles), the plain route (f32)
    and the plain versions on bf16 tiles. Checks: chunk 2 resumed chunk 1's
    checkpoint (the trainer says it
    loaded it, and the run ends at 36 steps); every logged loss finite; the
    validation record at epoch 5; training launched every training kernel
    (conv3x3_train forward and dx, the fused and prologue-off conv3x3_gn,
    gn_relu forward and backward, the fold, resize3d forward and backward)
    and the kernel route every serving kernel, the plain routes none; 9
    held-out cases (3 valid, 6 test), each label map of the kernel route
    agreeing on >= 0.95 of its voxels with the plain versions' on bf16
    tiles (phase 8's limit, between two routes at one dtype; each route's
    agreement with the plain route in f32 is reported). Returns the calls of
    both paths and their per-shape tables for the kernels line (the kernels
    timed at every shape either path launched)."""
    import contextlib
    import io
    from collections import Counter

    from multimodal_pl_tpu_torch.ops import conv3x3
    from multimodal_pl_tpu_torch.tools import campaign, campaign_eval
    from multimodal_pl_tpu_torch.tools.spawn import _launch_counts, _reset_launch_counts

    snap = os.path.join(root, "snapshots")
    per_epoch = campaign.steps_per_epoch(root)
    log = io.StringIO()
    t0 = time.perf_counter()
    _reset_launch_counts()
    with contextlib.redirect_stdout(log):
        chunks = campaign.run_chunks(root, CAMPAIGN_EPOCHS, CAMPAIGN_CHUNK, snap, val_every=1,
                                     extra=["--device", str(dev), "--log_every", "1"])
    train_calls = _launch_counts()
    train_s = time.perf_counter() - t0
    first = os.path.join(snap, f"ckpt_{CAMPAIGN_CHUNK * per_epoch}.pt")
    print(f"[15] tools/campaign.py run_chunks, {CAMPAIGN_EPOCHS} epochs in chunks of "
          f"{CAMPAIGN_CHUNK} ({per_epoch} steps per epoch at B = 3, {CAMPAIGN_TILE}): "
          + "; ".join(f"epochs {c['start']}-{c['stop']} resumed from "
                      f"{c['resumed_from'] and os.path.basename(c['resumed_from'])}, ended at "
                      f"step {c['step']} ({c['seconds']:.1f} s)" for c in chunks), flush=True)
    check([(c["start"], c["stop"]) for c in chunks] == [(0, CAMPAIGN_CHUNK),
                                                        (CAMPAIGN_CHUNK, CAMPAIGN_EPOCHS)],
          f"campaign chunks {chunks}")
    check(chunks[0]["resumed_from"] is None and chunks[0]["checkpoint"] == first
          and chunks[1]["resumed_from"] == first
          and f"loading from checkpoint: {first}" in log.getvalue()
          and chunks[1]["step"] == CAMPAIGN_EPOCHS * per_epoch,
          f"chunk 2 did not resume chunk 1's checkpoint {first}: {chunks}")
    with open(os.path.join(snap, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "loss" in r]
    losses = [v for r in steps for k, v in r.items() if "loss" in k]
    check(len(steps) == CAMPAIGN_EPOCHS * per_epoch and all(np.isfinite(losses)),
          f"{len(steps)} step records, losses finite: {all(np.isfinite(losses))}")
    epochs = [r for r in recs if "epoch/epoch_loss" in r]
    check(len(epochs) == CAMPAIGN_EPOCHS and all(np.isfinite(r["epoch/epoch_loss"])
                                                 for r in epochs), f"epoch records {epochs}")
    vals = [r for r in recs if "val/val_dice_ct_mean" in r]
    check([r["step"] for r in vals] == [CAMPAIGN_EPOCHS - 1]
          and all(np.isfinite(v) for r in vals for v in r.values() if isinstance(v, float)),
          f"validation records {vals}")
    pps = [round(r["epoch/patches_per_sec"], 2) for r in epochs]
    print(f"[15] {len(steps)} steps, every loss finite; patches/s per epoch {pps}; validation "
          f"at epoch {vals[0]['step']}: ct_mean {vals[0]['val/val_dice_ct_mean']:.4f}, "
          f"sup_dice_sum {vals[0]['val/val_dice_sup_sum']:.4f}", flush=True)
    spec = Counter(k[0] for k in train_calls["conv3x3"].elements())
    train_counts = {"conv3x3": dict(spec), **{k: sum(train_calls[k].values()) for k in (
        "gn_relu", "gn_relu_backward", "fold", "resize", "resize_backward")}}
    print(f"[15] kernel calls in training (validation included): {train_counts}", flush=True)
    check(all(spec[k] > 0 for k in conv3x3.SPECS) and all(
        train_counts[k] > 0 for k in ("gn_relu", "gn_relu_backward", "fold", "resize",
                                      "resize_backward")),
          f"campaign training left a kernel unlaunched: {train_counts}")

    # the tool's two routes (kernels on bf16 tiles, plain versions in f32),
    # and the plain versions on bf16 tiles: phase 8's limit holds two routes
    # at one dtype (bf16 against f32 flips the argmax of a 6-epoch model's
    # near-tied logits on ~7% of the voxels on the plain route alone)
    evals, eval_calls = {}, {}
    for route, plain, bf16 in (("kernels", False, True), ("plain", True, False),
                               ("plain bf16", True, True)):
        t1 = time.perf_counter()
        _reset_launch_counts()
        evals[route] = campaign_eval.evaluate(root, snap, 0, CAMPAIGN_TILE, plain=plain,
                                              bf16=bf16, device=dev, keep_maps=True,
                                              say=log.write)
        eval_calls[route] = _launch_counts()
        evals[route]["seconds"] = time.perf_counter() - t1
    kcalls = eval_calls["kernels"]
    espec = Counter(k[0] for k in kcalls["conv3x3"].elements())
    eval_counts = {"conv3x3": dict(espec), **{k: sum(kcalls[k].values())
                                              for k in ("gn_relu", "fold", "resize")}}
    check(all(espec[k] > 0 for k in (conv3x3.FUSED, conv3x3.PROLOGUE_OFF))
          and all(eval_counts[k] > 0 for k in ("gn_relu", "fold", "resize")),
          f"the kernel route's evaluation left a serving kernel unlaunched: {eval_counts}")
    for route in ("plain", "plain bf16"):
        check(not any(sum(c.values()) for c in eval_calls[route].values()),
              f"the {route} route launched kernels: {eval_calls[route]}")
    cases = {route: out["cases"] for route, out in evals.items()}
    check(all([(c["case_id"], c["usage"]) for c in cases["kernels"]]
              == [(c["case_id"], c["usage"]) for c in cases[r]] for r in cases)
          and [c["usage"] for c in cases["kernels"]] == ["valid"] * 3 + ["test"] * 6,
          f"held-out cases {[(c['case_id'], c['usage']) for c in cases['kernels']]}")

    def agreement(a, b):
        return [float((x["label_map"] == y["label_map"]).mean())
                for x, y in zip(cases[a], cases[b])]

    agree = agreement("kernels", "plain bf16")
    agree_f32 = {"kernels": agreement("kernels", "plain"),
                 "plain bf16": agreement("plain bf16", "plain")}
    check(all(np.isfinite(c["dice"]).all() and np.isfinite(c["dice_atlas"]).all()
              for route in cases.values() for c in route), "non-finite dice")
    for route, out in evals.items():
        print(f"[15] tools/campaign_eval.py, {route} route, {os.path.basename(out['checkpoint'])},"
              f" {len(out['cases'])} held-out cases ({out['seconds']:.1f} s): unsupervised "
              f"argmax {out['unsup_mean']:.4f} ({out['unsup_organs_above']}/13 > 0.3), "
              f"atlas-blended {out['unsup_mean_atlas']:.4f} ({out['unsup_organs_above_atlas']}"
              f"/13), CT {np.mean(out['ct_per_organ']):.4f}, MRI "
              f"{np.mean(out['mri_per_organ']):.4f}", flush=True)
    print(f"[15] kernel calls in the kernel route's evaluation: {eval_counts}; label maps "
          f"kernels vs plain on bf16 tiles agree on {min(agree):.5f} of the voxels (worst "
          f"case, limit {CAMPAIGN_AGREE}); against the plain route in f32, the kernels "
          f"{min(agree_f32['kernels']):.5f} and the plain versions on bf16 tiles "
          f"{min(agree_f32['plain bf16']):.5f} (worst cases; the dtype's share)", flush=True)
    check(min(agree) >= CAMPAIGN_AGREE, f"campaign label maps kernel vs plain agree {agree}")

    forks = campaign_forks(dev, root, snap)
    fcalls = forks.pop("calls")

    # every shape a path launched, kernel vs plain, timed
    train_table = phase_train_conv(dev, results, {k for c in (train_calls, fcalls)
                                                  for k in c["conv3x3"]
                                                  if k[0] == conv3x3.TRAIN_FWD})
    nograd = {k for c in (train_calls, kcalls, fcalls) for k in c["conv3x3"]
              if k[0] in (conv3x3.FUSED, conv3x3.PROLOGUE_OFF)}
    conv_table = {}
    for batch in sorted({k[3] for k in nograd}):
        conv_table.update(phase_kernels(
            dev, results, sorted((k[1], k[2], tuple(k[4:7]), k[0] == conv3x3.FUSED, k[7])
                                 for k in nograd if k[3] == batch), batch=batch, groups=4))
    every = (train_calls, kcalls, fcalls)
    gn_table = phase_gn(dev, results, set().union(*(c["gn_relu"] for c in every)))
    gn_bwd_table = phase_gn_bwd(dev, results, set(train_calls["gn_relu_backward"])
                                | set(fcalls["gn_relu_backward"]))
    fold_table = phase_fold(dev, results, set().union(*(c["fold"] for c in every)))
    resize_fwd, resize_bwd = phase_resize(dev, results,
                                          set().union(*(c["resize"] for c in every)),
                                          set(train_calls["resize_backward"])
                                          | set(fcalls["resize_backward"]))
    probe = campaign_route_probe(dev, root, snap)
    results["campaign"] = {
        "route_probe": probe, "forks": forks,
        "chunks": chunks, "train_s": train_s, "patches_per_sec": pps, "validation": vals,
        "train_calls": train_counts, "eval_calls": eval_counts, "label_agreement": agree,
        "label_agreement_vs_f32": agree_f32,
        "eval": {route: {k: v for k, v in out.items() if k != "cases"}
                 for route, out in evals.items()}}
    return {"train": train_calls, "eval": kcalls, "fork": fcalls, "conv_train": train_table,
            "conv": conv_table, "gn_relu": gn_table, "gn_relu_backward": gn_bwd_table,
            "fold": fold_table, "resize": resize_fwd, "resize_backward": resize_bwd}


def campaign_forks(dev, root, snap) -> dict:
    """Phase 15's forks: the 6-epoch state in ``snap`` forked
    (``run_chunks(fork_from=)``) into a fresh snapshot directory per route,
    the kernel route and the plain bf16 route, each trained one epoch at
    seed CAMPAIGN_FORK_SEED (LR horizon 7, validation at epoch 6), then both
    final states evaluated by the kernel evaluator. Checks: both forks
    resumed the copied checkpoint at step 36 and logged steps 37-42 only;
    their first logged total loss within CAMPAIGN_FORK_LOSS of each other
    (relative to plain's); their label maps agreeing on >= CAMPAIGN_AGREE of
    each held-out case's voxels; the kernel fork launched every training
    kernel, the plain fork none. Returns the tables, the seconds per epoch
    and, under "calls", the kernel fork's launches."""
    import contextlib
    import io
    from collections import Counter

    from multimodal_pl_tpu_torch.ops import conv3x3
    from multimodal_pl_tpu_torch.tools import campaign, campaign_eval
    from multimodal_pl_tpu_torch.tools.spawn import _launch_counts, _reset_launch_counts

    per_epoch = campaign.steps_per_epoch(root)
    base = os.path.join(snap, f"ckpt_{CAMPAIGN_EPOCHS * per_epoch}.pt")
    out, calls, maps = {}, {}, {}
    for route, flags in (("kernel", []), ("plain", ["--pallas_k2", "false",
                                                    "--pallas_gn", "false"])):
        fork = os.path.join(root, f"fork_{route}")
        log = io.StringIO()
        _reset_launch_counts()
        with contextlib.redirect_stdout(log):
            (chunk,) = campaign.run_chunks(
                root, CAMPAIGN_EPOCHS + 1, CAMPAIGN_CHUNK, fork, val_every=1,
                extra=["--device", str(dev), "--log_every", "1", "--seed",
                       str(CAMPAIGN_FORK_SEED)] + flags, fork_from=base)
        calls[route] = _launch_counts()
        copied = os.path.join(fork, os.path.basename(base))
        with open(os.path.join(fork, "train.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        steps = [r for r in recs if "loss" in r]
        check(chunk["resumed_from"] == copied and f"loading from checkpoint: {copied}"
              in log.getvalue() and [r["step"] for r in steps] == list(
                  range(CAMPAIGN_EPOCHS * per_epoch + 1, (CAMPAIGN_EPOCHS + 1) * per_epoch + 1)),
              f"the {route} fork did not resume {base} at step {CAMPAIGN_EPOCHS * per_epoch}: "
              f"{chunk}, steps {[r['step'] for r in steps]}")
        check(all(np.isfinite(v) for r in steps for k, v in r.items() if "loss" in k),
              f"the {route} fork logged a non-finite loss")
        ev = campaign_eval.evaluate(root, fork, 0, CAMPAIGN_TILE, device=dev, keep_maps=True,
                                    say=log.write)
        maps[route] = [c["label_map"] for c in ev["cases"]]
        vals = [r["val/val_dice_ct_mean"] for r in recs if "val/val_dice_ct_mean" in r]
        conv = Counter(k[0] for k in calls[route]["conv3x3"].elements())
        (pps,) = [r["epoch/patches_per_sec"] for r in recs if "epoch/patches_per_sec" in r]
        out[route] = {"start_step": steps[0]["step"] - 1, "first_loss": steps[0]["loss"],
                      "s_per_epoch": per_epoch * campaign.BATCH / pps,
                      "call_s": chunk["seconds"], "val_ct_mean": vals,
                      "unsup_mean": ev["unsup_mean"],
                      "launches": {**{spec: conv[spec] for spec in conv3x3.SPECS}, **{
                          k: sum(calls[route][k].values()) for k in (
                              "gn_relu", "gn_relu_backward", "fold", "resize",
                              "resize_backward")}}}
        print(f"[15] fork of the {CAMPAIGN_EPOCHS}-epoch state, {route} route, seed "
              f"{CAMPAIGN_FORK_SEED}: {out[route]['s_per_epoch']:.3f} s/epoch ({pps:.2f} "
              f"patches/s; the call {chunk['seconds']:.1f} s with process start, validation and "
              f"checkpoint), from step {out[route]['start_step']}, "
              f"first loss {steps[0]['loss']:.6f}, ct_mean {vals}, held-out unsupervised "
              f"argmax {ev['unsup_mean']:.4f}", flush=True)
    k, p = out["kernel"], out["plain"]
    rel = abs(k["first_loss"] - p["first_loss"]) / max(abs(p["first_loss"]), 1e-12)
    agree = [float((a == b).mean()) for a, b in zip(maps["kernel"], maps["plain"])]
    out.update(first_loss_rel=rel, label_agreement=agree)
    print(f"[15] forks: both from step {k['start_step']}; first total loss kernel "
          f"{k['first_loss']:.6f} vs plain {p['first_loss']:.6f}, rel {rel:.2e} (limit "
          f"{CAMPAIGN_FORK_LOSS}); label maps agree on {min(agree):.5f} of the voxels (worst "
          f"of {len(agree)} cases, limit {CAMPAIGN_AGREE}); launches kernel {k['launches']}, "
          f"plain {p['launches']}", flush=True)
    check(k["start_step"] == p["start_step"] == CAMPAIGN_EPOCHS * per_epoch,
          f"the forks resumed from steps {k['start_step']} and {p['start_step']}")
    check(rel <= CAMPAIGN_FORK_LOSS, f"fork first losses kernel {k['first_loss']} plain "
                                     f"{p['first_loss']}: rel {rel}")
    check(len(agree) == 9 and min(agree) >= CAMPAIGN_AGREE, f"fork label maps agree {agree}")
    check(all(v > 0 for v in k["launches"].values()),
          f"the kernel fork left a kernel unlaunched: {k['launches']}")
    check(not any(p["launches"].values()), f"the plain fork launched kernels: {p['launches']}")
    out["calls"] = calls["kernel"]
    return out


def campaign_route_probe(dev, root, snap) -> dict:
    """Phase 15's route probes (``tools/route_probe.py``) from the latest
    checkpoint in ``snap`` on the campaign's batches: the signed bias of
    every kernel call of one kernel-route gradient step against its plain
    version (<= CAMPAIGN_BIAS), and the refiner's gradient-free pass,
    kernel against plain bf16 (pooled |z| <= CAMPAIGN_REST_Z). The
    consistency term at its full weight, whatever the epoch."""
    from multimodal_pl_tpu_torch.tools import route_probe as R
    from multimodal_pl_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint

    t0 = time.perf_counter()
    cfg, seed = R.campaign_config(root, CAMPAIGN_EPOCHS)
    cfgs = R.route_configs(cfg)
    steps = R.make_steps({k: cfgs[k] for k in ("kernel", "plain")}, dev)
    state = restore_checkpoint(latest_checkpoint(snap)).to(dev)
    batches = R.campaign_batches(root, cfgs["kernel"], CAMPAIGN_REST_BATCHES, seed, dev,
                                 CAMPAIGN_TILE)
    wf = torch.tensor(cfg.weight_feature_max, device=dev)
    rows = R.kernel_bias(steps["kernel"], state, batches[:1], wf)
    worst = max(rows, key=lambda r: abs(r["bias_kernel"]))
    inputs = [R.rest_inputs(steps["kernel"], state, b, wf) for b in batches]
    rest = R.rest(steps, state, inputs, pairs=[("kernel", "plain")])["kernel-plain"]["all"]
    out = {"kernel_rows": len(rows), "kernels": sorted({r["kernel"] for r in rows}),
           "worst_bias": {k: worst[k] for k in ("kernel", "shape", "output", "bias_kernel",
                                                 "bias_plain", "err_kernel", "err_plain")},
           "rest_kernel_vs_plain": rest, "seconds": time.perf_counter() - t0}
    print(f"[15] route probes from the {CAMPAIGN_EPOCHS}-epoch state at B = 3 x {CAMPAIGN_TILE} "
          f"({out['seconds']:.1f} s): {len(rows)} (kernel, shape, output) rows of one gradient "
          f"step, worst |mean(kernel - f32)| / rms(f32) {abs(worst['bias_kernel']):.2e} "
          f"({worst['kernel']} {worst['output']} {worst['shape']}; plain "
          f"{worst['bias_plain']:.2e}; limit {CAMPAIGN_BIAS}); refiner gradient-free pass over "
          f"{len(batches)} batches, kernel vs plain bf16: foreground shift "
          f"{rest['prob']['mean']:.3e} (z {rest['prob']['z']:.2f}, limit {CAMPAIGN_REST_Z}), "
          f"dice {rest['dice']:.5f}", flush=True)
    check(out["kernels"] == ROUTE_PROBE_KERNELS, f"the route probe saw kernels {out['kernels']}")
    check(abs(worst["bias_kernel"]) <= CAMPAIGN_BIAS, f"kernel call biased: {out['worst_bias']}")
    check(abs(rest["prob"]["z"]) <= CAMPAIGN_REST_Z,
          f"the refiner's gradient-free pass shifts on the kernel route: {rest}")
    del steps, state, batches, inputs
    torch.cuda.empty_cache()
    return out


def campaign_entries(run) -> list:
    """The kernels-line entries of phase 15's two paths: every call of the
    6-epoch campaign's training (its epoch-5 validation included) and of the
    kernel route's held-out evaluation, each call's device time from the
    per-shape tables."""
    from multimodal_pl_tpu_torch.ops import conv3x3

    train_specs = (conv3x3.TRAIN_FWD, conv3x3.TRAIN_DX, conv3x3.PROLOGUE_OFF)
    out = []
    for path, tag in (("train", "campaign training, 6 epochs (validation at epoch 5)"),
                      ("eval", "campaign held-out evaluation, 9 cases, kernel route"),
                      ("fork", "campaign fork of the 6-epoch state, 1 epoch, kernel route")):
        calls = run[path]
        specs = ((train_specs, K2, "conv3x3_train: conv3x3_gn prologue off (forward, dx; "
                                   "gradient-free refiner and validation)"),
                 ((conv3x3.FUSED,), K2_GN, "conv3x3_gn fused GN-ReLU prologue (refiner "
                                           "gradient-free pass and validation)"))
        if path == "eval":
            specs = (((conv3x3.FUSED,), BDX, "conv3x3_gn fused GN-ReLU prologue"),
                     ((conv3x3.PROLOGUE_OFF,), BK3, "conv3x3_gn prologue off"))
        for spec_set, replaces, label in specs:
            out.append(kernel_entry(
                f"{label}, {tag}", SOURCE, replaces,
                sum(n for k, n in calls["conv3x3"].items() if k[0] in spec_set),
                conv_rows(spec_set, calls["conv3x3"], run["conv_train"], run["conv"])))
        kinds = [("gn_relu", "gn_relu forward (gn_relu_fwd_bf16)", GN_SOURCE, GN_RELU),
                 ("fold", "group_norm_fold statistics (gn_fold_bf16)", GN_SOURCE, GN_FOLD),
                 ("resize", "resize3d forward (upsample [+ skip])", RESIZE_SOURCE, RESIZE)]
        if path != "eval":
            kinds += [("gn_relu_backward", "gn_relu backward (gn_relu_bwd_bf16)", GN_SOURCE,
                       GN_BWD),
                      ("resize_backward", "resize3d backward (gather form)", RESIZE_SOURCE,
                       RESIZE_BWD)]
        for key, label, src, replaces in kinds:
            out.append(kernel_entry(f"{label}, {tag}", src, replaces,
                                    sum(calls[key].values()),
                                    [(n, run[key][k]) for k, n in calls[key].items()]))
    return out


# phase 16: the spatial train step (parallel/spatial.py make_spatial_train_step)
BIG_PATCH = (128, 128, 128)     # BASELINE.json config 5, the 1 x 128^3 step
# The plain f32 route split against whole, per gradient leaf, both against
# the whole step in float64: the split moves only the order of sums and the
# library's conv algorithms (chosen per shape), so its median leaf may sit
# at most SPLIT_F64_RATIO times as far from float64 as the whole step's
# (plus 1e-6); every leaf within SPLIT_PLAIN_WORST of the whole step's. Single
# leaves move by more where a GroupNorm -> ReLU's pre-activation sits within
# rounding of 0 and its mask flips with the order of sums: in a CPU step at
# 32 x 64 x 32 one such voxel (pre-activation -2e-7) moved every
# full-resolution encoder leaf by 3-8e-4, where the whole f32 step sat 1e-6
# from float64; on the card (TF32 off) the split's median leaf read 2.4e-4
# from the whole's and its worst 5.1e-3.
SPLIT_F64_RATIO, SPLIT_PLAIN_WORST = 2.0, 0.1
GN_BWD_SPLIT = ("multimodal_pl_tpu/ops/norm.py:95 _gn_relu_bwd (XLA; the VJP of row 5): its "
                "per-(sample, channel) sums of gy and gy * xhat, on an H slab")
GN_DX_SPLIT = ("multimodal_pl_tpu/ops/norm.py:95 _gn_relu_bwd (XLA; the VJP of row 5): dx from "
               "the whole sample's sums, and the slab's ds and dt")


def remat_recompute(layers=(1, 2, 2, 2, 2)) -> dict:
    """Phase 16: what the recompute of a remat step's checkpointed segmenter
    stages adds per step under an H split, from the architecture. The stages
    are the encoder's layer0-4 (``layers`` blocks; stride 2 from layer1,
    whose first block has a projection) and the decoder's x8/x4/x2 (one block
    with a projection) and x1 (one without). Per block: halo exchanges (each
    stride-1 conv's and a stride-2 conv1's), crops and conv3x3_train
    forwards (stride-1 convs), moment gathers (GN1, GN2, the projection's);
    the recompute stops after the last op that saved a tensor, so a stage
    whose last block has no projection skips its final crop. Returns
    {'halo', 'crop', 'stats', 'conv': calls added per step}."""
    stages = [[(1, False)] * layers[0]]
    stages += [[(2, True)] + [(1, False)] * (n - 1) for n in layers[1:]]
    stages += [[(1, True)]] * 3 + [[(1, False)]]
    out = dict(halo=0, crop=0, stats=0, conv=0)
    for blocks in stages:
        for stride, proj in blocks:
            convs = 2 if stride == 1 else 1
            out["halo"] += 2
            out["crop"] += convs
            out["conv"] += convs
            out["stats"] += 2 + proj
        out["crop"] -= not blocks[-1][1]
    return out


def phase_gn_bwd_split(dev, results, keys, n=SPACE_N):
    """Phase 16: the slab backward's entry points of csrc/gn_relu.cu against
    their plain twins at every slab shape the spatial step launches them,
    from n slabs' moments (this slab's and n - 1 others'): gn_bwd_sums_bf16's
    sums and gn_bwd_dx_bf16's ds, dt by relative norm <= GN_BWD_REL, its dx
    within 1e-2 * max|plain|, the whole sample's sums being this slab's and
    n - 1 other slabs'. Bounds: sums, one read of x and dy; dx, one read of
    x and dy and one write of dx. No library call gives the GroupNorm
    backward from given sums (library_ms null). Returns ({key: sums row},
    {key: dx row})."""
    from multimodal_pl_tpu_torch.ops import gn_relu as G

    g = torch.Generator().manual_seed(16)

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()

    def slab(c, b, d, h, w, shift=0.5):
        return (torch.randn((b, d, h, w, c), generator=g) * 2 + shift).to(dev, torch.bfloat16)

    tables = ({}, {})
    for key in sorted(keys):
        c, groups, b, d, h, w = key
        x, dy = slab(c, b, d, h, w), slab(c, b, d, h, w, 0.0)
        sc = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
        bi = (0.1 * torch.randn(c, generator=g)).to(dev)
        others = [slab(c, b, d, h, w) for _ in range(n - 1)]
        moments = torch.stack([G.gn_moments(t, groups) for t in [x] + others])
        count = d * h * w * (c // groups)
        stats_p = G.merge_moments_reference(moments, float(count))
        stats, sums = G.gn_bwd_sums(x, dy, moments, sc, bi, groups)
        sums_p = G.gn_bwd_sums_reference(x, dy, sc, bi, stats_p)
        rest = [G.gn_bwd_sums(t, slab(c, b, d, h, w, 0.0), moments, sc, bi, groups)[1]
                for t in others]
        total = sums + sum(rest) if rest else sums
        total_p = sums_p + sum(rest) if rest else sums_p
        dx, ds, dt = G.gn_bwd_dx(x, dy, stats, sc, bi, sums, total, groups, n * count)
        pdx, pds, pdt = G.gn_bwd_dx_reference(x, dy, sc, bi, stats_p, sums_p, total_p, n * count)
        torch.cuda.synchronize()
        sums_rel = rel(sums, sums_p)
        dx_err, dx_max = (dx.float() - pdx.float()).abs().max().item(), pdx.float().abs().max().item()
        dsdt_rel = max(rel(ds, pds), rel(dt, pdt))
        reps = 5 if x.numel() > 2 ** 26 else 20
        common = {"c": c, "groups": groups, "b": b, "dhw": [d, h, w], "slabs": n,
                  "library_ms": None}
        one = G.sums_plan(b, d * h * w, c, G.limits(x.device.index).stats_clusters[1])[2] > 0
        rows = (
            dict(common, kernel="gn_bwd_sums_bf16", rel=sums_rel, launches_per_call=2 - one,
                 max_abs_err=(sums - sums_p).abs().max().item(),
                 ms=time_ms(lambda: G.gn_bwd_sums(x, dy, moments, sc, bi, groups), reps),
                 plain_ms=time_ms(lambda: G.gn_bwd_sums_reference(x, dy, sc, bi, stats_p), reps),
                 **bound(0.0, 4 * x.numel() + 4 * (moments.numel() + 2 * c + 2 * b * c))),
            dict(common, kernel="gn_bwd_dx_bf16", dsdt_rel=dsdt_rel, max_abs_err=dx_err,
                 max_abs_plain=dx_max,
                 ms=time_ms(lambda: G.gn_bwd_dx(x, dy, stats, sc, bi, sums, total, groups,
                                                n * count), reps),
                 plain_ms=time_ms(lambda: G.gn_bwd_dx_reference(
                     x, dy, sc, bi, stats_p, sums_p, total_p, n * count), reps),
                 **bound(0.0, 6 * x.numel() + 4 * (2 * b * groups + 4 * b * c + 4 * c))))
        print(f"  gn_bwd_sums/dx B={b} C={c:3d} G={groups:2d} @{d}x{h}x{w} from {n} slabs "
              f"({2 - one} + 1 launches): sums "
              f"rel {sums_rel:.2e}, dx {dx_err:.3g} (max|p| {dx_max:.3g}), ds/dt rel "
              f"{dsdt_rel:.2e}  kernels {rows[0]['ms']:.3f} + {rows[1]['ms']:.3f} ms  plain "
              f"{rows[0]['plain_ms']:.3f} + {rows[1]['plain_ms']:.3f} ms  bound "
              f"{rows[0]['bound_ms']:.3f} + {rows[1]['bound_ms']:.3f} ms", flush=True)
        check(sums_rel <= GN_BWD_REL and dsdt_rel <= GN_BWD_REL and dx_err <= 1e-2 * dx_max,
              f"gn_bwd_sums / gn_bwd_dx kernels disagree with plain at {rows}")
        tables[0][key], tables[1][key] = rows
        results["gn_split"] += list(rows)
        del x, dy, dx, pdx, others
    torch.cuda.empty_cache()
    return tables


def grad_leaf_check(got, f32, plain):
    """Per leaf of the segmenter's and the refiner's gradients: got's
    relative distance from the f32 step against the plain bf16 step's
    (phase 7's rule: <= LEAF_RATIO x plain + LEAF_FLOOR). Returns (passes,
    the worst leaf, its two distances, the median ratio)."""
    kf = {k: rel_tree(got, f32, [k]) for k in f32}
    pf = {k: rel_tree(plain, f32, [k]) for k in f32}
    worst = max(kf, key=lambda k: kf[k] - LEAF_RATIO * pf[k])
    ratio = [kf[k] / max(pf[k], 1e-30) for k in kf]
    return (kf[worst] <= LEAF_RATIO * pf[worst] + LEAF_FLOOR, worst, kf[worst], pf[worst],
            float(np.median(ratio)))


def phase_spatial_step(dev, results, tables):
    """Phase 16: the spatial train step at the full geometry (B = 1, 64 x 192
    x 192, bf16, kernels, the StepConfig defaults) from one seeded state and
    batch. ``tables``: phase 6's per-shape tables (the refiner runs on the
    gathered sample at the unsplit step's shapes). Returns the kernels-line
    entries of the path without and with remat (rank 0 of 2, one step
    each)."""
    import dataclasses

    from multimodal_pl_tpu_torch.ops import conv3x3
    from multimodal_pl_tpu_torch.parallel import init_mesh
    from multimodal_pl_tpu_torch.parallel.spatial import make_spatial_train_step, spatial_batch
    from multimodal_pl_tpu_torch.tools import spawn, spatial_fault
    from multimodal_pl_tpu_torch.train.state import StepConfig, build_models, create_train_state
    from multimodal_pl_tpu_torch.train.step import make_train_step

    out = {}
    cfg = StepConfig(compute_dtype=torch.bfloat16)
    cfg_r = dataclasses.replace(cfg, remat=True)
    plain = dataclasses.replace(cfg, conv_impl="plain", gn_impl="plain")
    plain32 = dataclasses.replace(plain, compute_dtype=torch.float32)
    state = create_train_state(torch.Generator().manual_seed(0), cfg)
    batch = train_batch(dev, cfg)
    host = {k: v.cpu() for k, v in batch.items()}
    big = {k: v.cpu() for k, v in train_batch(dev, cfg, patch=BIG_PATCH).items()}
    lr, wf = 5e-4, 0.05
    lr_t, wf_t = torch.tensor(lr, device=dev), torch.tensor(wf, device=dev)
    sd = state.to(dev)

    # 1. space:1 over a one-rank NCCL group: TrainStep's state and metrics, bit for bit,
    # without and with remat; deep_up=False raises, split or not, as the JAX step fails
    from multimodal_pl_tpu_torch.tools.spawn import states_unequal
    from multimodal_pl_tpu_torch.train.step import TrainStep

    for c in (cfg, cfg_r):
        t0 = time.perf_counter()
        one_state, m_one = make_train_step(*(m.to(dev) for m in build_models(c)), c)(
            sd, batch, lr_t, wf_t)
        with init_mesh("space:1", dev) as mesh:
            check(torch.distributed.get_backend(mesh.space.group) == "nccl",
                  "space:1 group is not NCCL")
            step1 = make_spatial_train_step(
                *(m.to(dev) for m in build_models(c, space=mesh.space)), c, mesh.space)
            s1, m1 = step1(sd, spatial_batch(batch, mesh.space), lr_t, wf_t)
            torch.cuda.synchronize()
            if c.remat:
                nodu = dataclasses.replace(cfg, deep_up=False)
                for space in (None, mesh.space):
                    try:
                        TrainStep(*build_models(nodu), nodu, space=space)
                        raised = False
                    except ValueError:
                        raised = True
                    check(raised, f"TrainStep(deep_up=False, space={space}) did not raise")
        unequal = states_unequal(s1, one_state)
        m1, m_one = ({k: float(v) for k, v in m.items()} for m in (m1, m_one))
        print(f"[16] space:1 over a one-rank NCCL group vs TrainStep, B=1 x {PATCH} bf16 "
              f"kernels{', remat' if c.remat else ''}: states differ in {len(unequal)} leaves, "
              f"metrics equal {m1 == m_one} ({time.perf_counter() - t0:.1f} s)", flush=True)
        check(not unequal and m1 == m_one,
              f"space:1 step (remat {c.remat}) differs from TrainStep: {unequal[:5]}")
        out["space1_bit_equal" + ("_remat" if c.remat else "")] = True
        if not c.remat:
            one_m = m_one
        del s1, one_state, step1
        torch.cuda.empty_cache()

    # 2. one spawned rank (the step of a group of one, TrainStep): the
    # gradients of the kernel, plain bf16 and plain f32 steps (phase 7's
    # references), then the kernel step's peak GiB and wall ms at the patch
    # and at 1 x 128^3
    del sd
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (single,) = spawn.run(spawn.dp_calls, 1, [
        *((spawn.sp_grads, (c, state, host, wf, "cuda:0")) for c in (cfg, plain, plain32)),
        (spawn.sp_grads, (plain32, state, host, wf, "cuda:0", None, True)),
        *((spawn.sp_step, (c, state, p, lr, wf, "cuda:0", None, True)) for c in (cfg, cfg_r)
          for p in (host, big))], timeout=600)
    single_s = time.perf_counter() - t0
    ref = dict(zip(("kernel", "plain", "plain_f32", "plain_f64"), single[:4]))
    single = single[4:]

    # 3. two gloo ranks on the card: the kernel, plain f32 and faulty gradient
    # passes, then the kernel step at the patch and at 1 x 128^3; the same
    # kernel gradient pass and steps with remat
    calls = [(spawn.sp_grads, (cfg, state, host, wf, "cuda:0")),
             (spawn.sp_grads, (plain32, state, host, wf, "cuda:0")),
             (spawn.sp_grads, (cfg, state, host, wf, "cuda:0", spatial_fault.drop_halo_grads)),
             (spawn.sp_step, (cfg, state, host, lr, wf, "cuda:0", None, True)),
             (spawn.sp_step, (cfg, state, big, lr, wf, "cuda:0", None, True)),
             (spawn.sp_grads, (cfg_r, state, host, wf, "cuda:0")),
             (spawn.sp_step, (cfg_r, state, host, lr, wf, "cuda:0", None, True)),
             (spawn.sp_step, (cfg_r, state, big, lr, wf, "cuda:0", None, True))]
    t0 = time.perf_counter()
    ranks = spawn.run(spawn.dp_calls, SPACE_N, calls, backend="gloo", timeout=900)
    spawn_s = time.perf_counter() - t0
    (kl, kg), (pl, pg), (fl, fg), step_out, big_out, (rl, rg), rstep_out, rbig_out = ranks[0]
    for r, rank in enumerate(ranks[1:], 1):
        same = all(rank[i][0] == ranks[0][i][0]
                   and all(torch.equal(rank[i][1][k], ranks[0][i][1][k]) for k in kg)
                   for i in (0, 5))
        same = same and all(not states_unequal(rank[i][0], ranks[0][i][0])
                            and rank[i][1] == ranks[0][i][1] for i in (3, 6))
        check(same, f"rank {r}'s gradients or new states differ from rank 0's")
    f32_loss, f32_grads = ref["plain_f32"]
    ok, worst, kf, pf, med = grad_leaf_check(kg, f32_grads, ref["plain"][1])
    loss_rel = abs(kl - ref["kernel"][0]) / abs(ref["kernel"][0])
    loss_rel32 = abs(kl - f32_loss) / abs(f32_loss)
    seg = [k for k in kg if k.startswith("params.")]
    plain_rels = {k: rel_tree(pg, f32_grads, [k]) for k in f32_grads}
    plain_leaf = max((v, k) for k, v in plain_rels.items())
    plain_median = float(np.median(list(plain_rels.values())))
    f64 = {k: g.float() for k, g in ref["plain_f64"][1].items()}
    to_f64 = {name: [rel_tree(t, f64, [k]) for k in f64] for name, t in (("split", pg),
                                                                       ("whole", f32_grads))}
    med64 = {name: float(np.median(v)) for name, v in to_f64.items()}
    worst64 = {name: max(v) for name, v in to_f64.items()}
    f_ok, f_worst, f_kf, f_pf, f_med = grad_leaf_check(fg, f32_grads, ref["plain"][1])
    step_loss_rel = abs(step_out[1]["loss"] - one_m["loss"]) / abs(one_m["loss"])
    print(f"[16] {SPACE_N} gloo ranks on one card, B=1 x {PATCH} split along H, bf16 kernels "
          f"({spawn_s:.1f} s for the spawn): ranks bit-equal; loss {kl:.6f} vs the one-rank "
          f"kernel step's {ref['kernel'][0]:.6f} (rel {loss_rel:.2e}) and the f32 step's "
          f"{f32_loss:.6f} (rel {loss_rel32:.2e}); segmenter gradients rel Frobenius vs f32 "
          f"{rel_tree(kg, f32_grads, seg):.3e} (one-rank kernel "
          f"{rel_tree(ref['kernel'][1], f32_grads, seg):.3e}, plain bf16 "
          f"{rel_tree(ref['plain'][1], f32_grads, seg):.3e}); per leaf vs f32 / plain-bf16 vs "
          f"f32: median {med:.3f}, worst {worst} {kf:.3e} vs {pf:.3e}; the new state's loss vs "
          f"the one-rank step's rel {step_loss_rel:.2e}", flush=True)
    check(loss_rel <= 3e-2 and loss_rel32 <= 3e-2 and step_loss_rel <= 3e-2,
          f"spatial step loss: {kl} vs {ref['kernel'][0]}, f32 {f32_loss}, step "
          f"{step_out[1]['loss']} vs {one_m['loss']}")
    check(ok, f"spatial step gradient leaf {worst}: {kf} vs f32 > {LEAF_RATIO} x the plain "
              f"bf16 step's {pf} + {LEAF_FLOOR}")
    print(f"[16] plain f32 route (TF32 off), split vs whole: loss {pl:.7f} vs {f32_loss:.7f}, "
          f"gradient leaves rel: median {plain_median:.2e}, worst {plain_leaf[0]:.2e} "
          f"({plain_leaf[1]}), {sum(v > 1e-5 for v in plain_rels.values())} of "
          f"{len(plain_rels)} above 1e-5; against the whole float64 step (loss "
          f"{ref['plain_f64'][0]:.7f}): split median {med64['split']:.2e} worst "
          f"{worst64['split']:.2e}, whole f32 median {med64['whole']:.2e} worst "
          f"{worst64['whole']:.2e}", flush=True)
    check(med64["split"] <= SPLIT_F64_RATIO * med64["whole"] + 1e-6
          and plain_leaf[0] <= SPLIT_PLAIN_WORST and abs(pl - f32_loss) <= 1e-5 * abs(f32_loss),
          f"plain f32 spatial step vs whole: to float64 {med64} {worst64}, worst {plain_leaf}, "
          f"loss {pl} vs {f32_loss}")
    print(f"[16] planted fault (tools/spatial_fault.py drop_halo_grads: no halo row's gradient "
          f"returned): worst leaf {f_worst} {f_kf:.3e} vs f32 (plain bf16 {f_pf:.3e}), median "
          f"ratio {f_med:.3f}: {'MISSED' if f_ok else 'caught'}", flush=True)
    check(not f_ok, "the planted halo-gradient fault passed phase 16's per-leaf check")
    # remat: the same gradients as without (phase 9's rule), and phase 7's per-leaf rule
    remat_loss_rel = abs(rl - kl) / abs(kl)
    remat_leaf = max((rel_tree(rg, kg, [k]), k) for k in kg)
    r_ok, r_worst, r_kf, r_pf, r_med = grad_leaf_check(rg, f32_grads, ref["plain"][1])
    print(f"[16] remat split vs split: loss rel {remat_loss_rel:.2e}, worst leaf "
          f"{remat_leaf[0]:.2e} ({remat_leaf[1]}); per leaf vs f32 / plain-bf16 vs f32: median "
          f"{r_med:.3f}, worst {r_worst} {r_kf:.3e} vs {r_pf:.3e}", flush=True)
    check(remat_loss_rel <= REMAT_LOSS_REL and remat_leaf[0] <= REMAT_LEAF_REL,
          f"remat split step vs split step: loss {remat_loss_rel}, leaf {remat_leaf}")
    check(r_ok, f"remat spatial step gradient leaf {r_worst}: {r_kf} vs f32 > {LEAF_RATIO} x "
                f"the plain bf16 step's {r_pf} + {LEAF_FLOOR}")
    for name, (s_, m_, calls_, ex_, peak, ms) in (("patch", step_out), ("128^3", big_out),
                                                  ("patch, remat", rstep_out),
                                                  ("128^3, remat", rbig_out)):
        check(all(np.isfinite(v) for v in m_.values()) and m_["grads_finite"] == 1.0,
              f"spatial step metrics at {name}: {m_}")

    def kinds_of(exchanges):
        kinds = {}
        for key, n in exchanges.items():
            kinds[key[0]] = kinds.get(key[0], 0) + n
        return kinds

    launches, kinds = step_out[2], kinds_of(step_out[3])
    launches_r, kinds_r = rstep_out[2], kinds_of(rstep_out[3])
    seg_gn = sum(n for k, n in launches["gn_apply"].items() if k[0] == "relu")
    counts = {k: sum(v.values()) for k, v in launches.items()}
    counts_r = {k: sum(v.values()) for k, v in launches_r.items()}
    print(f"[16] rank 0's calls per step: {counts}; exchanges {kinds}", flush=True)
    print(f"[16] with remat: {counts_r}; exchanges {kinds_r}", flush=True)
    check(counts["gn_bwd_sums"] == counts["gn_bwd_dx"] == seg_gn == counts["gn_moments"] > 0,
          f"slab GroupNorm calls per step {counts}")
    check(kinds.get("halo_bwd", 0) == kinds.get("halo", 0) - 1,
          f"every halo but the stem's returns its gradient: {kinds}")
    # remat adds the recompute of the checkpointed stages, derived from the architecture
    recompute = remat_recompute(cfg.layers)
    train_fwd = {c: sum(n for k, n in ls["conv3x3"].items() if k[0] == conv3x3.TRAIN_FWD)
                 for c, ls in ((False, launches), (True, launches_r))}
    want_r = dict(counts, gn_moments=counts["gn_moments"] + recompute["stats"],
                  gn_apply=counts["gn_apply"] + recompute["stats"],
                  conv3x3=counts["conv3x3"] + recompute["conv"])
    want_kinds = dict(kinds, **{k: kinds[k] + recompute[k] for k in ("halo", "crop", "stats")})
    check(counts_r == want_r and kinds_r == want_kinds
          and train_fwd[True] == train_fwd[False] + recompute["conv"],
          f"remat split step calls {counts_r} / exchanges {kinds_r} != the derived {want_r} / "
          f"{want_kinds} (recompute {recompute})")
    peaks = {p: {"one_rank": single[i][4], "rank0_of_2": ranks[0][j][4],
                 "rank1_of_2": ranks[1][j][4]}
             for p, i, j in (("patch", 0, 3), ("128^3", 1, 4), ("patch, remat", 2, 6),
                             ("128^3, remat", 3, 7))}
    wall = {p: {"one_rank": single[i][5], "two_ranks_gloo": ranks[0][j][5]}
            for p, i, j in (("patch", 0, 3), ("128^3", 1, 4), ("patch, remat", 2, 6),
                            ("128^3, remat", 3, 7))}
    print(f"[16] peak GiB per rank (torch.cuda.max_memory_allocated in each rank's process): "
          f"{peaks}; step wall ms (the second step of each process, synchronized; two ranks "
          f"share one card over gloo, which stages through the host: not a scaling figure): "
          f"{wall} ({single_s:.1f} s for the one-rank spawn)", flush=True)
    out.update(loss_rel=loss_rel, loss_rel_f32=loss_rel32, leaf_worst=[worst, kf, pf],
               leaf_median_ratio=med, plain_f32_leaf_worst=list(plain_leaf),
               plain_f32_leaf_median=plain_median, plain_to_f64_median=med64,
               plain_to_f64_worst=worst64,
               plain_f32_leaves_above_1e5=sum(v > 1e-5 for v in plain_rels.values()),
               fault={"worst": [f_worst, f_kf, f_pf], "median_ratio": f_med, "caught": not f_ok},
               calls=counts, exchanges=kinds, peak_gib=peaks, step_ms=wall, spawn_s=spawn_s,
               remat={"loss_rel": remat_loss_rel, "worst_leaf": list(remat_leaf),
                      "leaf_worst": [r_worst, r_kf, r_pf], "leaf_median_ratio": r_med,
                      "calls": counts_r, "exchanges": kinds_r, "recompute": recompute},
               gathered_mb={"organ_probs_bf16": 2 * (NC - 1) * int(np.prod(PATCH)) / 2**20,
                            "catlas_bf16": 2 * (NC - 1) * int(np.prod(PATCH)) / 2**20,
                            "labels_int64": 8 * int(np.prod(PATCH)) / 2**20})

    # 4. every kernel at every shape the path launched, against its plain version
    print("[16] the spatial step's calls on rank 0, kernel vs plain at shapes not checked yet",
          flush=True)
    train_table, gn_table, gn_bwd_table, nograd_table, fold_table, rfwd_table, rbwd_table = tables
    keys = {k: set(launches[k]) | set(launches_r[k]) for k in launches}
    bwd_tables = phase_gn_bwd_split(dev, results, keys["gn_bwd_sums"])
    split_tables = phase_gn_split(dev, results, keys["gn_moments"], keys["gn_apply"])
    train_table = dict(train_table)
    train_table.update(phase_train_conv(dev, results, {
        k for k in keys["conv3x3"] if k[0] == conv3x3.TRAIN_FWD
        and (k[1], k[2], *k[3:7]) not in train_table}))
    more = phase_resize(dev, results, keys["resize"] - set(rfwd_table),
                        keys["resize_backward"] - set(rbwd_table))
    rfwd_table, rbwd_table = {**rfwd_table, **more[0]}, {**rbwd_table, **more[1]}
    missing = ({k for k in keys["conv3x3"] if k[0] in (conv3x3.FUSED, conv3x3.PROLOGUE_OFF)}
               - set(nograd_table)) | (keys["gn_relu"] - set(gn_table)) | (
        keys["gn_relu_backward"] - set(gn_bwd_table)) | (keys["fold"] - set(fold_table))
    check(not missing, f"the spatial step launched shapes phase 6 did not check: {missing}")
    results["spatial_step"] = out

    train_specs = (conv3x3.TRAIN_FWD, conv3x3.TRAIN_DX, conv3x3.PROLOGUE_OFF)

    def entry(label, src, replaces, n, rows):
        check(n > 0 and rows, f"the spatial step launched no {label}")
        if rows:
            entries.append(kernel_entry(f"{label}, {tag}", src, replaces, n, rows))

    entries = []
    for tag, launches in (
            (f"spatial train step --mesh space:{SPACE_N}, rank 0 of {SPACE_N} (gloo, one card)",
             launches),
            (f"spatial train step with remat --mesh space:{SPACE_N}, rank 0 of {SPACE_N} (gloo, "
             "one card)", launches_r)):
        spatial_step_entries(entry, launches, train_specs, train_table, nograd_table,
                             split_tables, bwd_tables, gn_table, gn_bwd_table, fold_table,
                             rfwd_table, rbwd_table)
    return entries


def spatial_step_entries(entry, launches, train_specs, train_table, nograd_table, split_tables,
                         bwd_tables, gn_table, gn_bwd_table, fold_table, rfwd_table, rbwd_table):
    """Phase 16: ``entry(label, source, replaces, launches, rows)`` for each
    kernel of one spatial step's ``launches``, its rows from the tables."""
    from multimodal_pl_tpu_torch.ops import conv3x3

    for label, specs, replaces in (
            ("conv3x3_train: conv3x3_gn prologue off (forward and dx on halo-extended slabs; "
             "gradient-free refiner)", train_specs, K2),
            ("conv3x3_gn fused GN-ReLU prologue, refiner gradient-free pass", (conv3x3.FUSED,),
             K2_GN)):
        calls_ = {k: n for k, n in launches["conv3x3"].items() if k[0] in specs}
        entry(label, SOURCE, replaces, sum(calls_.values()),
              conv_rows(specs, calls_, train_table, nograd_table))
    for key, label, src, replaces, table_ in (
            ("gn_moments", "gn_moments_bf16 (slab statistics)", GN_SOURCE,
             SPACE_REPLACES["moments"], split_tables[0]),
            ("gn_apply", "gn_apply_bf16 (normalize from merged statistics)", GN_SOURCE,
             SPACE_REPLACES["apply"], split_tables[1]),
            ("gn_bwd_sums", "gn_bwd_sums_bf16 (slab sums of the GroupNorm -> ReLU backward)",
             GN_SOURCE, GN_BWD_SPLIT, bwd_tables[0]),
            ("gn_bwd_dx", "gn_bwd_dx_bf16 (dx from the merged sums, slab ds and dt)", GN_SOURCE,
             GN_DX_SPLIT, bwd_tables[1]),
            ("gn_relu", "gn_relu forward (gn_relu_fwd_bf16), refiner", GN_SOURCE, GN_RELU,
             gn_table),
            ("gn_relu_backward", "gn_relu backward (gn_relu_bwd_bf16), refiner", GN_SOURCE,
             GN_BWD, gn_bwd_table),
            ("fold", "group_norm_fold statistics (gn_fold_bf16), refiner gradient-free pass",
             GN_SOURCE, GN_FOLD, fold_table),
            ("resize", "resize3d forward (x2/x4/x8 on halo-extended slabs; refiner)",
             RESIZE_SOURCE, RESIZE, rfwd_table),
            ("resize_backward", "resize3d backward (gather form; slabs and refiner)",
             RESIZE_SOURCE, RESIZE_BWD, rbwd_table)):
        entry(label, src, replaces, sum(launches[key].values()),
              [(n, table_[k]) for k, n in launches[key].items()])


# phase 17: raw NIfTI to label maps with the port alone: mpl-preprocess-torch
# and mpl-atlas-torch (host work, numpy and scipy), then mpl-train-torch and
# mpl-evaluate-torch on what they wrote
ASSET_CASES = (8, 2)                      # raw CT (ids 40 .. 430) and MRI cases
ASSET_SHAPE = (64, 96, 80)                # a synthetic case (Z, Y, X) before its air margin
ASSET_SPACING = (0.8, 0.8, 2.5)           # world (x, y, z) voxel size of a raw scan
ASSET_LAYOUT = ((1, 2, 0), (-1, 1, -1))   # index axes along world y, z, x; x, z reversed
ASSET_TILE = "64,64,64"                   # the training patch and evaluation tile (D, H, W)
ASSET_EPOCHS, ASSET_BATCH = 2, 2
NO_PORT_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "multimodal_pl_tpu")


def make_raw_scans(root: str) -> list:
    """Phase 17's raw scans under ``root``: synthetic cases with 5 voxels of
    air around them (-1000 for CT, whose tissue is lifted by 100 so that the
    411-500 body threshold of 25 finds a body; 0 for MRI), stored in the
    ASSET_LAYOUT at ASSET_SPACING as a scanner writes them, and the first
    case stored RAS at the same voxel size under ``root``/ras; returns the
    case ids."""
    from multimodal_pl_tpu_torch.data.nifti import read_nifti
    from multimodal_pl_tpu_torch.utils.synthetic import (make_synthetic_amos, scanner_layout,
                                                         write_nifti_affine)

    make_synthetic_amos(root, n_ct=ASSET_CASES[0], n_mri=ASSET_CASES[1], shape=ASSET_SHAPE,
                        seed=17)
    ids = []
    for name in sorted(os.listdir(os.path.join(root, "labelsTr"))):
        cid = int(name.split("_")[1].split(".")[0])
        paths = (os.path.join(root, "imagesTr", name.replace(".nii", "_0000.nii")),
                 os.path.join(root, "labelsTr", name))
        ct = cid < 500
        image = np.pad(read_nifti(paths[0]).data + (100 if ct else 0), 5,
                       constant_values=-1000 if ct else 0).astype(np.float32)
        label = np.pad(read_nifti(paths[1]).data, 5)
        for path, vol in zip(paths, (image, label)):
            write_nifti_affine(path, *scanner_layout(vol, *ASSET_LAYOUT, ASSET_SPACING))
            if not ids:
                os.makedirs(os.path.join(root, "ras"), exist_ok=True)
                write_nifti_affine(os.path.join(root, "ras", os.path.basename(path)),
                                   *scanner_layout(vol, (0, 1, 2), (1, 1, 1), ASSET_SPACING))
        ids.append(cid)
    return ids


def phase_assets(dev, tmp):
    """Phase 17: raw synthetic scans in a non-RAS layout at another voxel
    size through mpl-preprocess-torch and mpl-atlas-torch (their ``main``),
    then ASSET_EPOCHS epochs of mpl-train-torch (kernel route, full width,
    ASSET_TILE patches, B = ASSET_BATCH) and mpl-evaluate-torch on its
    checkpoint over the test split. Checks: every written case at spacing
    (1, 1, 2), image and label of one shape; a scan of the first case stored
    RAS preprocesses to the same bytes as its non-RAS scan; the atlas
    (13, D, H, W) within the cases' shapes, finite, in [0, 1]; the csv one
    row per case; training finite, launching every training kernel and
    evaluation every serving kernel (counts set to 0 before each); a label
    map per test case of the shape the dataset serves it at (D, H, W, padded
    to the tile), labels < 14; and no module of JAX or of the JAX package
    loaded. Returns the record."""
    import contextlib
    import csv
    import gzip
    import io
    from collections import Counter

    from multimodal_pl_tpu_torch.cli import atlas as atlas_cli
    from multimodal_pl_tpu_torch.cli import evaluate, train
    from multimodal_pl_tpu_torch.cli import preprocess as preprocess_cli
    from multimodal_pl_tpu_torch.data.dataset import AMOSDataset
    from multimodal_pl_tpu_torch.data.nifti import read_nifti
    from multimodal_pl_tpu_torch.data.preprocess import preprocess_case
    from multimodal_pl_tpu_torch.ops import conv3x3
    from multimodal_pl_tpu_torch.tools.spawn import _launch_counts, _reset_launch_counts
    from multimodal_pl_tpu_torch.train.checkpoint import latest_checkpoint

    tile = tuple(int(v) for v in ASSET_TILE.split(","))
    t0 = time.perf_counter()
    raw, data = os.path.join(tmp, "raw"), os.path.join(tmp, "data")
    ids = make_raw_scans(raw)
    raw_s = time.perf_counter() - t0
    log = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        preprocess_cli.main(["--images_dir", os.path.join(raw, "imagesTr"),
                             "--out_images", os.path.join(data, "imagesTr"),
                             "--out_labels", os.path.join(data, "labelsTr")])
        atlas_cli.main(["--labels_dir", os.path.join(data, "labelsTr"),
                        "--out_atlas", os.path.join(data, "atlas_mm.npy"),
                        "--out_csv", os.path.join(data, "supervise_mask.csv")])
    assets_s = time.perf_counter() - t1
    lines = log.getvalue().splitlines()
    check(lines[0] == f"Totally {len(ids)} files." and len(lines) == len(ids) + 3,
          f"mpl-preprocess-torch / mpl-atlas-torch printed {lines}")
    shapes = {}
    for cid in ids:
        img = read_nifti(os.path.join(data, "imagesTr", f"amos_{cid:04d}_0000.nii.gz"))
        lab = read_nifti(os.path.join(data, "labelsTr", f"amos_{cid:04d}.nii.gz"))
        check(img.spacing == lab.spacing == (1.0, 1.0, 2.0) and img.data.shape == lab.data.shape
              and lab.data.max() < 14, f"case {cid}: spacing {img.spacing} {lab.spacing}, "
              f"shapes {img.data.shape} {lab.data.shape}, labels < {lab.data.max() + 1}")
        shapes[cid] = img.data.shape

    # the first case's scan stored RAS gives the same bytes
    first = ids[0]
    names = (f"amos_{first:04d}_0000.nii.gz", f"amos_{first:04d}.nii.gz")
    preprocess_case(*(os.path.join(raw, "ras", n) for n in names),
                    *(os.path.join(tmp, "ras_out", n) for n in names), first)

    def unzipped(path):
        with gzip.open(path, "rb") as f:
            return f.read()

    twin_ok = all(unzipped(os.path.join(tmp, "ras_out", n)) == unzipped(os.path.join(data, d, n))
                  for n, d in zip(names, ("imagesTr", "labelsTr")))

    atlas = np.load(os.path.join(data, "atlas_mm.npy"))
    dims = np.array(list(shapes.values()))
    check(atlas.dtype == np.float32 and atlas.shape[0] == 13
          and all(dims[:, i].min() <= atlas.shape[1 + i] <= dims[:, i].max() for i in range(3))
          and np.isfinite(atlas).all() and 0 <= atlas.min() and atlas.max() <= 1,
          f"atlas {atlas.dtype} {atlas.shape} against case shapes {sorted(shapes.values())}")
    with open(os.path.join(data, "supervise_mask.csv")) as f:
        rows = list(csv.reader(f))
    check(rows[0] == ["name", "mask"] and [r[0] for r in rows[1:]] ==
          [f"amos_{cid:04d}" for cid in ids] and all(
              len(r[1]) == 14 and r[1].count("1") == (cid < 500) for r, cid in zip(rows[1:], ids)),
          f"supervise_mask.csv rows {rows}")
    print(f"[17] {len(ids)} raw scans (ids {ids}) in a non-RAS layout at {ASSET_SPACING} "
          f"({raw_s:.1f} s to write); mpl-preprocess-torch and mpl-atlas-torch "
          f"({assets_s:.1f} s): every case at spacing (1, 1, 2), shapes "
          f"{sorted(set(shapes.values()))}; the RAS twin of case {first} the same bytes: "
          f"{twin_ok}; atlas {atlas.shape}, csv {len(rows) - 1} rows", flush=True)
    check(twin_ok, f"case {first} stored RAS preprocesses to other bytes than its raw scan")

    snap = os.path.join(tmp, "snap17")
    t2 = time.perf_counter()
    _reset_launch_counts()
    state = train.main(["--data_dir", os.path.join(data, "imagesTr"),
                        "--atlas_path", os.path.join(data, "atlas_mm.npy"),
                        "--supervision_csv", os.path.join(data, "supervise_mask.csv"),
                        "--snapshot_dir", snap, "--input_size", ASSET_TILE,
                        "--batch_size", str(ASSET_BATCH), "--num_epochs", str(ASSET_EPOCHS),
                        "--log_every", "1", "--device_data", "false", "--device", str(dev)])
    train_calls = _launch_counts()
    train_s = time.perf_counter() - t2
    ckpt = latest_checkpoint(snap)
    with open(os.path.join(snap, "train.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
    check(ckpt is not None and int(state.step) > 0 and len(losses) == int(state.step)
          and all(np.isfinite(losses)), f"training: checkpoint {ckpt}, losses {losses}")
    spec = Counter(k[0] for k in train_calls["conv3x3"].elements())
    train_counts = {"conv3x3": dict(spec), **{k: sum(train_calls[k].values()) for k in (
        "gn_relu", "gn_relu_backward", "fold", "resize", "resize_backward")}}
    check(all(spec[k] > 0 for k in conv3x3.SPECS) and all(v > 0 for v in train_counts.values()
                                                         if isinstance(v, int)),
          f"mpl-train-torch left a training kernel unlaunched: {train_counts}")

    out_dir = os.path.join(tmp, "eval17")
    t3 = time.perf_counter()
    _reset_launch_counts()
    evaluate.main(["--data_dir", os.path.join(data, "imagesTr"),
                   "--atlas_path", os.path.join(data, "atlas_mm.npy"), "--reload_path", ckpt,
                   "--save_path", out_dir, "--usage", "test", "--input_size", ASSET_TILE,
                   "--print", "true", "--device", str(dev)])
    eval_calls = _launch_counts()
    eval_s = time.perf_counter() - t3
    espec = Counter(k[0] for k in eval_calls["conv3x3"].elements())
    eval_counts = {"conv3x3": dict(espec), **{k: sum(eval_calls[k].values())
                                              for k in ("gn_relu", "fold", "resize")}}
    check(all(espec[k] > 0 for k in (conv3x3.FUSED, conv3x3.PROLOGUE_OFF))
          and all(eval_counts[k] > 0 for k in ("gn_relu", "fold", "resize")),
          f"mpl-evaluate-torch left a serving kernel unlaunched: {eval_counts}")
    maps = {int(f.split("_")[0]): read_nifti(os.path.join(out_dir, f)).data
            for f in sorted(os.listdir(out_dir)) if f.endswith("_pred.nii.gz")}
    test = AMOSDataset(os.path.join(data, "imagesTr"), crop_size=tile, usage="test",
                       atlas=atlas)
    labels = {s.case_id: s.label.shape for s in (test[i] for i in range(len(test)))}
    check(sorted(maps) == sorted(labels) and all(
        m.shape == labels[cid] and m.max() < 14 for cid, m in maps.items()),
          f"label maps {[(cid, m.shape, int(m.max())) for cid, m in maps.items()]} against "
          f"the test split's volumes {labels}")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in NO_PORT_MODULES)
    print(f"[17] mpl-train-torch, {int(state.step)} steps in {ASSET_EPOCHS} epochs at "
          f"{ASSET_TILE}, B = {ASSET_BATCH} ({train_s:.1f} s), losses finite, kernel calls "
          f"{train_counts}; mpl-evaluate-torch on {os.path.basename(ckpt)} ({eval_s:.1f} s): "
          f"label maps of cases {sorted(maps)}, kernel calls {eval_counts}; modules of JAX or "
          f"the JAX package loaded: {loaded}", flush=True)
    check(not loaded, f"modules of JAX or the JAX package loaded: {loaded}")
    return {"ids": ids, "shapes": {str(k): v for k, v in shapes.items()},
            "atlas_shape": atlas.shape, "steps": int(state.step), "losses": losses,
            "train_calls": train_counts, "eval_calls": eval_counts, "maps": sorted(maps),
            "raw_s": raw_s, "assets_s": assets_s, "train_s": train_s, "eval_s": eval_s}


# phase 18: the train step's ablation ladder (tools/step_ablate.py) at the
# production shape; flip-TTA serving at full width, where the 8 flips fold
# into each window batch (4 tiles become 32, and the full-resolution
# tensors pass 2^31 elements); the kernels at those shapes; ensembles
TTA_TILES = 8 * WINDOW_BATCH      # tiles per forward with flip TTA
BIG_ROWS = (0, TTA_TILES - 1)     # the rows of a 32-tile output held against plain
LADDER_STEPS = 3                  # timed steps per rung
# with the refiner off the step drops the consistency term too (the JAX
# ladder's construction), so these two rungs run one program
SAME_STEP = ("norefiner", "segonly")
ENSEMBLE_REL = 1e-6               # two members' blend vs the mean of theirs: f32 order only


def phase_ladder(dev, results):
    """Phase 18: the ladder at B = PROD_B x PATCH on the kernel route,
    LADDER_STEPS timed steps and 3 profiled steps per rung. The full rung's
    new state is TrainStep's bit for bit (the step is deterministic); each
    hand-written kernel's calls per step do not increase down the ladder, nor
    do the kernel launches per step (profiler) where a rung drops work; the
    rungs of SAME_STEP run one program, so their metrics are bit-equal step
    for step and their launch counts differ only by the profiler's spread
    between runs, which is printed; every rung's losses are finite. Returns
    the hand-written kernels' calls of the whole ladder run ({'conv3x3',
    ...}: Counter by key)."""
    from collections import Counter

    from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu, norm, resize
    from multimodal_pl_tpu_torch.tools import step_ablate
    from multimodal_pl_tpu_torch.train.loop import to_device
    from multimodal_pl_tpu_torch.train.state import build_models, create_train_state
    from multimodal_pl_tpu_torch.train.step import TrainStep

    cfg = step_ablate.step_config("kernel")
    models = tuple(m.to(dev) for m in build_models(cfg))
    batch = to_device(step_ablate.ladder_batch(PATCH, PROD_B), cfg, dev)
    lr, wf = (torch.tensor(v, device=dev) for v in (step_ablate.LR, step_ablate.WF))
    state = create_train_state(torch.Generator().manual_seed(0), cfg).to(dev)
    got = step_ablate.AblatedStep(*models, cfg)(state, batch, lr, wf)[0]
    want = TrainStep(*models, cfg)(state, batch, lr, wf)[0]
    trees = [(g, getattr(got, g), getattr(want, g)) for g in ("params", "rparams", "dparams",
                                                               "tokens")]
    trees += [(f"momentum{i}", got.momentum[i], want.momentum[i]) for i in range(2)]
    differ = [f"{name}.{k}" for name, a, b in trees for k in b if not torch.equal(a[k], b[k])]
    leaves = sum(len(b) for _, _, b in trees)
    print(f"[18] ladder's full rung vs TrainStep, B={PROD_B} x {PATCH}: {leaves - len(differ)} of "
          f"{leaves} state tensors bit-equal", flush=True)
    check(not differ, f"the full rung's new state differs from TrainStep's at {differ[:5]}")
    del got, want, state, models, batch
    torch.cuda.empty_cache()

    counters = {"conv3x3": conv3x3.launches, "gn_relu": gn_relu.launches,
                "gn_relu_backward": gn_relu.bwd_launches, "fold": norm.fold_launches,
                "resize": resize.launches, "resize_backward": resize.bwd_launches}
    conv3x3.reset_launches()
    gn_relu.reset_launches()
    norm.fold_launches.clear()
    resize.reset_launches()
    rungs = step_ablate.run_ladder(PATCH, PROD_B, "kernel", steps=LADDER_STEPS, device=dev,
                                   say=lambda s: print("  " + s, flush=True))
    calls = {k: Counter(v) for k, v in counters.items()}
    spread = None
    for a, b in zip(rungs, rungs[1:]):
        if (a["name"], b["name"]) == SAME_STEP:
            check(a["metrics"] == b["metrics"] and a["kernel_calls"] == b["kernel_calls"],
                  f"{b['name']} is not {a['name']}'s step: metrics {b['metrics']}, calls "
                  f"{b['kernel_calls']} against {a['metrics']}, {a['kernel_calls']}")
            spread = b["launches"] - a["launches"]
        else:
            check(b["launches"] <= a["launches"],
                  f"launches per step rise from {a['name']} ({a['launches']}) to {b['name']} "
                  f"({b['launches']})")
        for kind, n in b["kernel_calls"].items():
            check(n <= a["kernel_calls"][kind], f"{kind} calls per step rise from {a['name']} "
                  f"({a['kernel_calls'][kind]}) to {b['name']} ({n})")
    for r in rungs:
        check(all(np.isfinite(m["loss"]) for m in r["metrics"]),
              f"rung {r['name']}: losses {[m['loss'] for m in r['metrics']]}")
    print(f"[18] ladder, B={PROD_B} x {PATCH}, kernel route: launches per step "
          f"{[(r['name'], r['launches']) for r in rungs]}; hand-written kernel calls per step "
          f"{[(r['name'], sum(r['kernel_calls'].values())) for r in rungs]}; {SAME_STEP} one "
          f"program, bit-equal metrics, launches differ by {spread} (the profiler's spread)",
          flush=True)
    results["ladder"] = {"rungs": rungs, "full_vs_train_step": "bit-equal", "leaves": leaves,
                         "same_step_launch_spread": spread}
    return calls


def _rows_err(out, plain_rows):
    """(max over BIG_ROWS of max|out[r] - plain of row r alone|, of
    max|plain|)."""
    err = scale = 0.0
    for r in BIG_ROWS:
        p = plain_rows(slice(r, r + 1)).float()
        err = max(err, (out[r:r + 1].float() - p).abs().max().item())
        scale = max(scale, p.abs().max().item())
    return err, scale


def _in_pairs(fn, b):
    """fn over the batch rows two at a time: the plain version over the
    whole 32-tile batch, as the check takes it."""
    def run():
        for i in range(0, b, 2):
            fn(slice(i, i + 2))
    return run


def phase_big_tiles(dev, results, calls):
    """Phase 18: every kernel of the TTA forward at its full-resolution
    shapes (32 tiles, past 2^31 elements) against its plain version: the
    conv3x3_gn calls, gn_relu forward and the fold at 64 x 192 x 192, and
    the x2 upsample + skip into it. Rows 0 and 31 of the kernel's output
    against the plain version on that row alone (conv, gn_relu, resize
    within 1e-2 * max|plain|, the fold's rows within FOLD_REL). Times: the
    kernel; the plain version over all rows, two at a time; the library
    call. Returns {kind: {key: row}}."""
    import torch.nn.functional as F

    from multimodal_pl_tpu_torch.ops import conv3x3, resize
    from multimodal_pl_tpu_torch.ops.conv import standardize_kernel
    from multimodal_pl_tpu_torch.ops.gn_relu import group_norm_relu, group_norm_relu_reference
    from multimodal_pl_tpu_torch.ops.norm import group_norm_fold

    full = tuple(TILE)
    gen = torch.Generator(device=dev).manual_seed(18)
    g = torch.Generator().manual_seed(18)
    bf = torch.bfloat16

    def randn(shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def affine(c):
        return ((1 + 0.1 * torch.randn(c, generator=g)).to(dev),
                (0.1 * torch.randn(c, generator=g)).to(dev))

    def report(kind, key, row, limit_ok, note=""):
        row.update(kind=kind, key=list(key))
        results["big_tiles"].append(row)
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.3f} ms"
        print(f"  {kind} {key}: {row['elements']:.3e} elements; rows {list(BIG_ROWS)} vs plain "
              f"{note}; kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library {lib}, "
              f"bound {row['bound_ms']:.3f} ms", flush=True)
        check(limit_ok, f"{kind} at {key} past 2^31 elements disagrees with plain: {row}")
        torch.cuda.empty_cache()
        return row

    out = {"conv3x3": {}, "gn_relu": {}, "fold": {}, "resize": {}}
    for key in sorted(k for k in calls["conv3x3"] if tuple(k[4:7]) == full):
        spec, cin, cout, b, d, h, w, with_res = key
        x = randn((b, d, h, w, cin))
        wt = standardize_kernel(torch.randn((cout, cin, 3, 3, 3), generator=g)).to(dev, bf)
        a = bb = res = None
        t = x
        if spec == conv3x3.FUSED:
            a, bb = 1 + 0.1 * randn((b, cin), torch.float32), 0.1 * randn((b, cin), torch.float32)
            t = torch.empty_like(x)  # the library's input: already normalized
            for i in range(b):
                t[i] = torch.relu(x[i].float() * a[i] + bb[i]).to(bf)
        if with_res:
            res = randn((b, d, h, w, cout))

        def plain(s):
            return conv3x3.conv3x3_gn_reference(x[s], wt, None if a is None else a[s],
                                                None if bb is None else bb[s],
                                                None if res is None else res[s])

        k = conv3x3.conv3x3_gn(x, wt, a, bb, res)
        err, scale = _rows_err(k, plain)
        del k
        t_cl = t.permute(0, 4, 1, 2, 3)
        row = {"elements": b * d * h * w * max(cin, cout), "max_abs_err": err,
               "max_abs_plain": scale, "ms": time_ms(lambda: conv3x3.conv3x3_gn(x, wt, a, bb, res), 3),
               "plain_ms": time_ms(_in_pairs(plain, b), 1), "library_ms": time_ms(lambda: F.conv3d(t_cl, wt, padding=1), 3),
               **conv_bound(b, d, h, w, cin, cout, spec == conv3x3.FUSED, with_res)}
        out["conv3x3"][key] = report("conv3x3_gn", key, row, err <= 1e-2 * scale,
                                     f"max|k-p| {err:.3g} (max|p| {scale:.3g})")
        del x, t, t_cl, res, a, bb
    for key in sorted(k for k in calls["gn_relu"] if tuple(k[3:6]) == full):
        c, groups, b, d, h, w = key
        x = randn((b, d, h, w, c)) * 2 + 0.5
        sc, bi = affine(c)
        with torch.no_grad():
            k = group_norm_relu(x, sc, bi, groups)
            err, scale = _rows_err(k, lambda s: group_norm_relu_reference(x[s], sc, bi, groups))
            del k
            x_cl = x.permute(0, 4, 1, 2, 3)
            row = {"elements": x.numel(), "max_abs_err": err, "max_abs_plain": scale,
                   "ms": time_ms(lambda: group_norm_relu(x, sc, bi, groups), 3),
                   "plain_ms": time_ms(_in_pairs(
                       lambda s: group_norm_relu_reference(x[s], sc, bi, groups), b), 1),
                   "library_ms": time_ms(lambda: _gn_library(x_cl, groups, sc.to(bf), bi.to(bf)), 3),
                   **bound(0.0, 4 * x.numel() + 8 * c)}
        out["gn_relu"][key] = report("gn_relu forward", key, row, err <= 1e-2 * scale,
                                     f"max|k-p| {err:.3g} (max|p| {scale:.3g})")
        del x, x_cl
    for key in sorted(k for k in calls["fold"] if tuple(k[3:6]) == full):
        c, groups, b, d, h, w = key
        x = randn((b, d, h, w, c)) * 2 + 0.5
        sc, bi = affine(c)
        ka, kb = group_norm_fold(x, sc, bi, groups, impl="kernel")
        rel = err = 0.0
        for r in BIG_ROWS:
            pa, pb = group_norm_fold(x[r:r + 1], sc, bi, groups)
            for kt, pt in ((ka[r:r + 1], pa), (kb[r:r + 1], pb)):
                err = max(err, (kt - pt).abs().max().item())
                rel = max(rel, ((kt - pt).abs().max() / pt.abs().max()).item())
        row = {"elements": x.numel(), "rel": rel, "max_abs_err": err,
               "ms": time_ms(lambda: group_norm_fold(x, sc, bi, groups, impl="kernel"), 3),
               "plain_ms": time_ms(_in_pairs(lambda s: group_norm_fold(x[s], sc, bi, groups), b), 1),
               "library_ms": None,  # no library call gives GroupNorm statistics alone
               **bound(0.0, 2 * x.numel() + 4 * (2 * b * c + 2 * c))}
        out["fold"][key] = report("fold", key, row, rel <= FOLD_REL, f"rel {rel:.3g}")
        del x, ka, kb
    for key in sorted((k for k in calls["resize"] if tuple(v * k[0] for v in k[4:7]) == full),
                      key=str):
        factor, c, dtype, b, d, h, w, with_skip = key
        x = randn((b, d, h, w, c), getattr(torch, dtype))
        sk = randn((b, *full, c), getattr(torch, dtype)) if with_skip else None
        k = resize.upsample_trilinear(x, factor, sk)
        err, scale = _rows_err(k, lambda s: resize.upsample_trilinear_reference(
            x[s].float(), factor, None if sk is None else sk[s].float()))
        del k
        x_cf = x.permute(0, 4, 1, 2, 3)
        row = {"elements": b * c * factor ** 3 * d * h * w, "max_abs_err": err,
               "max_abs_plain": scale,
               "ms": time_ms(lambda: resize.upsample_trilinear(x, factor, sk), 3),
               "plain_ms": time_ms(_in_pairs(lambda s: resize.upsample_trilinear_reference(
                   x[s], factor, None if sk is None else sk[s]), b), 1),
               "library_ms": time_ms(lambda: F.interpolate(x_cf, scale_factor=factor,
                                                           mode="trilinear"), 3),
               **resize_bound(key)}
        out["resize"][key] = report("resize3d forward", key, row, err <= 1e-2 * scale,
                                    f"max|k-p| {err:.3g} (max|p| {scale:.3g})")
        del x, sk, x_cf
    check(all(out.values()), f"a kernel of the TTA forward has no full-resolution shape: "
          f"{ {k: list(v) for k, v in out.items()} }")
    return out


def phase_tta(dev, results, model, plain, vol):
    """Phase 18: flip-TTA serving at window batch WINDOW_BATCH, bf16, argmax,
    over phase 4's volume, kernel route against the plain route with the
    same weights: label agreement >= 0.95; the kernels' calls per volume
    as phase 4's (the flips fold into the batch), each call at TTA_TILES
    tiles. Then each kernel at the forward's full-resolution shapes
    (phase_big_tiles). Returns (calls per volume {kind: Counter}, window
    batches per volume, phase_big_tiles' rows)."""
    from collections import Counter

    from multimodal_pl_tpu_torch.infer.sliding import (
        SlidingWindowPredictor, make_window_grid, pad_to_bucket)
    from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu, norm, resize

    def predictor(net):
        return SlidingWindowPredictor(lambda t: net(t, aux=False), TILE, NC,
                                      window_batch=WINDOW_BATCH, tta=True,
                                      compute_dtype=torch.bfloat16, device=dev, output="argmax")

    pred = predictor(model)
    pred(vol)  # warm-up: the library picks its algorithms at the 32-tile batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    conv3x3.reset_launches()
    norm.fold_launches.clear()
    gn_relu.reset_launches()
    resize.reset_launches()
    t0 = time.perf_counter()
    labels = pred(vol)
    torch.cuda.synchronize()
    s_vol = time.perf_counter() - t0
    calls = {"conv3x3": Counter(conv3x3.launches), "fold": Counter(norm.fold_launches),
             "gn_relu": Counter(gn_relu.launches), "resize": Counter(resize.launches)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    totals = conv3x3.launch_totals()
    torch.cuda.reset_peak_memory_stats()
    agree = (predictor(plain)(vol) == labels).float().mean().item()
    plain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batches = -(-len(make_window_grid(pad_to_bucket(VOL, tile=TILE), TILE)) // WINDOW_BATCH)
    tiles = ({k[3] for k in calls["conv3x3"]} | {k[2] for k in calls["fold"]}
             | {k[2] for k in calls["gn_relu"]} | {k[3] for k in calls["resize"]})
    n = {kind: sum(c.values()) for kind, c in calls.items()}
    results["tta"] = {"s_per_vol": s_vol, "peak_gib": peak, "plain_peak_gib": plain_peak,
                      "label_agreement": agree, "calls": n, "conv_totals": totals,
                      "tile_batches": sorted(tiles), "window_batches": batches}
    print(f"[18] flip TTA, {VOL} volume, window batch {WINDOW_BATCH} ({batches} forwards of "
          f"{sorted(tiles)} tiles), bf16, argmax: {s_vol:.3f} s/vol, peak {peak:.2f} GiB (plain "
          f"route {plain_peak:.2f} GiB); calls {totals} + fold {n['fold']} + gn_relu "
          f"{n['gn_relu']} + resize3d {n['resize']}; label agreement with plain {agree:.5f}",
          flush=True)
    check(totals == {conv3x3.FUSED: 54, conv3x3.PROLOGUE_OFF: 12, conv3x3.TRAIN_FWD: 0,
                     conv3x3.TRAIN_DX: 0}, f"TTA launches {totals} != phase 4's 54 + 12")
    check(n["fold"] == 54 and n["gn_relu"] == 51 and n["resize"] == 12,
          f"TTA calls {n} != phase 4's fold 54, gn_relu 51, resize3d 12")
    check(tiles == {TTA_TILES}, f"TTA kernel calls at batches {tiles}, not {TTA_TILES}")
    check(agree >= 0.95, f"TTA label agreement with the plain model {agree} < 0.95")
    del pred, labels
    torch.cuda.empty_cache()
    print(f"[18] the kernels at the TTA forward's full-resolution shapes ({TTA_TILES} tiles), "
          f"rows {list(BIG_ROWS)} against plain", flush=True)
    return calls, batches, phase_big_tiles(dev, results, calls)


def phase_ensemble(dev, results, model, vol):
    """Phase 18: at the predictor level, a two-member ensemble of the kernel
    route with flip TTA (the evaluator's ``ensemble_forward``) blends to the
    mean of the members' own blended logits within ENSEMBLE_REL of its
    largest magnitude (the blend is linear; only the f32 order of sums
    differs)."""
    from multimodal_pl_tpu_torch.cli.evaluate import ensemble_forward
    from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
    from multimodal_pl_tpu_torch.models import UNet3DFEAM

    other = UNet3DFEAM(deep_up=True, conv_impl="kernel",
                       generator=torch.Generator().manual_seed(1)).to(dev).eval()

    def logits(members):
        return SlidingWindowPredictor(ensemble_forward(members), TILE, NC,
                                      window_batch=WINDOW_BATCH, tta=True,
                                      compute_dtype=torch.bfloat16, device=dev)(vol)

    with torch.inference_mode():
        both = logits([model, other])
        mean = (logits([model]) + logits([other])) / 2
        rel = ((both - mean).abs().max() / mean.abs().max()).item()
    results["ensemble_rel"] = rel
    print(f"[18] ensemble of two with flip TTA over {VOL}: blend vs the mean of the members' "
          f"blends, max|diff| / max = {rel:.3e}", flush=True)
    check(rel <= ENSEMBLE_REL, f"two-member blend {rel} from the members' mean > {ENSEMBLE_REL}")
    del other, both, mean
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

    # phase 10's cases at the AMOS grid take a minute of numpy and gzip, and
    # phase 15's fixture 15 s: one worker process makes them while phases 1-9 run
    with (tempfile.TemporaryDirectory() as tmp,
          ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as maker):
        amos_data = maker.submit(make_synthetic_amos, os.path.join(tmp, "amos"),
                                 n_ct=AMOS_CASES[0], n_mri=AMOS_CASES[1], shape=AMOS_GRID,
                                 seed=4, spread_ids=False)
        campaign_data = maker.submit(make_campaign, os.path.join(tmp, "campaign"))
        return run_phases(amos_data, campaign_data)


def run_phases(amos_data, campaign_data) -> int:
    """Phases 1-17; ``amos_data``, ``campaign_data``: futures of phase 10's
    synthetic cases and phase 15's fixture root."""
    from multimodal_pl_tpu_torch.cli import evaluate
    from multimodal_pl_tpu_torch.convert import save_npz
    from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
    from multimodal_pl_tpu_torch.models import UNet3DFEAM
    from collections import Counter

    from multimodal_pl_tpu_torch.ops import _build, conv3x3, gn_relu, norm, resize
    from multimodal_pl_tpu_torch.train.state import StepConfig
    from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "cuda": torch.version.cuda, "kernels": [],
               "fold": [], "gn_relu": [], "gn_relu_serving": [], "gn_relu_backward": [],
               "conv3x3_train": [], "resize": [], "gn_relu_ablation": [], "gn_split": [],
               "big_tiles": [], "phase_s": {}}
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
    names = ("conv3x3_gn", "gn_relu", "resize3d")
    with ThreadPoolExecutor(len(names)) as pool:
        lib_paths = dict(zip(names, pool.map(_build.build, names)))
    conv3x3._lib()
    gn_relu._lib()
    resize._lib()
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
    print("[2] gn_relu forward kernel vs plain at every gradient-free GroupNorm -> ReLU",
          flush=True)
    serving_gn = serving_gn_keys()
    gn_serving_table = phase_gn(dev, results, serving_gn, "gn_relu_serving")
    print("[2] resize3d forward kernel vs plain at every upsample of the tile batch", flush=True)
    serving_resize = serving_resize_keys()
    resize_serving_table = phase_resize(dev, results, serving_resize)[0]
    resize_summary("serving", [resize_serving_table])
    phase_done("serving kernels")

    # ---- phase 3: whole model, kernel vs plain -----------------------------
    model = UNet3DFEAM(deep_up=True, conv_impl="kernel",
                       generator=torch.Generator().manual_seed(0)).to(dev).eval()
    plain = UNet3DFEAM(deep_up=True, conv_impl="plain", gn_impl="plain").to(dev).eval()
    plain.load_state_dict(model.state_dict())
    x = torch.randn((WINDOW_BATCH, *TILE, 1), generator=torch.Generator().manual_seed(2)).to(
        dev, torch.bfloat16)
    with torch.inference_mode():
        conv3x3.reset_launches()
        norm.fold_launches.clear()
        gn_relu.reset_launches()
        resize.reset_launches()
        lk = model(x, aux=False)
        torch.cuda.synchronize()
        per_forward = dict(conv3x3.launches)
        per_forward_fold = dict(norm.fold_launches)
        per_forward_gn = Counter(gn_relu.launches)
        per_forward_resize = Counter(resize.launches)
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
    check(per_forward_gn == serving_gn and sum(per_forward_gn.values()) == 17,
          f"gn_relu calls {dict(per_forward_gn)} != the 17 derived {dict(serving_gn)}")
    check(per_forward_resize == serving_resize and sum(per_forward_resize.values()) == 4,
          f"resize3d calls {dict(per_forward_resize)} != the 4 derived {dict(serving_resize)}")
    missing = (sorted(set(per_forward) - set(table)) + sorted(set(per_forward_fold) - set(fold_table))
               + sorted(set(per_forward_gn) - set(gn_serving_table))
               + sorted(set(per_forward_resize) - set(resize_serving_table)))
    check(not missing, f"shapes launched by the model but not checked in phase 2: {missing}")
    del lk, lp, x
    torch.cuda.empty_cache()
    phase_feam2(dev, results, model.state_dict())

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
    gn_relu.reset_launches()
    resize.reset_launches()
    t0 = time.perf_counter()
    labels = pred(vol)
    torch.cuda.synchronize()
    one_shot_s = time.perf_counter() - t0
    main_launches = conv3x3.launch_totals()
    main_folds = sum(norm.fold_launches.values())
    main_gn = sum(gn_relu.launches.values())
    main_resize = sum(resize.launches.values())
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(labels.dtype == torch.uint8 and tuple(labels.shape) == VOL,
          f"label map {labels.dtype} {tuple(labels.shape)}")
    check(int(labels.max()) < NC, "label out of range")
    check(main_launches == {conv3x3.FUSED: 54, conv3x3.PROLOGUE_OFF: 12, conv3x3.TRAIN_FWD: 0,
                            conv3x3.TRAIN_DX: 0},
          f"main-path launches {main_launches} != 54 + 12 (66)")
    check(main_folds == 54, f"main-path fold calls {main_folds} != 54")
    check(main_gn == 51, f"main-path gn_relu calls {main_gn} != 51 (17 per tile batch)")
    check(main_resize == 12, f"main-path resize3d calls {main_resize} != 12 (4 per tile batch)")
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
                   main_path_gn_relu=main_gn, main_path_resize=main_resize,
                   one_shot_s_per_vol=one_shot_s,
                   stream_s_per_vol=stream_s, label_agreement=agree,
                   stream_vs_one_shot=stream_agree, peak_gib=peak_gib)
    print(f"[4] {VOL} volume, {TILE} tiles, window batch {WINDOW_BATCH}, bf16, argmax: "
          f"launches {main_launches} + fold {main_folds} + gn_relu {main_gn} + resize3d "
          f"{main_resize}; label agreement "
          f"with plain {agree:.5f}; "
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
        # flip TTA at window batch 4, one member and the same member twice:
        # the mean of two equal logits is the logits, so the same CSV
        tta_csv = {}
        for name, reload in (("one", ckpt), ("twice", f"{ckpt},{ckpt}")):
            with open(evaluate.main(["--data_dir", img_dir, "--reload_path", reload,
                                     "--save_path", os.path.join(tmp, "tta_" + name),
                                     "--atlas_path", atlas_path, "--tta", "true",
                                     "--window_batch", str(WINDOW_BATCH)])) as f:
                tta_csv[name] = f.read()
    check(len(rows) == 3, f"CLI CSV has {len(rows)} lines, expected header + 2 cases")
    print(f"[5] mpl-evaluate-torch: {len(rows) - 1} cases written to per_case_dice.csv",
          flush=True)
    check(len(tta_csv["one"].strip().splitlines()) == 3 and tta_csv["one"] == tta_csv["twice"],
          f"--tta true: the ensemble of one checkpoint twice wrote another CSV than the "
          f"checkpoint alone:\n{tta_csv['one']}\n{tta_csv['twice']}")
    print("[5] mpl-evaluate-torch --tta true --window_batch 4: --reload_path a,a writes the CSV "
          "of a alone", flush=True)

    phase_done("serving")

    # ---- phase 6: the training kernels vs plain at every train-step shape ----
    conv_expected, gn_expected, gn_nograd, _, _ = training_shapes(StepConfig())
    print(f"[6] training kernels vs plain at every shape of one B=1 x {PATCH} train step "
          f"(bf16 inputs; plain in f32, TF32 off)", flush=True)
    gn_table = phase_gn(dev, results, gn_expected + gn_nograd)
    gn_bwd_table = phase_gn_bwd(dev, results, gn_expected)
    train_table = phase_train_conv(dev, results, conv_expected)
    rest = sorted({k for k in conv_expected if k[0] in (conv3x3.FUSED, conv3x3.PROLOGUE_OFF)})
    nograd_table = {}
    for batch in sorted({k[3] for k in rest}):
        nograd_table.update(phase_kernels(
            dev, results, [(k[1], k[2], k[4:7], k[0] == conv3x3.FUSED, k[7])
                           for k in rest if k[3] == batch], batch=batch, groups=4))
    fold_expected = fold_keys(conv_expected, 4)
    fold_step_table = phase_fold(dev, results, fold_expected)
    resize_fwd_table, resize_bwd_table = phase_resize(dev, results, *resize_shapes(StepConfig()))
    # the shapes of a B = PROD_B step that B = 1 does not launch (the
    # segmenter's; the refiner's rows do not depend on the batch)
    conv3, gn3, gn3_nograd, _, _ = training_shapes(StepConfig(), PROD_B)
    print(f"[6] the same at every further shape of one B={PROD_B} x {PATCH} train step", flush=True)
    gn_table.update(phase_gn(dev, results, {k for k in gn3 + gn3_nograd if k not in gn_table}))
    gn_bwd_table.update(phase_gn_bwd(dev, results, {k for k in gn3 if k not in gn_bwd_table}))
    train_table.update(phase_train_conv(dev, results, {
        k for k in conv3 if k[0] == conv3x3.TRAIN_FWD and (k[1], k[2], *k[3:7]) not in train_table}))
    check(not {k for k in conv3 if k[0] in (conv3x3.FUSED, conv3x3.PROLOGUE_OFF)} - set(nograd_table),
          "the B = PROD_B step launches a gradient-free conv shape phase 6 did not check")
    rfwd3, rbwd3 = resize_shapes(StepConfig(), PROD_B)
    more_fwd, more_bwd = phase_resize(dev, results, set(rfwd3) - set(resize_fwd_table),
                                      set(rbwd3) - set(resize_bwd_table))
    resize_fwd_table.update(more_fwd)
    resize_bwd_table.update(more_bwd)
    resize_summary("train steps B = 1 and 3", [resize_fwd_table, resize_bwd_table])
    phase_done("training kernels")

    # ---- phase 7: the training path ------------------------------------------
    # every step launches exactly the derived shapes (checked per step), and
    # phase 6 held the kernels against their plain versions at each of them
    step_run = phase_step(dev, results)
    phase_done("train step")

    # ---- phase 8: the training entry point -----------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        results["train_cli"] = phase_train_cli(tmp)
    phase_done("train entry point")

    # ---- phase 9: the production step, B = 3, with and without remat ---------
    prod_run = phase_production(dev, results)
    phase_done("production step")

    # ---- phase 10: the device pipeline and the production entry point --------
    data = amos_data.result()
    print(f"[10] {sum(AMOS_CASES)} synthetic cases at {AMOS_GRID} made in a worker process",
          flush=True)
    phase_pipeline(dev, results, data)
    with tempfile.TemporaryDirectory() as tmp:
        results["production_cli"] = phase_production_cli(tmp, data, prod_run[True])
    phase_done("production entry point")

    # ---- phase 11: the re-profile ---------------------------------------------
    results["profile"] = phase_profile()
    phase_done("profile")

    # ---- phase 12: data parallelism on the one card ---------------------------
    dp_step_run, dp_serving_run = phase_data_parallel(
        dev, results, model.state_dict(), vol,
        {"conv3x3": per_forward, "fold": per_forward_fold, "gn_relu": per_forward_gn,
         "resize": per_forward_resize})
    phase_done("data parallel")

    # ---- phase 13: the ablation U-Nets at full width ----------------------------
    ablation_serving = phase_ablations(
        dev, results, model, vol, {"conv3x3": table, "fold": fold_table,
                                   "gn_relu": dict(gn_serving_table),
                                   "resize": resize_serving_table})
    phase_done("ablations")

    # ---- phase 14: spatial serving, each tile's H axis split over ranks ----------
    spatial_run = phase_spatial(dev, results, model.state_dict(), vol)
    phase_done("spatial serving")

    # ---- phase 15: the partial-label campaign, chunked training and evaluation ----
    campaign_run = phase_campaign(dev, results, campaign_data.result())
    phase_done("campaign")

    # ---- phase 16: the spatial train step, each sample's H axis split over ranks ----
    spatial_step_entries = phase_spatial_step(
        dev, results, (train_table, gn_table, gn_bwd_table, nograd_table, fold_step_table,
                       resize_fwd_table, resize_bwd_table))
    phase_done("spatial train step")

    # ---- phase 17: raw NIfTI to label maps with the port alone -------------------
    with tempfile.TemporaryDirectory() as tmp:
        results["assets"] = phase_assets(dev, tmp)
    phase_done("raw NIfTI to label maps")

    # ---- phase 18: the step's ladder; flip TTA and ensembles at full width ------
    ladder_calls = phase_ladder(dev, results)
    phase_done("step ladder")
    tta_calls, tta_batches, big = phase_tta(dev, results, model, plain, vol)
    phase_ensemble(dev, results, model, vol)
    phase_done("flip TTA and ensembles")

    entry = kernel_entry
    # serving: per 4-tile forward (times) and per volume (calls)
    serving = {k: r for k, r in table.items() if r["b"] == WINDOW_BATCH}
    kernels = [entry(name, SOURCE, replaces, main_launches[spec],
                     [(n, serving[k]) for k, n in per_forward.items() if k[0] == spec])
               for spec, name, replaces in (
                   (conv3x3.FUSED, "conv3x3_gn fused GN-ReLU prologue", BDX),
                   (conv3x3.PROLOGUE_OFF, "conv3x3_gn prologue off", BK3))]
    kernels.append(entry("group_norm_fold statistics (gn_fold_bf16)", GN_SOURCE, GN_FOLD,
                         main_folds, [(n, fold_table[k]) for k, n in per_forward_fold.items()]))
    kernels.append(entry("gn_relu forward (gn_relu_fwd_bf16), serving", GN_SOURCE, GN_RELU,
                         main_gn, [(n, gn_serving_table[k]) for k, n in serving_gn.items()]))
    kernels.append(entry("resize3d forward (x2 upsample + skip), serving", RESIZE_SOURCE, RESIZE,
                         main_resize,
                         [(n, resize_serving_table[k]) for k, n in serving_resize.items()]))

    # per train step: each call's per-shape row from phase 6
    def step_rows(specs, expected):
        return conv_rows(specs, expected, train_table, nograd_table)

    train_specs = (conv3x3.TRAIN_FWD, conv3x3.TRAIN_DX, conv3x3.PROLOGUE_OFF)
    for tag, run, cfg in (("train step", step_run, StepConfig()),
                          (f"B={PROD_B} train step with remat", prod_run[True],
                           StepConfig(remat=True))):
        expected = step_expected(cfg, PROD_B if cfg.remat else 1)
        kernels.append(entry(
            f"conv3x3_train: conv3x3_gn prologue off (forward, dx; gradient-free refiner), {tag}",
            SOURCE, K2, sum(n for k, n in run["conv3x3"].items() if k[0] in train_specs),
            step_rows(train_specs, expected["conv3x3"])))
        kernels.append(entry(
            f"conv3x3_gn fused GN-ReLU prologue, refiner gradient-free pass, {tag}", SOURCE, K2_GN,
            sum(n for k, n in run["conv3x3"].items() if k[0] == conv3x3.FUSED),
            step_rows((conv3x3.FUSED,), expected["conv3x3"])))
        kernels.append(entry(f"gn_relu forward (gn_relu_fwd_bf16), {tag}", GN_SOURCE, GN_RELU,
                             sum(run["gn_relu"].values()),
                             [(n, gn_table[k]) for k, n in expected["gn_relu"].items()]))
        kernels.append(entry(f"gn_relu backward (gn_relu_bwd_bf16), {tag}", GN_SOURCE, GN_BWD,
                             sum(run["gn_relu_backward"].values()),
                             [(n, gn_bwd_table[k]) for k, n in expected["gn_relu_backward"].items()]))
        kernels.append(entry(f"group_norm_fold statistics (gn_fold_bf16), {tag}", GN_SOURCE,
                             GN_FOLD, sum(run["fold"].values()),
                             [(n, fold_step_table[k]) for k, n in expected["fold"].items()]))
        kernels.append(entry(f"resize3d forward (upsample [+ skip]), {tag}", RESIZE_SOURCE,
                             RESIZE, sum(run["resize"].values()),
                             [(n, resize_fwd_table[k]) for k, n in expected["resize"].items()]))
        kernels.append(entry(f"resize3d backward (gather form), {tag}", RESIZE_SOURCE,
                             RESIZE_BWD, sum(run["resize_backward"].values()),
                             [(n, resize_bwd_table[k])
                              for k, n in expected["resize_backward"].items()]))
    # per B = PROD_B train step: each call's per-shape row from phase 6, the
    # launches those of the path's run
    def step_entries(tag, run):
        expected = step_expected(StepConfig(), PROD_B)
        out = [entry(f"{name}, {tag}", SOURCE, replaces,
                     sum(n for k, n in run["conv3x3"].items() if k[0] in spec_set),
                     step_rows(spec_set, expected["conv3x3"]))
               for name, spec_set, replaces in (
                   ("conv3x3_train: conv3x3_gn prologue off (forward, dx; gradient-free "
                    "refiner)", train_specs, K2),
                   ("conv3x3_gn fused GN-ReLU prologue, refiner gradient-free pass",
                    (conv3x3.FUSED,), K2_GN))]
        for key, name, src, replaces, table_ in (
                ("gn_relu", "gn_relu forward (gn_relu_fwd_bf16)", GN_SOURCE, GN_RELU, gn_table),
                ("gn_relu_backward", "gn_relu backward (gn_relu_bwd_bf16)", GN_SOURCE, GN_BWD,
                 gn_bwd_table),
                ("fold", "group_norm_fold statistics (gn_fold_bf16)", GN_SOURCE, GN_FOLD,
                 fold_step_table),
                ("resize", "resize3d forward (upsample [+ skip])", RESIZE_SOURCE, RESIZE,
                 resize_fwd_table),
                ("resize_backward", "resize3d backward (gather form)", RESIZE_SOURCE,
                 RESIZE_BWD, resize_bwd_table)):
            out.append(entry(f"{name}, {tag}", src, replaces, sum(run[key].values()),
                             [(n, table_[k]) for k, n in expected[key].items()]))
        return out

    # this slice's paths: rank 0 of the two-rank step and of sharded serving
    # (per volume: 2 of its 3 tile batches), each row the single path's
    tag = "rank 0 of 2 (gloo, one card)"
    kernels += step_entries(f"data-parallel B={PROD_B} train step, {tag}", dp_step_run)
    kernels += [entry(f"conv3x3_gn fused GN-ReLU prologue, sharded serving, {tag}", SOURCE, BDX,
                      sum(n for k, n in dp_serving_run["conv3x3"].items()
                          if k[0] == conv3x3.FUSED),
                      [(n, serving[k]) for k, n in per_forward.items() if k[0] == conv3x3.FUSED]),
                entry(f"conv3x3_gn prologue off, sharded serving, {tag}", SOURCE, BK3,
                      sum(n for k, n in dp_serving_run["conv3x3"].items()
                          if k[0] == conv3x3.PROLOGUE_OFF),
                      [(n, serving[k]) for k, n in per_forward.items()
                       if k[0] == conv3x3.PROLOGUE_OFF]),
                entry(f"group_norm_fold statistics (gn_fold_bf16), sharded serving, {tag}",
                      GN_SOURCE, GN_FOLD, sum(dp_serving_run["fold"].values()),
                      [(n, fold_table[k]) for k, n in per_forward_fold.items()]),
                entry(f"gn_relu forward (gn_relu_fwd_bf16), sharded serving, {tag}", GN_SOURCE,
                      GN_RELU, sum(dp_serving_run["gn_relu"].values()),
                      [(n, gn_serving_table[k]) for k, n in serving_gn.items()]),
                entry(f"resize3d forward (x2 upsample + skip), sharded serving, {tag}",
                      RESIZE_SOURCE, RESIZE, sum(dp_serving_run["resize"].values()),
                      [(n, resize_serving_table[k]) for k, n in serving_resize.items()])]
    # the ablations' serving path (phase 13): calls per volume, per-shape
    # times of phase 2 summed over one 4-tile forward's calls
    for name, (per_vol, tile_batch) in ablation_serving.items():
        tag = f"ablation serving, {ablation_models()[name][0].__name__}"
        for spec, label, replaces in ((conv3x3.FUSED, "conv3x3_gn fused GN-ReLU prologue", BDX),
                                      (conv3x3.PROLOGUE_OFF, "conv3x3_gn prologue off", BK3)):
            kernels.append(entry(f"{label}, {tag}", SOURCE, replaces,
                                 sum(n for k, n in per_vol["conv3x3"].items() if k[0] == spec),
                                 [(n, serving[k]) for k, n in tile_batch["conv3x3"].items()
                                  if k[0] == spec]))
        for key, label, src, replaces, table_ in (
                ("fold", "group_norm_fold statistics (gn_fold_bf16)", GN_SOURCE, GN_FOLD,
                 fold_table),
                ("gn_relu", "gn_relu forward (gn_relu_fwd_bf16)", GN_SOURCE, GN_RELU,
                 gn_serving_table),
                ("resize", "resize3d forward (x2 upsample + skip)", RESIZE_SOURCE, RESIZE,
                 resize_serving_table)):
            kernels.append(entry(f"{label}, {tag}", src, replaces, sum(per_vol[key].values()),
                                 [(n, table_[k]) for k, n in tile_batch[key].items()]))
    kernels += spatial_entries(spatial_run)
    for name, calls in spatial_run["ablations"].items():
        kernels += spatial_entries(spatial_run, calls, f"{ablation_models()[name][0].__name__} "
                                                       "split serving (per tile batch)")
    kernels += campaign_entries(campaign_run)
    kernels += spatial_step_entries
    # phase 18: the ladder's six rungs (rows: the full rung's step), and the
    # flip-TTA forward's full-resolution calls at 32 tiles (per forward)
    kernels += step_entries(f"the step ladder's six rungs, B={PROD_B}", ladder_calls)
    for kind, label, src, replaces in (
            ("conv3x3", "conv3x3_gn fused GN-ReLU prologue", SOURCE, BDX),
            ("gn_relu", "gn_relu forward (gn_relu_fwd_bf16)", GN_SOURCE, GN_RELU),
            ("fold", "group_norm_fold statistics (gn_fold_bf16)", GN_SOURCE, GN_FOLD),
            ("resize", "resize3d forward (x2 upsample + skip)", RESIZE_SOURCE, RESIZE)):
        kernels.append(entry(
            f"{label}, flip-TTA serving: its {TTA_TILES}-tile calls at full resolution", src,
            replaces, sum(tta_calls[kind][k] for k in big[kind]),
            [(tta_calls[kind][k] // tta_batches, row) for k, row in big[kind].items()]))
    results["fold_calls_per_step"] = sum(step_run["fold"].values()) // 3
    # conv3x3_gn calls per key, for per-row sums of other timings of the shapes
    results["serving_calls"] = [[*k, n] for k, n in per_forward.items()]
    results["step_calls"] = [[*k, n] for k, n in conv_expected.items()]
    results["production_step_calls"] = [[*k, n] for k, n in step_expected(
        StepConfig(remat=True), PROD_B)["conv3x3"].items()]
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

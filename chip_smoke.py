#!/usr/bin/env python3
"""Drive the PyTorch port (multimodal_pl_tpu_torch) on one NVIDIA GPU and
check it. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on any failed check:

1. the card's name and power limit; build csrc/conv3x3_gn.cu with nvcc for
   sm_90a (timed);
2. the conv3x3_gn kernel vs its plain PyTorch version (f32, TF32 off) on the
   same bf16 inputs, at every shape one 4 x 64 x 192 x 192 tile batch of the
   flagship UNet3DFEAM gives it: max|k - p| <= 1e-2 * max|p|; both times;
3. the whole model on one bf16 tile batch, conv_impl='kernel' vs 'plain'
   with the same weights: relative L2 error of the logits <= 3e-2, and 22
   kernel launches (18 fused, 4 prologue-off), every launched shape covered
   by phase 2;
4. the main path: SlidingWindowPredictor(output='argmax', window_batch=4,
   bf16) over seeded 128 x 256 x 256 volumes (12 windows): a uint8 label map
   of labels < 14, 66 launches per volume, agreement with the plain model's
   label map; then predict_iter over 5 volumes (s/vol);
5. the entry point: mpl-evaluate-torch's main() on 2 synthetic cases with
   random weights written as .npz; its CSV.

Prints the kernels' JSON line, the card line, and as the last line
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

import numpy as np
import torch

VOL = (128, 256, 256)
TILE = (64, 192, 192)
NC = 14
WINDOW_BATCH = 4
N_STREAM = 5
BDX = "multimodal_pl_tpu/ops/pallas/bdx.py:247"
BK3 = "multimodal_pl_tpu/ops/pallas/bk3_conv.py:163"
SOURCE = "multimodal_pl_tpu_torch/csrc/conv3x3_gn.cu"

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


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls (CUDA events), after warm-up."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_kernels(dev, results):
    """Phase 2: kernel vs plain at every main-path shape."""
    import torch.nn.functional as F

    from multimodal_pl_tpu_torch.ops.conv import standardize_kernel
    from multimodal_pl_tpu_torch.ops.conv3x3 import (
        FUSED, PROLOGUE_OFF as OFF, conv3x3_gn, conv3x3_gn_reference)
    from multimodal_pl_tpu_torch.ops.norm import group_norm_fold

    def eager_bf16(x, w, a, b, res):
        # the same op as unfused bf16 PyTorch ops (cuDNN conv), for scale
        t = x if a is None else torch.relu(x.float() * a[:, None, None, None]
                                           + b[:, None, None, None]).to(x.dtype)
        y = F.conv3d(t.permute(0, 4, 1, 2, 3), w, padding=1).permute(0, 2, 3, 4, 1)
        return y if res is None else y + res

    g = torch.Generator().manual_seed(1)
    table = {}
    for cin, cout, (d, h, w_), prologue, with_res in SHAPES:
        x = torch.randn((WINDOW_BATCH, d, h, w_, cin), generator=g).to(dev, torch.bfloat16)
        w = standardize_kernel(torch.randn((cout, cin, 3, 3, 3), generator=g)).to(
            dev, torch.bfloat16)
        a = b = res = None
        if prologue:
            a, b = group_norm_fold(x, (1 + 0.1 * torch.randn(cin, generator=g)).to(dev),
                                   (0.1 * torch.randn(cin, generator=g)).to(dev), 16)
        if with_res:
            res = torch.randn((WINDOW_BATCH, d, h, w_, cout), generator=g).to(dev, torch.bfloat16)
        k = conv3x3_gn(x, w, a, b, res)
        torch.cuda.synchronize()
        p = conv3x3_gn_reference(x, w, a, b, res)
        err = (k.float() - p.float()).abs().max().item()
        scale = p.float().abs().max().item()
        reps = 5 if d * h * w_ * max(cin, cout) > 2 ** 26 else 20
        row = {
            "spec": FUSED if prologue else OFF, "cin": cin, "cout": cout, "dhw": [d, h, w_],
            "res": with_res, "max_abs_err": err, "max_abs_plain": scale,
            "ms": time_ms(lambda: conv3x3_gn(x, w, a, b, res), reps),
            "plain_ms": time_ms(lambda: conv3x3_gn_reference(x, w, a, b, res), reps),
            "eager_bf16_ms": time_ms(lambda: eager_bf16(x, w, a, b, res), reps),
        }
        row["tflops"] = 2 * 27 * cin * cout * WINDOW_BATCH * d * h * w_ / row["ms"] / 1e9
        print(f"  {row['spec']:12s} {cin:3d}->{cout:3d} @{d}x{h}x{w_} res={with_res!s:5s} "
              f"max|k-p|={err:.3g} (max|p|={scale:.3g})  kernel {row['ms']:.3f} ms "
              f"({row['tflops']:.1f} TFLOP/s)  plain f32 {row['plain_ms']:.3f} ms  "
              f"eager bf16 {row['eager_bf16_ms']:.3f} ms", flush=True)
        check(err <= 1e-2 * scale, f"kernel disagrees with plain at {row}")
        table[(row["spec"], cin, cout, WINDOW_BATCH, d, h, w_, with_res)] = row
        results["kernels"].append(row)
        del x, w, a, b, res, k, p
    torch.cuda.empty_cache()
    return table


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from multimodal_pl_tpu.data.synthetic import make_synthetic_amos
    from multimodal_pl_tpu_torch.cli import evaluate
    from multimodal_pl_tpu_torch.convert import save_npz
    from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
    from multimodal_pl_tpu_torch.models import UNet3DFEAM
    from multimodal_pl_tpu_torch.ops import _build, conv3x3

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "cuda": torch.version.cuda, "kernels": []}

    # ---- phase 1: build ----------------------------------------------------
    print(f"[1] card: {card}", flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build("conv3x3_gn")
    conv3x3._lib()
    results["build_s"] = time.perf_counter() - t0
    print(f"[1] built {lib_path.name} in {results['build_s']:.1f} s", flush=True)
    ptxas = [ln for ln in (lib_path.parent / "build.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    results["ptxas"] = ptxas

    # ---- phase 2: kernel vs plain at every main-path shape ------------------
    print("[2] conv3x3_gn kernel vs plain (bf16 inputs; plain in f32, TF32 off)", flush=True)
    table = phase_kernels(dev, results)

    # ---- phase 3: whole model, kernel vs plain -----------------------------
    model = UNet3DFEAM(deep_up=True, conv_impl="kernel",
                       generator=torch.Generator().manual_seed(0)).to(dev).eval()
    plain = UNet3DFEAM(deep_up=True, conv_impl="plain").to(dev).eval()
    plain.load_state_dict(model.state_dict())
    x = torch.randn((WINDOW_BATCH, *TILE, 1), generator=torch.Generator().manual_seed(2)).to(
        dev, torch.bfloat16)
    with torch.inference_mode():
        conv3x3.reset_launches()
        lk = model(x, aux=False)
        torch.cuda.synchronize()
        per_forward = dict(conv3x3.launches)
        totals = conv3x3.launch_totals()
        lp = plain(x, aux=False)
        rel = ((lk.float() - lp.float()).norm() / lp.float().norm()).item()
        fwd_ms = time_ms(lambda: model(x, aux=False), 3)
        plain_fwd_ms = time_ms(lambda: plain(x, aux=False), 3)
    check(lk.shape == (WINDOW_BATCH, *TILE, NC) and bool(torch.isfinite(lk).all()),
          f"logits {tuple(lk.shape)} not finite / wrong shape")
    results.update(model_rel_l2=rel, model_launches=totals, forward_ms=fwd_ms,
                   plain_forward_ms=plain_fwd_ms)
    print(f"[3] tile batch {WINDOW_BATCH}x{TILE}: logits rel L2 kernel vs plain = {rel:.3e}; "
          f"launches {totals}; forward {fwd_ms:.1f} ms (plain {plain_fwd_ms:.1f} ms)",
          flush=True)
    check(rel <= 3e-2, f"whole-model relative L2 error {rel} > 3e-2")
    check(totals == {conv3x3.FUSED: 18, conv3x3.PROLOGUE_OFF: 4}, f"launches {totals} != 18 + 4")
    missing = sorted(set(per_forward) - set(table))
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
    t0 = time.perf_counter()
    labels = pred(vol)
    torch.cuda.synchronize()
    one_shot_s = time.perf_counter() - t0
    main_launches = conv3x3.launch_totals()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(labels.dtype == torch.uint8 and tuple(labels.shape) == VOL,
          f"label map {labels.dtype} {tuple(labels.shape)}")
    check(int(labels.max()) < NC, "label out of range")
    check(main_launches == {conv3x3.FUSED: 54, conv3x3.PROLOGUE_OFF: 12},
          f"main-path launches {main_launches} != 54 + 12 (66)")
    for key, n in main_launches.items():
        check(n > 0, f"kernel {key} never launched on the main path")
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
    results.update(main_path_launches=main_launches, one_shot_s_per_vol=one_shot_s,
                   stream_s_per_vol=stream_s, label_agreement=agree,
                   stream_vs_one_shot=stream_agree, peak_gib=peak_gib)
    print(f"[4] {VOL} volume, {TILE} tiles, window batch {WINDOW_BATCH}, bf16, argmax: "
          f"launches {main_launches}; label agreement with plain {agree:.5f}; "
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

    kernels = []
    for spec, name, replaces in ((conv3x3.FUSED, "conv3x3_gn fused GN-ReLU prologue", BDX),
                                 (conv3x3.PROLOGUE_OFF, "conv3x3_gn prologue off", BK3)):
        rows_s = [r for r in results["kernels"] if r["spec"] == spec]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": main_launches[spec],
            "max_abs_err": max(r["max_abs_err"] for r in rows_s),
            # device time of this kernel's launches in one tile-batch forward
            "ms": sum(n * table[k]["ms"] for k, n in per_forward.items() if k[0] == spec),
            "plain_ms": sum(n * table[k]["plain_ms"] for k, n in per_forward.items()
                            if k[0] == spec),
        })
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

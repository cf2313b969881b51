"""Device-time profile of the port's two main paths on one GPU, by kernel
category: one serving tile batch (UNet3DFEAM, 4 x 64 x 192 x 192 bf16,
``aux=False``) and the train step (``StepConfig`` defaults, bf16) at B = 1
and at the production B = 3 without and with remat, all with random
weights from fixed seeds.

    PYTHONPATH=. python3 -m multimodal_pl_tpu_torch.tools.profile_chip [OUTDIR]

torch.profiler records each path over ``calls`` calls after warm-up (3 from
the command line); kernels are summed per category (by name), the device's
busy time is the union of the kernel intervals, and the wall time is the
host clock around the profiled calls. Writes ``OUTDIR/profile.json``
(default ``chiprun_out``).
"""

from __future__ import annotations

import json
import os
import sys
import time

RESIZE_KERNEL = "resize3d kernel (trilinear upsample + skip, gradient)"
LIBRARY_RESIZE = "library trilinear resize (F.interpolate and its gradient)"
# (category, substrings of the kernel name), first match wins
CATEGORIES = (
    (RESIZE_KERNEL, ("resize3d_",)),
    (LIBRARY_RESIZE, ("upsample_trilinear",)),
    ("nearest resize (index_select)", ("index_select", "indexSelect")),
    ("conv3x3_gn kernel", ("conv3x3_gn_kernel",)),
    ("conv3x3_gn split-K reduction", ("splitk_reduce",)),
    ("GroupNorm fold statistics kernel", ("gn_fold_",)),
    ("gn_relu forward kernel", ("gn_relu_stats_kernel", "gn_relu_norm_kernel",
                                "gn_relu_cluster_kernel")),
    ("gn_relu backward kernel", ("gn_bwd_",)),
    ("library conv (cuDNN: stem, stride 2, 1x1, dgrad, wgrad)",
     ("conv", "cudnn", "xmma", "implicit_gemm", "wgrad", "dgrad", "fprop")),
    ("GEMM", ("gemm", "cutlass", "cublas", "sm90_xmma")),
    ("reductions", ("reduce", "Reduce")),
    ("memcpy / memset", ("memcpy", "Memcpy", "memset", "Memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Elementwise")),
)


def _category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def _profile(fn, calls: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    cats: dict = {}
    spans = []
    for e in kernels:
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        c = cats.setdefault(_category(e.name), {"ms": 0.0, "launches": 0})
        c["ms"] += (end - start) / 1e3 / calls
        c["launches"] += 1
    for c in cats.values():
        c["launches"] /= calls
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    busy_ms = busy / 1e3 / calls
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "kernel_ms": sum(c["ms"] for c in cats.values()),
            "launches": sum(c["launches"] for c in cats.values()),
            "busy_share": busy_ms / wall_ms,
            "categories": dict(sorted(cats.items(), key=lambda kv: -kv[1]["ms"]))}


def _report(name: str, r: dict) -> None:
    print(f"{name}: wall {r['wall_ms']:.2f} ms, device busy {r['device_busy_ms']:.2f} ms "
          f"({100 * r['busy_share']:.1f}%), kernel time {r['kernel_ms']:.2f} ms in "
          f"{r['launches']:.0f} launches", flush=True)
    for cat, c in r["categories"].items():
        print(f"  {c['ms']:9.3f} ms  {100 * c['ms'] / r['kernel_ms']:5.1f}%  "
              f"{c['launches']:7.0f}  {cat}", flush=True)


def main(outdir: str = "chiprun_out", calls: int = 3) -> dict:
    import numpy as np
    import torch

    from multimodal_pl_tpu_torch.models import UNet3DFEAM
    from multimodal_pl_tpu_torch.train.loop import to_device
    from multimodal_pl_tpu_torch.train.state import StepConfig, build_models, create_train_state
    from multimodal_pl_tpu_torch.train.step import make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("profile_chip: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0)}

    model = UNet3DFEAM(deep_up=True, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    x = torch.randn((4, 64, 192, 192, 1), generator=torch.Generator().manual_seed(2)).to(
        dev, torch.bfloat16)
    with torch.inference_mode():
        for _ in range(2):
            model(x, aux=False)
        out["serving_tile_batch"] = _profile(lambda: model(x, aux=False), calls)
    _report("serving tile batch 4 x 64 x 192 x 192", out["serving_tile_batch"])
    del model, x
    torch.cuda.empty_cache()

    for batch, remat in ((1, False), (3, False), (3, True)):
        cfg = StepConfig(compute_dtype=torch.bfloat16, remat=remat)
        state = create_train_state(torch.Generator().manual_seed(0), cfg).to(dev)
        step = make_train_step(*(m.to(dev) for m in build_models(cfg)), cfg)
        rng = np.random.default_rng(5)
        nc, patch = cfg.num_classes, (64, 192, 192)
        sup = np.zeros(nc, np.float32)
        sup[5] = 1
        host = {"image": rng.standard_normal((batch, *patch, 1)).astype(np.float32),
                "label": rng.integers(0, nc, (batch, *patch)).astype(np.uint8),
                "catlas": rng.random((nc - 1, *patch)).astype(np.float32), "sup_mask": sup,
                "label_t": np.array([0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1], np.float32)}
        batch_t = to_device(host, cfg, dev)
        lr, wf = torch.tensor(5e-4, device=dev), torch.tensor(0.05, device=dev)
        box = [state]

        def one_step():
            box[0], _ = step(box[0], batch_t, lr, wf)

        for _ in range(4):
            one_step()
        name = "train_step" if batch == 1 else f"train_step_b{batch}" + ("_remat" * remat)
        out[name] = _profile(one_step, calls)
        _report(f"train step B = {batch} x 64 x 192 x 192, remat {remat}", out[name])
        del state, step, box, batch_t
        torch.cuda.empty_cache()
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:])

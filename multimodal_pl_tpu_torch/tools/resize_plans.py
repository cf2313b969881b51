"""Device time of the resize3d kernels (``csrc/resize3d.cu``) at every
forward and backward shape of a serving tile batch and of the B = 1 and
B = 3 train steps, as ``chip_smoke.py`` derives them from the model's
configuration (``serving_resize_keys``, ``resize_shapes``).

    PYTHONPATH=. python3 multimodal_pl_tpu_torch/tools/resize_plans.py [OUTDIR]
    PYTHONPATH=. python3 multimodal_pl_tpu_torch/tools/resize_plans.py --sweep [OUTDIR]

The first form runs ``chip_smoke.phase_resize`` at those shapes: each
kernel against its plain version (checked), with kernel, plain and library
times and the bound. Started by its path it imports ``chip_smoke`` and the
package from the tree on PYTHONPATH, so one chip call can time a parent
tree (unpacked by ``git archive``) and a change in turns without running
the whole of either's ``chip_smoke.py``. The second form times each shape
under the wrapper's launch plan (fwd_plan, bwd_plan) and every other plan
that fits the card, to check the planners' choices against the best.

Times are device times per call (one call captured in a CUDA graph and
replayed; ``tools/timing.py``). Writes ``OUTDIR/resize_plans.json`` or
``OUTDIR/resize_sweep.json`` (default ``chiprun_out``).
"""

from __future__ import annotations

import json
import os
import sys


def main_path_keys() -> tuple:
    """({forward key}, {backward key}) over a serving tile batch and the
    B = 1 and B = 3 train steps (chip_smoke's keys: (factor, C, dtype, B, D,
    H, W[, skip]))."""
    import chip_smoke
    from multimodal_pl_tpu_torch.train.state import StepConfig

    fwd, bwd = set(chip_smoke.serving_resize_keys()), set()
    for batch in (1, chip_smoke.PROD_B):
        f, b = chip_smoke.resize_shapes(StepConfig(), batch)
        fwd |= set(f)
        bwd |= set(b)
    return fwd, bwd


def _candidates(key, backward: bool):
    from multimodal_pl_tpu_torch.ops import resize

    f, c, dtype, b, d, h, w = key[:7]
    esz = 2 if dtype == "bfloat16" else 4
    if not backward:
        nchunks = -(-w * f * c * esz // 16)
        for hs in sorted({min(h, t) for t in (1, 2, 4, 8, 16, 32)}):
            for dg in (g for g in (1, 2, 4, 8) if g <= f):
                for cs in (s for s in (1, 2, 4, 8) if s <= nchunks):
                    smem = resize.fwd_smem(h, w, c, f, hs, esz)
                    if smem <= resize.SMEM_MAX:
                        yield (hs, dg, cs, 1, smem)
                    yield (hs, dg, cs, 0, 0)
        return
    cv = 16 // esz if c % (16 // esz) == 0 else 1
    for th in sorted({min(h, t) for t in resize.TILES}):
        for tw in sorted({min(w, t) for t in resize.TILES if min(w, t) * (c // cv) <= resize.NT}):
            smem = resize.bwd_smem(c, f, th, tw, esz)
            if smem > resize.SMEM_MAX:
                continue
            for dt in sorted({-(-d // k) for k in (1, 2, 4, 8, 16)}):
                yield (th, tw, dt, smem)


def _time(key, backward: bool, plans, reps: int) -> list:
    """[(plan, ms)] of the kernel at ``key`` under each plan (the wrapper's
    first), on random inputs."""
    import torch

    from multimodal_pl_tpu_torch.ops import resize
    from multimodal_pl_tpu_torch.tools.timing import graph_ms

    f, c, dtype, b, d, h, w = key[:7]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(1)
    small = torch.randn((b, d, h, w, c), generator=g).to("cuda", dt)
    big = torch.randn((b, d * f, h * f, w * f, c), generator=g).to("cuda", dt)
    skip = big.clone() if not backward and key[7] else None
    lib, code = resize._lib(), resize._DTYPES[dt]
    out = []
    for plan in plans:
        # the stream is read at each call: the graph captures on its own
        if backward:
            def call(p=plan):
                resize._raise_on(lib.resize3d_bwd(
                    big.data_ptr(), small.data_ptr(), code, b, d, h, w, c, f, *p,
                    torch.cuda.current_stream().cuda_stream), "resize3d_bwd")
        else:
            def call(p=plan):
                resize._raise_on(lib.resize3d_fwd(
                    small.data_ptr(), None if skip is None else skip.data_ptr(), big.data_ptr(),
                    code, b, d, h, w, c, f, *p, torch.cuda.current_stream().cuda_stream),
                    "resize3d_fwd")
        out.append((list(plan), graph_ms(call, reps)))
    del small, big, skip
    torch.cuda.empty_cache()
    return out


def sweep(fwd_keys, bwd_keys) -> list:
    """One row per key: the wrapper's plan and its time, the best plan of
    every one that fits and its time, and the five best."""
    from multimodal_pl_tpu_torch.ops import resize

    rows = []
    keys = [(k, False) for k in fwd_keys] + [(k, True) for k in bwd_keys]
    for key, backward in sorted(keys, key=str):
        f, c, dtype, b, d, h, w = key[:7]
        esz = 2 if dtype == "bfloat16" else 4
        reps = 5 if b * d * h * w * c * f ** 3 > 2 ** 26 else 20
        if backward:
            p = resize.bwd_plan(b, d, h, w, c, f, esz)
            default = (p.th, p.tw, p.dt, p.smem)
        else:
            p = resize.fwd_plan(b, d, h, w, c, f, esz, key[7])
            default = (p.hs, p.dgroups, p.csplit, p.staged, p.smem)
        plans = [default] + [q for q in _candidates(key, backward) if q != default]
        times = _time(key, backward, plans, reps)
        best = min(times, key=lambda t: t[1])
        row = {"key": list(key), "backward": backward, "plan": times[0][0], "ms": times[0][1],
               "best_plan": best[0], "best_ms": best[1], "candidates": len(times),
               "top": sorted(times, key=lambda t: t[1])[:5]}
        rows.append(row)
        print(f"{'bwd' if backward else 'fwd'} {key}: plan {row['plan']} {row['ms']:.4f} ms; "
              f"best of {len(times)} {row['best_plan']} {row['best_ms']:.4f} ms", flush=True)
    return rows


def main(*args: str) -> dict:
    import torch

    outdir = next((a for a in args if not a.startswith("--")), "chiprun_out")
    if not torch.cuda.is_available():
        raise SystemExit("resize_plans: needs an NVIDIA GPU")
    fwd, bwd = main_path_keys()
    if "--sweep" in args:
        name, rows = "resize_sweep.json", sweep(fwd, bwd)
    else:
        import chip_smoke

        results = {"resize": []}
        chip_smoke.phase_resize(torch.device("cuda"), results, fwd, bwd)
        name, rows = "resize_plans.json", results["resize"]
    out = {"device": torch.cuda.get_device_name(0), "rows": rows}
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, name), "w") as fh:
        json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:])

"""Device time of ``group_norm_relu`` forward and backward at every
GroupNorm -> ReLU shape of the two main paths, on one GPU: the 17
gradient-free calls of a serving tile batch (4 x 64 x 192 x 192), and the 62
calls of a train step (B = 1, 64 x 192 x 192) that autograd differentiates
(forward and backward), with the shapes from ``chip_smoke.py``.

It uses only ``group_norm_relu(x, scale, bias, groups)``, so one copy of
this script (with the ``chip_smoke.py`` of its own repository) times any
tree of the package: put the tree first on PYTHONPATH and run the script by
its path from the repository root, e.g. parent, change, change, parent in
one run on one card to compare two commits:

    PYTHONPATH=<tree> python3 multimodal_pl_tpu_torch/tools/gn_times.py LABEL [OUTDIR]

torch.profiler sums the kernels' durations and counts the kernel launches
over 3 calls after one warm-up (bf16 inputs from a fixed seed). Writes
``OUTDIR/gn_times_LABEL.json`` (default ``chiprun_out``).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_time(fn, calls: int = 3):
    """(kernel ms, kernel launches) of one fn() call on the GPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3 / calls,
            len(kernels) / calls)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(label: str, outdir: str = "chiprun_out") -> dict:
    import torch

    from multimodal_pl_tpu_torch.ops.gn_relu import group_norm_relu
    from multimodal_pl_tpu_torch.train.state import StepConfig

    if not torch.cuda.is_available():
        raise SystemExit("gn_times: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    out = {"label": label, "device": torch.cuda.get_device_name(0), "sets": {}}
    chip_smoke = _chip_smoke()
    train = chip_smoke.training_shapes(StepConfig())[1]
    for name, keys, backward in (("serving", chip_smoke.serving_gn_keys(), False),
                                 ("train", train, True)):
        rows, tot = [], dict.fromkeys(("fwd_ms", "fwd_launches", "bwd_ms", "bwd_launches"), 0.0)
        for (c, groups, b, d, h, w), n in sorted(keys.items()):
            x = (torch.randn((b, d, h, w, c), generator=g) * 2 + 0.5).to(dev, torch.bfloat16)
            sc = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
            bi = (0.1 * torch.randn(c, generator=g)).to(dev)
            row = {"key": [c, groups, b, d, h, w], "calls": n}
            with torch.no_grad():
                row["fwd_ms"], row["fwd_launches"] = device_time(
                    lambda: group_norm_relu(x, sc, bi, groups))
            if backward:
                dy = torch.randn((b, d, h, w, c), generator=g).to(dev, torch.bfloat16)
                xs, ss, bs = (t.clone().requires_grad_() for t in (x, sc, bi))
                y = group_norm_relu(xs, ss, bs, groups)
                row["bwd_ms"], row["bwd_launches"] = device_time(
                    lambda: torch.autograd.grad(y, (xs, ss, bs), dy, retain_graph=True))
                del dy, xs, ss, bs, y
            for k in tot:
                tot[k] += n * row.get(k, 0.0)
            rows.append(row)
            del x
        torch.cuda.empty_cache()
        out["sets"][name] = dict(tot, calls=sum(keys.values()), shapes=rows)
        print(f"{label} {name} ({sum(keys.values())} calls): forward {tot['fwd_ms']:.3f} ms in "
              f"{tot['fwd_launches']:.0f} launches, backward {tot['bwd_ms']:.3f} ms in "
              f"{tot['bwd_launches']:.0f} launches", flush=True)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"gn_times_{label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:])

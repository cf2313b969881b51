"""Sensitivity of ``chip_smoke.py`` phase 13's f32-relative check to a
planted fault: on the kernel route of ``UNet3DDeepSup`` at full width (base
32, 14 classes, one 4 x 64 x 192 x 192 bf16 tile batch, seeded weights),
the GroupNorm -> ReLU before the 1/8-scale deep head (C = 128 at
8 x 24 x 24) is scaled by 1.0 (no fault), 1.01 and 1.03 at run time; for
each output, the relative L2 distances kernel vs plain, kernel vs an f32
forward (the plain route on the f32 input) and plain vs f32, and whether
phase 13's ``F32_RATIO`` check fails it.

    PYTHONPATH=. python3 multimodal_pl_tpu_torch/tools/ablation_fault.py [OUTDIR]

Needs one GPU; writes ``OUTDIR/ablation_fault.json`` (default
``chiprun_out``).
"""

from __future__ import annotations

import json
import os
import sys

FAULTS = (1.0, 1.01, 1.03)
SITE = (128, (8, 24, 24))  # channels and (D, H, W) of the faulted call


def main(outdir: str = "chiprun_out") -> dict:
    import torch

    import chip_smoke as cs
    from multimodal_pl_tpu_torch.models import UNet3DDeepSup, blocks

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    clean = blocks.group_norm_relu
    x = torch.randn((cs.WINDOW_BATCH, *cs.TILE, 1),
                    generator=torch.Generator().manual_seed(2)).to(dev, torch.bfloat16)
    out = {}
    try:
        for fault in FAULTS:
            def planted(x, w, b, groups, impl, fault=fault):
                y = clean(x, w, b, groups, impl)
                if impl == "kernel" and (x.shape[-1], tuple(x.shape[1:4])) == SITE:
                    y = y * fault
                return y

            blocks.group_norm_relu = planted
            nets = {impl: UNet3DDeepSup(conv_impl=impl, gn_impl=impl,
                                        generator=torch.Generator().manual_seed(13)).to(dev).eval()
                    for impl in ("kernel", "plain")}
            with torch.inference_mode():
                k = cs._flat(nets["kernel"](x))
                p = cs._flat(nets["plain"](x))
                f = cs._flat(nets["plain"](x.float()))
            row = {"kernel_vs_plain": [cs._rel(a, b) for a, b in zip(k, p)],
                   "kernel_vs_f32": [cs._rel(a, b) for a, b in zip(k, f)],
                   "plain_vs_f32": [cs._rel(a, b) for a, b in zip(p, f)]}
            row["fails_check"] = [kf > cs.F32_RATIO * pf for kf, pf in
                                  zip(row["kernel_vs_f32"], row["plain_vs_f32"])]
            out[str(fault)] = row
            print(f"fault x{fault}: " + json.dumps(row), flush=True)
            del nets, k, p, f
            torch.cuda.empty_cache()
    finally:
        blocks.group_norm_relu = clean
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "ablation_fault.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:])

"""Where the conv kernel's time goes: device times of source variants of
``csrc/conv3x3_gn.cu`` at the serving path's largest shapes.

Each variant is the kernel's source with one phase removed (its results are
wrong; only the time counts): ``no_mma`` issues no wgmma, ``no_prologue``
skips the prologue pass over the staged halo, ``no_stores`` skips the
epilogue's global loads and stores. The difference to ``base`` is what the
phase costs where it does not overlap the rest. Each variant is built with
nvcc into the package's ``build/variants`` and loaded in place of the
kernel; the times go to ``OUTDIR/conv_variants.json``.

    PYTHONPATH=. python3 -m multimodal_pl_tpu_torch.tools.conv_variants [OUTDIR]
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

VARIANTS = {
    "base": [],
    "no_mma": [("for (int m = 0; m < MT; ++m) Wgmma<N>::mma(acc[m], slot[s][m], desc);", "")],
    "no_prologue": [("      apply_prologue<N, KSTEPS>(p, hb, c, arow, brow, bk);\n", "")],
    "no_stores": [("    if (gd >= p.D || gh >= p.H || gw >= p.W || n >= p.Cout) continue;",
                   "    continue;")],
}
# (B, D, H, W, Cin, Cout, prologue, residual)
SHAPES = ((4, 64, 192, 192, 32, 32, True, True), (4, 32, 96, 96, 64, 64, True, True),
          (4, 16, 48, 48, 128, 128, True, True), (4, 8, 24, 24, 256, 256, True, True))


def _build(name: str, src: str, outdir: str) -> str:
    from multimodal_pl_tpu_torch.ops import _build as build

    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: the kernel source no longer has {old!r}")
        src = src.replace(old, new)
    path = os.path.join(outdir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    out = os.path.join(outdir, f"lib{name}.so")
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", out, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    return out


def main(outdir: str = "chiprun_out") -> dict:
    import torch

    from multimodal_pl_tpu_torch.ops import _build as build
    from multimodal_pl_tpu_torch.ops import conv3x3
    from multimodal_pl_tpu_torch.ops.norm import group_norm_fold
    from multimodal_pl_tpu_torch.tools.timing import graph_ms

    if not torch.cuda.is_available():
        raise SystemExit("conv_variants: needs an NVIDIA GPU")
    vdir = str(build.BUILD_DIR / "variants")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(outdir, exist_ok=True)
    src = (build.CSRC_DIR / "conv3x3_gn.cu").read_text()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(lambda n: _build(n, src, vdir), VARIANTS)))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        lib.conv3x3_gn_bf16.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.conv3x3_gn_bf16.restype = ctypes.c_int
        lib.conv3x3_gn_error_string.argtypes = [ctypes.c_int]
        lib.conv3x3_gn_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    own_lib = conv3x3._lib
    rows = []
    try:
        for b, d, h, w_, cin, cout, pro, with_res in SHAPES:
            x = torch.randn((b, d, h, w_, cin), generator=g).to(dev, torch.bfloat16)
            w = (torch.randn((cout, cin, 3, 3, 3), generator=g) * 0.05).to(dev, torch.bfloat16)
            a = bb = res = None
            if pro:
                a, bb = group_norm_fold(x, torch.ones(cin, device=dev),
                                        torch.zeros(cin, device=dev), 16)
            if with_res:
                res = torch.randn((b, d, h, w_, cout), generator=g).to(dev, torch.bfloat16)
            row = {"shape": [b, d, h, w_, cin, cout, pro, with_res]}
            for name, lib in libs.items():
                conv3x3._lib = lambda lib=lib: lib
                row[name] = graph_ms(lambda: conv3x3.conv3x3_gn(x, w, a, bb, res), 10)
            rows.append(row)
            print(f"B={b} {cin}->{cout} @{d}x{h}x{w_}: " + ", ".join(
                f"{n} {row[n]:.4f} ms" for n in VARIANTS), flush=True)
            del x, w, a, bb, res
    finally:
        conv3x3._lib = own_lib
    with open(os.path.join(outdir, "conv_variants.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "rows": rows}, f, indent=1)
    return {"rows": rows}


if __name__ == "__main__":
    main(*sys.argv[1:])

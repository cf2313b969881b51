"""A planted halo fault in the H-split (``--mesh space:N``) forward: what the
checks of ``chip_smoke.py`` phase 14 read when one rank's low halo rows are
zeroed at one conv.

:func:`zero_low_halo` patches one block of a model built with a
SpatialGroup so that on one rank the rows its stride-1 convs receive from the
slab below are zeros. :func:`run` holds such a forward, on two gloo ranks
spawned on the card, against the one-rank kernel forward and an f32 forward
of the same tile batch, with phase 14's criteria (logits rel L2 <= 3e-2 and
label agreement >= 0.95 against the one-rank forward; rel L2 to f32 at most
1.05 times the one-rank forward's), and reports which of them fail. Run on
the card from the repository root:

    PYTHONPATH=. python3 multimodal_pl_tpu_torch/tools/spatial_fault.py [OUTDIR]

(about a minute with the build); the numbers also go to
``OUTDIR/spatial_fault.json`` (default ``chiprun_out``).
"""

from __future__ import annotations

import functools
import json
import os
import sys

import torch

REL_LIMIT = 3e-2      # phase 14: two ranks vs the one-rank kernel forward
AGREE_LIMIT = 0.95
F32_RATIO = 1.05      # rel L2 to f32: sharded <= 1.05 x unsharded


def zero_low_halo(net, space, rank: int = 1, module: str = "layer0.0"):
    """On ``rank``, the NoBottleneck ``module`` of ``net`` attaches zeros in
    place of the rows of the slab below (its two stride-1 convs and the
    residual read them). Returns net."""
    block = net.get_submodule(module)
    real = block._halo

    def halo(x):
        ext, lo = real(x)
        if space.rank == rank and lo:
            ext = ext.clone()
            ext[:, :, :lo] = 0
        return ext, lo

    block._halo = halo
    return net


def criteria(got, one_rank, f32) -> dict:
    """Phase 14's numbers for the logits ``got`` of the H-split forward
    against the one-rank kernel forward's and an f32 forward's (CPU
    tensors), and whether each limit holds."""
    got, one_rank, f32 = (t.float() for t in (got, one_rank, f32))
    rel = ((got - one_rank).norm() / one_rank.norm()).item()
    agree = (got.argmax(-1) == one_rank.argmax(-1)).float().mean().item()
    ratio = ((got - f32).norm() / (one_rank - f32).norm()).item()
    return {"rel_l2": rel, "agreement": agree, "f32_ratio": ratio,
            "rel_ok": rel <= REL_LIMIT, "agree_ok": agree >= AGREE_LIMIT,
            "ratio_ok": ratio <= F32_RATIO}


def run(weights, x, one_rank, f32, modules=("layer0.0",), rank: int = 1, device="cuda:0",
        backend: str = "gloo") -> dict:
    """{module: criteria} of the two-rank forward of UNet3DFEAM(deep_up=True)
    holding ``weights`` on the tile batch ``x`` (CPU, bf16), each with the
    low halo of ``rank`` zeroed at that module."""
    from multimodal_pl_tpu_torch.tools import spawn

    calls = [(spawn.sp_forward, ({"deep_up": True}, weights, x, device, "UNet3DFEAM", False,
                                 functools.partial(zero_low_halo, rank=rank, module=m)))
             for m in modules]
    ranks = spawn.run(spawn.dp_calls, 2, calls, backend=backend, timeout=600)
    return {m: criteria(out[0], one_rank, f32) for m, out in zip(modules, ranks[0])}


def main(outdir: str = "chiprun_out") -> int:
    from multimodal_pl_tpu_torch.models import UNet3DFEAM

    dev = torch.device("cuda")
    model = UNet3DFEAM(deep_up=True, generator=torch.Generator().manual_seed(0))
    weights = model.state_dict()
    x = torch.randn((4, 64, 192, 192, 1), generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16)
    plain = UNet3DFEAM(deep_up=True, conv_impl="plain", gn_impl="plain")
    plain.load_state_dict(weights)
    with torch.inference_mode():
        one_rank = model.to(dev).eval()(x.to(dev), aux=False).float().cpu()
        f32 = plain.to(dev).eval()(x.to(dev).float(), aux=False).float().cpu()
    del model, plain
    torch.cuda.empty_cache()
    out = run(weights, x, one_rank, f32, modules=("layer0.0", "layer4.1", "x1_resb.0"))
    for module, c in out.items():
        print(f"zeroed low halo at {module} on rank 1: rel L2 vs one rank {c['rel_l2']:.3e} "
              f"(limit {REL_LIMIT}), agreement {c['agreement']:.5f} (limit {AGREE_LIMIT}), "
              f"rel to f32 {c['f32_ratio']:.3f} x the one-rank forward's (limit {F32_RATIO}): "
              f"{'caught' if not all((c['rel_ok'], c['agree_ok'], c['ratio_ok'])) else 'MISSED'}",
              flush=True)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "spatial_fault.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))

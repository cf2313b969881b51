"""A planted halo fault in the H-split (``--mesh space:N``) forward: what the
checks of ``chip_smoke.py`` phase 14 read when one rank's low halo rows are
zeroed at one conv.

:func:`zero_low_halo` patches one block of a model built with a
SpatialGroup so that on one rank the rows its stride-1 convs receive from the
slab below are zeros. :func:`run` holds such a forward, on two gloo ranks
spawned on the card, against the one-rank kernel forward and an f32 forward
of the same tile batch, with phase 14's criteria (logits rel L2 <= 3e-2 and
label agreement >= 0.95 against the one-rank forward; rel L2 to f32 at most
1.05 times the one-rank forward's; each level's output, the two ranks' slabs
against the one-rank forward's rows, rel L2 <= 0.1), and reports which of
them fail, with the clean forward's level readings beside them. A zeroed
halo at the 1/16 scale moves the logits little (the decoder upsamples it
away) but its own level by far more than bf16 rounding does, so the level
check catches what the logits' checks miss. Run on the card from the
repository root:

    PYTHONPATH=. python3 multimodal_pl_tpu_torch/tools/spatial_fault.py [OUTDIR]

(about a minute with the build); the numbers also go to
``OUTDIR/spatial_fault.json`` (default ``chiprun_out``).

Two planted faults of the spatial train step's backward
(``parallel.spatial.make_spatial_train_step``), each a ``prepare(step,
space)`` for ``tools/spawn.py`` ``sp_step``: :func:`drop_halo_grads` (a halo
row's gradient never returned to the rank that owns the row) and
:func:`loss_counted_per_rank` (the losses' sums over the ranks by
``torch.distributed.nn.functional.all_reduce``, whose backward all-reduces
the gradient again: each rank's slab gets the gradient of N copies of the
loss). ``tests/test_torch_port_spatial_step.py`` and ``chip_smoke.py`` phase
16 show that their steps miss the step's tolerances.

A planted fault of the split EAM cascade, a ``prepare(model, space)`` for
``tools/spawn.py`` ``sp_forward``: :func:`unmerged_softmax` (each rank takes
its own slab's softmax over the voxels, unmerged).
``tests/test_torch_port_spatial_rest.py`` shows that the tokens then miss
the tolerance.
"""

from __future__ import annotations

import json
import os
import sys

import torch

REL_LIMIT = 3e-2      # phase 14: two ranks vs the one-rank kernel forward
AGREE_LIMIT = 0.95
F32_RATIO = 1.05      # rel L2 to f32: sharded <= 1.05 x unsharded
# each level: the ranks' slabs vs the one-rank forward's rows. A clean split
# of phase 14's tile batch reads up to 3.9e-2 (fusionConv, the 1/16 scale:
# bf16 rounding grows with depth, and the conv's split-K plan follows the
# slab shape); a zeroed halo at layer4.1 reads 0.207 at layer4, at layer0.0
# 0.397 at fusionConv (H100 runs; the kernels are deterministic)
LEVEL_REL = 0.1
# UNet3DFEAM's stage outputs, full resolution down to 1/16 and back up
LEVELS = ("layer0", "layer1", "layer2", "layer3", "layer4", "fusionConv", "x8_resb",
          "x4_resb", "x2_resb", "x1_resb")


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


def drop_halo_grads(step=None, space=None):
    """The halo exchange's backward keeps each attached row's gradient on
    the rank that attached it: no rank adds its neighbours' gradients to
    its boundary rows (the exchange itself still runs, so the ranks stay in
    step; a repeated edge row's gradient still adds into the edge row).
    Returns the undo."""
    from multimodal_pl_tpu_torch.parallel import spatial

    real = spatial._HaloRows.backward

    def backward(ctx, g):
        real(ctx, g)
        r, n, nb, h = ctx.space.rank, ctx.space.world, ctx.below, ctx.h
        gx = g[:, :, nb:nb + h].clone()
        if ctx.edge == "repeat" and r == 0 and ctx.lo:
            gx[:, :, :1] += g[:, :, :nb].sum(2, keepdim=True)
        if ctx.edge == "repeat" and r == n - 1 and ctx.hi:
            gx[:, :, h - 1:] += g[:, :, nb + h:].sum(2, keepdim=True)
        return gx, None, None, None, None

    spatial._HaloRows.backward = staticmethod(backward)
    return lambda: setattr(spatial._HaloRows, "backward", staticmethod(real))


def loss_counted_per_rank(step=None, space=None):
    """``SpatialGroup.sum`` by ``torch.distributed.nn.functional.all_reduce``:
    its backward sums the incoming gradient over the ranks again. Returns
    the undo."""
    import torch.distributed.nn.functional as dnn

    from multimodal_pl_tpu_torch.parallel import spatial

    real = spatial.SpatialGroup.sum
    spatial.SpatialGroup.sum = lambda self, t: dnn.all_reduce(t, group=self.group)
    return lambda: setattr(spatial.SpatialGroup, "sum", real)


def unmerged_softmax(net=None, space=None):
    """On every rank, ``space.softmax_product`` is the slab's own softmax
    product: the voxels of the other slabs never enter the EAM's token
    update. Patches this SpatialGroup instance only. Returns net."""
    def own(scores, v):
        return torch.softmax(scores, -1) @ v.float()

    object.__setattr__(space, "softmax_product", own)
    return net


def _keep_outputs(net, levels) -> dict:
    """{level: its output of the latest forward}, kept by forward hooks."""
    out = {}
    for name in levels:
        net.get_submodule(name).register_forward_hook(
            lambda mod, args, y, name=name: out.__setitem__(name, y))
    return out


def level_sums(weights, x, device="cpu", fault=None, levels=LEVELS):
    """Rank r of a spatial group over the default group: the H-split forward
    of UNet3DFEAM(deep_up=True) holding ``weights`` on this rank's slab of
    the tile batch ``x`` (with ``zero_low_halo(**fault)`` planted first when
    ``fault`` is a dict), and the unsplit forward of the same weights on the
    whole of ``x`` in this process. Returns ({level: (sum of (split -
    whole)^2, sum of whole^2)} over this rank's rows of each level's output,
    which :func:`readings` sums over the ranks; the split forward's logits,
    gathered whole, on the CPU)."""
    import torch.distributed as dist

    from multimodal_pl_tpu_torch.parallel import spatial
    from multimodal_pl_tpu_torch.tools.spawn import _on, _spatial_model

    device = _on(device)
    space = spatial.SpatialGroup.of(dist.group.WORLD)
    split = _spatial_model("UNet3DFEAM", {"deep_up": True}, weights, device, space)
    if fault is not None:
        zero_low_halo(split, space, **fault)
    whole = _spatial_model("UNet3DFEAM", {"deep_up": True}, weights, device, None)
    got, ref = _keep_outputs(split, levels), _keep_outputs(whole, levels)
    logits = spatial.make_spatial_apply(split, space)(
        spatial.put_spatial(x.to(device), space), aux=False)
    with torch.inference_mode():
        whole(x.to(device), aux=False)
    out = {}
    for name in levels:
        mine = ref[name].chunk(space.world, dim=2)[space.rank].float()
        out[name] = (float((got[name].float() - mine).square().sum()),
                     float(mine.square().sum()))
    return out, logits.cpu()


def readings(ranks_out, one_rank, f32) -> dict:
    """Phase 14's criteria (:func:`criteria`) of one case's
    :func:`level_sums` on every rank, with "levels": {level: rel L2 of the
    split forward's output against the unsplit one's} and "levels_ok"."""
    sums = [r[0] for r in ranks_out]
    levels = {name: (sum(r[name][0] for r in sums) / sum(r[name][1] for r in sums)) ** 0.5
              for name in sums[0]}
    return dict(criteria(ranks_out[0][1], one_rank, f32), levels=levels,
                levels_ok=max(levels.values()) <= LEVEL_REL)


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
    """{module: :func:`readings`} of the two-rank forward of
    UNet3DFEAM(deep_up=True) holding ``weights`` on the tile batch ``x``
    (CPU, bf16), each with the low halo of ``rank`` zeroed at that module,
    and under None the clean forward's."""
    from multimodal_pl_tpu_torch.tools import spawn

    cases = (None, *modules)
    calls = [(level_sums, (weights, x, device, m and {"rank": rank, "module": m}))
             for m in cases]
    ranks = spawn.run(spawn.dp_calls, 2, calls, backend=backend, timeout=600)
    return {m: readings([r[i] for r in ranks], one_rank, f32) for i, m in enumerate(cases)}


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
        levels = " ".join(f"{k} {v:.2e}" for k, v in c["levels"].items())
        caught = not all((c["rel_ok"], c["agree_ok"], c["ratio_ok"], c["levels_ok"]))
        verdict = ("caught" if caught else "MISSED") if module else (
            "FAILS" if caught else "passes")
        print(f"{f'zeroed low halo at {module} on rank 1' if module else 'clean'}: "
              f"rel L2 vs one rank {c['rel_l2']:.3e} "
              f"(limit {REL_LIMIT}), agreement {c['agreement']:.5f} (limit {AGREE_LIMIT}), "
              f"rel to f32 {c['f32_ratio']:.3f} x the one-rank forward's (limit {F32_RATIO}); "
              f"per level {levels} (limit {LEVEL_REL}): {verdict}", flush=True)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "spatial_fault.json"), "w") as f:
        json.dump({str(k): v for k, v in out.items()}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))

"""Probes of the kernel route against the plain routes at the partial-label
campaign's shapes (B = 3 x 64 x 96 x 96), from trained states.

The campaign (``tools/campaign.py``) trains the full-width FEAM on the
kernel route: the hand-written kernels in bf16. Its plain route
(``--pallas_gn false --pallas_k2 false``) runs their plain PyTorch versions
in bf16, and the f32 route those versions in f32. Each probe runs from a
checkpoint of a campaign run (``ckpt_<step>.pt``) on the campaign's own
device batches (``DeviceDataPipeline`` over the fixture's train split) and
prints one line of numbers per state:

1. ``determinism``: two kernel-route steps from one state and batch give
   the same bits (every tensor of the new state);
2. ``leaves``: phase 7's per-leaf rule (``chip_smoke.py``) per batch: each
   segmenter and refiner gradient leaf of the kernel step against the f32
   step, beside the plain bf16 step's distance, and with the roles
   swapped; and per leaf the signed
   projection of each route's gradient error on the f32 gradient,
   sum_b <g_route - g_f32, g_f32> / sum_b |g_f32|^2, with the z-score of
   the per-batch projections: a leaf whose error keeps one sign is biased;
3. ``rest``: the refiner's gradient-free pass over the rows that sample 0
   does not supervise (its output is the consistency term's pseudo-label
   target, ``train/step.py``), on the same inputs by each route; per organ
   the shift of the mean foreground probability and of the count of
   foreground voxels against the f32 route, signed, averaged over the
   batches with its z-score, and the dice of the thresholded maps;
4. ``bias``: every kernel call of one kernel-route step (the convs forward
   and dx, the fused conv, the fold, GroupNorm -> ReLU forward and
   backward, the upsample forward and backward) on the inputs that the step
   gave it: mean(kernel - f32) / rms(f32) beside mean(plain - f32) /
   rms(f32) per kernel and shape, the f32 value being the plain version's
   without its final rounding.

    python -m multimodal_pl_tpu_torch.tools.route_probe --root ROOT --ckpt CKPT [--ckpt ...] \\
        [--probes determinism,leaves,rest,bias] [--batches 32] [--leaf_batches 8] \\
        [--json OUT] [--device cpu]

ROOT is a campaign root (its fixture); the checkpoints come from a
kernel-route run on it. It runs on the GPU unless ``--device cpu`` is given
(on the CPU every route runs the plain versions, so only the arithmetic is
exercised). TF32 is off throughout.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os

import numpy as np
import torch
from torch.func import functional_call

PROBES = ("determinism", "leaves", "rest", "bias")
Z_FLAG = 3.0  # |z| above which a signed shift counts as a bias
LEAF_SHARE = 0.1  # a flagged leaf's bias: at least this share of plain bf16's own error


def route_configs(cfg):
    """{'kernel', 'plain', 'f32'}: the kernel route in bf16, the plain
    versions in bf16 and in f32, of one StepConfig."""
    plain = dataclasses.replace(cfg, conv_impl="plain", gn_impl="plain",
                                compute_dtype=torch.bfloat16)
    return {"kernel": dataclasses.replace(cfg, conv_impl="kernel", gn_impl="kernel",
                                          compute_dtype=torch.bfloat16),
            "plain": plain, "f32": dataclasses.replace(plain, compute_dtype=torch.float32)}


def campaign_config(root: str, epochs: int = 2500, extra=()):
    """The StepConfig that ``tools/campaign.py run`` trains on ``root``
    with, and its seed (``extra``: the run's other flags)."""
    from multimodal_pl_tpu_torch.cli.train import get_arguments, step_config
    from multimodal_pl_tpu_torch.tools import campaign

    args = get_arguments().parse_args(
        campaign.chunk_argv(root, os.path.join(root, "snapshots"), epochs, 0, epochs)
        + list(extra))
    return step_config(args), args.seed


def campaign_batches(root: str, cfg, n: int, seed: int = 0, device="cuda",
                     tile=(64, 96, 96), batch_size: int = 3) -> list:
    """``n`` device batches of the campaign's training stream on ``root``:
    the device pipeline over the train split, seeded as the trainer seeds
    it, epoch after epoch."""
    from multimodal_pl_tpu_torch.data.dataset import AMOSDataset
    from multimodal_pl_tpu_torch.data.device_cache import DeviceDataPipeline

    ds = AMOSDataset(os.path.join(root, "imagesTr"), crop_size=tile, usage="train",
                     atlas=np.load(os.path.join(root, "atlas_mm.npy")),
                     supervision_csv=os.path.join(root, "supervise_mask.csv"), seed=seed,
                     cache=True)
    pipe = DeviceDataPipeline(ds, compute_dtype=cfg.compute_dtype, seed=seed, device=device)
    out = []
    per_epoch = len(ds) // batch_size
    for b in pipe.batches(batch_size, epochs=-(-n // per_epoch)):
        out.append({k: v.clone() for k, v in b.items()})
        if len(out) == n:
            break
    return out


def schedule(state, cfg, lr: float = 5e-4):
    """(lr, weight_feature) of the state's epoch, as the loop computes them."""
    from multimodal_pl_tpu_torch.losses.compose import feature_ramp
    from multimodal_pl_tpu_torch.train.step import poly_lr

    dev = state.step.device
    return (poly_lr(lr, state.epoch, cfg.num_epochs).to(dev),
            feature_ramp(state.epoch, cfg.pretrain_epoch, cfg.ramp_until,
                         cfg.weight_feature_max).to(dev))


def make_steps(cfgs: dict, device) -> dict:
    """{name: TrainStep} of route configs, the models on ``device``."""
    from multimodal_pl_tpu_torch.train.state import build_models
    from multimodal_pl_tpu_torch.train.step import make_train_step

    return {name: make_train_step(*(m.to(device) for m in build_models(c)), c)
            for name, c in cfgs.items()}


def shift(values) -> dict:
    """Mean, standard deviation, count and z-score (the mean over its
    standard error; 0 where every value is 0) of signed per-batch values."""
    v = np.asarray(values, np.float64)
    n = len(v)
    mean = float(v.mean()) if n else 0.0
    sd = float(v.std(ddof=1)) if n > 1 else 0.0
    if sd > 0:
        z = mean / (sd / math.sqrt(n))
    else:
        z = 0.0 if mean == 0 else math.copysign(math.inf, mean)
    return {"mean": mean, "sd": sd, "n": n, "z": z}


# ---- 1. determinism -------------------------------------------------------

def _state_tensors(state) -> dict:
    out = {}
    for group in ("params", "rparams", "dparams", "tokens"):
        out.update({f"{group}.{k}": v for k, v in getattr(state, group).items()})
    for i, tree in enumerate(state.momentum):
        out.update({f"momentum{i}.{k}": v for k, v in tree.items()})
    return out


def determinism(step, state, batch, lr, wf) -> dict:
    """Two steps from one state and batch: the tensors of the new states
    that differ, and the largest difference."""
    a, _ = step(state, batch, lr, wf)
    b, _ = step(state, batch, lr, wf)
    ta, tb = _state_tensors(a), _state_tensors(b)
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    worst = max(((ta[k].float() - tb[k].float()).abs().max().item() for k in differ),
                default=0.0)
    return {"tensors": len(ta), "differ": len(differ), "max_abs": worst,
            "first": differ[:5]}


# ---- 2. gradient leaves ----------------------------------------------------

def route_grads(step, state, batch, wf) -> dict:
    """{'params.'/'rparams.' + leaf: f32 gradient} of one gradient step."""
    _, (gp, gr), _ = step.grads(state, batch, wf)
    return {**{"params." + k: g.detach().float() for k, g in gp.items()},
            **{"rparams." + k: g.detach().float() for k, g in gr.items()}}


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def leaves(steps: dict, state, batches, wf, ref: str = "f32", base: str = "plain",
           ratio: float = 1.4, floor: float = 1e-2) -> dict:
    """Phase 7's per-leaf rule per batch for every route but ``ref`` and
    ``base`` (distance from ``ref`` <= ratio x ``base``'s + floor), and the
    same rule with the two routes' roles swapped (how often noise of the
    same size fails it), and per
    leaf and route the signed projection of the gradient error on the
    ``ref`` gradient, sum_b <g_route - g_ref, g_ref> / sum_b |g_ref|^2 over
    the batches, with the z-score of the per-batch projections; and the
    same of the route's excess over ``base``, <g_route - g_base, g_ref>: the
    route's own error, without the rounding that both bf16 routes share."""
    routes = [r for r in steps if r != ref]
    dots = {r: {} for r in routes}      # leaf -> per-batch <g_r - g_ref, g_ref>
    excess = {r: {} for r in routes if r != base}  # <g_r - g_base, g_ref>
    norms = {}                          # leaf -> per-batch |g_ref|^2
    base_dist = {}                      # leaf -> per-batch |g_base - g_ref| / |g_ref|
    checks = []
    for batch in batches:
        g = {r: route_grads(s, state, batch, wf) for r, s in steps.items()}
        f = g[ref]
        for k, v in f.items():
            norms.setdefault(k, []).append(torch.sum(v * v).item())
        for r in routes:
            for k, v in g[r].items():
                dots[r].setdefault(k, []).append(torch.sum((v - f[k]) * f[k]).item())
                if r in excess:
                    excess[r].setdefault(k, []).append(
                        torch.sum((v - g[base][k]) * f[k]).item())
        dist = {r: {k: _rel(g[r][k], f[k]) for k in f} for r in routes}
        for k in f:
            base_dist.setdefault(k, []).append(dist[base][k])
        for r in excess:
            for a, b in ((r, base), (base, r)):  # the rule, and the same with the roles swapped
                worst = max(f, key=lambda k: dist[a][k] - ratio * dist[b][k])
                ratios = [dist[a][k] / max(dist[b][k], 1e-30) for k in f]
                checks.append({"route": a, "against": b, "passes": dist[a][worst]
                               <= ratio * dist[b][worst] + floor, "worst": worst,
                               "dist": dist[a][worst], "base_dist": dist[b][worst],
                               "median_ratio": float(np.median(ratios)),
                               "max_ratio": float(max(ratios))})
        del g

    def project(table):
        out = {}
        for k, d in table.items():
            per = [x / max(n, 1e-30) for x, n in zip(d, norms[k])]
            out[k] = dict(shift(per), proj=sum(d) / max(sum(norms[k]), 1e-30),
                          base_dist=float(np.mean(base_dist[k])))
        return out

    return {"checks": checks, "projection": {r: project(t) for r, t in dots.items()},
            "excess": {r: project(t) for r, t in excess.items()}}


def flagged_leaves(excess: dict, route: str, z: float = Z_FLAG, share: float = LEAF_SHARE) -> list:
    """Leaves whose excess projection over the base route keeps one sign
    (|z| > z) on ``route`` and is at least ``share`` of the base route's own
    distance from the reference (a bias of a size that can matter), most
    significant first."""
    rows = [(k, v) for k, v in excess[route].items()
            if abs(v["z"]) > z and abs(v["proj"]) >= share * v["base_dist"]]
    return [k for k, _ in sorted(rows, key=lambda kv: -abs(kv[1]["z"]))]


# ---- 3. the refiner's rest pass -------------------------------------------

def rest_inputs(step, state, batch, wf):
    """(organ probabilities (nfg, D, H, W) in the compute dtype, atlas,
    rest rows) of sample 0, as ``step`` feeds its refiner: the segmenter's
    training forward (its graph discarded), the rows that sample 0 does not
    supervise in the labeled modality after the K gradient rows."""
    params = {n: p.detach().requires_grad_(True) for n, p in state.params.items()}
    rparams = {n: p.detach() for n, p in state.rparams.items()}
    with torch.enable_grad():
        _, aux = step.losses(params, rparams, state, batch, wf)
    cfg = step.cfg
    tlist_w = batch["label_t"] * batch["sup_mask"][1:]
    order = torch.argsort(-tlist_w, stable=True)
    k = min(cfg.refine_grad_organs, cfg.num_classes - 1)
    return aux["organs"].detach(), aux["catlas"].detach(), order[k:]


@torch.no_grad()
def rest_logits(step, rparams, organs, catlas, rows) -> torch.Tensor:
    """The refiner of ``step`` on ``rows`` without autograd, in its
    compute dtype, as f32 logits (R, D, H, W, 2)."""
    dt = step.cfg.compute_dtype
    return functional_call(step.refiner, rparams,
                           ((organs[rows].to(dt), catlas[rows].to(dt)),)).float()


def _dice(a: torch.Tensor, b: torch.Tensor) -> float:
    inter = (a & b).sum().item()
    total = a.sum().item() + b.sum().item()
    return 1.0 if total == 0 else 2.0 * inter / total


def rest_pairs(routes, ref: str = "f32", base: str = "plain") -> list:
    """(route, against) pairs of the rest probe: every route against
    ``ref``, and every other bf16 route against ``base``."""
    pairs = [(r, ref) for r in routes if r != ref]
    return pairs + [(r, base) for r in routes if r not in (ref, base) and base in routes]


def rest(steps: dict, state, inputs, pairs=None) -> dict:
    """Per organ and (route, against) pair (``rest_pairs``): the signed
    shift of the mean foreground probability and of the foreground voxel
    count (argmax) over the batches (``shift``), and the mean dice of the
    foreground maps; keyed 'route-against'. ``inputs``: (organs, catlas,
    rest rows) per batch (``rest_inputs``)."""
    pairs = pairs or rest_pairs(steps)
    per = {p: {} for p in pairs}
    rparams = {n: p.detach() for n, p in state.rparams.items()}
    for organs, catlas, rows in inputs:
        out = {r: torch.softmax(rest_logits(s, rparams, organs, catlas, rows), -1)[..., 1]
               for r, s in steps.items()}
        for r, ref in pairs:
            for i, organ in enumerate(rows.tolist()):
                p, q = out[r][i], out[ref][i]
                rec = per[(r, ref)].setdefault(organ + 1, {"prob": [], "count": [], "dice": []})
                rec["prob"].append((p.mean() - q.mean()).item())
                rec["count"].append(((p > 0.5).sum() - (q > 0.5).sum()).item())
                rec["dice"].append(_dice(p > 0.5, q > 0.5))
    summary = {}
    for (r, ref), organs in per.items():
        rows = {o: {"prob": shift(v["prob"]), "count": shift(v["count"]),
                    "dice": float(np.mean(v["dice"]))} for o, v in sorted(organs.items())}
        rows["all"] = {key: shift([x for v in organs.values() for x in v[key]])
                       for key in ("prob", "count")}
        rows["all"]["dice"] = float(np.mean([x for v in organs.values() for x in v["dice"]]))
        summary[f"{r}-{ref}"] = rows
    return summary


def biased_organs(rows: dict, z: float = Z_FLAG) -> list:
    """The organs of one pair's rows whose mean foreground probability
    shifts with one sign (|z| > z)."""
    return [o for o, v in rows.items() if o != "all" and abs(v["prob"]["z"]) > z]


# ---- 4. signed bias per kernel --------------------------------------------

class BiasTable:
    """Per (kernel, shape, output): n, sums of (kernel - f32), (plain -
    f32), their squares and f32^2, from which :meth:`rows` forms the signed
    bias mean(route - f32) / rms(f32) and the error rms(route - f32) /
    rms(f32) of each route."""

    def __init__(self):
        self.acc = {}

    def add(self, key, kernel, plain, f32) -> None:
        k, p, f = (t.double() for t in (kernel, plain, f32))
        a = self.acc.setdefault(key, np.zeros(7))
        a += [f.numel(), (k - f).sum().item(), (p - f).sum().item(), (f * f).sum().item(),
              ((k - f) ** 2).sum().item(), ((p - f) ** 2).sum().item(), 1]

    def rows(self) -> list:
        out = []
        for key, (n, sk, sp, ff, kk, pp, calls) in self.acc.items():
            rms = math.sqrt(ff / n) if ff > 0 else 1.0
            out.append({"kernel": key[0], "shape": list(key[1]), "output": key[2],
                        "calls": int(calls), "n": int(n),
                        "bias_kernel": sk / n / rms, "bias_plain": sp / n / rms,
                        "err_kernel": math.sqrt(kk / n) / rms,
                        "err_plain": math.sqrt(pp / n) / rms})
        return out


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _conv_refs(x, w, a, b, res):
    """(plain bf16, f32) of the conv3x3_gn kernel's function on its inputs."""
    from multimodal_pl_tpu_torch.ops.conv3x3 import conv3x3_gn_reference

    t = x
    if a is not None:
        a, b = (r[:, None, None, None, :] for r in (a, b))
        t = torch.relu(x.float() * a + b).to(x.dtype)
    f32 = conv3x3_gn_reference(t.float(), w.float(), None, None,
                               None if res is None else res.float())
    return f32.to(x.dtype), f32


@contextlib.contextmanager
def capture_kernels(table: BiasTable):
    """While active, every kernel call through the ops' wrappers is also
    computed by its plain version, rounded as the plain route rounds and
    unrounded (f32), and the three are added to ``table``."""
    from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu, norm, resize

    orig = {"conv": conv3x3._launch, "fold": norm._fold_kernel,
            "gn_fwd": gn_relu.gn_relu_forward, "gn_bwd": gn_relu.gn_relu_backward,
            "up_fwd": resize.upsample_forward, "up_bwd": resize.upsample_backward}

    def conv(spec, x, w, a=None, b=None, res=None):
        y = orig["conv"](spec, x, w, a, b, res)
        with torch.no_grad():
            plain, f32 = _conv_refs(x, w, a, b, res)
            table.add((f"conv3x3 {spec}", (*x.shape, w.shape[0], res is not None), "y"),
                      y, plain, f32)
        return y

    def fold(x, scale, bias, groups, eps):
        a, b = orig["fold"](x, scale, bias, groups, eps)
        with torch.no_grad():
            pa, pb = norm.group_norm_fold(x, scale, bias, groups, eps, "plain")
            mean_c, inv_c = _stats64(x, groups, eps)
            fa = inv_c * scale.double()[None]
            fb = bias.double()[None] - mean_c * fa
            for name, k, p, f in (("a", a, pa, fa), ("b", b, pb, fb)):
                table.add(("fold", (*x.shape, groups), name), k, p, f)
        return a, b

    def gn_fwd(x, scale, bias, groups, path=None):
        y, stats = orig["gn_fwd"](x, scale, bias, groups, path)
        with torch.no_grad():
            plain = gn_relu.group_norm_relu_reference(x, scale, bias, groups)
            f32 = gn_relu.group_norm_relu_reference(x.float(), _bf16_round(scale),
                                                    _bf16_round(bias), groups)
            table.add(("gn_relu forward", (*x.shape, groups), "y"), y, plain, f32)
        return y, stats

    def gn_bwd(x, dy, scale, bias, stats, groups, path=None):
        dx, ds, dt = orig["gn_bwd"](x, dy, scale, bias, stats, groups, path)
        with torch.no_grad():
            pdx, pds, pdt = gn_relu.group_norm_relu_backward_reference(x, dy, scale, bias, stats,
                                                                       groups)
            fdx, fds, fdt = gn_relu.group_norm_relu_backward_reference(
                x.float(), dy.float(), _bf16_round(scale), _bf16_round(bias), stats, groups)
            key = (*x.shape, groups)
            for name, k, p, f in (("dx", dx, pdx, fdx), ("ds", ds, pds, fds), ("dt", dt, pdt, fdt)):
                table.add(("gn_relu backward", key, name), k, p, f)
        return dx, ds, dt

    def up_fwd(x, factor, skip=None):
        y = orig["up_fwd"](x, factor, skip)
        with torch.no_grad():
            plain = resize.upsample_trilinear_reference(x, factor, skip)
            f32 = resize.upsample_trilinear_reference(x.float(), factor,
                                                      None if skip is None else skip.float())
            table.add(("resize3d forward", (*x.shape, factor, skip is not None), "y"),
                      y, plain, f32)
        return y

    def up_bwd(dy, factor):
        dx = orig["up_bwd"](dy, factor)
        with torch.no_grad():
            plain = resize.upsample_trilinear_backward_reference(dy, factor)
            f32 = resize.upsample_trilinear_backward_reference(dy.float(), factor)
            table.add(("resize3d backward", (*dy.shape, factor), "dx"), dx, plain, f32)
        return dx

    patches = ((conv3x3, "_launch", conv), (norm, "_fold_kernel", fold),
               (gn_relu, "gn_relu_forward", gn_fwd), (gn_relu, "gn_relu_backward", gn_bwd),
               (resize, "upsample_forward", up_fwd), (resize, "upsample_backward", up_bwd))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield table
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _stats64(x, groups: int, eps: float):
    """Per-channel (mean, inv) rows (B, C) of GroupNorm in float64."""
    b, c = x.shape[0], x.shape[-1]
    xd = x.double().reshape(b, -1, groups, c // groups)
    mean = xd.mean(dim=(1, 3))
    inv = torch.rsqrt(((xd - mean[:, None, :, None]) ** 2).mean(dim=(1, 3)) + eps)
    return (mean.repeat_interleave(c // groups, -1), inv.repeat_interleave(c // groups, -1))


def kernel_bias(step, state, batches, wf) -> list:
    """Every kernel call of the kernel route's gradient step on each batch
    (forward, the gradient-free refiner pass and the backward), against
    its plain version (``capture_kernels``); rows per kernel, shape and
    output."""
    table = BiasTable()
    with capture_kernels(table):
        for batch in batches:
            route_grads(step, state, batch, wf)
    return table.rows()


# ---- command line ----------------------------------------------------------

def _line(tag: str, **nums) -> str:
    def fmt(v):
        return f"{v:.4g}" if isinstance(v, float) else str(v)

    return f"[{tag}] " + " ".join(f"{k}={fmt(v)}" for k, v in nums.items())


def probe_state(path: str, cfgs: dict, batches: list, probes, device, leaf_batches: int,
                say=print) -> dict:
    """Every probe of ``probes`` from the checkpoint at ``path``."""
    from multimodal_pl_tpu_torch.train.checkpoint import restore_checkpoint

    state = restore_checkpoint(path).to(device)
    steps = make_steps(cfgs, device)
    lr, wf = schedule(state, cfgs["kernel"])
    tag = f"{os.path.basename(path)} epoch {int(state.epoch)}"
    out = {"checkpoint": path, "epoch": int(state.epoch), "step": int(state.step)}
    if "determinism" in probes:
        d = determinism(steps["kernel"], state, batches[0], lr, wf)
        out["determinism"] = d
        say(_line(f"determinism {tag}", tensors=d["tensors"], differ=d["differ"],
                  max_abs=d["max_abs"]))
    if "leaves" in probes:
        lv = leaves(steps, state, batches[:leaf_batches], wf)
        out["leaves"] = dict(lv, flagged={r: flagged_leaves(lv["excess"], r)
                                          for r in lv["excess"]})
        for r, flags in out["leaves"]["flagged"].items():
            chk = [c for c in lv["checks"] if c["route"] == r]
            rev = [c for c in lv["checks"] if c["against"] == r]
            decoder = [v["proj"] for k, v in lv["excess"][r].items() if "_resb" in k
                       and k.startswith("params.x")]
            say(_line(f"leaves {r} {tag}", batches=len(chk),
                      passes=sum(c["passes"] for c in chk),
                      worst_ratio=max(c["max_ratio"] for c in chk),
                      median_ratio=float(np.median([c["median_ratio"] for c in chk])),
                      swapped_passes=sum(c["passes"] for c in rev),
                      swapped_worst_ratio=max(c["max_ratio"] for c in rev),
                      flagged=len(flags), decoder_excess=float(np.mean(decoder)),
                      first=",".join(flags[:3]) or "-"))
    if "rest" in probes:
        inputs = [rest_inputs(steps["kernel"], state, b, wf) for b in batches]
        rs = rest(steps, state, inputs)
        out["rest"] = {"pairs": rs, "biased": {p: biased_organs(v) for p, v in rs.items()}}
        for p, v in rs.items():
            a = v["all"]
            say(_line(f"rest {p} {tag}", prob_shift=a["prob"]["mean"], prob_z=a["prob"]["z"],
                      count_shift=a["count"]["mean"], count_z=a["count"]["z"],
                      dice=a["dice"], biased=",".join(map(str, out["rest"]["biased"][p]))
                      or "-"))
        del inputs
    if "bias" in probes:
        rows = kernel_bias(steps["kernel"], state, batches[:2], wf)
        out["bias"] = rows
        worst = max(rows, key=lambda r: abs(r["bias_kernel"]) - abs(r["bias_plain"]),
                    default=None)
        if worst:
            say(_line(f"bias {tag}", rows=len(rows), worst=f"{worst['kernel']}/{worst['output']}"
                      f"@{'x'.join(map(str, worst['shape']))}",
                      bias_kernel=worst["bias_kernel"], bias_plain=worst["bias_plain"],
                      err_kernel=worst["err_kernel"], err_plain=worst["err_plain"]))
    del steps, state
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True, help="the campaign root (its fixture)")
    p.add_argument("--ckpt", action="append", required=True, help="a checkpoint (repeatable)")
    p.add_argument("--probes", default=",".join(PROBES))
    p.add_argument("--batches", type=int, default=32, help="campaign batches (rest pass)")
    p.add_argument("--leaf_batches", type=int, default=8,
                   help="of those, the batches of the per-leaf probe")
    p.add_argument("--epochs", type=int, default=2500, help="the run's LR horizon")
    p.add_argument("--json", default="", help="write every number here")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    args, extra = p.parse_known_args(argv)
    from multimodal_pl_tpu_torch.cli.evaluate import resolve_device

    device = resolve_device(args.device)
    probes = [s for s in args.probes.split(",") if s]
    if set(probes) - set(PROBES):
        raise ValueError(f"--probes must name some of {PROBES}, got {probes}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, seed = campaign_config(args.root, args.epochs, extra)
    cfgs = route_configs(cfg)
    batches = campaign_batches(args.root, cfgs["kernel"], args.batches, seed, device)
    results = [probe_state(path, cfgs, batches, probes, device, args.leaf_batches)
               for path in args.ckpt]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=str)
    return results


if __name__ == "__main__":
    main()

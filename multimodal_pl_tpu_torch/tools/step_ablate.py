"""The ladder of the port's train step: counterpart of the JAX package's
``scripts/step_ablate.py``.

Each rung drops one more component of the step, so the difference between
adjacent rungs is that component's cost inside the whole step. The rungs are
the JAX script's ``RUNGS``:

  full        the production step (``train/step.py`` ``TrainStep``)
  nometrics   the metrics (organ and refiner dice) off: ``d`` and ``rd`` are 0
  norest      the refiner's gradient-free complement pass off: the rows it
              fills in the pseudo-labels stay zero
  nodisc      the GAN terms off: no generator term, no discriminator step
              (``dparams`` unchanged, ``dl`` = 0)
  norefiner   the refiner's gradient pass and refine loss off: its logits are
              zeros and its gradients zeros, on which SGD still runs (weight
              decay still moves ``rparams`` and their momentum)
  segonly     the consistency term off too (``segmentation_loss`` without
              refiner logits): the segmenter's forward, backward, SGD and
              token EMA alone

The JAX script's docstring names a ``noconsist`` rung (the consistency term
off alone) that its ``RUNGS`` lacks; the port mirrors ``RUNGS``, and
``AblatedStep(consist_on=False)`` builds that step. Each rung reports the JAX
ladder's metrics ``loss``, ``d``, ``rd``, ``dl``. The ladder runs on one
device: a data-parallel group or a split space raises ValueError.

    python -m multimodal_pl_tpu_torch.tools.step_ablate [--steps 8] [--patch 64,192,192] \\
        [--rungs full,nometrics,...] [--batch 1] [--route kernel|plain] [--device cuda] \\
        [--json chiprun_out/step_ablate.json]

The batch is the JAX script's (numpy ``default_rng(0)``: image, labels,
atlas; organ 3 supervised; lr 5e-4, weight_feature 0.05) with ``--batch``
rows of image and label; every rung starts from one
``create_train_state`` of seed 0. Per rung: the median wall ms/step of
``--steps`` steps after 2 warm-ups (each step waits for the device), the
component's cost (the previous rung's median less this one's), the
hand-written kernels' calls of one step, and, on a GPU, ``torch.profiler``
over 3 steps (``tools/profile_chip.py``): device-busy ms
and kernel launches per step by kernel category, and the busy share
(device-busy ms over the median). All rungs are timed before any is
profiled: once the profiler has run, the host's launches are slower. It
runs on the GPU unless ``--device cpu`` is given (there the profile is not
taken).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from multimodal_pl_tpu_torch.ops.norm import split
from multimodal_pl_tpu_torch.train.state import StepConfig
from multimodal_pl_tpu_torch.train.step import TrainStep

RUNGS = [
    ("full", {}),
    ("nometrics", dict(metrics_on=False)),
    ("norest", dict(metrics_on=False, rest_on=False)),
    ("nodisc", dict(metrics_on=False, rest_on=False, disc_on=False)),
    ("norefiner", dict(metrics_on=False, rest_on=False, disc_on=False, refiner_on=False)),
    ("segonly", dict(metrics_on=False, rest_on=False, disc_on=False, refiner_on=False,
                     consist_on=False)),
]
LABEL_T = [0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1]
SUP_ORGAN = 3
LR, WF = 5e-4, 0.05
WARMUP = 2          # steps before the timed ones, as the JAX script
PROFILE_STEPS = 3   # steps under torch.profiler per rung


class AblatedStep(TrainStep):
    """``TrainStep`` with components switched off (the JAX script's
    ``build_ablated_step``): ``step(state, batch, lr, weight_feature) ->
    (state, {'loss', 'd', 'rd', 'dl'})``. It overrides only the pieces of
    ``TrainStep`` that a switch drops; with every switch on it runs
    ``TrainStep``'s code and its new state is ``TrainStep``'s, bit for bit."""

    def __init__(self, model, refiner, disc, cfg: StepConfig, group=None, space=None, *,
                 metrics_on=True, rest_on=True, disc_on=True, refiner_on=True, consist_on=True):
        if group is not None or split(space):
            raise ValueError("the step ladder runs on one device: no data-parallel group and "
                             "no split space")
        super().__init__(model, refiner, disc, cfg)
        self.metrics_on, self.rest_on, self.disc_on = metrics_on, rest_on, disc_on
        self.refiner_on, self.consist_on = refiner_on, consist_on

    def refiner_passes(self, rparams, organ_probs, catlas_c, cmask0, tlist_w):
        if self.refiner_on:
            return super().refiner_passes(rparams, organ_probs, catlas_c, cmask0, tlist_w)
        # no refiner pass: the refine loss 0 and the logits zeros; rparams do
        # not reach the loss, so their gradients are zeros
        zero = organ_probs.new_zeros((), dtype=torch.float32)
        return zero, zero.new_zeros((*organ_probs.shape, 2))

    def rest_pass(self, rparams, organ_probs, catlas_c, rows):
        return super().rest_pass(rparams, organ_probs, catlas_c, rows) if self.rest_on else None

    def consistency_logits(self, rlogits, h: int):
        return rlogits if self.consist_on and self.refiner_on else None

    def generator_term(self, state, logits32, organs, catlas_c, label_t):
        if self.disc_on:
            return super().generator_term(state, logits32, organs, catlas_c, label_t)
        return None

    def disc_step(self, state, aux, batch, total):
        if self.disc_on:
            return super().disc_step(state, aux, batch, total)
        return state.dparams, total.new_zeros(()), total.new_ones((), dtype=torch.bool), total

    def step_metrics(self, aux, batch, lr, total, d_loss, g_ok, d_ok) -> dict:
        if self.metrics_on:
            aux = {"gan_g_loss": d_loss, **aux}  # no generator term with the GAN off
            m = super().step_metrics(aux, batch, lr, total, d_loss, g_ok, d_ok)
            d, rd = m["train_dice_mean"], m["refiner_dice_mean"]
        else:
            d = rd = total.new_zeros(())
        return {"loss": total, "d": d, "rd": rd, "dl": d_loss}


def ladder_batch(patch, batch: int = 1, num_classes: int = 14) -> dict:
    """The JAX script's seeded host batch, ``batch`` rows of image and
    label (numpy arrays)."""
    rng = np.random.default_rng(0)
    sup = np.zeros(num_classes, np.float32)
    sup[SUP_ORGAN] = 1
    return {"image": rng.standard_normal((batch, *patch, 1)).astype(np.float32),
            "label": rng.integers(0, num_classes, (batch, *patch)).astype(np.int32),
            "catlas": rng.random((num_classes - 1, *patch)).astype(np.float32),
            "sup_mask": sup, "label_t": np.asarray(LABEL_T, np.float32)}


def step_config(route: str) -> StepConfig:
    """The JAX script's StepConfig (bf16) on the kernel or the plain route."""
    return StepConfig(compute_dtype=torch.bfloat16, conv_impl=route, gn_impl=route)


def kernel_calls() -> dict:
    """The hand-written kernels' wrapper counts so far: {'conv3x3',
    'gn_relu', 'gn_relu_backward', 'fold', 'resize', 'resize_backward'}:
    calls."""
    from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu, norm, resize

    return {"conv3x3": sum(conv3x3.launches.values()), "gn_relu": sum(gn_relu.launches.values()),
            "gn_relu_backward": sum(gn_relu.bwd_launches.values()),
            "fold": sum(norm.fold_launches.values()), "resize": sum(resize.launches.values()),
            "resize_backward": sum(resize.bwd_launches.values())}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stepper(kw, models, cfg, batch, state, device):
    """One step of the rung ``kw`` at a time from ``state`` (a copy on
    ``device``; the step makes new tensors): a callable that returns the
    step's metrics."""
    step = AblatedStep(*models, cfg, **kw)
    box = [state.to(device)]
    lr, wf = torch.tensor(LR, device=device), torch.tensor(WF, device=device)

    def one_step():
        box[0], m = step(box[0], batch, lr, wf)
        return m

    return one_step


def time_rung(name, kw, models, cfg, batch, state, device, steps=8) -> dict:
    """Warm-up steps (the first counted: the hand-written kernels' calls of
    one step), then ``steps`` steps timed on the host clock, each waiting
    for the device."""
    one_step = _stepper(kw, models, cfg, batch, state, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    metrics = []
    for i in range(WARMUP):
        before = kernel_calls()
        m = one_step()
        if i == 0:
            calls = {k: n - before[k] for k, n in kernel_calls().items()}
        metrics.append({k: float(v) for k, v in m.items()})
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = one_step()
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    rec = {"name": name, "switches": kw, "step_ms": ms, "median_ms": statistics.median(ms),
           "kernel_calls": calls, "metrics": metrics}
    if device.type == "cuda":
        rec["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    return rec


def profile_rung(kw, models, cfg, batch, state, device, steps=PROFILE_STEPS) -> dict:
    """``torch.profiler`` over ``steps`` steps after one warm-up step, per
    step: device-busy ms, kernel launches and ms by category, and the
    profiled wall ms (inflated by the profiler's own tracing)."""
    from multimodal_pl_tpu_torch.tools.profile_chip import _profile

    one_step = _stepper(kw, models, cfg, batch, state, device)
    one_step()
    prof = _profile(one_step, steps)
    return {"device_busy_ms": prof["device_busy_ms"], "launches": prof["launches"],
            "profiled_wall_ms": prof["wall_ms"], "categories": prof["categories"]}


def run_ladder(patch=(64, 192, 192), batch=1, route="kernel", rungs=None, steps=8,
               device="cuda", say=print, profile_steps=PROFILE_STEPS) -> list:
    """The records of the rungs named in ``rungs`` (default all), in the
    order of RUNGS, each with ``component_ms``: the previous rung's median
    less its own (None for the first). Every rung is timed first, then on
    a GPU every rung is profiled, since the profiler, once started, slows
    the host's later launches; ``busy_share`` is the device-busy ms over
    the timed median."""
    from multimodal_pl_tpu_torch.train.loop import to_device
    from multimodal_pl_tpu_torch.train.state import build_models, create_train_state

    device = torch.device(device)
    cfg = step_config(route)
    models = tuple(m.to(device) for m in build_models(cfg))
    state = create_train_state(torch.Generator().manual_seed(0), cfg)
    dev_batch = to_device(ladder_batch(patch, batch, cfg.num_classes), cfg, device)
    chosen = [(n, kw) for n, kw in RUNGS if n in set(rungs or [n for n, _ in RUNGS])]
    out, prev = [], None
    for name, kw in chosen:
        rec = time_rung(name, kw, models, cfg, dev_batch, state, device, steps)
        rec["component_ms"] = None if prev is None else prev - rec["median_ms"]
        prev = rec["median_ms"]
        out.append(rec)
        _free(device)
    for rec, (_, kw) in zip(out, chosen):
        if device.type == "cuda":
            rec.update(profile_rung(kw, models, cfg, dev_batch, state, device, profile_steps))
            rec["busy_share"] = rec["device_busy_ms"] / rec["median_ms"]
            _free(device)
        say(rung_line(rec))
    return out


def _free(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def rung_line(rec) -> str:
    delta = ("" if rec["component_ms"] is None
             else f"  (component: {rec['component_ms']:+8.2f} ms)")
    line = f"{rec['name']:10s} {rec['median_ms']:8.2f} ms/step{delta}"
    if "device_busy_ms" in rec:
        line += (f"  device busy {rec['device_busy_ms']:8.2f} ms ({100 * rec['busy_share']:.1f}% "
                 f"of the median) in {rec['launches']:.0f} launches; peak {rec['peak_gib']:.2f} GiB")
    line += f"; kernel calls {rec['kernel_calls']}; loss {rec['metrics'][-1]['loss']:.6g}"
    return line


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"


def get_arguments() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="the train step's ablation ladder")
    p.add_argument("--steps", type=int, default=8, help="timed steps per rung, after 2 warm-ups")
    p.add_argument("--patch", default="64,192,192", help="D,H,W of the patch")
    p.add_argument("--rungs", default=",".join(n for n, _ in RUNGS))
    p.add_argument("--batch", type=int, default=1, help="rows of image and label")
    p.add_argument("--route", choices=("kernel", "plain"), default="kernel",
                   help="the hand-written kernels or their plain PyTorch versions "
                        "(--pallas_k2/--pallas_gn of the trainer)")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--json", default=os.path.join("chiprun_out", "step_ablate.json"))
    return p


def main(argv=None) -> dict:
    from multimodal_pl_tpu_torch.cli.evaluate import resolve_device

    args = get_arguments().parse_args(argv)
    device = resolve_device(args.device)
    patch = tuple(map(int, args.patch.split(",")))
    card = card_line() if device.type == "cuda" else "cpu"
    print(f"card: {card}; route {args.route}, B = {args.batch} x {patch}, "
          f"{args.steps} timed steps per rung", flush=True)
    rungs = run_ladder(patch, args.batch, args.route, args.rungs.split(","), args.steps, device,
                       say=lambda s: print(s, flush=True))
    out = {"card": card, "torch": torch.__version__, "route": args.route, "batch": args.batch,
           "patch": patch, "steps": args.steps, "rungs": rungs}
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return out


if __name__ == "__main__":
    main()

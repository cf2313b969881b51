"""The campaign's kernel route against its plain bf16 route over seeds: the
counted runs, the exact one-sided Mann-Whitney test of plain > kernel and
the verdict of the rule in PERF.md section 6 (PR 15); and over forks of one
epoch-1000 state, paired by seed: the exact one-sided Wilcoxon signed-rank
test of plain > kernel and the verdict of the fork rule (PR 17).

A run is ``tools/campaign.py run --epochs 2500 --chunk 800 --until 1600
--seed S`` (the plain route adds ``--pallas_k2 false --pallas_gn false``)
and then ``tools/campaign_eval.py best --json``. Its statistic is the
held-out unsupervised argmax mean at the in-loop ``val_dice_ct_mean`` peak
over epochs <= 1600. ``campaign_seeds_runs.jsonl`` holds the runs counted
so far, one row each; ``--run ROUTE:SEED:PREFIX`` reads a new run from
``PREFIX.train.jsonl`` (the snapshot directory's ``train.jsonl``) and
``PREFIX.best.json``, and ``--add`` appends its row to that file.

    python -m multimodal_pl_tpu_torch.tools.campaign_seeds \\
        [--run plain:2:OUT/plain2 ...] [--fork plain:10:OUT/plain10 ...] [--add]

A fork is the base ``tools/campaign.py run --epochs 2500 --chunk 1000
--until 1000 --seed 0`` (the kernel route) continued from its epoch-1000
checkpoint on one route to epoch 1500 (``run --fork_from CKPT --until 1500
--seed S``, a fresh snapshot directory) and then ``campaign_eval best
--json``. Its statistic is the held-out unsupervised argmax mean at its own
in-loop ``val_dice_ct_mean`` peak over epochs 1100-1500.
``campaign_forks_runs.jsonl`` holds the forks counted so far; ``--fork
ROUTE:SEED:PREFIX`` reads a new one from ``PREFIX.train.jsonl`` and
``PREFIX.best.json`` (``--add`` appends it). The test pairs the two routes'
forks by seed: with dᵢ = plain - kernel, ``scipy.stats.wilcoxon(d,
alternative="greater", method="exact")`` on ``FORK_PAIRS`` pairs; with
fewer pairs the verdict is pending and no test is computed.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

UNTIL = 1600
VAL_EVERY = 100
RUNS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "campaign_seeds_runs.jsonl")
FORK_BASE, FORK_UNTIL = 1000, 1500   # the base's epoch and the forks' last epoch
FORK_SEEDS = (10, 11, 12, 13, 14, 15)
FORK_PAIRS = len(FORK_SEEDS)
FELL_BACK = 0.05                     # a fork ending this far below its own peak fell back
FORKS = os.path.join(os.path.dirname(RUNS), "campaign_forks_runs.jsonl")


def read_records(prefix: str):
    """({epoch: validation ct_mean}, {epoch: patches/s}) of ``PREFIX.train.jsonl``,
    epochs counted from 1."""
    val, pps = {}, {}
    with open(prefix + ".train.jsonl") as f:
        for line in f:
            r = json.loads(line)
            if "val/val_dice_ct_mean" in r:
                val[r["step"] + 1] = r["val/val_dice_ct_mean"]
            if "epoch/patches_per_sec" in r:
                pps[r["step"] + 1] = r["epoch/patches_per_sec"]
    return val, pps


def read_run(route: str, seed: int, prefix: str) -> dict:
    """One run's row; raises if the run stopped before epoch ``UNTIL`` or if
    the evaluated epoch is not the in-loop peak over epochs <= ``UNTIL``."""
    val, pps = read_records(prefix)
    reached = max(pps)
    if reached < UNTIL or UNTIL not in val:
        raise ValueError(f"{prefix}: reached epoch {reached}, validations to {max(val)}")
    best_epoch = max((e for e in val if e <= UNTIL), key=lambda e: (val[e], -e))
    with open(prefix + ".best.json") as f:
        best = json.load(f)
    if best["peak_epoch"] + 1 != best_epoch:
        raise ValueError(f"{prefix}: evaluated epoch {best['peak_epoch'] + 1}, "
                         f"peak over <= {UNTIL} at {best_epoch}")
    peak = best["peak"]
    return dict(route=route, seed=seed, source=prefix, reached=reached, peak_epoch=best_epoch,
                stat=peak["unsup_mean"], above=peak["unsup_organs_above"],
                atlas=peak["unsup_mean_atlas"], atlas_above=peak["unsup_organs_above_atlas"],
                pps=float(np.median(list(pps.values()))),
                curve=[val[e] for e in range(VAL_EVERY, UNTIL + 1, VAL_EVERY)])


def verdict(plain, kernel) -> dict:
    """The exact one-sided Mann-Whitney test for plain > kernel, the
    medians and the verdict of the rule."""
    from scipy.stats import mannwhitneyu

    test = mannwhitneyu(plain, kernel, alternative="greater", method="exact")
    gap = float(np.median(plain) - np.median(kernel))
    p = float(test.pvalue)
    if p <= 0.05 and gap >= 0.05:
        word = "confirmed"
    elif p > 0.2 or gap < 0.02:
        word = "spread"
    else:
        word = "inconclusive"
    return {"n_plain": len(plain), "n_kernel": len(kernel), "U": float(test.statistic), "p": p,
            "median_plain": float(np.median(plain)), "median_kernel": float(np.median(kernel)),
            "median_gap": gap, "verdict": word}


def read_fork(route: str, seed: int, prefix: str) -> dict:
    """One fork's row; raises if its validation records start at or before
    the base epoch (not a fresh snapshot directory), if it stopped before
    epoch ``FORK_UNTIL``, or if the evaluated epoch is not its own ct_mean
    peak over epochs ``FORK_BASE`` + 100 .. ``FORK_UNTIL``."""
    val, pps = read_records(prefix)
    if not val or min(val) <= FORK_BASE or min(pps) <= FORK_BASE:
        raise ValueError(f"{prefix}: records start at epoch {min(pps, default=None)} "
                         f"(validation {min(val, default=None)}), at or before the base "
                         f"epoch {FORK_BASE}")
    reached = max(pps)
    window = list(range(FORK_BASE + VAL_EVERY, FORK_UNTIL + 1, VAL_EVERY))
    if reached < FORK_UNTIL or any(e not in val for e in window):
        raise ValueError(f"{prefix}: reached epoch {reached}, validations at {sorted(val)}")
    best_epoch = max(window, key=lambda e: (val[e], -e))
    with open(prefix + ".best.json") as f:
        best = json.load(f)
    if best["peak_epoch"] + 1 != best_epoch:
        raise ValueError(f"{prefix}: evaluated epoch {best['peak_epoch'] + 1}, its own peak "
                         f"over {window[0]}-{FORK_UNTIL} at {best_epoch}")
    peak = best["peak"]
    return dict(route=route, seed=seed, source=prefix, base=FORK_BASE,
                window=[window[0], FORK_UNTIL], reached=reached, peak_epoch=best_epoch,
                stat=peak["unsup_mean"], above=peak["unsup_organs_above"],
                atlas=peak["unsup_mean_atlas"], atlas_above=peak["unsup_organs_above_atlas"],
                peak_ct=val[best_epoch], end_ct=val[FORK_UNTIL],
                fell_back=val[FORK_UNTIL] < val[best_epoch] - FELL_BACK,
                pps=float(np.median(list(pps.values()))), curve=[val[e] for e in window])


def fork_verdict(d) -> dict:
    """The exact one-sided Wilcoxon signed-rank test of d = plain - kernel
    > 0 and the fork rule's verdict: confirmed at p <= 0.05 and median d >=
    0.03; spread at p > 0.2 or |median d| < 0.015; else inconclusive. W- is
    the rank sum of the negative differences. Fewer than ``FORK_PAIRS``
    pairs: pending, and nothing is tested."""
    d = [float(x) for x in d]
    out = {"n": len(d), "median_d": float(np.median(d)) if d else None,
           "W_minus": None, "p": None, "verdict": "pending"}
    if len(d) < FORK_PAIRS:
        return out
    from scipy.stats import rankdata, wilcoxon

    ranks = rankdata(np.abs(d))
    out["W_minus"] = float(sum(r for r, x in zip(ranks, d) if x < 0))
    p = float(wilcoxon(d, alternative="greater", method="exact").pvalue)
    med = out["median_d"]
    out["p"] = p
    if p <= 0.05 and med >= 0.03:
        out["verdict"] = "confirmed"
    elif p > 0.2 or abs(med) < 0.015:
        out["verdict"] = "spread"
    else:
        out["verdict"] = "inconclusive"
    return out


def fork_pairs(rows) -> list:
    """(seed, kernel row, plain row) for every seed with both routes, by seed."""
    by = {(r["route"], r["seed"]): r for r in rows}
    seeds = sorted({s for route, s in by if ("kernel", s) in by and ("plain", s) in by})
    return [(s, by[("kernel", s)], by[("plain", s)]) for s in seeds]


def print_forks(rows) -> dict:
    """The table of the forks by seed (a route without its fork reads "-"),
    the paired test on the seeds with both and the verdict."""
    by = {(r["route"], r["seed"]): r for r in rows}
    print(f"forks of the epoch-{FORK_BASE} state, epochs {FORK_BASE}-{FORK_UNTIL}, by seed "
          "(statistic: held-out unsupervised argmax mean at the fork's own ct_mean peak)")
    print("| seed | kernel | plain | d | peak epoch k / p | end ct_mean k / p | fell back k / p "
          "| patches/s k / p |")
    print("|---|---|---|---|---|---|---|---|")

    def cell(r, f):
        return "-" if r is None else f(r)

    for s in sorted({r["seed"] for r in rows}):
        k, p = by.get(("kernel", s)), by.get(("plain", s))
        stat = [cell(r, lambda r: f"{r['stat']:.4f} ({r['above']}/13)") for r in (k, p)]
        d = f"{p['stat'] - k['stat']:+.4f}" if k and p else "-"
        cols = [" / ".join(cell(r, f) for r in (k, p)) for f in (
            lambda r: str(r["peak_epoch"]), lambda r: f"{r['end_ct']:.4f}",
            lambda r: "yes" if r["fell_back"] else "no", lambda r: f"{r['pps']:.2f}")]
        print(f"| {s} | {stat[0]} | {stat[1]} | {d} | " + " | ".join(cols) + " |")
    pairs = fork_pairs(rows)
    out = fork_verdict([p["stat"] - k["stat"] for _, k, p in pairs])
    out["missing_seeds"] = [s for s in FORK_SEEDS if s not in {s for s, _, _ in pairs}]
    print(json.dumps(out))
    return out


def read_rows(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None, runs_file: str = RUNS, forks_file: str = FORKS) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", action="append", default=[], help="ROUTE:SEED:PREFIX")
    p.add_argument("--fork", action="append", default=[], help="ROUTE:SEED:PREFIX")
    p.add_argument("--source", default="",
                   help="the new rows' source (default: their PREFIX), e.g. the PR and call")
    p.add_argument("--add", action="store_true",
                   help="append the --run rows to the runs file, the --fork rows to the forks file")
    args = p.parse_args(argv)
    rows = read_rows(runs_file)
    forks = read_rows(forks_file)
    new_forks = []
    for spec in args.fork:
        route, seed, prefix = spec.split(":", 2)
        if any((r["route"], r["seed"]) == (route, int(seed)) for r in forks + new_forks):
            raise ValueError(f"fork {route} seed {seed} is counted already")
        new_forks.append(dict(read_fork(route, int(seed), prefix),
                              source=args.source or prefix))
    new = []
    for spec in args.run:
        route, seed, prefix = spec.split(":", 2)
        if any((r["route"], r["seed"]) == (route, int(seed)) for r in rows + new):
            raise ValueError(f"{route} seed {seed} is counted already")
        new.append(dict(read_run(route, int(seed), prefix), source=args.source or prefix))
    if args.add:
        with open(runs_file, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in new)
        if new_forks:
            with open(forks_file, "a") as f:
                f.writelines(json.dumps(r) + "\n" for r in new_forks)
    rows = sorted(rows + new, key=lambda r: (r["route"], r["seed"]))
    print("| route | seed | source | epoch reached | peak epoch | argmax (> 0.3) | "
          "atlas-blended (> 0.3) | patches/s |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['route']} | {r['seed']} | {r['source']} | {r['reached']} | "
              f"{r['peak_epoch']} | {r['stat']:.4f} ({r['above']}/13) | {r['atlas']:.4f} "
              f"({r['atlas_above']}/13) | {r['pps']:.2f} |")
    by = {k: [r for r in rows if r["route"] == k] for k in ("plain", "kernel")}
    out = verdict(*([r["stat"] for r in by[k]] for k in ("plain", "kernel")))
    print(json.dumps(out))
    for route, xs in by.items():
        curves = np.array([x["curve"] for x in xs])
        sd = curves.std(0, ddof=1) if len(xs) > 1 else np.full(curves.shape[1], np.nan)
        print(f"{route} ct_mean every {VAL_EVERY} epochs, mean±sd: " + " ".join(
            f"{m:.3f}±{s:.3f}" for m, s in zip(curves.mean(0), sd)))
    out["forks"] = print_forks(sorted(forks + new_forks, key=lambda r: (r["seed"], r["route"])))
    return out


if __name__ == "__main__":
    main()

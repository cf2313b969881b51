"""The campaign's kernel route against its plain bf16 route over seeds: the
counted runs, the exact one-sided Mann-Whitney test of plain > kernel and
the verdict of the rule in PERF.md section 6 (PR 15).

A run is ``tools/campaign.py run --epochs 2500 --chunk 800 --until 1600
--seed S`` (the plain route adds ``--pallas_k2 false --pallas_gn false``)
and then ``tools/campaign_eval.py best --json``. Its statistic is the
held-out unsupervised argmax mean at the in-loop ``val_dice_ct_mean`` peak
over epochs <= 1600. ``campaign_seeds_runs.jsonl`` holds the runs counted
so far, one row each; ``--run ROUTE:SEED:PREFIX`` reads a new run from
``PREFIX.train.jsonl`` (the snapshot directory's ``train.jsonl``) and
``PREFIX.best.json``, and ``--add`` appends its row to that file.

    python -m multimodal_pl_tpu_torch.tools.campaign_seeds \\
        [--run plain:2:OUT/plain2 ...] [--add]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

UNTIL = 1600
VAL_EVERY = 100
RUNS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "campaign_seeds_runs.jsonl")


def read_run(route: str, seed: int, prefix: str) -> dict:
    """One run's row; raises if the run stopped before epoch ``UNTIL`` or if
    the evaluated epoch is not the in-loop peak over epochs <= ``UNTIL``."""
    val, pps = {}, {}
    with open(prefix + ".train.jsonl") as f:
        for line in f:
            r = json.loads(line)
            if "val/val_dice_ct_mean" in r:
                val[r["step"] + 1] = r["val/val_dice_ct_mean"]
            if "epoch/patches_per_sec" in r:
                pps[r["step"] + 1] = r["epoch/patches_per_sec"]
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


def main(argv=None, runs_file: str = RUNS) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", action="append", default=[], help="ROUTE:SEED:PREFIX")
    p.add_argument("--add", action="store_true", help="append the --run rows to the runs file")
    args = p.parse_args(argv)
    with open(runs_file) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    new = []
    for spec in args.run:
        route, seed, prefix = spec.split(":", 2)
        if any((r["route"], r["seed"]) == (route, int(seed)) for r in rows + new):
            raise ValueError(f"{route} seed {seed} is counted already")
        new.append(read_run(route, int(seed), prefix))
    if args.add:
        with open(runs_file, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in new)
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
    return out


if __name__ == "__main__":
    main()

"""Per-shape times of ``conv3x3_gn`` in one tree of this repository, for
comparing two versions of the kernel on one card.

Times the kernel at every shape ``chip_smoke.py`` derives (the 20 serving
shapes at B = 4 and every conv call of one train step), two ways: CUDA events
around back-to-back calls (host launch costs included) and CUDA-graph replays
(device time only). Run from the root of each tree, the parent and the
change in turns, then summarize:

    cd <tree> && PYTHONPATH=. python3 -m multimodal_pl_tpu_torch.tools.compare_conv run TAG OUTDIR
    python3 -m multimodal_pl_tpu_torch.tools.compare_conv summary OUTDIR parent1,parent2 change1,change2

Each run writes ``OUTDIR/compare_TAG.json``; the summary prints each
shape's mean time per version and the ratio.
"""

from __future__ import annotations

import json
import os
import sys
import time


# compare_conv runs against another tree's package (the parent's), which may
# lack tools/timing.py: it keeps its own copies of the two timers.


def _graph_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _event_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(tag: str, outdir: str) -> None:
    """Time this tree's conv3x3_gn (imported from the current directory)."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from multimodal_pl_tpu_torch.ops import conv3x3
    from multimodal_pl_tpu_torch.ops.conv import standardize_kernel
    from multimodal_pl_tpu_torch.ops.norm import group_norm_fold
    from multimodal_pl_tpu_torch.train.state import StepConfig

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    conv3x3._lib()
    build_s = time.perf_counter() - t0
    shapes = [("serving", ci, co, cs.WINDOW_BATCH, dhw, pro, res)
              for ci, co, dhw, pro, res in cs.SHAPES]
    conv_expected, _ = cs.training_shapes(StepConfig())
    for spec, ci, co, b, d, h, w, res in sorted(conv_expected):
        shapes.append((spec, ci, co, b, (d, h, w), spec == conv3x3.FUSED, res))
    g = torch.Generator().manual_seed(1)
    rows = []
    with torch.no_grad():
        for spec, cin, cout, batch, (d, h, w_), pro, with_res in shapes:
            x = torch.randn((batch, d, h, w_, cin), generator=g).to(dev, torch.bfloat16)
            w = standardize_kernel(torch.randn((cout, cin, 3, 3, 3), generator=g)).to(
                dev, torch.bfloat16)
            a = b = res = None
            if pro:
                a, b = group_norm_fold(x, torch.ones(cin, device=dev),
                                       torch.zeros(cin, device=dev), 4 if cin % 16 else 16)
            if with_res:
                res = torch.randn((batch, d, h, w_, cout), generator=g).to(dev, torch.bfloat16)
            reps = 5 if d * h * w_ * max(cin, cout) * batch > 2 ** 27 else 20

            def fn():
                return conv3x3.conv3x3_gn(x, w, a, b, res)

            rows.append({"spec": spec, "cin": cin, "cout": cout, "b": batch, "dhw": [d, h, w_],
                         "prologue": pro, "res": with_res, "event_ms": _event_ms(fn, reps),
                         "graph_ms": _graph_ms(fn, reps)})
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"compare_{tag}.json"), "w") as f:
        json.dump({"tag": tag, "build_s": build_s, "rows": rows,
                   "device": torch.cuda.get_device_name(0)}, f)
    print(f"{tag}: {len(rows)} shapes, library loaded in {build_s:.1f} s", flush=True)


def summary(outdir: str, base_tags: str, new_tags: str) -> dict:
    """Mean of each version's runs per shape, and new / base per method."""
    def load(tags):
        runs = [json.load(open(os.path.join(outdir, f"compare_{t}.json")))["rows"]
                for t in tags.split(",")]
        return [{k: sum(r[i][k] for r in runs) / len(runs) for k in ("event_ms", "graph_ms")}
                | {k: runs[0][i].get(k) for k in ("spec", "cin", "cout", "b", "dhw", "prologue",
                                                   "res")}
                for i in range(len(runs[0]))]

    base, new = load(base_tags), load(new_tags)
    out = []
    for o, n in zip(base, new):
        row = dict(n, base_event_ms=o["event_ms"], base_graph_ms=o["graph_ms"],
                   event_ratio=n["event_ms"] / o["event_ms"],
                   graph_ratio=n["graph_ms"] / o["graph_ms"])
        out.append(row)
        print(f"{row['spec']:12s} B={row['b']:2d} {row['cin']:3d}->{row['cout']:3d} "
              f"@{'x'.join(map(str, row['dhw']))} res={row['res']!s:5s} events "
              f"{o['event_ms']:.4f} -> {n['event_ms']:.4f} ({row['event_ratio']:.2f}x)  graph "
              f"{o['graph_ms']:.4f} -> {n['graph_ms']:.4f} ({row['graph_ratio']:.2f}x)")
    worst = max(out, key=lambda r: r["event_ratio"])
    print(f"slowest relative to the base (events): {worst['event_ratio']:.3f}x at {worst['spec']} "
          f"{worst['cin']}->{worst['cout']} B={worst['b']} {worst['dhw']}; (graph) "
          f"{max(r['graph_ratio'] for r in out):.3f}x")
    totals = _row_totals(outdir, out)
    with open(os.path.join(outdir, "compare_summary.json"), "w") as f:
        json.dump({"rows": out, "totals": totals}, f, indent=1)
    return {"rows": out, "totals": totals}


# the kernel-table rows: (row, calls of chip_smoke.json, specs)
ROWS = (("1 fused, per 4-tile forward", "serving_calls", ("fused",)),
        ("2 prologue off, per 4-tile forward", "serving_calls", ("prologue_off",)),
        ("3 train fwd + dx + no-grad prologue off, per step", "step_calls",
         ("train_fwd", "train_dx", "prologue_off")),
        ("4 no-grad fused, per step", "step_calls", ("fused",)))


def _row_totals(outdir: str, rows: list) -> dict:
    """Per kernel-table row, both versions' times summed over the calls of
    one forward or step that chip_smoke.py recorded in OUTDIR/chip_smoke.json
    (absent: no totals)."""
    path = os.path.join(outdir, "chip_smoke.json")
    if not os.path.exists(path):
        return {}
    smoke = json.load(open(path))
    by_key = {}
    for r in rows:
        spec = r["spec"] if r["spec"] != "serving" else ("fused" if r["prologue"] else "prologue_off")
        by_key[(r["spec"] == "serving", spec, r["cin"], r["cout"], r["b"], tuple(r["dhw"]),
                r["res"])] = r
    totals = {}
    for name, calls, specs in ROWS:
        acc = dict.fromkeys(("base_event_ms", "event_ms", "base_graph_ms", "graph_ms"), 0.0)
        for spec, ci, co, b, d, h, w, res, n in smoke[calls]:
            if spec not in specs:
                continue
            r = by_key[(calls == "serving_calls", spec, ci, co, b, (d, h, w), res)]
            for k in acc:
                acc[k] += n * r[k]
        totals[name] = acc
        print(f"row {name}: events {acc['base_event_ms']:.3f} -> {acc['event_ms']:.3f} ms, "
              f"graph {acc['base_graph_ms']:.3f} -> {acc['graph_ms']:.3f} ms")
    return totals


if __name__ == "__main__":
    if sys.argv[1] == "run":
        run(sys.argv[2], sys.argv[3])
    else:
        summary(sys.argv[2], sys.argv[3], sys.argv[4])

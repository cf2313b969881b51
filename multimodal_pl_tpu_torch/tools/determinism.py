"""Nondeterminism of the train step on the card: which operations torch's
deterministic mode reports in one gradient pass, and how far two runs of the
pass from one state and batch lie apart.

    PYTHONPATH=. python3 -m multimodal_pl_tpu_torch.tools.determinism [BATCH [OUTDIR]]

runs the production step configuration (bf16, 64 x 192 x 192, the
``StepConfig`` defaults) at batch BATCH (default 3) with random weights and
data from fixed seeds, prints the reported operations and the distance of a
rerun (loss, worst gradient leaf, leaves that differ), then the same pass
with cuDNN held to its deterministic algorithms
(``torch.backends.cudnn.deterministic``): its rerun distance, its distance
from the default pass, and the device-synchronized ms of one gradient pass
each way (median of 5 after one; the default timed before and after).
Writes ``OUTDIR/determinism.json`` (default ``chiprun_out``).
``chip_smoke.py`` runs the first two in its phase 9.
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings


def reported_ops(grads_fn) -> list:
    """The distinct first lines of the warnings that
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` raises while
    ``grads_fn()`` runs (an operation without a deterministic CUDA
    implementation, or a library call whose determinism needs a setting).
    The mode is off again afterwards. In the mode, some operations switch to
    slower deterministic algorithms silently (cuDNN's convs among them): a
    rerun shows those (:func:`rerun_distance`)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            grads_fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).strip().splitlines()[0] for w in caught
                   if "determinis" in str(w.message)})


def rerun_distance(first, second) -> dict:
    """first, second: (loss, {leaf: gradient}) of two runs. The loss
    difference, the largest absolute gradient difference per leaf, and the
    leaves whose bits differ."""
    import torch

    (la, ga), (lb, gb) = first, second
    diff = {k: float((ga[k].float() - gb[k].float()).abs().max()) for k in ga}
    return {"loss_diff": abs(float(la) - float(lb)),
            "differing_leaves": sorted(k for k in ga if not torch.equal(ga[k], gb[k])),
            "worst_leaf": max(diff, key=diff.get), "worst_abs": max(diff.values())}


def main(batch: int = 3, outdir: str = "chiprun_out") -> dict:
    import numpy as np
    import torch

    from multimodal_pl_tpu_torch.train.loop import to_device
    from multimodal_pl_tpu_torch.train.state import StepConfig, build_models, create_train_state
    from multimodal_pl_tpu_torch.train.step import make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("determinism: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg = StepConfig(compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    nc, patch = cfg.num_classes, (64, 192, 192)
    sup = np.zeros(nc, np.float32)
    sup[5] = 1
    host = {"image": rng.standard_normal((batch, *patch, 1)).astype(np.float32),
            "label": rng.integers(0, nc, (batch, *patch)).astype(np.uint8),
            "catlas": rng.random((nc - 1, *patch)).astype(np.float32), "sup_mask": sup,
            "label_t": np.array([0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1], np.float32)}
    batch_t = to_device(host, cfg, dev)
    wf = torch.tensor(0.05, device=dev)
    state = create_train_state(torch.Generator().manual_seed(0), cfg).to(dev)
    step = make_train_step(*(m.to(dev) for m in build_models(cfg)), cfg)

    def grads():
        total, (gp, gr), _ = step.grads(state, batch_t, wf)
        return total, {**{"params." + k: v for k, v in gp.items()},
                       **{"rparams." + k: v for k, v in gr.items()}}

    def median_ms(fn, n=5):
        fn()
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    out = {"device": torch.cuda.get_device_name(0), "batch": batch,
           "reported_ops": reported_ops(grads)}
    first = grads()
    out["rerun"] = rerun_distance(first, grads())
    out["ms"] = median_ms(grads)
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic
    cudnn.deterministic = True
    try:
        held = grads()
        out["cudnn_deterministic"] = {"rerun": rerun_distance(held, grads()),
                                      "vs_default": rerun_distance(held, first),
                                      "ms": median_ms(grads)}
    finally:
        cudnn.deterministic = prev
    out["ms_again"] = median_ms(grads)  # default, after: the spread of the ms
    print(json.dumps(out, indent=1), flush=True)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "determinism.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main(*(int(a) if i == 0 else a for i, a in enumerate(sys.argv[1:])))

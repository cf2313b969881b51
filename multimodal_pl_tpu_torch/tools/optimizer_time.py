"""Device time and kernel launches of the train step's update section on
one GPU (``StepConfig`` defaults, the step's parameter trees): SGD with
momentum and weight decay on the segmenter's and the refiner's parameters,
the non-finite guards and ``select_tree``, the discriminator's fresh-Adam
update, on seeded gradients. With ``tools/gn_times.py`` (the GroupNorm ->
ReLU backward) it splits the step's elementwise time.

    PYTHONPATH=. python3 -m multimodal_pl_tpu_torch.tools.optimizer_time [OUTDIR]

torch.profiler records 3 updates after one warm-up. Writes
``OUTDIR/optimizer_time.json`` (default ``chiprun_out``).
"""

from __future__ import annotations

import json
import os
import sys

from multimodal_pl_tpu_torch.tools.gn_times import device_time


def main(outdir: str = "chiprun_out") -> dict:
    import torch

    from multimodal_pl_tpu_torch.train.state import (
        StepConfig, all_finite, create_train_state, fresh_adam_update, select_tree,
        torch_sgd_update)

    if not torch.cuda.is_available():
        raise SystemExit("optimizer_time: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg = StepConfig(compute_dtype=torch.bfloat16)
    state = create_train_state(torch.Generator().manual_seed(0), cfg).to(dev)
    g = torch.Generator(device=dev).manual_seed(4)

    def grads(tree):
        return {k: torch.randn(v.shape, generator=g, device=dev, dtype=v.dtype) * 1e-3
                for k, v in tree.items()}

    gp, gr, gd = grads(state.params), grads(state.rparams), grads(state.dparams)
    lr = torch.tensor(5e-4, device=dev)

    def update():
        ok = all_finite(gp) & all_finite(gr)
        new_p, new_bp = torch_sgd_update(state.params, gp, state.momentum[0], lr,
                                         cfg.momentum, cfg.weight_decay)
        new_r, new_br = torch_sgd_update(state.rparams, gr, state.momentum[1], lr,
                                         cfg.momentum, cfg.weight_decay)
        select_tree(ok, new_p, state.params)
        select_tree(ok, new_r, state.rparams)
        select_tree(ok, new_bp, state.momentum[0])
        select_tree(ok, new_br, state.momentum[1])
        select_tree(all_finite(gd), fresh_adam_update(state.dparams, gd, lr), state.dparams)

    ms, launches = device_time(update)
    out = {"device": torch.cuda.get_device_name(0), "ms": ms, "launches": launches}
    print(f"optimizer: {ms:.3f} ms of device time, {launches:.0f} launches per step", flush=True)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "optimizer_time.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:])

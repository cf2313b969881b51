"""The port's train step against the JAX package's over a long horizon, held
to chaos baselines (ROADMAP.md queue 3: the campaign's gap to the JAX
record).

Over hundreds of steps two f32 implementations of one step drift apart
chaotically: the discriminator's fresh-Adam update lr * g / (|g| + 1e-8) is
a sign wherever |g| >> 1e-8 and flips with the sign of a near-zero
gradient, the token EMA's class means jump when the agreement mask gains or
loses a voxel, and every difference of summation order is amplified. So the
port is not held to a fixed tolerance here but to chaos baselines: from one
JAX state (carried across by ``convert.train_state_from_jax``), on the same
JAX device-pipeline batches of the tiny campaign fixture, with the
campaign's schedules (2500 epochs, the feature ramp from epoch 20 to 50, 3
steps an epoch), these runs step together:

- JAX (the reference);
- JAX again from the state with the leaves of some trees moved by a
  relative 1e-6 (``perturb``; by default the segmenter's): a JAX baseline,
  compared with JAX;
- the port (torch on ``THREADS`` threads), compared with JAX;
- the port again on one thread (``reorder``): the same code summing in
  another order at every step, compared with the port.

At the end of every window of ``WINDOW`` steps each run's trees (segmenter,
refiner, discriminator, tokens) are compared with its reference by the
relative Frobenius distance of their updates since the start
(``rel_update``). The verdict "no fault at this length" holds when the
port's distance from JAX stays within ``RATIO`` times the larger of the
baselines' distances in every window for every tree. Each baseline alone
misses a kind of chaos the port shows (PERF.md, PR 12, 300 steps): the JAX
baseline perturbs the state once and misses the rounding that every step
adds to the discriminator's own sign-like update (2.4 times below the
port's distance there at window 25, while the reordered port reads it to
within 4%); the reordered port misses a jump of the tokens (a class's
masked mean jumps when the agreement mask gains or loses voxels), which
the port and the JAX baseline both take at window 100 and the reordered
port at window 150 (6.4 times below the port's distance at window 100).
The window means of every loss, of ``train_dice_sup`` and of
``refiner_dice_mean`` are kept beside them.

``test_port_within_chaos_baselines_over_10_steps`` runs 10 steps with the
reordered port alone (tier 1; a JAX step takes about 3 s on the CPU, so
50 steps would take minutes); ``test_port_within_chaos_baselines_over_300_steps``
runs 300 with the segmenter-perturbed JAX baseline as well, through the
end of the feature ramp (epoch 50 = step 150), and is marked ``slow``.
``python tests/test_torch_port_campaign_horizon.py STEPS [OUT.json]``
prints (and writes) the table of a run of STEPS steps with the
segmenter-perturbed and the all-trees-perturbed JAX baselines beside it.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.data.dataset import AMOSDataset as JAMOSDataset
from multimodal_pl_tpu.data.device_cache import DeviceDataPipeline as JDeviceDataPipeline
from multimodal_pl_tpu.losses.compose import feature_ramp as jfeature_ramp
from multimodal_pl_tpu.train.state import build_models as jbuild_models
from multimodal_pl_tpu.train.state import create_train_state as jcreate_train_state
from multimodal_pl_tpu.train.state import tiny_step_config as jtiny_step_config
from multimodal_pl_tpu.train.step import make_train_step as jmake_train_step
from multimodal_pl_tpu.train.step import poly_lr as jpoly_lr
from multimodal_pl_tpu_torch.convert import train_state_from_jax
from multimodal_pl_tpu_torch.losses.compose import feature_ramp
from multimodal_pl_tpu_torch.train.state import build_models, tiny_step_config
from multimodal_pl_tpu_torch.train.step import make_train_step, poly_lr
from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

THREADS = 4
torch.set_num_threads(THREADS)

EPOCHS, PRETRAIN, RAMP, BATCH, LR = 2500, 20, 50, 2, 5e-4
WINDOW, RATIO, PERTURB = 25, 2.0, 1e-6
TREES = ("params", "rparams", "dparams", "tokens")
KEPT = ("loss", "seg_loss", "refine_loss", "gan_g_loss", "disc_loss", "train_dice_sup",
        "refiner_dice_mean")
JAX_BASELINES = {"baseline": ("params",), "all": TREES}


def rel_update(got, ref, init):
    """Relative Frobenius distance of two runs' updates over a tree."""
    diff = sum(float(np.square(np.asarray(got[k], np.float64) - ref[k]).sum()) for k in ref)
    step = sum(float(np.square(np.asarray(ref[k], np.float64) - init[k]).sum()) for k in ref)
    return (diff / max(step, 1e-30)) ** 0.5


def _trees(state):
    """name -> {leaf: numpy f32} of a port TrainState."""
    return {t: {k: v.detach().numpy().copy() for k, v in getattr(state, t).items()}
            for t in TREES}


def perturb(jstate, rel: float, trees=("params",), seed: int = 1):
    """The JAX state with each leaf p of ``trees`` (default: the segmenter's)
    moved to p * (1 + rel * n), n standard normal from ``seed``; every other
    leaf copied (the JAX step donates its state)."""
    jstate = jax.tree_util.tree_map(jnp.array, jstate)
    rng = np.random.default_rng(seed)
    moved = {}
    for t in trees:
        leaves, treedef = jax.tree_util.tree_flatten(getattr(jstate, t))
        moved[t] = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(np.asarray(p) * (1.0 + rel * rng.standard_normal(p.shape))
                        .astype(np.float32)) for p in leaves])
    return jstate.replace(**moved)


def run_horizon(root: str, steps: int, batch: int = BATCH, baselines=(), reorder: bool = True,
                **overrides) -> dict:
    """The runs over ``steps`` steps on the fixture written under ``root``:
    {'windows': [{'step': s, 'dist': {run: {tree: distance}}, 'means': {run:
    {metric: mean over the window}}}], 'runs': the runs}. ``baselines``:
    {name: the trees it perturbs} of JAX runs from perturbed states, each
    compared with JAX; 'port' is compared with JAX, 'reordered' (the port
    on one thread, with ``reorder``) with the port. ``overrides``:
    StepConfig fields set on both sides (weight_gan=0, train_refiner=False,
    token_alpha=0)."""
    baselines = dict(baselines)
    runs_all = ("jax", *baselines, "port", *(("reordered",) if reorder else ()))
    img_dir, atlas_path, csv_path = make_synthetic_amos(root, n_ct=7, n_mri=2,
                                                        shape=(40, 40, 36), seed=5,
                                                        organ_r_frac=0.2)
    kw = dict(num_epochs=EPOCHS, pretrain_epoch=PRETRAIN, ramp_until=RAMP, **overrides)
    jcfg = jtiny_step_config(compute_dtype=jnp.float32, **kw)
    cfg = tiny_step_config(compute_dtype=torch.float32, **kw)
    jstates = {"jax": jcreate_train_state(jax.random.PRNGKey(0), jcfg)}
    for name, trees in baselines.items():
        jstates[name] = perturb(jstates["jax"], PERTURB, trees)
    states = {r: train_state_from_jax(jstates["jax"]) for r in runs_all
              if r in ("port", "reordered")}
    init = _trees(states["port"])
    ds = JAMOSDataset(img_dir, crop_size=(32, 32, 32), usage="train", atlas=np.load(atlas_path),
                      supervision_csv=csv_path, seed=0, cache=True)
    pipe = JDeviceDataPipeline(ds, compute_dtype=jnp.float32, seed=0)
    jstep = jmake_train_step(*jbuild_models(jcfg), jcfg)
    step = make_train_step(*build_models(cfg), cfg)
    windows, kept, done, epoch = [], {r: [] for r in runs_all}, 0, 0
    try:
        while done < steps:
            jlr, jwf = jpoly_lr(LR, epoch, EPOCHS), jfeature_ramp(epoch, PRETRAIN, RAMP,
                                                                  jcfg.weight_feature_max)
            lr, wf = (poly_lr(LR, torch.tensor(epoch), EPOCHS),
                      feature_ramp(torch.tensor(epoch), PRETRAIN, RAMP, cfg.weight_feature_max))
            jstates = {r: s.replace(epoch=jnp.asarray(epoch, jnp.int32))
                       for r, s in jstates.items()}
            states = {r: s.replace(epoch=torch.tensor(epoch)) for r, s in states.items()}
            for b in pipe.batches(batch, epochs=1):
                if done == steps:
                    break
                for r in jstates:
                    jstates[r], m = jstep(jstates[r], b, jlr, jwf)
                    kept[r].append({k: float(m[k]) for k in KEPT})
                tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
                for r in states:
                    torch.set_num_threads(1 if r == "reordered" else THREADS)
                    states[r], m = step(states[r], tb, lr, wf)
                    kept[r].append({k: float(m[k]) for k in KEPT})
                done += 1
                if done % WINDOW == 0 or done == steps:
                    runs = {r: _trees(train_state_from_jax(s)) for r, s in jstates.items()}
                    runs.update({r: _trees(s) for r, s in states.items()})
                    refs = {r: "port" if r == "reordered" else "jax" for r in runs if r != "jax"}
                    windows.append({
                        "step": done,
                        "dist": {r: {t: rel_update(runs[r][t], runs[ref][t], init[t])
                                     for t in TREES} for r, ref in refs.items()},
                        "means": {r: {k: float(np.mean([s[k] for s in kept[r][-WINDOW:]]))
                                      for k in KEPT} for r in runs_all}})
            epoch += 1
    finally:
        torch.set_num_threads(THREADS)
    return {"windows": windows, "runs": runs_all}


def baselines_of(result: dict) -> list:
    """The baseline runs of a result: every run but JAX and the port."""
    return [r for r in result["runs"] if r not in ("jax", "port")]


def ratios(result: dict, bases=None) -> dict:
    """{tree: the largest ratio over the windows of the port's distance to
    the larger of the ``bases`` runs' (default: every baseline)}."""
    bases = bases or baselines_of(result)
    return {t: max(w["dist"]["port"][t] / max(max(w["dist"][b][t] for b in bases), 1e-30)
                   for w in result["windows"]) for t in TREES}


def table(result: dict) -> str:
    """The windows as text: per window each run's distance per tree (the
    port first), and every run's loss, train_dice_sup and refiner_dice_mean
    means (JAX first)."""
    others = [r for r in result["runs"] if r != "jax"]
    others = ["port"] + [r for r in others if r != "port"]
    lines = ["step | " + " | ".join(f"{t} {'/'.join(others)}" for t in TREES) + " | "
             + " | ".join(f"{k} {'/'.join(result['runs'])}"
                          for k in ("loss", "train_dice_sup", "refiner_dice_mean"))]
    for w in result["windows"]:
        d, m = w["dist"], w["means"]
        lines.append(f"{w['step']} | " + " | ".join(
            "/".join(f"{d[r][t]:.3g}" for r in others) for t in TREES) + " | " + " | ".join(
            "/".join(f"{m[r][k]:.4f}" for r in result["runs"])
            for k in ("loss", "train_dice_sup", "refiner_dice_mean")))
    for bases in [[b] for b in others[1:]] + ([others[1:]] if len(others) > 2 else []):
        lines.append(f"max port/{'|'.join(bases)}: " + ", ".join(
            f"{t} {v:.3g}" for t, v in ratios(result, bases).items()))
    return "\n".join(lines)


def _hold(result: dict) -> None:
    worst = ratios(result)
    assert all(v <= RATIO for v in worst.values()), (
        f"port-vs-JAX above {RATIO} x the larger baseline: {worst}\n{table(result)}")


def test_port_within_chaos_baselines_over_10_steps(tmp_path):
    _hold(run_horizon(str(tmp_path), 10))


@pytest.mark.slow
def test_port_within_chaos_baselines_over_300_steps(tmp_path):
    _hold(run_horizon(str(tmp_path), 300, baselines={"baseline": ("params",)}))


if __name__ == "__main__":
    import tempfile

    import tests.conftest  # noqa: F401  the CPU device and the compile cache

    with tempfile.TemporaryDirectory() as tmp:
        res = run_horizon(tmp, int(sys.argv[1]), baselines=JAX_BASELINES)
    print(table(res))
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            json.dump(res, f, indent=1)

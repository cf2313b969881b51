"""The port's spatial train step (``parallel.spatial.make_spatial_train_step``)
against the JAX package's ``make_spatial_train_step`` on a ``space:2`` CPU
mesh, against the port's own unsplit step, and its parts: each exchange's
gradient, and the GroupNorm -> ReLU backward from slab sums.

The port runs as two gloo ranks spawned by ``tools/spawn.py`` (each holds
one H slab of the batch and the whole state), f32, plain versions of the
kernels, at ``TestSpatialTrainStep``'s batch and configuration
(``tests/test_parallel.py``: a 32^3 patch, ``tiny_step_config(deep_up=True,
augmask=2, weight_gan=1e-3)``) and at JAX's own tolerances there (metrics
rtol 2e-4, atol 1e-6; state rtol 2e-4, atol 1e-5, momentum atol 5e-5).
Two faults planted in the backward (``tools/spatial_fault.py``: a halo
row's gradient never returned to its owner; the losses' sums over the ranks
by an all_reduce whose backward all-reduces again, so the loss counts once
per rank) must miss those tolerances by more than 10 times.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.parallel.mesh import make_mesh
from multimodal_pl_tpu.parallel.spatial import make_spatial_train_step as jmake_spatial_step
from multimodal_pl_tpu.train import create_train_state as jcreate_train_state
from multimodal_pl_tpu.train.state import build_models as jbuild_models
from multimodal_pl_tpu.train.state import tiny_step_config as jtiny_step_config
from multimodal_pl_tpu_torch.convert import train_state_from_jax
from multimodal_pl_tpu_torch.ops import gn_relu
from multimodal_pl_tpu_torch.tools import spatial_fault, spawn
from multimodal_pl_tpu_torch.train.state import build_models, tiny_step_config
from multimodal_pl_tpu_torch.train.step import make_train_step
from tests.conftest import cpu_devices

torch.set_num_threads(2)

P, NC = (32, 32, 32), 14
LR, WF = 5e-4, 0.05
TREES = ("params", "rparams", "dparams", "tokens")
ATOL = {"params": 1e-5, "rparams": 1e-5, "dparams": 1e-5, "tokens": 1e-5, "momentum": 5e-5}
RTOL = 2e-4
FAULTS = {"halo_grad_dropped": spatial_fault.drop_halo_grads,
          "loss_counted_per_rank": spatial_fault.loss_counted_per_rank}


def _batch():
    rng = np.random.default_rng(0)  # tests/test_parallel.py's rng fixture
    return {
        "image": rng.standard_normal((1, *P, 1)).astype(np.float32),
        "label": rng.integers(0, NC, (1, *P)).astype(np.int32),
        "catlas": rng.random((NC - 1, *P)).astype(np.float32),
        "sup_mask": np.asarray([0, 0, 0, 1] + [0] * 10, np.float32),
        "label_t": np.asarray([0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1], np.float32),
    }


def _leaves(state):
    """name -> tensor of every leaf a step updates, momentum under its own
    prefix."""
    out = {f"{t}.{k}": v for t in TREES for k, v in getattr(state, t).items()}
    out.update({f"momentum.{i}.{k}": v for i in range(2) for k, v in state.momentum[i].items()})
    return out


def excess(got, ref) -> float:
    """The largest max|got - ref| / (atol + rtol * |ref|) over the leaves of
    two train states, at the JAX test's tolerances: at most 1 passes."""
    a, b = _leaves(got), _leaves(ref)
    return max(float(((a[k] - b[k]).abs() / (ATOL[k.split(".")[0]] + RTOL * b[k].abs())).max())
               for k in b)


@pytest.fixture(scope="module")
def runs():
    """The JAX spatial step, the port's unsplit step, and the port's step on
    two ranks (clean and with each planted fault) and on one rank, all from
    one JAX state on one batch."""
    cfg_kw = dict(num_classes=NC, deep_up=True, augmask=2, weight_gan=1e-3)
    jcfg = jtiny_step_config(**cfg_kw)
    jstate = jcreate_train_state(jax.random.PRNGKey(0), jcfg)
    state = train_state_from_jax(jstate)
    batch = _batch()
    jstep = jmake_spatial_step(*jbuild_models(jcfg), jcfg, make_mesh("space:2", cpu_devices()))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(LR),
                     jnp.float32(WF))
    cfg = tiny_step_config(compute_dtype=torch.float32, **cfg_kw)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    new, m = make_train_step(*build_models(cfg), cfg)(state, tb, torch.tensor(LR),
                                                       torch.tensor(WF))
    calls = [(spawn.sp_step, (cfg, state, tb, LR, WF)), (spawn.sp_grads, (cfg, state, tb, WF))]
    calls += [(spawn.sp_step, (cfg, state, tb, LR, WF, "cpu", fault)) for fault in FAULTS.values()]
    two = spawn.run(spawn.dp_calls, 2, calls, timeout=300)
    (one,) = spawn.run(spawn.sp_step, 1, cfg, state, tb, LR, WF, timeout=300)
    _, (gp, gr), _ = make_train_step(*build_models(cfg), cfg).grads(state, tb, torch.tensor(WF))
    whole = {**{"params." + k: v for k, v in gp.items()}, **{"rparams." + k: v for k, v in gr.items()}}
    return {"jax": (train_state_from_jax(jnew), {k: float(v) for k, v in jm.items()}),
            "unsplit": (new, {k: float(v) for k, v in m.items()}),
            "ranks": [r[0] for r in two], "grads": ([r[1] for r in two], whole),
            "faults": dict(zip(FAULTS, zip(*[r[2:] for r in two]))), "one": one}


def _hold(got, ref):
    (gs, gm), (rs, rm) = got, ref
    for k in rm:
        np.testing.assert_allclose(gm[k], rm[k], rtol=RTOL, atol=1e-6, err_msg=f"metric {k}")
    assert excess(gs, rs) <= 1.0


def test_split_step_matches_jax_spatial_step(runs):
    for rank in runs["ranks"]:
        _hold(rank[:2], runs["jax"])


def test_split_step_matches_unsplit_step(runs):
    for rank in runs["ranks"]:
        _hold(rank[:2], runs["unsplit"])


def test_split_gradients_match_the_whole_steps(runs):
    """The gradients every rank applies (the segmenter's summed over the
    ranks) against the unsplit step's, per leaf by relative norm: the
    median leaf within 1e-5 (f32 summation order), every leaf within 1e-2
    (a ReLU whose pre-activation sits within rounding of 0 may flip with the
    order of sums; chip_smoke.py phase 16 holds the card's plain f32 route
    alike); the ranks' bit-equal."""
    ranks, whole = runs["grads"]
    (loss, got), (loss1, got1) = ranks
    assert loss == loss1 and all(torch.equal(got[k], got1[k]) for k in got)
    rels = [float((got[k] - whole[k]).norm() / whole[k].norm().clamp_min(1e-30)) for k in whole]
    assert float(np.median(rels)) <= 1e-5 and max(rels) <= 1e-2


def test_ranks_agree_bit_for_bit_and_exchange_both_ways(runs):
    (s0, m0, _, ex0), (s1, m1, _, ex1) = runs["ranks"]
    assert spawn.states_unequal(s0, s1) == [] and m0 == m1
    kinds = {k[0] for k in ex0}
    assert {"halo", "halo_bwd", "crop", "crop_bwd", "gather", "sum", "stats", "gn_sums",
            "grad_sum"} <= kinds
    collective = {"halo", "halo_bwd", "gather", "sum", "stats", "gn_sums", "grad_sum"}
    assert ({k: n for k, n in ex0.items() if k[0] in collective}
            == {k: n for k, n in ex1.items() if k[0] in collective})  # the same on both ranks
    # every halo returns its gradient but the stem's, whose input (the image)
    # needs none
    halo = sum(n for k, n in ex0.items() if k[0] == "halo")
    assert sum(n for k, n in ex0.items() if k[0] == "halo_bwd") == halo - 1


def test_space_1_is_train_step_bit_for_bit(runs):
    state, metrics, _, exchanges = runs["one"]
    assert spawn.states_unequal(state, runs["unsplit"][0]) == []
    assert metrics == runs["unsplit"][1]
    assert not exchanges  # a group of one exchanges nothing


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_backward_fault_misses_by_10x(runs, fault):
    clean = max(excess(r[0], runs["unsplit"][0]) for r in runs["ranks"])
    got = runs["faults"][fault]
    assert clean <= 1.0
    assert min(excess(r[0], runs["unsplit"][0]) for r in got) > 10.0


def _halo_whole(x, r, n, lo, hi, edge):
    """Rank r's extended slab of x, built from the whole tensor."""
    h = x.shape[2] // n
    rows = [x[:, :, r * h:(r + 1) * h]]
    if lo:
        if r > 0:
            rows.insert(0, x[:, :, r * h - lo:r * h])
        elif edge == "zero":
            rows.insert(0, torch.zeros_like(x[:, :, :lo]))
        elif edge == "repeat":
            rows.insert(0, x[:, :, :1].expand(-1, -1, lo, -1, -1))
    if hi:
        if r < n - 1:
            rows.append(x[:, :, (r + 1) * h:(r + 1) * h + hi])
        elif edge == "zero":
            rows.append(torch.zeros_like(x[:, :, :hi]))
        elif edge == "repeat":
            rows.append(x[:, :, -1:].expand(-1, -1, hi, -1, -1))
    return torch.cat(rows, 2)


@pytest.mark.parametrize("world", [2, 3])
def test_exchange_gradients_equal_autograd_through_the_whole_tensor(world):
    """Each exchange's gradient on every rank is the rows of the gradient
    that autograd takes through the whole tensor: the halo in each edge mode,
    the crop with an added skip, the gather and the sum. Integer weights
    keep every sum exact, so the two agree bit for bit."""
    g = torch.Generator().manual_seed(3)
    h = 4
    x = torch.randint(-4, 5, (2, 3, h * world, 5, 2), generator=g).float()

    def ints(*shape):
        return torch.randint(-4, 5, shape, generator=g).float()

    halos = [(1, 1, None), (2, 1, None), (1, 0, "zero"), (1, 1, "zero"), (1, 1, "repeat")]
    cases, refs = [], []
    for lo, hi, edge in halos:
        shapes = [_halo_whole(x, r, world, lo, hi, edge).shape for r in range(world)]
        ws = [ints(*s) for s in shapes]
        cases.append(("halo", lo, hi, edge, ws))
        xw = x.clone().requires_grad_(True)
        loss = sum((_halo_whole(xw, r, world, lo, hi, edge) * ws[r]).sum() for r in range(world))
        refs.append((torch.autograd.grad(loss, xw)[0],))
    ws, adds = [ints(2, 3, 2, 5, 2) for _ in range(world)], [ints(2, 3, 2, 5, 2)
                                                               for _ in range(world)]
    cases.append(("crop", 1, 2, ws, adds))
    crop_x = torch.zeros_like(x)
    for r in range(world):
        crop_x[:, :, r * h + 1:r * h + 3] = ws[r]
    refs.append((crop_x, torch.stack(ws)))
    w = ints(*x.shape)
    cases.append(("gather", w))
    refs.append((w,))
    w_sum = ints(2, 3, 5, 2)
    cases.append(("sum", w_sum))
    refs.append((w_sum[:, :, None].expand_as(x),))
    ranks = spawn.run(spawn.sp_exchange_grads, world, x, cases, timeout=120)
    for i, (case, ref) in enumerate(zip(cases, refs)):
        got = torch.cat([ranks[r][i][0] for r in range(world)], 2)
        assert torch.equal(got, ref[0]), f"{case[:4]}"
        if case[0] == "crop":
            assert torch.equal(torch.stack([ranks[r][i][1] for r in range(world)]), ref[1])


def test_gn_relu_backward_from_merged_sums_matches_the_whole_sample():
    """The GroupNorm -> ReLU backward of each H slab from the slabs' summed
    sums (the plain versions of gn_bwd_sums_bf16 and gn_bwd_dx_bf16) is the
    whole sample's backward: dx within 1e-6 of its largest value, ds and dt
    within 1e-6 relative."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 4, 8, 6, 32), generator=g) * 3 + 1
    dy = torch.randn(x.shape, generator=g)
    scale, bias = torch.randn(32, generator=g), torch.randn(32, generator=g) * 0.5
    groups, n = 8, 2
    y, stats = gn_relu._reference(x, scale, bias, groups)
    dx, ds, dt = gn_relu.group_norm_relu_backward_reference(x, dy, scale, bias, stats, groups)
    slabs = [t.chunk(n, 2) for t in (x, dy)]
    sums = [gn_relu.gn_bwd_sums_reference(xs, gs, scale, bias, stats) for xs, gs in zip(*slabs)]
    total = sum(sums)
    count = x.numel() // x.shape[0] // groups
    parts = [gn_relu.gn_bwd_dx_reference(xs, gs, scale, bias, stats, s, total, count)
             for xs, gs, s in zip(*slabs, sums)]
    got_dx = torch.cat([p[0] for p in parts], 2)
    assert float((got_dx - dx).abs().max()) <= 1e-6 * float(dx.abs().max())
    for i, ref in ((1, ds), (2, dt)):
        got = sum(p[i] for p in parts)
        assert float((got - ref).norm() / ref.norm()) <= 1e-6

"""Stage rematerialization (``StepConfig.remat``, ``UNet3DFEAM(remat=True)``)
and the logical FLOP count, on the CPU.

The remat step must equal the step without remat exactly (the plain
versions are deterministic on the CPU and the recompute runs the same ops
on the same tensors), from a state after one step, so that the state's
parameters differ from the modules' own. The modules' own parameters are
overwritten with noise: a recompute that read them (a checkpoint of the
stage module in place of its parameter tensors) would change the
gradients.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multimodal_pl_tpu.utils import flops as jflops
from multimodal_pl_tpu_torch.models import UNet3DFEAM
from multimodal_pl_tpu_torch.ops import gn_relu
from multimodal_pl_tpu_torch.train.state import build_models, create_train_state, tiny_step_config
from multimodal_pl_tpu_torch.train.step import make_train_step
from multimodal_pl_tpu_torch.utils import flops

torch.set_num_threads(4)

NC = 14
P = (32, 32, 32)
LABEL_T = [0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1]


def _batch(b, seed=0):
    rng = np.random.default_rng(seed)
    sup = np.zeros(NC, np.float32)
    sup[5] = 1
    return {"image": torch.from_numpy(rng.standard_normal((b, *P, 1)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, NC, (b, *P)).astype(np.uint8)),
            "catlas": torch.from_numpy(rng.random((NC - 1, *P)).astype(np.float32)),
            "sup_mask": torch.from_numpy(sup),
            "label_t": torch.tensor(LABEL_T, dtype=torch.float32)}


def _noisy_models(cfg):
    models = build_models(cfg)
    with torch.no_grad():
        for m in models:
            for p in m.parameters():
                p.normal_(generator=torch.Generator().manual_seed(9))
    return models


@pytest.fixture(scope="module")
def stepped():
    """A state after one step (lr 1.0: far from the modules' own weights)."""
    cfg = tiny_step_config()
    state = create_train_state(torch.Generator().manual_seed(0), cfg)
    state, _ = make_train_step(*build_models(cfg), cfg)(state, _batch(2), torch.tensor(1.0),
                                                          torch.tensor(0.05))
    return cfg, state


@pytest.mark.parametrize("b", [1, 2])
def test_remat_step_equals_step(stepped, b):
    """Loss, every segmenter and refiner gradient leaf, and the next state:
    bit for bit with and without remat."""
    cfg, state = stepped
    batch, lr, wf = _batch(b, seed=b), torch.tensor(5e-4), torch.tensor(0.05)
    plain_step = make_train_step(*build_models(cfg), cfg)
    rcfg = dataclasses.replace(cfg, remat=True)
    remat_step = make_train_step(*_noisy_models(rcfg), rcfg)
    assert remat_step.model.remat and not plain_step.model.remat
    want, (wp, wr), _ = plain_step.grads(state, batch, wf)
    got, (gp, gr), _ = remat_step.grads(state, batch, wf)
    assert torch.equal(got, want)
    for g, w in ((gp, wp), (gr, wr)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k
    new_want, m_want = plain_step(state, batch, lr, wf)
    new_got, m_got = remat_step(state, batch, lr, wf)
    for group in ("params", "rparams", "dparams", "tokens"):
        a, c = getattr(new_got, group), getattr(new_want, group)
        assert all(torch.equal(a[k], c[k]) for k in c), group
    assert all(torch.equal(m_got[k], m_want[k]) for k in m_want)


def test_remat_recomputes_the_stages(monkeypatch):
    """Under remat the backward runs each checkpointed stage's GroupNorm ->
    ReLU forwards again: the forward calls of one gradient step rise by the
    stage sites (all but fusionConv's and precls_conv's), and only then."""
    calls = []
    real = gn_relu._forward
    monkeypatch.setattr(gn_relu, "_forward", lambda *a: calls.append(1) or real(*a))
    kw = dict(layers=(1, 1, 1, 1, 1), base=16, deep_up=True)
    x = torch.randn((1, 32, 32, 32, 1), generator=torch.Generator().manual_seed(1))
    counts, grads = {}, {}
    for remat in (False, True):
        model = UNet3DFEAM(remat=remat, **kw)
        calls.clear()
        loss = model(x, aux=False).square().mean()
        forward = len(calls)
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        counts[remat] = (forward, len(calls))
    # 5 encoder stages of 1 block (3 GNs each with a projection, else 2) and
    # 4 decoder stages of 1 block; fusionConv and precls_conv outside stages
    stage_sites = 2 + 4 * 3 + 3 * 3 + 2
    assert counts[False] == (stage_sites + 2, stage_sites + 2)
    assert counts[True] == (stage_sites + 2, 2 * stage_sites + 2)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(grads[False], grads[True]))


def test_remat_leaves_the_gradient_free_forward_alone():
    """Without grad (validation, serving) remat changes nothing: the same
    logits, and no checkpoint is set up."""
    kw = dict(layers=(1, 1, 1, 1, 1), base=16, deep_up=True)
    x = torch.randn((2, 32, 32, 32, 1), generator=torch.Generator().manual_seed(2))
    plain, remat = UNet3DFEAM(**kw), UNet3DFEAM(remat=True, **kw)
    with torch.no_grad():
        assert torch.equal(plain(x, aux=False), remat(x, aux=False))


@pytest.mark.parametrize("b,s,c", [(3, 64 * 192 * 192, 32), (3, 32 * 96 * 96, 64),
                                   (3, 4 * 12 * 12, 256), (3, 8 * 24 * 24, 128),
                                   (1, 4 * 12 * 12, 256), (2, 16 * 48 * 48, 24)])
def test_gn_relu_cluster_plan_holds_all_samples(b, s, c):
    """The backward's cluster holds all B samples: B times its blocks per
    sample fit the largest cluster (16 blocks on an H100), and each block's
    rows of x and dy fit its shared memory; the forward clusters one sample."""
    max_cluster, smem = 16, 227 * 1024
    for backward in (False, True):
        plan = gn_relu.cluster_plan(b, s, c, backward, max_cluster, smem)
        if plan is None:
            continue
        m, rows, nbytes = plan
        assert m * rows >= s and nbytes <= smem
        assert m * (b if backward else 1) <= max_cluster


@pytest.mark.parametrize("c,d,h,w", [(32, 64, 96, 192), (64, 32, 48, 96), (128, 16, 24, 48),
                                     (256, 8, 12, 24), (256, 4, 6, 12), (128, 8, 12, 24),
                                     (64, 16, 24, 48), (32, 32, 48, 96)])
def test_gn_bwd_sums_plan_one_launch_where_one_cluster_holds_the_sample(c, d, h, w):
    """gn_bwd_sums_bf16's plan at the spatial step's slab shapes (B = 1),
    for any count of co-resident clusters: stats_plan's blocks, none of them
    empty, and one launch (a cluster of STATS_CLUSTER) exactly where the
    sample's blocks fit one cluster, which only the 4 x 6 x 12 slab does."""
    s = d * h * w
    for clusters in (8, 33, 64, 132):
        rows, nblk, cluster = gn_relu.sums_plan(1, s, c, clusters)
        assert (rows, nblk) == gn_relu.stats_plan(1, s, c, clusters)
        assert rows * nblk >= s > rows * (nblk - 1)
        assert cluster == (gn_relu.STATS_CLUSTER if nblk <= gn_relu.STATS_CLUSTER else 0)
        assert bool(cluster) == ((d, h, w) == (4, 6, 12))


@pytest.mark.parametrize("kw", [dict(), dict(batch=3), dict(batch=2, shape=(32, 32, 32)),
                                dict(batch=1, base=16, refine_k=3, aug_mask=1)])
def test_flops_copy_matches_jax(kw):
    """utils/flops.py is a copy: every count equals the JAX package's."""
    assert flops.train_step_flops(**kw) == jflops.train_step_flops(**kw)
    fwd = {k: v for k, v in kw.items() if k in ("shape", "batch", "base")}
    assert flops.flagship_forward_flops(**fwd) == jflops.flagship_forward_flops(**fwd)
    ref = {k: v for k, v in kw.items() if k in ("shape", "batch")}
    assert flops.refiner_forward_flops(**ref) == jflops.refiner_forward_flops(**ref)
    assert flops.H100_BF16_PEAK == 989e12

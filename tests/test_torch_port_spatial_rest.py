"""The rest of the port's spatial parallelism (``--mesh space:N``): the
ablations, the FEAM's other configurations and the train step with remat
split over two gloo ranks, on the CPU, in f32 with the plain versions of the
kernels, at tiny shapes.

The ranks are spawned by ``tools/spawn.py`` (one spawn for every case, its
timeout 120 s, so that a collective that hangs fails its tests and not the
suite's clock). Each split output is held against the port's unsplit
forward of the same weights (``tests/test_torch_port_zoo.py`` and
``tests/test_torch_port_models.py`` hold those to JAX) within relative L2
1e-5, f32 summation order only (``tests/test_torch_port_spatial.py``'s
limit for the split logits; raw attention scores of magnitude 30 cross
zero, so an elementwise atol of 1e-5 would test the order of sums), and
``UNet3DEAM(aux=True)`` also against the JAX ``make_spatial_apply`` on a
``space:2`` CPU mesh at the zoo's port-against-JAX tolerance (rtol 2e-3,
atol 2e-4). The split remat step is held against the split step without
remat bit for bit, and against the unsplit step at
``tests/test_torch_port_spatial_step.py``'s tolerances. A planted fault
(``tools/spatial_fault.py``: each rank takes its own slab's softmax,
unmerged) must miss the JAX tolerance by more than 10 times.

The JAX package's train step with ``deep_up=False`` does not run: its
consistency term holds attention maps at their own scales against the
refiner's full-size probabilities and fails to broadcast at trace time. The
port's ``TrainStep`` raises ValueError for it, split or not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_pl_tpu.models as jmodels
from multimodal_pl_tpu.parallel.mesh import make_mesh as jmake_mesh
from multimodal_pl_tpu.parallel.spatial import make_spatial_apply as jmake_spatial_apply
from multimodal_pl_tpu.parallel.spatial import make_spatial_train_step as jmake_spatial_step
from multimodal_pl_tpu.parallel.spatial import put_spatial as jput_spatial
from multimodal_pl_tpu.train import create_train_state as jcreate_train_state
from multimodal_pl_tpu.train.state import build_models as jbuild_models
from multimodal_pl_tpu.train.state import tiny_step_config as jtiny_step_config
from multimodal_pl_tpu_torch import models
from multimodal_pl_tpu_torch.convert import state_dict_from_jax
from multimodal_pl_tpu_torch.models.blocks import init_default_
from multimodal_pl_tpu_torch.ops.resize import resize_nearest
from multimodal_pl_tpu_torch.parallel import spatial
from multimodal_pl_tpu_torch.tools import spatial_fault, spawn
from multimodal_pl_tpu_torch.train.state import build_models, create_train_state, tiny_step_config
from multimodal_pl_tpu_torch.train.step import TrainStep, make_train_step
from tests.conftest import cpu_devices

torch.set_num_threads(2)

NC = 14
X_SHAPE = (1, 16, 32, 32, 1)
P = (32, 32, 32)
KW = {"layers": (1, 1, 1, 1, 1), "base": 16, "num_classes": NC}
TOKEN_DIMS = {"t1": 64, "t2": 32, "t3": 16}
SPLIT_REL = 1e-5                 # split against unsplit, relative L2 per output
RTOL = 2e-4                      # the step against the unsplit step
JAX_TOL = {"rtol": 2e-3, "atol": 2e-4}  # the port against JAX (tests/test_torch_port_zoo.py)
LR, WF = 5e-4, 0.05
TASKS = torch.tensor([3])
# name -> (port class, constructor keywords, forward args, forward keywords)
MODELS = {
    "eam3": ("UNet3DEAM", dict(KW, num_eams=3), (), {}),
    "eam2": ("UNet3DEAM", dict(KW, num_eams=2), (), {}),
    "deepsup": ("UNet3DDeepSup", KW, (), {}),
    "dynhead": ("UNet3DDynHead", {k: v for k, v in KW.items() if k != "num_classes"},
                (TASKS,), {}),
    "feam_own_scale_maps": ("UNet3DFEAM", dict(KW, deep_up=False), ("tokens",), {}),
    "feam2_pre_update": ("UNet3DFEAM", dict(KW, deep_up=True, token_update="pre"), ("tokens",),
                         {"mask": "mask"}),
}
EAMS = ("EAM", "EAMBK", "EAMIdentity")  # both orders of _attend's scale


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for v in out.values() for t in _flat(v)]
    return [t for v in out for t in _flat(v)]


def rel(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def excess(got, want, rtol=RTOL, atol=1e-5) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def _x():
    return torch.from_numpy(np.random.default_rng(0).standard_normal(X_SHAPE).astype(np.float32))


def _inputs():
    tokens = models.init_class_tokens(torch.Generator().manual_seed(1), NC, TOKEN_DIMS)
    mask = torch.from_numpy(np.random.default_rng(2).integers(0, NC, X_SHAPE[:4]))
    return {"tokens": tokens, "mask": mask}


def _batch():
    rng = np.random.default_rng(0)
    b = {"image": rng.standard_normal((1, *P, 1)).astype(np.float32),
         "label": rng.integers(0, NC, (1, *P)).astype(np.int32),
         "catlas": rng.random((NC - 1, *P)).astype(np.float32),
         "sup_mask": np.asarray([0, 0, 0, 1] + [0] * 10, np.float32),
         "label_t": np.asarray([0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1], np.float32)}
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _eam_case(name):
    dim = 32
    eam = getattr(models, name)(dim)
    init_default_(eam, torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    return dim, eam, torch.randn((2, 4, 8, 4, dim), generator=g), torch.randn((1, NC - 1, dim),
                                                                              generator=g)


@pytest.fixture(scope="module")
def jax_eam():
    """JAX UNet3DEAM(num_eams=3) at the port's tiny widths: its params, its
    unsharded forward, and its space:2 GSPMD forward gathered whole."""
    jm = jmodels.UNet3DEAM(num_classes=NC, layers=KW["layers"], base=KW["base"], num_eams=3)
    x = jnp.asarray(_x().numpy())
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    mesh = jmake_mesh("space:2", cpu_devices(2))
    sharded = jmake_spatial_apply(jm.apply, mesh, out_sharded=False)(params,
                                                                     jput_spatial(x, mesh))
    return {"weights": state_dict_from_jax(params),
            "want": jax.tree_util.tree_map(np.asarray, jax.jit(jm.apply)(params, x)),
            "sharded": jax.tree_util.tree_map(np.asarray, sharded)}


@pytest.fixture(scope="module")
def unsplit():
    """The port's unsplit forward of every model of MODELS and of each EAM
    variant, with their weights."""
    x, inputs = _x(), _inputs()
    out = {}
    for name, (cls, kw, args, kwargs) in MODELS.items():
        net = getattr(models, cls)(**kw, generator=torch.Generator().manual_seed(5)).eval()
        args = [inputs.get(a, a) if isinstance(a, str) else a for a in args]
        kwargs = {k: inputs[v] for k, v in kwargs.items()}
        with torch.no_grad():
            out[name] = (net.state_dict(), args, kwargs, net(x, *args, **kwargs))
    for name in EAMS:
        dim, eam, xe, tokens = _eam_case(name)
        with torch.no_grad():
            out[name] = (eam.state_dict(), xe, tokens, eam(xe.reshape(2, -1, dim), tokens))
    return out


@pytest.fixture(scope="module")
def ranks(jax_eam, unsplit):
    """One spawn of two gloo ranks: the split forward of every model of
    MODELS, UNet3DEAM with JAX's weights clean and with the unmerged-softmax
    fault, each EAM variant alone, and the split step without and with
    remat. {case: (rank 0's result, rank 1's)}."""
    x = _x()
    calls = {}
    for name, (cls, kw, _, _) in MODELS.items():
        weights, args, kwargs, _ = unsplit[name]
        calls[name] = (spawn.sp_forward, (kw, weights, x, "cpu", cls, False, None, args, kwargs))
    jkw = dict(KW, num_eams=3)
    calls["jax_eam"] = (spawn.sp_forward, (jkw, jax_eam["weights"], x, "cpu", "UNet3DEAM",
                                           False, None, (), {}))
    calls["fault"] = (spawn.sp_forward, (jkw, jax_eam["weights"], x, "cpu", "UNet3DEAM", False,
                                         spatial_fault.unmerged_softmax, (), {}))
    for name in EAMS:
        weights, xe, tokens, _ = unsplit[name]
        calls[name] = (spawn.sp_eam, (name, xe.shape[-1], weights, xe, tokens))
    cfg = tiny_step_config(num_classes=NC, augmask=2, weight_gan=1e-3,
                           compute_dtype=torch.float32)
    state = create_train_state(torch.Generator().manual_seed(0), cfg)
    for remat in (False, True):
        calls[f"step_remat_{remat}"] = (spawn.sp_step, (dataclasses.replace(cfg, remat=remat),
                                                        state, _batch(), LR, WF))
    got = spawn.run(spawn.dp_calls, 2, list(calls.values()), timeout=120)
    out = dict(zip(calls, zip(*got)))
    out["step_inputs"] = (cfg, state)
    return out


def test_split_eam_matches_jax_spatial_apply_and_the_port_unsplit(jax_eam, ranks):
    """UNet3DEAM(num_eams=3, aux=True) split over two ranks: logits, the
    cascade's tokens (merged softmax over the voxels) and its three
    attention maps against JAX's space:2 forward and JAX's unsharded one;
    the ranks' outputs bit-equal; one 'softmax' gather per EAM."""
    (r0, _, ex0), (r1, _, _) = ranks["jax_eam"]
    got = _flat(r0)
    assert all(torch.equal(a, b) for a, b in zip(got, _flat(r1)))
    for ref in (jax_eam["sharded"], jax_eam["want"]):
        want = [ref[0], ref[1], *ref[2]]
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, **JAX_TOL)
    assert sum(n for k, n in ex0.items() if k[0] == "softmax") == 3


@pytest.mark.parametrize("name", list(MODELS))
def test_split_forward_matches_the_port_unsplit(unsplit, ranks, name):
    """Every output of each model split over two ranks (logits, deep maps,
    attention maps at their own scales, features, tokens; DynHead's logits
    through the mean over the whole tile) within SPLIT_REL of the unsplit
    forward's, the ranks' bit for bit; the new reductions gather once per
    use (3 or 2 EAMs; DynHead's one mean)."""
    (r0, _, ex0), (r1, _, _) = ranks[name]
    got, want = _flat(r0), _flat(unsplit[name][3])
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, _flat(r1)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w) or rel(g, w) <= SPLIT_REL
    kinds = {k[0]: 0 for k in ex0}
    for k, n in ex0.items():
        kinds[k[0]] += n
    assert kinds.get("softmax", 0) == {"eam3": 3, "eam2": 2}.get(name, 0)
    assert kinds.get("mean", 0) == (name == "dynhead")


def test_feam2_pre_update_moves_the_tokens_as_unsplit(unsplit, ranks):
    """The feam2 token pre-update split: each scale's class means summed
    over the ranks move the tokens as the unsplit forward's do; the update
    (new - old, alpha times the means) within rel 1e-5 of the unsplit one."""
    tokens = _inputs()["tokens"]
    got, want = ranks["feam2_pre_update"][0][0][4], unsplit["feam2_pre_update"][3][4]
    for k in tokens:
        dg, dw = got[k] - tokens[k], want[k] - tokens[k]
        assert dw.abs().max() > 0
        assert rel(dg, dw) <= SPLIT_REL


@pytest.mark.parametrize("h", [16, 32])
def test_nearest_mask_slab_holds_the_whole_masks_rows(h):
    """The pre-update's nearest resize of a rank's label slab to its feature
    slab gives the whole mask's resized rows: a slab starts at a multiple of
    every scale factor (1/2, 1/4, 1/8 of a tile whose H is a multiple of
    16 N)."""
    mask = torch.from_numpy(np.random.default_rng(3).integers(0, NC, (1, 8, h, 8, 1)))

    class Ranks:
        def __init__(self, rank):
            self.rank, self.world = rank, 2

    for f in (2, 4, 8):
        out = (8 // f, h // f, 8 // f)
        whole = resize_nearest(mask, out)
        for r in range(2):
            own = resize_nearest(spatial.put_spatial(mask, Ranks(r)), (out[0], out[1] // 2,
                                                                       out[2]))
            assert torch.equal(own, spatial.put_spatial(whole, Ranks(r)))


@pytest.mark.parametrize("name", EAMS)
def test_split_eam_variants_match_whole(unsplit, ranks, name):
    """EAM (scaled after the product), EAMBK and EAMIdentity (queries scaled
    first) on two slabs of the voxels: the token update whole on each rank
    within SPLIT_REL, the scores the whole scores' columns of the rank's
    voxels, bit for bit."""
    _, xe, _, (want_out, want_attn) = unsplit[name]
    b, d, h, w, _ = xe.shape
    whole = want_attn.reshape(*want_attn.shape[:3], d, h, w)
    for r, (out, attn) in enumerate(ranks[name]):
        assert rel(out, want_out) <= SPLIT_REL
        own = whole[..., r * h // 2:(r + 1) * h // 2, :].reshape(attn.shape)
        assert torch.equal(attn, own)


def test_unmerged_softmax_fails_by_more_than_10x(jax_eam, ranks):
    """The planted fault, each rank's softmax over its own slab's voxels
    alone: the cascade's tokens miss the split-against-JAX tolerance (and
    the ranks disagree)."""
    want = jax_eam["sharded"][1]
    got0, got1 = (r[0][1] for r in ranks["fault"])
    assert excess(got0, want, **JAX_TOL) > 10
    assert not torch.equal(got0, got1)


def test_split_remat_step_equals_the_split_step(ranks):
    """The split step with remat (the checkpointed stages recompute their
    halo exchanges and moment gathers in the backward) gives the split
    step's new state and metrics bit for bit on each rank, and the ranks
    agree. Remat adds exactly the recompute's exchanges, derived from the
    architecture (layers (1, 1, 1, 1, 1)): per stage, each block's halos
    (a stride-1 conv's and a stride-2 conv's), crops (stride-1 convs) and
    GroupNorm moment gathers (GN1, GN2, the projection's), except the final
    crop of a stage whose last block has no projection (layer0, x1_resb:
    the recompute stops after the last op that saved a tensor): 18 halos,
    12 crops, 25 moment gathers; the backward's exchanges unchanged."""
    plain, remat = ranks["step_remat_False"], ranks["step_remat_True"]
    for (s0, m0, _, e0), (s1, m1, _, e1) in zip(plain, remat):
        assert spawn.states_unequal(s0, s1) == [] and m0 == m1
        extra = {}
        for key, n in e1.items():
            extra[key[0]] = extra.get(key[0], 0) + n - e0.get(key, 0)
        assert {k: n for k, n in extra.items() if n} == {"halo": 18, "crop": 12, "stats": 25}
    assert spawn.states_unequal(remat[0][0], remat[1][0]) == []


def test_split_remat_step_matches_the_unsplit_step(ranks):
    """The split remat step against the port's unsplit step (which
    tests/test_torch_port_remat.py holds bit-equal to remat), at
    tests/test_torch_port_spatial_step.py's tolerances: metrics rtol 2e-4,
    atol 1e-6; every leaf within 1e-5 + 2e-4 |ref| (momentum 5e-5)."""
    cfg, state = ranks["step_inputs"]
    new, m = make_train_step(*build_models(cfg), cfg)(state, _batch(), torch.tensor(LR),
                                                       torch.tensor(WF))
    got, gm = ranks["step_remat_True"][0][:2]
    for k, v in m.items():
        np.testing.assert_allclose(gm[k], float(v), rtol=2e-4, atol=1e-6, err_msg=k)
    for tree in ("params", "rparams", "dparams", "tokens"):
        for k, v in getattr(new, tree).items():
            assert excess(getattr(got, tree)[k], v, atol=1e-5) <= 1.0, (tree, k)
    for i in range(2):
        for k, v in new.momentum[i].items():
            assert excess(got.momentum[i][k], v, atol=5e-5) <= 1.0, k


def test_deep_up_false_step_fails_in_jax_and_raises_in_the_port():
    """The JAX spatial step (and so its single-device step) with
    deep_up=False fails at trace time: the consistency term's own-scale
    attention maps do not broadcast with the refiner's probabilities. The
    port's TrainStep raises ValueError before any work, split or not."""
    jcfg = jtiny_step_config(num_classes=NC, deep_up=False, augmask=2, weight_gan=1e-3)
    jstate = jax.eval_shape(lambda: jcreate_train_state(jax.random.PRNGKey(0), jcfg))
    jstep = jmake_spatial_step(*jbuild_models(jcfg), jcfg, jmake_mesh("space:2",
                                                                      cpu_devices(2)))
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batch().items()}
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(jstep, jstate, batch, jnp.float32(LR), jnp.float32(WF))
    cfg = tiny_step_config(num_classes=NC, deep_up=False)
    for space in (None, spatial.SpatialGroup(None, 0, 2)):
        with pytest.raises(ValueError, match="deep_up=False"):
            TrainStep(*build_models(cfg), cfg, space=space)

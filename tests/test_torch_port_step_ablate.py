"""The port's train-step ladder (``tools/step_ablate.py``) against the JAX
package's (``scripts/step_ablate.py``, loaded by its path), rung by rung.

Setup as tests/test_torch_port_train_step.py: ``tiny_step_config()``, a
32^3 patch, f32 on the CPU, JAX's voxel models, one JAX state carried across
by ``train_state_from_jax``. The JAX ladder runs its XLA GroupNorm, not the
Pallas kernel in interpret mode: what this file holds is the rungs'
semantics, and that file already holds the step's Pallas route against the
port's. The batch is the ladder's (``ladder_batch``) with
organ 5 supervised, a labeled-modality organ, so the refiner's gradient pass
has a row and switching the refiner off changes its update.

Tolerances (that file's): the metrics ``loss``, ``d``, ``rd``, ``dl`` rtol
1e-3; the updates of params and rparams at lr 1.0 (new - old) by relative
Frobenius norm <= 1e-3 over each tree; the tokens rtol 1e-4. Port-only: the
``full`` rung's new state is ``TrainStep``'s bit for bit, ``norefiner``
moves rparams by weight decay alone, and a data group or a split space
raises.
"""

import importlib.util
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.models import NormStyleDiscriminator as JNormStyle
from multimodal_pl_tpu.models import RefinerUNet3D as JRefiner
from multimodal_pl_tpu.models import UNet3DFEAM as JUNet3DFEAM
from multimodal_pl_tpu.ops.norm import set_fused_gn_relu
from multimodal_pl_tpu.ops.s2d import set_k2_pallas
from multimodal_pl_tpu.train.state import create_train_state as jcreate_train_state
from multimodal_pl_tpu.train.state import tiny_step_config as jtiny_step_config
from multimodal_pl_tpu_torch.convert import train_state_from_jax
from multimodal_pl_tpu_torch.parallel.spatial import SpatialGroup
from multimodal_pl_tpu_torch.tools.step_ablate import RUNGS, AblatedStep, ladder_batch
from multimodal_pl_tpu_torch.train.state import build_models, tiny_step_config
from multimodal_pl_tpu_torch.train.step import TrainStep

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = (32, 32, 32)
NC = 14
SUP_ORGAN = 5
UPDATE_LR, WF = 1.0, 0.05
# XLA:CPU without LLVM's costly optimisations: a third less compile for
# each JAX rung, at a few 1e-6 of the loss
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _batch():
    b = ladder_batch(P, 1, NC)
    b["sup_mask"] = np.zeros(NC, np.float32)
    b["sup_mask"][SUP_ORGAN] = 1
    return b


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def jax_side():
    spec = importlib.util.spec_from_file_location(
        "jax_step_ablate", os.path.join(REPO, "scripts", "step_ablate.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    cfg = jtiny_step_config()
    set_fused_gn_relu(False)  # the trace-time switches of the Pallas route, off
    set_k2_pallas(False)
    state = jcreate_train_state(jax.random.PRNGKey(0), cfg)
    model = JUNet3DFEAM(layers=cfg.layers, num_classes=NC, weight_std=True, deep_up=True,
                        base=cfg.base, s2d=False, bd=False)
    refiner = JRefiner(num_classes=2, weight_std=True, init_filter=cfg.refiner_filter,
                       in_channel=2, s2d=False)
    disc = JNormStyle(ndf=cfg.disc_ndf, depth=cfg.disc_depth)
    return script, state, (model, refiner, disc), cfg


@pytest.fixture(scope="module")
def jax_rungs(jax_side):
    """{rung: (new JAX state, metrics)} of one step of each rung from the
    shared state. Each rung is traced and compiled once, in a thread of its
    own: tracing holds the interpreter, XLA's compile does not, so the
    compiles overlap the other rungs' tracing."""
    script, jstate0, models, cfg = jax_side
    args = ({k: jnp.asarray(v) for k, v in _batch().items()}, jnp.float32(UPDATE_LR),
            jnp.float32(WF))

    def run(kw):
        step = script.build_ablated_step(*models, cfg, **kw).lower(jstate0, *args).compile(
            compiler_options=FAST_COMPILE)
        # the JAX step donates its state: give it a copy of the shared one
        return step(jax.tree_util.tree_map(jnp.copy, jstate0), *args)

    with ThreadPoolExecutor(len(RUNGS)) as pool:
        return dict(zip([n for n, _ in RUNGS], pool.map(run, [kw for _, kw in RUNGS])))


@pytest.fixture(scope="module")
def port_models():
    cfg = tiny_step_config()
    return build_models(cfg), cfg


def _port_rung(port_models, state, kw, lr=UPDATE_LR):
    models, cfg = port_models
    return AblatedStep(*models, cfg, **kw)(state, _tb(_batch()), torch.tensor(lr),
                                           torch.tensor(WF))


@pytest.mark.parametrize("name,kw", RUNGS, ids=[n for n, _ in RUNGS])
def test_rung_matches_jax(jax_side, jax_rungs, port_models, name, kw):
    jstate1, jm = jax_rungs[name]
    state0 = train_state_from_jax(jax_side[1])
    state1, m = _port_rung(port_models, state0, kw)

    assert sorted(m) == sorted(jm) == ["d", "dl", "loss", "rd"]
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3, atol=1e-6, err_msg=k)
    if kw.get("metrics_on", True):
        assert float(m["d"]) > 0
    else:
        assert float(m["d"]) == float(m["rd"]) == 0
    disc_on = kw.get("disc_on", True)
    assert (float(m["dl"]) > 0) == disc_on

    want1 = train_state_from_jax(jstate1)
    for group in ("params", "rparams"):
        old, new, ref = (getattr(s, group) for s in (state0, state1, want1))
        got, want = (np.concatenate([(t[k] - old[k]).numpy().ravel() for k in ref])
                     for t in (new, ref))
        rel = _rel(got, want)
        assert rel <= 1e-3, f"{name} {group}: update rel Frobenius {rel:.2e}"
    for s in (state1, want1):  # the discriminator steps on every leaf, or on none
        moved = [not torch.equal(s.dparams[k], state0.dparams[k]) for k in state0.dparams]
        assert all(moved) if disc_on else not any(moved)
    for k in want1.tokens:
        np.testing.assert_allclose(state1.tokens[k].numpy(), want1.tokens[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(state1.step) == int(jstate1.step) == 1


def test_full_rung_is_train_step_bit_for_bit(jax_side, port_models):
    models, cfg = port_models
    state0 = train_state_from_jax(jax_side[1])
    lr, wf = torch.tensor(5e-4), torch.tensor(WF)
    got, m = AblatedStep(*models, cfg)(state0, _tb(_batch()), lr, wf)
    want, wm = TrainStep(*models, cfg)(state0, _tb(_batch()), lr, wf)
    for group in ("params", "rparams", "dparams", "tokens"):
        a, b = getattr(got, group), getattr(want, group)
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in b), group
    for i in range(2):
        assert all(torch.equal(got.momentum[i][k], want.momentum[i][k]) for k in want.momentum[i])
    assert torch.equal(m["loss"], wm["loss"]) and torch.equal(m["dl"], wm["disc_loss"])
    assert torch.equal(m["d"], wm["train_dice_mean"])
    assert torch.equal(m["rd"], wm["refiner_dice_mean"])
    assert float(wm["refine_loss"]) > 0


def test_norefiner_moves_rparams_by_weight_decay_alone(jax_side, port_models):
    """Zero gradients, on which SGD still runs: from zero momentum the
    buffer is wd * p and the update -lr * wd * p; the full step's refiner
    update differs from that (its gradient is live)."""
    cfg = port_models[1]
    state0 = train_state_from_jax(jax_side[1])
    kw = dict(RUNGS)["norefiner"]
    state1, _ = _port_rung(port_models, state0, kw)
    full, _ = _port_rung(port_models, state0, {})
    wd = cfg.weight_decay
    for k, p in state0.rparams.items():
        torch.testing.assert_close(state1.momentum[1][k], wd * p, rtol=0, atol=0)
        torch.testing.assert_close(state1.rparams[k], p - UPDATE_LR * (wd * p), rtol=0, atol=0)
    assert any(not torch.equal(full.rparams[k], state1.rparams[k]) for k in state0.rparams)


@pytest.mark.parametrize("where", ["group", "space"])
def test_ladder_runs_on_one_device(port_models, where):
    models, cfg = port_models
    kw = {"group": object()} if where == "group" else {"space": SpatialGroup(None, 0, 2)}
    with pytest.raises(ValueError, match="one device"):
        AblatedStep(*models, cfg, **kw)
    AblatedStep(*models, cfg, space=SpatialGroup(None, 0, 1))  # a group of one is one device

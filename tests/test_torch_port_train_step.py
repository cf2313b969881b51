"""The port's train step against the JAX package's, from one state.

Setup: ``tiny_step_config()`` (base 16, single-block stages, refiner 8, disc
16 x 5), a 32^3 patch, the batch of tests/test_train_step.py (and one whose
supervised organ is in the labeled modality, so the refiner loss is live),
f32 on the CPU. The JAX side runs ``build_step_body`` on its voxel models
(``s2d=False``) with ``pallas_gn/pallas_k2/pallas_infer`` on, as the step is
configured on the chip: every GN -> ReLU is the Pallas kernel in interpret
mode, so both frameworks compute its one-pass moments (the k2 switches only
reach the s2d layouts). Both start from one JAX state carried across by
``train_state_from_jax``.

Tolerances: losses and metrics rtol 1e-3; the parameter updates
(new - old) by relative Frobenius norm, <= 1e-3 over each whole tree and
<= 1.5e-3 per leaf. The per-leaf bound is not 1e-3 because of the JAX side's
own f32 rounding: against a float64 run of the port's step (readings of
``_float64_step``), JAX's update is off by 1.1e-3 on ``layer0.0.gn2.bias`` and
``layer1.0.gn1.bias`` (sup organ 3; 5.7e-4 for organ 5), the port's by 1.7e-6
and 7.6e-7; the port's worst leaf against float64 is 1.3e-4 (a GN scale).
Those GN biases of the full-resolution blocks are sums of 32^3 voxels that
nearly cancel. test_one_step_is_float64_accurate holds the port to its
float64 step at 1e-3 on every leaf. The one-step tests use lr 1.0: at lr
5e-4 an update is ~1e-4 of its parameter, and new - old in f32 would measure
rounding, not the step;
the discriminator's gradients by relative Frobenius norm <= 1e-3, and its
sign-SGD update lr * g / (|g| + eps) only where |g| >= 1e-3 * max|g| (where
g ~ 0 the sign of a gradient is noise), at rtol 1e-3: the update's relative
error is at most the gradient's; tokens rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.losses.gan import smooth_cross_entropy as jsmooth_ce
from multimodal_pl_tpu.models import NormStyleDiscriminator as JNormStyle
from multimodal_pl_tpu.models import RefinerUNet3D as JRefiner
from multimodal_pl_tpu.models import UNet3DFEAM as JUNet3DFEAM
from multimodal_pl_tpu.ops.norm import set_fused_gn_relu
from multimodal_pl_tpu.ops.s2d import set_k2_pallas
from multimodal_pl_tpu.train.state import create_train_state as jcreate_train_state
from multimodal_pl_tpu.train.state import tiny_step_config as jtiny_step_config
from multimodal_pl_tpu.train.step import build_step_body
from multimodal_pl_tpu_torch.convert import state_dict_from_jax, train_state_from_jax
from multimodal_pl_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from multimodal_pl_tpu_torch.train.state import build_models, map_state, tiny_step_config
from multimodal_pl_tpu_torch.train.step import make_train_step

torch.set_num_threads(4)

P = (32, 32, 32)
NC = 14
LR, WF = 5e-4, 0.05
UPDATE_LR = 1.0
LABEL_T = [0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1]


def _sup(organ):
    m = np.zeros(NC, np.float32)
    m[organ] = 1
    return m


def _batch(sup_organ, b=1):
    rng = np.random.default_rng(0)
    return {
        "image": rng.standard_normal((b, *P, 1)).astype(np.float32),
        "label": rng.integers(0, NC, (b, *P)).astype(np.int32),
        "catlas": rng.random((NC - 1, *P)).astype(np.float32),
        "sup_mask": _sup(sup_organ),
        "label_t": np.asarray(LABEL_T, np.float32),
    }


@pytest.fixture(scope="module")
def jax_side():
    # the step as configured on the chip: every Pallas kernel it can reach
    # (interpret mode here; on the voxel path that is fused_group_norm_relu)
    cfg = jtiny_step_config(pallas_gn=True, pallas_k2=True, pallas_infer=True)
    state = jcreate_train_state(jax.random.PRNGKey(0), cfg)
    model = JUNet3DFEAM(layers=cfg.layers, num_classes=NC, weight_std=True, deep_up=True,
                        base=cfg.base, s2d=False, bd=False)
    refiner = JRefiner(num_classes=2, weight_std=True, init_filter=cfg.refiner_filter,
                       in_channel=2, s2d=False)
    disc = JNormStyle(ndf=cfg.disc_ndf, depth=cfg.disc_depth)
    step = jax.jit(build_step_body(model, refiner, disc, cfg))

    def disc_grads(params, dparams, batch):
        logits = model.apply(params, jnp.asarray(batch["image"]), state.tokens)[0]
        probs = jax.nn.softmax(logits.astype(jnp.float32), -1)
        din = (jnp.moveaxis(probs[0, ..., 1:], -1, 0), jnp.asarray(batch["catlas"]))
        return jax.grad(lambda dp: jsmooth_ce(disc.apply(dp, din),
                                              jnp.asarray(batch["label_t"], jnp.int32)))(dparams)

    yield state, step, jax.jit(disc_grads)
    # build_step_body set the trace-time switches; other test files expect them off
    set_fused_gn_relu(False)
    set_k2_pallas(False)


@pytest.fixture(scope="module")
def port_step():
    cfg = tiny_step_config()
    return make_train_step(*build_models(cfg), cfg)


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _np(t):
    return t.detach().numpy()


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jax_step(jax_side, state, batch, lr):
    _, step, _ = jax_side
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return step(state, jb, jnp.float32(lr), jnp.float32(WF))


@pytest.mark.parametrize("sup_organ", [3, 5])
def test_one_step_matches_jax(jax_side, port_step, sup_organ):
    """sup_organ 3: the tests/test_train_step.py batch (no tlist row, refine
    loss 0); 5: a labeled-modality organ, so the refiner trains."""
    jstate0 = jax_side[0]
    batch = _batch(sup_organ)
    jstate1, jm = _jax_step(jax_side, jstate0, batch, UPDATE_LR)
    state0 = train_state_from_jax(jstate0)
    state1, m = port_step(state0, _tb(batch), torch.tensor(UPDATE_LR), torch.tensor(WF))

    assert sorted(m) == sorted(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3, atol=1e-6, err_msg=k)
    if sup_organ == 5:
        assert float(m["refine_loss"]) > 0

    want1 = train_state_from_jax(jstate1)
    for group in ("params", "rparams"):
        old, new, ref = (getattr(s, group) for s in (state0, state1, want1))
        assert sorted(new) == sorted(ref)
        got = {k: _np(new[k] - old[k]) for k in ref}
        want = {k: _np(ref[k] - old[k]) for k in ref}
        for k in ref:
            rel = _rel(got[k], want[k])
            assert rel <= 1.5e-3, f"{group}.{k}: update rel Frobenius {rel:.2e}"
        rel = _rel(*(np.concatenate([t[k].ravel() for k in ref]) for t in (got, want)))
        assert rel <= 1e-3, f"{group}: update rel Frobenius {rel:.2e}"

    # discriminator: gradients, then the sign update where |g| is not noise
    jg = jax_side[2](jstate0.params, jstate0.dparams, batch)
    jg = {k: v.numpy() for k, v in state_dict_from_jax(jg).items()}
    _, aux = port_step.losses(state0.params, state0.rparams, state0, _tb(batch), WF)
    _, g = port_step.disc_grads(state0, aux, _tb(batch))
    for k in jg:
        rel = _rel(_np(g[k]), jg[k])
        assert rel <= 1e-3, f"disc grad {k}: rel Frobenius {rel:.2e}"
        live = np.abs(jg[k]) >= 1e-3 * np.abs(jg[k]).max()
        np.testing.assert_allclose(_np(state1.dparams[k])[live],
                                   _np(want1.dparams[k])[live], rtol=1e-3, atol=0,
                                   err_msg=k)

    for k in want1.tokens:
        np.testing.assert_allclose(_np(state1.tokens[k]), _np(want1.tokens[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(state1.step) == int(jstate1.step) == 1


def _float64_step(state, batch, monkeypatch):
    """One step of the port in float64: the models, state, batch and every
    f32 cast of the step (``Tensor.float``) in double precision."""
    monkeypatch.setattr(torch.Tensor, "float", lambda self, *a, **k: self.double())
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        cfg = dataclasses.replace(tiny_step_config(), compute_dtype=torch.float64)
        step = make_train_step(*(m.double() for m in build_models(cfg)), cfg)
        dbl = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
        lr = torch.tensor(UPDATE_LR, dtype=torch.float64)
        return step(map_state(dbl, state), {k: dbl(v) for k, v in batch.items()}, lr,
                    torch.tensor(WF, dtype=torch.float64))[0]
    finally:
        torch.set_default_dtype(default)


@pytest.mark.parametrize("sup_organ", [3, 5])
def test_one_step_is_float64_accurate(jax_side, port_step, sup_organ, monkeypatch):
    """The port's f32 update against its own float64 step, per leaf <= 1e-3
    (measured <= 2.7e-4; the largest are refiner leaves whose update is
    weight decay alone, where new - old rounds in f32)."""
    batch = _tb(_batch(sup_organ))
    state0 = train_state_from_jax(jax_side[0])
    state1, _ = port_step(state0, batch, torch.tensor(UPDATE_LR), torch.tensor(WF))
    ref = _float64_step(state0, batch, monkeypatch)
    for group in ("params", "rparams"):
        old, new, want = (getattr(s, group) for s in (state0, state1, ref))
        for k in want:
            rel = _rel(_np(new[k] - old[k]).astype(np.float64), _np(want[k] - old[k].double()))
            assert rel <= 1e-3, f"{group}.{k}: update rel Frobenius vs float64 {rel:.2e}"


def test_one_step_at_batch_2_matches_jax(jax_side, port_step, monkeypatch):
    """B = 2 (the batch conventions): the segmenter and its loss take both
    samples, the refiner, the discriminator, the catlas and the metrics'
    dice sample 0, the token EMA both. Metrics rtol 1e-3; the tokens rtol
    1e-4; the updates by relative Frobenius norm over each tree <= 5e-3 of
    JAX's and <= 1e-3 of the port's float64 step. At B = 2 JAX's own f32
    update sits 2.2e-3 from that float64 step (the port's 1.9e-4; its
    worst leaves are the full-resolution GN biases, as at B = 1), while a
    sample taken from the wrong place moves the update by O(1)."""
    batch = _batch(5, b=2)
    jstate1, jm = _jax_step(jax_side, jax_side[0], batch, UPDATE_LR)
    state0 = train_state_from_jax(jax_side[0])
    state1, m = port_step(state0, _tb(batch), torch.tensor(UPDATE_LR), torch.tensor(WF))
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3, atol=1e-6, err_msg=k)
    assert float(m["refine_loss"]) > 0
    want1 = train_state_from_jax(jstate1)
    f64 = _float64_step(state0, _tb(batch), monkeypatch)
    for group in ("params", "rparams"):
        old, new, ref, ref64 = (getattr(s, group) for s in (state0, state1, want1, f64))

        def update(t):
            return np.concatenate([_np(t[k] - old[k].to(t[k].dtype)).ravel() for k in old])

        got = update(new).astype(np.float64)
        assert _rel(got, update(ref)) <= 5e-3, group
        assert _rel(got, update(ref64)) <= 1e-3, group
    for k in want1.tokens:
        np.testing.assert_allclose(_np(state1.tokens[k]), _np(want1.tokens[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_two_steps_match_jax(jax_side, port_step):
    batch = _batch(5)
    jstate, state = jax_side[0], train_state_from_jax(jax_side[0])
    for lr in (LR, 4e-4):
        jstate, jm = _jax_step(jax_side, jstate, batch, lr)
        state, m = port_step(state, _tb(batch), torch.tensor(lr), torch.tensor(WF))
    for k in ("loss", "seg_loss", "refine_loss", "gan_g_loss", "disc_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3, err_msg=k)
    assert int(state.step) == 2


def test_save_restore_step_is_bit_exact(jax_side, port_step, tmp_path):
    """step, save, restore, step == two unbroken steps, bit for bit."""
    batch = _tb(_batch(5))
    lr, wf = torch.tensor(LR), torch.tensor(WF)
    s1, _ = port_step(train_state_from_jax(jax_side[0]), batch, lr, wf)
    unbroken, m_unbroken = port_step(s1, batch, lr, wf)
    save_checkpoint(str(tmp_path), s1, int(s1.step))
    path = latest_checkpoint(str(tmp_path))
    assert path.endswith("ckpt_1.pt")
    resumed, m_resumed = port_step(restore_checkpoint(path), batch, lr, wf)
    for group in ("params", "rparams", "dparams", "tokens"):
        a, b = getattr(unbroken, group), getattr(resumed, group)
        assert all(torch.equal(a[k], b[k]) for k in a), group
    for i in range(2):
        assert all(torch.equal(unbroken.momentum[i][k], resumed.momentum[i][k])
                   for k in unbroken.momentum[i])
    assert all(torch.equal(m_unbroken[k], m_resumed[k]) for k in m_unbroken)
    assert int(resumed.step) == 2

"""The port's train step against the JAX package's over epochs of real
batches, as a campaign runs them: from one JAX state, the same device-pipeline
batches of a synthetic partial-label fixture (CT cases that supervise one
organ each, MRI cases that supervise none), with each epoch's poly LR and
feature-ramp weight, for 4 epochs that cross ``pretrain_epoch`` (the refiner
and pseudo-label terms switch on) and the ramp. One-step parity
(tests/test_torch_port_train_step.py) cannot see a fault of the schedules,
of the epoch the step reads, or of what accumulates (momentum, the token EMA,
the discriminator): each of those moves the runs apart here by far more
than f32 rounding does.

Tolerances, from the spread that f32 rounding alone leaves after these 12
steps (readings: every loss within 1.2e-4 relative; the updates' relative
Frobenius distance 2.3e-3 for the segmenter, 1.7e-3 for the refiner, 3.4e-5
for the tokens and 9.1e-2 for the discriminator, whose sign-SGD flips the
sign of near-zero gradients): each step's losses rtol 5e-3; the updates
5e-2 (segmenter, refiner), 0.3 (discriminator), 1e-3 (tokens). Planted in
the port's run, a feature ramp one epoch early reads 1.0 on a loss, 0.24 on
the segmenter and 3.2e-2 on the tokens; an epoch never advanced reads 1.8e-2
on a loss and 0.72 on the discriminator. The noise of the intensity recipe
comes from each framework's own generator (data/device_cache.py), so the
port steps on the JAX pipeline's batches.
"""

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

torch.set_num_threads(4)

EPOCHS, PRETRAIN, RAMP, BATCH, LR = 4, 1, 3, 2, 5e-4
LOSSES = ("loss", "seg_loss", "refine_loss", "gan_g_loss", "disc_loss")
UPDATE_REL = {"params": 5e-2, "rparams": 5e-2, "dparams": 0.3, "tokens": 1e-3}


def _rel_update(got, ref, init):
    """Relative Frobenius distance of two runs' updates over a tree."""
    keys = list(ref)
    diff = sum(float((got[k].float() - ref[k].float()).norm()) ** 2 for k in keys)
    step = sum(float((ref[k].float() - init[k].float()).norm()) ** 2 for k in keys)
    return (diff / step) ** 0.5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("campaign_steps"))
    img_dir, atlas_path, csv_path = make_synthetic_amos(root, n_ct=7, n_mri=2,
                                                        shape=(40, 40, 36), seed=5,
                                                        organ_r_frac=0.2)
    kw = dict(num_epochs=EPOCHS, pretrain_epoch=PRETRAIN, ramp_until=RAMP)
    jcfg = jtiny_step_config(compute_dtype=jnp.float32, **kw)
    cfg = tiny_step_config(compute_dtype=torch.float32, **kw)
    jstate = jcreate_train_state(jax.random.PRNGKey(0), jcfg)
    state = init = train_state_from_jax(jstate)
    ds = JAMOSDataset(img_dir, crop_size=(32, 32, 32), usage="train", atlas=np.load(atlas_path),
                      supervision_csv=csv_path, seed=0, cache=True)
    pipe = JDeviceDataPipeline(ds, compute_dtype=jnp.float32, seed=0)
    jstep = jmake_train_step(*jbuild_models(jcfg), jcfg)
    step = make_train_step(*build_models(cfg), cfg)
    schedules, metrics = [], []
    for epoch in range(EPOCHS):
        jlr, jwf = (jpoly_lr(LR, epoch, EPOCHS),
                    jfeature_ramp(epoch, PRETRAIN, RAMP, jcfg.weight_feature_max))
        lr, wf = (poly_lr(LR, torch.tensor(epoch), EPOCHS),
                  feature_ramp(torch.tensor(epoch), PRETRAIN, RAMP, cfg.weight_feature_max))
        schedules.append(((float(jlr), float(jwf)), (float(lr), float(wf))))
        jstate = jstate.replace(epoch=jnp.asarray(epoch, jnp.int32))
        state = state.replace(epoch=torch.tensor(epoch))
        for batch in pipe.batches(BATCH, epochs=1):
            jstate, jm = jstep(jstate, batch, jlr, jwf)
            state, m = step(state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                            lr, wf)
            metrics.append(({k: float(jm[k]) for k in LOSSES}, {k: float(m[k]) for k in LOSSES}))
    return {"schedules": schedules, "metrics": metrics, "init": init, "port": state,
            "jax": train_state_from_jax(jstate)}


def test_schedules_match_jax(runs):
    sched = runs["schedules"]
    np.testing.assert_allclose([j for j, _ in sched], [p for _, p in sched], rtol=1e-6)
    assert [wf for (_, wf), _ in sched][PRETRAIN - 1] == 0.0  # before pretrain_epoch
    assert all(wf > 0 for (_, wf), _ in sched[PRETRAIN:])


def test_every_step_loss_matches_jax(runs):
    assert len(runs["metrics"]) == EPOCHS * 3  # 6 train cases at B = 2
    for i, (ref, got) in enumerate(runs["metrics"]):
        for k in LOSSES:
            np.testing.assert_allclose(got[k], ref[k], rtol=5e-3, atol=1e-6,
                                       err_msg=f"step {i + 1} {k}")


@pytest.mark.parametrize("tree", list(UPDATE_REL))
def test_updates_over_the_epochs_match_jax(runs, tree):
    got, ref, init = (getattr(runs[r], tree) for r in ("port", "jax", "init"))
    assert _rel_update(got, ref, init) <= UPDATE_REL[tree]

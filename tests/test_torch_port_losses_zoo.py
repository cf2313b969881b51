"""The port's loss zoo (multimodal_pl_tpu_torch.losses: ``legacy``,
``aux_variants`` and the ``partial`` helpers) against the JAX package's
functions on the same seeded numpy inputs, in f32 on the CPU: the value and
its gradient with respect to the logits (``jax.value_and_grad`` against
autograd).

Values are held to rtol 1e-5 (f32 summation order over a few thousand
voxels); gradients to atol 1e-6 times the largest gradient magnitude and
rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.losses import aux_variants as jaux
from multimodal_pl_tpu.losses import compose as jcompose
from multimodal_pl_tpu.losses import legacy as jlegacy
from multimodal_pl_tpu.losses import partial as jpartial
from multimodal_pl_tpu_torch.losses import aux_variants, compose, legacy, partial

SP = (4, 6, 5)  # (D, H, W) of the MOTS volumes
TASKS = tuple(range(7))  # a task id from every row of MOTS_TASK_FG


def _check(jfn, tfn, logits, *rest, n_out=1):
    """value and d/d logits of jfn(logits, *rest) (JAX, numpy rest) and
    tfn(logits, *rest) (port); n_out > 1: a tuple of values, differentiated
    through their sum weighted 1, 2, ..."""

    def scalar(out):
        return out if n_out == 1 else sum((k + 1) * o for k, o in enumerate(out))

    jrest = [jnp.asarray(r) if isinstance(r, np.ndarray) else r for r in rest]

    def jvalue(x):
        out = jfn(x, *jrest)
        return scalar(out), out

    # one jitted program per case: eager JAX would compile every primitive
    (_, jout), jgrad = jax.jit(jax.value_and_grad(jvalue, has_aux=True))(jnp.asarray(logits))
    x = torch.from_numpy(logits.copy()).requires_grad_(True)
    out = tfn(x, *[torch.from_numpy(r.copy()) if isinstance(r, np.ndarray) else r
                   for r in rest])
    (grad,) = torch.autograd.grad(scalar(out), x)
    outs = out if n_out > 1 else (out,)
    jouts = jout if n_out > 1 else (jout,)
    for got, want in zip(outs, jouts, strict=True):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    g, jg = grad.numpy(), np.asarray(jgrad)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-6 * np.abs(jg).max())


def _mots_labels(rng, task_ids, shape=SP):
    """Per sample: background or one of its task's foreground classes, so
    that the marginal targets are in range."""
    out = []
    for tid in task_ids:
        classes = np.array((0,) + tuple(jlegacy.MOTS_TASK_FG[tid]))
        out.append(classes[rng.integers(0, len(classes), shape)])
    return np.stack(out).astype(np.int32)


@pytest.fixture
def mots():
    rng = np.random.default_rng(31)
    logits = (rng.standard_normal((len(TASKS), *SP, 12)) * 2).astype(np.float32)
    return rng, logits, _mots_labels(rng, TASKS)


def test_task_tables_are_the_jax_tables():
    assert legacy.MOTS_TASK_FG == jlegacy.MOTS_TASK_FG
    assert legacy.MOTS_TASK_FG6 == jlegacy.MOTS_TASK_FG6
    assert legacy.MOTS_TASK_FG5 == jlegacy.MOTS_TASK_FG5


@pytest.mark.parametrize("name", ["tal_loss", "marg_exc_loss"])
def test_marginal_losses(mots, name):
    """TAL and MargExcLoss over a sample of every MOTS_TASK_FG task."""
    _, logits, labels = mots
    _check(getattr(jlegacy, name), getattr(legacy, name), logits, labels, TASKS,
           n_out=4 if name == "marg_exc_loss" else 1)


@pytest.mark.parametrize("name,nc,table", [("tal6_loss", 6, "MOTS_TASK_FG6"),
                                           ("tal5_loss", 5, "MOTS_TASK_FG5"),
                                           ("bce_no_bg5", 5, "MOTS_TASK_FG5")])
def test_single_fg_heads(name, nc, table):
    """TAL6, TAL5 and BCELossNoBG5 over a sample of every task of their
    table."""
    rng = np.random.default_rng(nc)
    tasks = tuple(getattr(jlegacy, table))
    logits = rng.standard_normal((len(tasks), *SP, nc)).astype(np.float32)
    labels = rng.integers(0, nc, (len(tasks), *SP)).astype(np.int32)
    _check(getattr(jlegacy, name), getattr(legacy, name), logits, labels, tasks)


def test_tal_weights_and_weighted_loss(mots):
    """tal_update_weights over a sequence of updates (class 0 and others,
    one class twice; the rest keep weight 1), then TAL with those weights,
    normalized and not."""
    _, logits, labels = mots
    state = (np.zeros(12, np.float32), np.zeros(12, np.float32))
    jstate = tuple(jnp.asarray(s) for s in state)
    tstate = tuple(torch.from_numpy(s) for s in state)
    for dim, val in ((0, 30000.0), (3, 1200.0), (3, 900.0), (9, 77.0), (11, 5.0)):
        *jstate, jw = jlegacy.tal_update_weights(*jstate, val, dim)
        *tstate, tw = legacy.tal_update_weights(*tstate, val, dim)
        for got, want in zip((*tstate, tw), (*jstate, jw), strict=True):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert tw[1] == 1.0 and tw[3] != 1.0
    for norm in (True, False):
        _check(lambda x, *a: jlegacy.tal_loss_weighted(x, *a, norm=norm),
               lambda x, *a: legacy.tal_loss_weighted(x, *a, norm=norm),
               logits, labels, TASKS, np.asarray(jw))


def test_mots_dice_and_ce_with_an_ignored_sample():
    """binary_dice (reduced and per sample), DiceLoss4MOTS and CELoss4MOTS
    with sample 1's target -1 (ignored)."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, *SP, 2)).astype(np.float32)
    target = rng.integers(0, 2, (3, *SP, 2)).astype(np.float32)
    target[1] = -1
    for reduce_ignore in (True, False):
        _check(lambda x, t: jlegacy.binary_dice(jax.nn.sigmoid(x[..., 0]), t[..., 0],
                                                reduce_ignore=reduce_ignore).sum(),
               lambda x, t: legacy.binary_dice(torch.sigmoid(x[..., 0]), t[..., 0],
                                               reduce_ignore=reduce_ignore).sum(),
               logits, target)
    for name in ("dice_loss_4mots", "ce_loss_4mots"):
        _check(getattr(jlegacy, name), getattr(legacy, name), logits, target)
    got = legacy.binary_dice(torch.sigmoid(torch.from_numpy(logits[..., 0])),
                             torch.from_numpy(target[..., 0]), reduce_ignore=False)
    assert got.shape == (3,)


@pytest.mark.parametrize("name", ["bce_onehot", "dice_softmax_fg", "dice_sigmoid_shifted"])
def test_class_channel_losses(mots, name):
    rng, logits, _ = mots
    labels = rng.integers(0, 12, logits.shape[:-1]).astype(np.int32)
    nc = 11 if name != "dice_softmax_fg" else 12
    x = logits[..., :nc]
    _check(lambda a, b: getattr(jlegacy, name)(a, b, nc),
           lambda a, b: getattr(legacy, name)(a, b, nc), np.ascontiguousarray(x), labels)


def test_partial_helpers():
    """bce_probs, bce_logits, softmax_cross_entropy, edice_full (with and
    without CE) and edice_full2 (masked and not, sigmoid and not, per-axis
    reduction)."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, *SP, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (2, *SP)).astype(np.int32)
    target = rng.integers(0, 2, (2, *SP, 5)).astype(np.float32)
    mask = rng.integers(0, 2, (2, *SP, 5)).astype(np.float32)
    _check(lambda x, t: jpartial.bce_probs(jax.nn.sigmoid(x), t),
           lambda x, t: partial.bce_probs(torch.sigmoid(x), t), logits, target)
    _check(jpartial.bce_logits, partial.bce_logits, logits, target)
    _check(jpartial.softmax_cross_entropy, partial.softmax_cross_entropy, logits, labels)
    for uce in (True, False):
        _check(lambda x, y: jpartial.edice_full(x, y, uce=uce),
               lambda x, y: partial.edice_full(x, y, uce=uce), logits, labels)
    for m, uce, sigmoid, axes in ((None, True, True, None), (mask, True, True, (1, 2, 3)),
                                  (mask, False, False, None)):
        _check(lambda x, t, *mm: jpartial.edice_full2(x, t, *mm, uce=uce, sigmoid=sigmoid,
                                                      axes=axes).sum(),
               lambda x, t, *mm: partial.edice_full2(x, t, *mm, uce=uce, sigmoid=sigmoid,
                                                     axes=axes).sum(),
               logits, target, *(() if m is None else (m,)))


def test_nearest_labels_is_jax():
    labels = np.random.default_rng(2).integers(0, 14, (2, 8, 12, 10)).astype(np.int32)
    for spatial in ((4, 6, 5), (2, 3, 3), (8, 12, 10)):
        got = compose._nearest_labels(torch.from_numpy(labels), spatial).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcompose._nearest_labels(
            jnp.asarray(labels), spatial)))


# FEAM-shaped outputs of a small tile: 14 classes, 3 deep maps, 3 attention maps
FD = (8, 8, 8)


@pytest.fixture(scope="module")
def feam_outputs():
    rng = np.random.default_rng(41)
    nc = 14
    out = {
        "logits": (rng.standard_normal((2, *FD, nc)) * 2).astype(np.float32),
        "labels": rng.integers(0, nc, (2, *FD)).astype(np.int32),
        "sup_mask": np.array([0] + [1, 0, 1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1], np.float32),
        "deep": [rng.standard_normal((2, *(s // k for s in FD), nc)).astype(np.float32)
                 for k in (8, 4, 2)],
        "attns_small": [rng.standard_normal((2, *(s // k for s in FD), nc - 1)).astype(np.float32)
                        for k in (8, 4, 2)],
        "attns_full": [rng.standard_normal((2, *FD, nc - 1)).astype(np.float32)
                       for _ in range(3)],
        "refiner": (rng.standard_normal((nc - 1, *FD, 2)) * 3).astype(np.float32),
        "label_t": np.array([1, 0, 0, 1, 0, 1, 0, 0, 1, 0, 1, 0, 0], np.float32),
    }
    # ties in the argmax: equal head logits on some voxels
    out["refiner"][:, :2, :, :, 1] = out["refiner"][:, :2, :, :, 0]
    return out


@pytest.mark.parametrize("name,attns,extra", [
    ("segmentation_loss_mse", "attns_small", "refiner"),
    ("segmentation_loss2", "attns_full", "refiner"),
    ("segmentation_loss_multiref", "attns_small", "refiner"),
    ("segmentation_loss_multiref", "attns_full", "refiner"),
    ("segmentation_loss_semi", "attns_small", "refiner"),
    ("segmentation_loss_mse", "attns_small", None),
    ("segmentation_loss2", "attns_full", None),
    ("segmentation_loss_multiref", "attns_small", None),
    ("segmentation_loss_semi", "attns_small", None),
])
def test_aux_variants(feam_outputs, name, attns, extra):
    """Each aux_variants loss on FEAM-shaped outputs, with the refiner's (or
    the teacher's) logits given (argmax ties included) and None, deep maps
    at 1/8, 1/4, 1/2 and attention maps at those scales or full size."""
    o = feam_outputs
    kw = "teacher_logits" if name.endswith("semi") else "refiner_logits"
    given = {kw: o["refiner"], "label_t": o["label_t"]} if extra else {}

    def run(mod, conv):
        def f(x, labels, sup_mask):
            return getattr(mod, name)(x, labels, sup_mask, [conv(d) for d in o["deep"]],
                                      [conv(a) for a in o[attns]],
                                      **{k: conv(v) for k, v in given.items()})
        return f

    _check(run(jaux, jnp.asarray), run(aux_variants, torch.from_numpy), o["logits"],
           o["labels"], o["sup_mask"])

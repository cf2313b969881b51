"""The training slice's modules against the JAX package, f32 on the CPU:
the residual blocks under autograd (the route that trains), the refiner, both
discriminators, the token EMA, the losses, the refiner metric, the converted
train state and the copied utilities.

Tolerances: model outputs rtol 2e-3 / atol 2e-4 (tests/test_torch_parity.py);
parameter gradients of the blocks by relative Frobenius norm <= 1e-4 (f32
summation order through a few layers, measured ~4e-6); losses and metrics
1e-5, class sums atol 1e-5 (f32 sums of ~100 N(0, 1) values).

The refiner's gradients (JAX on its training route: the Pallas GN -> ReLU
in interpret mode, one-pass moments as in the port) are held to relative
Frobenius norms of 2.5e-3 over the whole tree and 1e-2 per leaf; measured
2.0e-3 and 7.9e-3 (x1_resb.0.gn1.bias). The gap is one ReLU mask flip: at
x1_resb.0.gn1 (16^3 x 8) one element's GroupNorm output is 1.4e-7 from 0 in
float64, below the f32 resolution there. Against a float64 run of the port
(two-pass), JAX's gradients are off by <= 4e-6 on every leaf, and so are the
port's when its forward GN -> ReLU is two-pass at every site. With the
one-pass forward at a single site and two-pass elsewhere, 5 of the 27 sites
each push that element across 0 and give the 7.9e-3 on their own; each of
the other 22 gives <= 3e-6.
"""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.infer.metrics import refiner_organ_scores as jrefiner_organ_scores
from multimodal_pl_tpu.losses import compose as jcompose
from multimodal_pl_tpu.losses import gan as jgan
from multimodal_pl_tpu.losses import partial as jpartial
from multimodal_pl_tpu.models import DeepStyleDiscriminator as JDeepStyle
from multimodal_pl_tpu.models import NormStyleDiscriminator as JNormStyle
from multimodal_pl_tpu.models import RefinerUNet3D as JRefiner
from multimodal_pl_tpu.models import tokens as jtokens
from multimodal_pl_tpu.models.blocks import ResStage as JResStage
from multimodal_pl_tpu.ops.norm import set_fused_gn_relu
from multimodal_pl_tpu.train.torch_import import refiner_state_dict_to_params
from multimodal_pl_tpu.utils import logging as jlogging
from multimodal_pl_tpu.utils import prng as jprng
from multimodal_pl_tpu.utils import schedule as jschedule
from multimodal_pl_tpu_torch.convert import state_dict_from_jax
from multimodal_pl_tpu_torch.infer.metrics import refiner_organ_scores
from multimodal_pl_tpu_torch.losses import compose, gan, partial
from multimodal_pl_tpu_torch.models import tokens
from multimodal_pl_tpu_torch.models.blocks import ResStage
from multimodal_pl_tpu_torch.models.discriminator import (
    DeepStyleDiscriminator,
    NormStyleDiscriminator,
)
from multimodal_pl_tpu_torch.models.refiner import RefinerUNet3D
from multimodal_pl_tpu_torch.ops import conv3x3
from multimodal_pl_tpu_torch.utils import logging as plogging
from multimodal_pl_tpu_torch.utils import prng, schedule

torch.set_num_threads(2)

TOL = dict(rtol=2e-3, atol=2e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30)


def _grads_match(module, jgrads, what, leaf=1e-4, tree=1e-4):
    sd = state_dict_from_jax(jgrads)
    assert sorted(sd) == sorted(k for k, _ in module.named_parameters())
    for k, p in module.named_parameters():
        assert p.grad is not None, f"{what}: no gradient reached {k}"
        assert _rel(p.grad.numpy(), sd[k].numpy()) <= leaf, f"{what}: {k}"
    flat = [np.concatenate([g.ravel() for g in gs]) for gs in zip(
        *((p.grad.numpy(), sd[k].numpy()) for k, p in module.named_parameters()))]
    assert _rel(*flat) <= tree, what


@pytest.mark.parametrize("cin,cout,stride,blocks", [
    (32, 32, 1, 1),    # identity residual
    (48, 24, 1, 1),    # stride-1 projection at the refiner's widths
    (32, 64, 2, 2),    # stride-2 projection, then an identity block
])
def test_res_stage_trains_like_jax(rng, cin, cout, stride, blocks):
    """Under autograd the port's blocks take the training route
    (group_norm_relu -> conv3x3_train) and carry gradients into every
    parameter and the input, as the JAX voxel blocks do."""
    x = rng.standard_normal((2, 4, 6, 8, cin)).astype(np.float32)
    r = rng.standard_normal((2, 4 // stride, 6 // stride, 8 // stride, cout)).astype(np.float32)
    jst = JResStage(cout, blocks, stride=stride, group=8 if cout % 16 else 16)
    params = jst.init(jax.random.PRNGKey(3), jnp.asarray(x))
    (want, (jg, jgx)) = jax.jit(jax.value_and_grad(
        lambda p, x: jnp.sum(jst.apply(p, x) * r), argnums=(0, 1)))(params, jnp.asarray(x))
    st = ResStage(cin, cout, blocks, stride, group=8 if cout % 16 else 16)
    st.load_state_dict(state_dict_from_jax(params), strict=True)
    xt = _t(x).requires_grad_()
    got = (st(xt) * _t(r)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    assert _rel(xt.grad.numpy(), jgx) <= 1e-4
    _grads_match(st, jg, "ResStage")


@pytest.fixture(scope="module")
def refiner_pair():
    f = 8
    jref = JRefiner(num_classes=2, weight_std=True, init_filter=f, in_channel=2, s2d=False)
    params = jax.jit(jref.init)(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 32, 2)))
    ref = RefinerUNet3D(init_filter=f)
    ref.load_state_dict(state_dict_from_jax(params), strict=True)
    return jref, params, ref


def test_refiner_state_dict_is_the_inverse_of_torch_import(refiner_pair):
    _, params, _ = refiner_pair
    back = refiner_state_dict_to_params(
        {k: v.numpy() for k, v in state_dict_from_jax(params).items()})
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(back_flat)
    for path, v in flat:
        np.testing.assert_array_equal(back_flat[path], np.asarray(v))


def test_refiner_matches_jax(refiner_pair, rng):
    """Planes in, both routes: no grad (the fused conv3x3_gn route of the
    train step's complement pass) and under autograd (the training route)."""
    jref, params, ref = refiner_pair
    probs = rng.random((2, 32, 32, 32)).astype(np.float32)
    atlas = rng.random((2, 32, 32, 32)).astype(np.float32)
    r = rng.standard_normal((2, 32, 32, 32, 2)).astype(np.float32)
    planes = (jnp.asarray(probs), jnp.asarray(atlas))
    want = np.asarray(jax.jit(jref.apply)(params, planes))
    assert want.shape == (2, 32, 32, 32, 2)
    with torch.no_grad():
        got = ref((_t(probs), _t(atlas)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    set_fused_gn_relu(True)  # the training route: JAX's Pallas GN -> ReLU, interpreted
    try:
        jg = jax.jit(jax.grad(lambda p: jnp.sum(jref.apply(p, planes) * r)))(params)
    finally:
        set_fused_gn_relu(False)
    out = ref(torch.stack([_t(probs), _t(atlas)], -1))
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    (out * _t(r)).sum().backward()
    _grads_match(ref, jg, "refiner", leaf=1e-2, tree=2.5e-3)


def test_norm_style_discriminator_matches_jax(rng):
    jd = JNormStyle(ndf=16, depth=5)
    planes = [rng.random((3, 32, 32, 32)).astype(np.float32) for _ in range(2)]
    params = jd.init(jax.random.PRNGKey(4), [jnp.asarray(p) for p in planes])
    want = np.asarray(jax.jit(jd.apply)(params, [jnp.asarray(p) for p in planes]))
    d = NormStyleDiscriminator(ndf=16, depth=5)
    d.load_state_dict(state_dict_from_jax(params), strict=True)
    assert [n for n, _ in d.named_children()][:5] == [
        "block1", "block2", "block3", "block4a", "block4b"]
    with torch.no_grad():
        got = d([_t(p) for p in planes])
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_deep_style_discriminator_matches_jax(rng):
    jd = JDeepStyle(ndf=8)
    x = rng.random((1, 64, 64, 64, 2)).astype(np.float32)
    amaps = [rng.standard_normal((1, s, s, s, 1)).astype(np.float32) for s in (8, 16, 32)]
    params = jd.init(jax.random.PRNGKey(5), jnp.asarray(x), [jnp.asarray(a) for a in amaps])
    want = np.asarray(jax.jit(jd.apply)(params, jnp.asarray(x), [jnp.asarray(a) for a in amaps]))
    d = DeepStyleDiscriminator(ndf=8)
    d.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = d(_t(x), [_t(a) for a in amaps])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_token_functions_match_jax(rng):
    feats = [rng.standard_normal((1, s, 2 * s, 2 * s, c)).astype(np.float32)
             for s, c in ((2, 64), (4, 32), (8, 16))]
    toks = {k: rng.standard_normal((13, c)).astype(np.float32)
            for k, c in (("t1", 64), ("t2", 32), ("t3", 16))}
    cmask = rng.integers(0, 14, (1, 16, 32, 32)).astype(np.int32)
    pred = np.where(rng.random(cmask.shape) < 0.5, cmask, 0).astype(np.int32)
    sup = np.zeros(14, np.float32)
    sup[[2, 5, 9]] = 1
    jf = jtokens.agreement_mask(jnp.asarray(cmask), jnp.asarray(pred), jnp.asarray(sup))
    f = tokens.agreement_mask(_t(cmask), _t(pred), _t(sup))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert set(np.unique(f.numpy())) <= {0, 2, 5, 9}

    m = cmask[:, :8, :16, :16]
    js, jc = jtokens.masked_class_sums(jnp.asarray(feats[2]), jnp.asarray(m), 13)
    s, c = tokens.masked_class_sums(_t(feats[2]), _t(m), 13)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **SUM_TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))

    want = jtokens.renew_tokens({k: jnp.asarray(v) for k, v in toks.items()},
                                [jnp.asarray(v) for v in feats], jf, 0.01)
    got = tokens.renew_tokens({k: _t(v) for k, v in toks.items()}, [_t(v) for v in feats], f, 0.01)
    for k in toks:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **LOSS_TOL)
        assert not np.array_equal(got[k].numpy(), toks[k])


@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(1)
    shape = (1, 6, 8, 8)
    labels = rng.integers(0, 14, shape).astype(np.int32)
    sup = np.zeros(14, np.float32)
    sup[[3, 7]] = 1
    return dict(
        logits=(rng.standard_normal((*shape, 14)) * 2).astype(np.float32),
        labels=labels, cmask=np.where(sup[labels] > 0, labels, 0).astype(np.int32), sup=sup,
        deep=[rng.standard_normal((1, 3, 4, 4, 14)).astype(np.float32)],
        attns=[rng.standard_normal((*shape, 13)).astype(np.float32) for _ in range(3)],
        rlogits=(rng.standard_normal((13, *shape[1:], 2)) * 3).astype(np.float32),
        d_out=rng.standard_normal((13, 2)).astype(np.float32),
        label_t=(rng.random(13) < 0.5).astype(np.float32))


def test_segmentation_and_refine_losses_match_jax(loss_inputs):
    i = loss_inputs
    J = {k: jnp.asarray(v) if not isinstance(v, list) else [jnp.asarray(a) for a in v]
         for k, v in i.items()}
    T = {k: _t(v) if not isinstance(v, list) else [_t(a) for a in v] for k, v in i.items()}
    for with_aux in (False, True):  # deep outputs and the consistency term, or neither
        want, got = (
            mod.segmentation_loss(
                A["logits"], A["cmask"], A["sup"], A["deep"] if with_aux else (), A["attns"],
                refiner_logits=A["rlogits"] if with_aux else None, label_d=A["sup"][1:],
                weight_feature=0.07)
            for mod, A in ((jcompose, J), (compose, T)))
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    ids = np.array([3, 7, 1])
    want = jcompose.refine_loss(J["rlogits"][:3], J["labels"], jnp.asarray([1.0, 1.0, 0.0]),
                                aug_mask=2, organ_ids=jnp.asarray(ids))
    got = compose.refine_loss(T["rlogits"][:3], T["labels"], torch.tensor([1.0, 1.0, 0.0]),
                              aug_mask=2, organ_ids=_t(ids))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    np.testing.assert_allclose(float(compose.refine_loss(T["rlogits"], T["labels"], T["label_t"])),
                               float(jcompose.refine_loss(J["rlogits"], J["labels"], J["label_t"])),
                               **LOSS_TOL)
    for e in (0, 19, 20, 35, 50, 80):
        np.testing.assert_allclose(float(compose.feature_ramp(e)),
                                   float(jcompose.feature_ramp(e)), **LOSS_TOL)


def test_partial_and_gan_losses_match_jax(loss_inputs):
    i = loss_inputs
    lg, lb = i["logits"], i["labels"]
    pairs = [
        (partial.edice_partial(_t(lg), _t(lb), _t(i["sup"])),
         jpartial.edice_partial(jnp.asarray(lg), jnp.asarray(lb), jnp.asarray(i["sup"]))),
        (gan.smooth_cross_entropy(_t(i["d_out"]), _t(i["label_t"]).long(), smoothing=0.1),
         jgan.smooth_cross_entropy(jnp.asarray(i["d_out"]), jnp.asarray(i["label_t"], jnp.int32),
                                   smoothing=0.1)),
        (gan.bce_loss(_t(i["d_out"]), 1), jgan.bce_loss(jnp.asarray(i["d_out"]), 1)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_refiner_organ_scores_match_jax(loss_inputs):
    i = loss_inputs
    want = jrefiner_organ_scores(jnp.asarray(i["rlogits"]), jnp.asarray(i["labels"]), 13)
    got = refiner_organ_scores(_t(i["rlogits"]), _t(i["labels"]), 13)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOSS_TOL)


def test_utils_copies_match_originals(tmp_path):
    for args in ((5e-4, 3, 100, 0.9), (1e-2, 0, 7, 1.0)):
        assert schedule.lr_poly(*args) == jschedule.lr_poly(*args)
    assert schedule.adjust_learning_rate(7, 5e-4, 500) == jschedule.adjust_learning_rate(7, 5e-4, 500)

    jprng.seedfix(11)
    want = (random.random(), np.random.rand())
    gen = prng.seedfix(11)
    assert (random.random(), np.random.rand()) == want
    assert torch.equal(torch.rand(3, generator=gen), torch.rand(3, generator=prng.seedfix(11)))

    recs = []
    for mod in (jlogging, plogging):
        logger = mod.MetricsLogger(str(tmp_path / mod.__name__.split(".")[0]))
        logger.log(3, {"loss": torch.tensor(0.5), "name": "x"}, prefix="train/")
        logger.close()
        with open(logger.path) as f:
            rec = json.loads(f.read())
        rec.pop("time")
        recs.append(rec)
    assert recs[0] == recs[1] == {"step": 3, "train/loss": 0.5, "train/name": "x"}


def test_synthetic_copy_matches_original(tmp_path):
    """Every file the port's copy writes equals the JAX package's, byte for
    byte (the volumes after gunzip: gzip stamps the write time)."""
    import gzip
    import os

    from multimodal_pl_tpu.data.synthetic import make_synthetic_amos as jmake
    from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

    kw = dict(n_ct=3, n_mri=1, shape=(20, 24, 16), seed=4)
    want = jmake(str(tmp_path / "jax"), **kw)
    got = make_synthetic_amos(str(tmp_path / "port"), **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    files = []
    for root, _, names in os.walk(tmp_path / "jax"):
        files += [os.path.relpath(os.path.join(root, n), tmp_path / "jax") for n in names]
    assert len(files) == 2 * 4 + 2
    for rel in files:
        a, b = (tmp_path / side / rel for side in ("jax", "port"))
        opener = gzip.open if rel.endswith(".gz") else open
        with opener(a, "rb") as fa, opener(b, "rb") as fb:
            assert fa.read() == fb.read(), rel


def test_blocks_route_by_grad_mode(rng):
    """No grad: the fused conv3x3_gn route of the inference path; under
    autograd: the training route. Both compute the same block."""
    x = _t(rng.standard_normal((1, 4, 6, 8, 32)).astype(np.float32))
    st = ResStage(32, 32, 1)
    with torch.no_grad():
        fused = st(x)
    train = st(x.clone().requires_grad_())
    assert train.grad_fn is not None
    np.testing.assert_allclose(train.detach().numpy(), fused.numpy(), rtol=1e-4, atol=1e-4)
    assert not conv3x3.launches  # CPU tensors never launch the kernel

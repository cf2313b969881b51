"""The port's ablation U-Nets, EAM variants and discriminator variants
(multimodal_pl_tpu_torch.models) against the JAX package's modules, on the
same seeded numpy inputs and the same parameters: each JAX module is
initialised once, its params carried across by ``convert.state_dict_from_jax``
and loaded with ``strict=True``.

f32 on the CPU, at the tiny size of tests/test_models.py (16 x 32 x 32, base
32), at B = 2 (DynHead with task ids (0, 3); the B = 2 shapes are compiled
once for all five models). Every output (logits, deep maps,
class tokens, attention maps) is held to rtol 2e-3 / atol 2e-4, the
tolerance of tests/test_torch_port_models.py. In bf16 the EAM variants are
held to 3 bf16 ulps (3 * 2^-8) of the largest magnitude of each output:
both frameworks round the projections, the scaled queries and the attention
output to bf16, in orders that may differ by one rounding each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_pl_tpu.models as jmodels
import multimodal_pl_tpu_torch.models as models
from multimodal_pl_tpu_torch.convert import state_dict_from_jax

torch.set_num_threads(2)

NC = 14
D, H, W = 16, 32, 32
TOL = dict(rtol=2e-3, atol=2e-4)
BF16_ULPS = 3 * 2.0 ** -8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _load(model, params):
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


B = 2
# name -> (JAX module, port module)
ABLATIONS = {
    "baseline": (lambda: jmodels.UNet3DBaseline(num_classes=NC),
                 lambda: models.UNet3DBaseline(num_classes=NC)),
    "deepsup": (lambda: jmodels.UNet3DDeepSup(num_classes=NC),
                lambda: models.UNet3DDeepSup(num_classes=NC)),
    "eam3": (lambda: jmodels.UNet3DEAM(num_classes=NC, num_eams=3),
             lambda: models.UNet3DEAM(num_classes=NC, num_eams=3)),
    "eam2": (lambda: jmodels.UNet3DEAM(num_classes=NC, num_eams=2),
             lambda: models.UNet3DEAM(num_classes=NC, num_eams=2)),
    "dynhead": (lambda: jmodels.UNet3DDynHead(num_tasks=7),
                lambda: models.UNet3DDynHead(num_tasks=7)),
}
TASK_IDS = np.array([0, 3], np.int32)


@pytest.fixture(scope="module")
def jax_runs():
    """name -> (params, numpy input, JAX outputs), each model initialised
    and applied once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            x = np.random.default_rng(len(cache) + 11).standard_normal(
                (B, D, H, W, 1)).astype(np.float32)
            args = (jnp.asarray(x),) + ((jnp.asarray(TASK_IDS),) if name == "dynhead" else ())
            jm = ABLATIONS[name][0]()
            params = jm.init(jax.random.PRNGKey(0), *args)
            cache[name] = (params, x, jax.tree_util.tree_map(np.asarray, jm.apply(params, *args)))
        return cache[name]

    return get


def _flat(out):
    """logits, then every further output in order."""
    if not isinstance(out, (tuple, list)):
        return [out]
    return [t for o in out for t in _flat(o)]


@pytest.mark.parametrize("name", list(ABLATIONS))
def test_ablation_matches_jax(jax_runs, name):
    """Every output of each ablation equals the JAX module's: the logits;
    DeepSup's three deep maps; the EAM cascade's tokens and its 3 or 2
    attention maps; DynHead's 2-channel logits."""
    params, x, want = jax_runs(name)
    model = _load(ABLATIONS[name][1](), params)
    args = (_t(x),) + ((_t(TASK_IDS),) if name == "dynhead" else ())
    with torch.no_grad():
        got = model(*args)
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want) == {"baseline": 1, "deepsup": 4, "eam3": 5, "eam2": 4,
                                     "dynhead": 1}[name]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    if name.startswith("eam"):
        assert tuple(got[1].shape) == (B, NC, 32 if name == "eam3" else 64)


def test_exact_trunk_equals_feam_bit_for_bit():
    """With one weight set, UNet3DBaseline, UNet3DDeepSup(aux=False) and
    UNet3DEAM(aux=False) give the bits of UNet3DFEAM(aux=False): the same
    trunk and classifier, and nothing else of theirs feeds the logits.
    UNet3DDeepSup's deep maps are the FEAM's deep_maps."""
    feam = models.UNet3DFEAM(num_classes=NC, generator=torch.Generator().manual_seed(3)).eval()
    sd = feam.state_dict()
    x = _t(np.random.default_rng(5).standard_normal((B, D, H, W, 1)).astype(np.float32))
    tokens = models.init_class_tokens(torch.Generator().manual_seed(4), NC)
    trunk = set(models.UNet3DBaseline(num_classes=NC).state_dict())  # with precls_conv
    assert trunk <= set(sd)
    with torch.no_grad():
        want = feam(x, aux=False)
        _, _, want_deep, _, _ = feam(x, tokens)
        for net in (models.UNet3DBaseline(num_classes=NC), models.UNet3DDeepSup(num_classes=NC),
                    models.UNet3DEAM(num_classes=NC, num_eams=3),
                    models.UNet3DEAM(num_classes=NC, num_eams=2)):
            own = net.state_dict()
            assert trunk <= set(own)
            net.load_state_dict({k: sd.get(k, v) for k, v in own.items()}, strict=True)
            got = net(x) if isinstance(net, models.UNet3DBaseline) else net(x, aux=False)
            assert torch.equal(got, want), type(net).__name__
            if isinstance(net, models.UNet3DDeepSup):
                logits, deep = net(x)
                assert torch.equal(logits, want)
                assert all(torch.equal(a, b) for a, b in zip(deep, want_deep, strict=True))


@pytest.mark.parametrize("cls", ["EAMBK", "EAMIdentity"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eam_variants_match_jax(cls, dtype):
    """The updated tokens and the scores (scaled before the product, and
    returned scaled) of EAMBK and EAMIdentity against JAX, with a singleton
    token batch broadcast over the voxel batch: f32 at TOL, bf16 within
    BF16_ULPS of each output's largest magnitude."""
    dim, n = 64, 2 * 3 * 4
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    tok = rng.standard_normal((1, NC - 1, dim)).astype(np.float32)
    jm = getattr(jmodels, cls)(dim, num_heads=4)
    params = jm.init(jax.random.PRNGKey(6), jnp.asarray(x), jnp.asarray(tok))
    jdt = getattr(jnp, dtype)
    jout, jattn = jm.apply(params, jnp.asarray(x, jdt), jnp.asarray(tok, jdt))
    m = _load(getattr(models, cls)(dim, num_heads=4), params)
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        out, attn = m(_t(x).to(tdt), _t(tok).to(tdt))
    assert out.dtype == tdt and attn.dtype == torch.float32
    for got, want in ((out, jout), (attn, jattn)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert got.shape == want.shape
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **TOL)
        else:
            assert np.abs(got - want).max() <= BF16_ULPS * np.abs(want).max()


@pytest.mark.parametrize("cls,shape", [("StyleDiscriminatorOutput", (2, 64, 64, 64, 2)),
                                       ("StyleDiscriminatorLinear", (3, 5, 13))])
def test_discriminator_variants_match_jax(cls, shape):
    """StyleDiscriminatorOutput (ndf 32, six stride-2 convs, one logit) and
    StyleDiscriminatorLinear (ndf 64, three Linears) against JAX."""
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    jm = getattr(jmodels, cls)()
    params = jm.init(jax.random.PRNGKey(9), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    width = {"StyleDiscriminatorOutput": "in_channel", "StyleDiscriminatorLinear": "in_features"}
    m = _load(getattr(models, cls)(**{width[cls]: shape[-1]}), params)
    with torch.no_grad():
        got = m(_t(x)).numpy()
    assert got.shape == want.shape == (*shape[:-1 if cls.endswith("Linear") else 1], 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_port_exports_every_jax_model_name():
    """Every name multimodal_pl_tpu.models exports, the port's
    models package exports too."""
    jax_names = {n for n in dir(jmodels) if not n.startswith("_")
                 and getattr(getattr(jmodels, n), "__module__", "").startswith(
                     "multimodal_pl_tpu.models")}
    assert jax_names and not jax_names - set(models.__all__)
    assert all(hasattr(models, n) for n in models.__all__)

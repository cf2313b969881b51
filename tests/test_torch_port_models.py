"""Port models (multimodal_pl_tpu_torch.models) == the JAX package's voxel
models, on the same numpy inputs and the same (converted) parameters.

f32 on the CPU. Logits, attention maps and deep-supervision maps are held to
rtol 2e-3 / atol 2e-4, the tolerance of tests/test_torch_parity.py. The
decoder features are un-normalized activations with an RMS of tens at these
random weights; f32 summation-order noise grows with them, so their atol is
2e-4 times their RMS (rtol 2e-3 unchanged).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.models import UNet3DFEAM as JUNet3DFEAM
from multimodal_pl_tpu.models import init_class_tokens as jinit_class_tokens
from multimodal_pl_tpu.models.blocks import NoBottleneck as JNoBottleneck
from multimodal_pl_tpu.models.blocks import ResStage as JResStage
from multimodal_pl_tpu.models.eam import EAM as JEAM
from multimodal_pl_tpu.models.eam import attn_to_map as jattn_to_map
from multimodal_pl_tpu_torch.convert import load_feam_state_dict, state_dict_from_jax
from multimodal_pl_tpu_torch.models import TOKEN_DIMS, UNet3DFEAM, init_class_tokens
from multimodal_pl_tpu_torch.models.blocks import NoBottleneck, ResStage
from multimodal_pl_tpu_torch.models.eam import EAM, attn_to_map

torch.set_num_threads(2)

NC = 14
D, H, W = 16, 32, 32
TOL = dict(rtol=2e-3, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("cin,cout,stride,blocks", [
    (32, 32, 1, 1),    # identity residual, fused residual epilogue
    (64, 32, 1, 1),    # stride-1 projection (decoder block0)
    (32, 64, 2, 2),    # stride-2 projection, then an identity block
])
def test_res_stage(rng, cin, cout, stride, blocks):
    x = rng.standard_normal((2, 4, 6, 8, cin)).astype(np.float32)
    jst = JResStage(cout, blocks, stride=stride)
    params = jst.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = jst.apply(params, jnp.asarray(x))
    st = ResStage(cin, cout, blocks, stride)
    st.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = st(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("conv_impl", ["kernel", "plain"])
def test_nobottleneck_stride2(rng, conv_impl):
    x = rng.standard_normal((1, 6, 6, 6, 32)).astype(np.float32)
    jblk = JNoBottleneck(64, stride=2)
    params = jblk.init(jax.random.PRNGKey(4), jnp.asarray(x))
    want = jblk.apply(params, jnp.asarray(x))
    blk = NoBottleneck(32, 64, stride=2, conv_impl=conv_impl)
    blk.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = blk(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_bad_conv_impl_raises():
    with pytest.raises(ValueError):
        NoBottleneck(32, 32, conv_impl="cudnn")


def test_eam_and_attn_to_map(rng):
    dim, spatial = 64, (2, 3, 4)
    x = rng.standard_normal((2, int(np.prod(spatial)), dim)).astype(np.float32)
    tok = rng.standard_normal((1, NC - 1, dim)).astype(np.float32)
    jeam = JEAM(dim, num_heads=4)
    params = jeam.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(tok))
    jout, jattn = jeam.apply(params, jnp.asarray(x), jnp.asarray(tok))
    eam = EAM(dim, num_heads=4)
    eam.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        out, attn = eam(_t(x), _t(tok))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(jattn), **TOL)
    np.testing.assert_allclose(attn_to_map(attn, spatial).numpy(),
                               np.asarray(jattn_to_map(jattn, spatial)), **TOL)


def test_init_class_tokens_shapes():
    toks = init_class_tokens(torch.Generator().manual_seed(0), NC)
    assert {k: tuple(v.shape) for k, v in toks.items()} == {
        k: (NC - 1, d) for k, d in TOKEN_DIMS.items()}
    again = init_class_tokens(torch.Generator().manual_seed(0), NC)
    assert all(torch.equal(toks[k], again[k]) for k in toks)


def test_token_update_pre_not_ported():
    with pytest.raises(NotImplementedError):
        UNet3DFEAM(token_update="pre")


@pytest.fixture(scope="module")
def jax_params():
    tokens = jinit_class_tokens(jax.random.PRNGKey(1), NC)
    model = JUNet3DFEAM(num_classes=NC, weight_std=True, s2d=False, bd=False)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, D, H, W, 1)), tokens)
    return params, tokens


@pytest.mark.parametrize("deep_up", [True, False])
def test_unet3d_feam_matches_jax(jax_params, deep_up):
    params, jtokens = jax_params
    x = np.random.default_rng(7).standard_normal((1, D, H, W, 1)).astype(np.float32)
    jmodel = JUNet3DFEAM(num_classes=NC, weight_std=True, deep_up=deep_up, s2d=False, bd=False)
    jlogits, jattn, jdeep, jfeat, _ = jmodel.apply(params, jnp.asarray(x), jtokens)

    model = UNet3DFEAM(num_classes=NC, deep_up=deep_up)
    tokens = load_feam_state_dict(model, state_dict_from_jax(params, jtokens))
    with torch.no_grad():
        logits, attn, deep, feat, tokens_out = model(_t(x), tokens)
        logits_only = model(_t(x), aux=False)

    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert len(attn) == len(jattn) == 3 and len(deep) == len(jdeep) == 3
    for got, want in zip(attn, jattn):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if deep_up:
        assert all(tuple(a.shape[1:4]) == (D, H, W) for a in attn)
    for got, want in zip(deep, jdeep):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for got, want in zip(feat, jfeat):
        want = np.asarray(want)
        rms = float(np.sqrt(np.mean(want ** 2)))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4 * rms)
    assert torch.equal(logits_only, logits)
    assert all(torch.equal(tokens_out[k], tokens[k]) for k in tokens)

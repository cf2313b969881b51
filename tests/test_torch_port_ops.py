"""Port ops (multimodal_pl_tpu_torch.ops) == the JAX package's ops.

Same numpy inputs through both; f32 on the CPU. Tolerance 1e-5 (rtol and
atol) for elementwise ops and reductions, 1e-4 for convolutions, whose
summation order differs between XLA and PyTorch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.ops import bd as jbd
from multimodal_pl_tpu.ops import conv as jconv
from multimodal_pl_tpu.ops import norm as jnorm
from multimodal_pl_tpu.ops import resize as jresize
from multimodal_pl_tpu_torch.ops import conv, norm, resize

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dhwio(w_torch_layout):
    return jnp.asarray(w_torch_layout.transpose(2, 3, 4, 1, 0))


@pytest.mark.parametrize("shape", [(8, 4, 3, 3, 3), (16, 32, 1, 1, 1)])
def test_standardize_kernel(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32) * 0.1 + 0.02
    got = conv.standardize_kernel(_t(w)).numpy()
    want = np.asarray(jconv.standardize_kernel(_dhwio(w))).transpose(4, 3, 0, 1, 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1), (1, 2)])
def test_conv3d(rng, k, stride):
    x = rng.standard_normal((2, 6, 8, 10, 16)).astype(np.float32)
    w = rng.standard_normal((24, 16, k, k, k)).astype(np.float32) * 0.1
    bias = rng.standard_normal(24).astype(np.float32)
    pad = k // 2
    got = conv.conv3d(_t(x), _t(w), stride, pad, _t(bias)).numpy()
    want = jconv.conv3d(jnp.asarray(x), _dhwio(w), stride, pad, jnp.asarray(bias))
    np.testing.assert_allclose(got, np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("groups", [16, 4])
def test_group_norm(rng, groups):
    x = rng.standard_normal((2, 3, 5, 4, 32)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    got = norm.group_norm(_t(x), _t(scale), _t(bias), groups).numpy()
    want = jnorm.group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    got_r = norm.group_norm_relu(_t(x), _t(scale), _t(bias), groups).numpy()
    np.testing.assert_allclose(got_r, np.maximum(np.asarray(want), 0), **TOL)


def test_group_norm_fold_matches_bd_fold(rng):
    x = rng.standard_normal((2, 3, 5, 4, 64)).astype(np.float32) * 2 - 0.5
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    a, b = norm.group_norm_fold(_t(x), _t(scale), _t(bias), 16)
    ja, jb = jbd.bd_gn_fold(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 16,
                            blocked=(False,) * 3)
    assert a.shape == b.shape == (2, 64) and a.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), **TOL)
    # the fold reproduces the normalization
    folded = x * a.numpy()[:, None, None, None] + b.numpy()[:, None, None, None]
    np.testing.assert_allclose(
        folded, norm.group_norm(_t(x), _t(scale), _t(bias), 16).numpy(), rtol=1e-5, atol=1e-4)


def test_group_norm_fold_two_pass_at_large_mean(rng):
    """mean 100, std 1: the plain fold equals bd_gn_fold to rel 1e-5 (f32
    summation order only), where one-pass E[x^2] - mean^2 in f32 loses the
    variance to cancellation (it misses by more than 1e-3)."""
    x = (rng.standard_normal((2, 6, 10, 8, 32)) + 100).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    a, b = norm.group_norm_fold(_t(x), _t(scale), _t(bias), 8)
    ja, jb = jbd.bd_gn_fold(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 8,
                            blocked=(False,) * 3)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=0)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5, atol=0)
    xg = _t(x).reshape(2, -1, 8, 4).transpose(1, 2).reshape(2, 8, -1)
    one_pass = xg.square().mean(-1) - xg.mean(-1).square()
    two_pass = (xg - xg.mean(-1, keepdim=True)).square().mean(-1)
    assert ((one_pass - two_pass).abs() / two_pass).max() > 1e-3


def test_group_norm_fold_kernel_impl_on_cpu(rng):
    """impl='kernel' on a CPU tensor is the plain fold (no launch); an
    unknown impl raises."""
    x = _t(rng.standard_normal((2, 3, 4, 5, 16)).astype(np.float32))
    ones, zeros = torch.ones(16), torch.zeros(16)
    norm.fold_launches.clear()
    got = norm.group_norm_fold(x, ones, zeros, 4, impl="kernel")
    want = norm.group_norm_fold(x, ones, zeros, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and not norm.fold_launches
    with pytest.raises(ValueError, match="impl"):
        norm.group_norm_fold(x, ones, zeros, 4, impl="fast")


def test_group_norm_bf16_stats_are_f32(rng):
    """bf16 input: statistics from the f32 two-pass moments of the bf16
    values, so the fold equals the f32 fold of the same (rounded) values."""
    x = (rng.standard_normal((1, 4, 4, 4, 32)) * 5 + 100).astype(np.float32)
    xb = _t(x).to(torch.bfloat16)
    ones, zeros = torch.ones(32), torch.zeros(32)
    a16, b16 = norm.group_norm_fold(xb, ones, zeros, 16)
    a32, b32 = norm.group_norm_fold(xb.float(), ones, zeros, 16)
    assert torch.equal(a16, a32) and torch.equal(b16, b32)


def test_layer_norm(rng):
    x = rng.standard_normal((2, 7, 32)).astype(np.float32) * 2 + 3
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    got = norm.layer_norm(_t(x), _t(scale), _t(bias)).numpy()
    want = jnorm.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_trilinear(rng, factor):
    x = rng.standard_normal((1, 2, 3, 4, 5)).astype(np.float32)
    got = resize.upsample_trilinear(_t(x), factor).numpy()
    want = jresize.upsample_trilinear(jnp.asarray(x), factor)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_resize_trilinear_to_shape(rng):
    x = rng.standard_normal((2, 3, 4, 5, 3)).astype(np.float32)
    got = resize.resize_trilinear(_t(x), (7, 9, 10)).numpy()
    want = jresize.resize_trilinear(jnp.asarray(x), (7, 9, 10))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        resize.resize_trilinear(_t(x), (2, 4, 5))


@pytest.mark.parametrize("out", [(5, 7, 3), (12, 4, 9)])
def test_resize_nearest(rng, out):
    x = rng.standard_normal((1, 6, 5, 4, 2)).astype(np.float32)
    got = resize.resize_nearest(_t(x), out).numpy()
    want = jresize.resize_nearest(jnp.asarray(x), out)
    np.testing.assert_array_equal(got, np.asarray(want))

"""The training ops of the port against the JAX package's Pallas kernels
they replace, f32 on the CPU.

- ``group_norm_relu`` (TPU kernel 5, ``fused_group_norm_relu``): forward vs
  the Pallas kernel in interpret mode at 1e-5, and vs JAX's two-pass
  ``_gn_relu_reference`` at mean 100 / std 1, where the Pallas kernel's
  one-pass variance cancels; gradients (the plain backward formula) vs JAX's
  custom VJP (``_gn_relu_pallas`` under ``set_fused_gn_relu(True)``) by
  relative Frobenius norm <= 5e-4 in f32 (tests/test_pallas.py:56-66:
  one-pass and two-pass variance round differently and flip the ReLU mask
  where the output is exactly at 0, so elementwise comparison is
  ill-posed), and in bf16.
- ``conv3x3_train`` (TPU kernel 3, ``k2_conv``): forward, dx and dw vs JAX
  ``s2d_conv3x3`` under ``set_k2_pallas(True)`` (the Pallas kernel runs
  interpreted where the channels fill its 128 lanes; Cin = 24 takes its XLA
  fallback) at 1e-4, and vs ``F.conv3d`` autograd at 1e-4.
On a CPU tensor both ops run their kernels' plain versions; the CUDA kernels
themselves are tested in tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_pl_tpu.ops import s2d as js2d
from multimodal_pl_tpu.ops.norm import _gn_relu_reference
from multimodal_pl_tpu.ops.norm import group_norm_relu as jgroup_norm_relu
from multimodal_pl_tpu.ops.norm import set_fused_gn_relu
from multimodal_pl_tpu.ops.pallas.fused_gn_relu import fused_group_norm_relu
from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu
from multimodal_pl_tpu_torch.ops.conv3x3 import conv3x3_train
from multimodal_pl_tpu_torch.ops.gn_relu import group_norm_relu, group_norm_relu_reference

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30)


def _gn_inputs(rng, shape):
    c = shape[-1]
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    return x, rng.standard_normal(c).astype(np.float32), rng.standard_normal(c).astype(np.float32)


@pytest.mark.parametrize("shape,groups", [((2, 4, 8, 8, 32), 16), ((1, 3, 5, 7, 24), 4),
                                          ((2, 2, 6, 6, 48), 6)])
def test_gn_relu_forward_matches_pallas(rng, shape, groups):
    x, scale, bias = _gn_inputs(rng, shape)
    want = fused_group_norm_relu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups,
                                 block_spatial=64, interpret=True)
    got = group_norm_relu(_t(x), _t(scale), _t(bias), groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, group_norm_relu_reference(_t(x), _t(scale), _t(bias), groups))


@pytest.mark.parametrize("shape,groups", [((2, 4, 8, 8, 32), 16), ((1, 4, 6, 6, 24), 4)])
def test_gn_relu_grads_match_jax_vjp(rng, shape, groups):
    x, scale, bias = _gn_inputs(rng, shape)
    r = rng.standard_normal(shape).astype(np.float32)

    def loss(x, s, b):
        return jnp.sum(jgroup_norm_relu(x, s, b, groups) * r)

    set_fused_gn_relu(True)
    try:
        want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, scale, bias)))
    finally:
        set_fused_gn_relu(False)
    ts = [_t(a).requires_grad_() for a in (x, scale, bias)]
    got = torch.autograd.grad((group_norm_relu(*ts, groups) * _t(r)).sum(), ts)
    for g, w, name in zip(got, want, ("dx", "dscale", "dbias")):
        assert _rel(g.numpy(), w) <= 5e-4, name


@pytest.mark.parametrize("shape,groups", [((2, 4, 8, 8, 32), 16), ((1, 4, 6, 6, 24), 4)])
def test_gn_relu_forward_two_pass_at_large_mean(rng, shape, groups):
    """mean 100, std 1: against JAX's two-pass f32 GroupNorm -> ReLU at atol
    2e-4 (the f32 mean of values near 100 is exact to ~1e-5, times inv and
    scale of order 1); the one-pass E[x^2] - mean^2 of the Pallas kernel
    cancels there and misses by more than ten times that."""
    _, scale, bias = _gn_inputs(rng, shape)
    x = (rng.standard_normal(shape) + 100.0).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = np.asarray(_gn_relu_reference(*args, groups, 1e-5))
    got = group_norm_relu(_t(x), _t(scale), _t(bias), groups).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    one_pass = np.asarray(fused_group_norm_relu(*args, groups, block_spatial=64, interpret=True))
    assert np.abs(one_pass - want).max() > 10 * 2e-4


@pytest.mark.parametrize("shape,groups", [((2, 4, 8, 8, 32), 16), ((1, 4, 6, 6, 24), 4)])
def test_gn_relu_bf16_grads_match_jax_vjp(rng, shape, groups):
    """bf16 x and incoming gradient (affine bf16-representable): the port's
    backward works in f32 and rounds dx to bf16, so it is within 4e-3
    (relative Frobenius; bf16 rounding of dx) of JAX's f32 gradient on the
    same inputs. JAX's own bf16 VJP rounds the affine's gradient sums to
    bf16 and sits 1-10% from that f32 gradient; the port is no farther from
    it than that gap plus 4e-3."""
    x, scale, bias = (np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                      for a in _gn_inputs(rng, shape))
    r = np.array(jnp.asarray(rng.standard_normal(shape)).astype(jnp.bfloat16)
                 .astype(jnp.float32))
    set_fused_gn_relu(True)
    try:
        want = {}
        for dtype in (jnp.float32, jnp.bfloat16):
            def loss(x, s, b):
                return jnp.sum((jgroup_norm_relu(x, s, b, groups) * r.astype(dtype))
                               .astype(jnp.float32))
            want[dtype] = jax.grad(loss, argnums=(0, 1, 2))(
                *(jnp.asarray(a).astype(dtype) for a in (x, scale, bias)))
    finally:
        set_fused_gn_relu(False)
    xt = _t(x).to(torch.bfloat16).requires_grad_()
    st, bt = _t(scale).requires_grad_(), _t(bias).requires_grad_()
    got = torch.autograd.grad(group_norm_relu(xt, st, bt, groups), (xt, st, bt),
                              _t(r).to(torch.bfloat16))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    for g, w32, w16, name in zip(got, want[jnp.float32], want[jnp.bfloat16],
                                 ("dx", "dscale", "dbias")):
        g, w32, w16 = (np.asarray(a, np.float32) for a in (g.float().numpy(), w32, w16))
        assert _rel(g, w32) <= 4e-3, name
        assert _rel(g, w16) <= _rel(w16, w32) + 4e-3, name


def test_gn_relu_plain_impl_and_bad_arguments(rng):
    x, scale, bias = _gn_inputs(rng, (1, 2, 3, 4, 16))
    gn_relu.reset_launches()
    a = group_norm_relu(_t(x), _t(scale), _t(bias), 4, impl="plain")
    b = group_norm_relu(_t(x), _t(scale), _t(bias), 4, impl="kernel")
    assert torch.equal(a, b) and not gn_relu.launches  # a CPU tensor never launches
    with pytest.raises(ValueError):
        group_norm_relu(_t(x), _t(scale), _t(bias), 4, impl="cudnn")
    with pytest.raises(ValueError):
        group_norm_relu(_t(x), _t(scale), _t(bias), 5)


def _dhwio(w):
    return jnp.asarray(np.ascontiguousarray(w.transpose(2, 3, 4, 1, 0)))


def _k2_reference(x, w, r):
    """JAX s2d_conv3x3 (stride 1, aligned in, shifted out) with the k2 Pallas
    kernel on: value and grads of sum(conv(x, w) * r), voxel layout."""
    def loss(x, w):
        out = js2d.depth_to_space_shifted(js2d.s2d_conv3x3(js2d.space_to_depth(x), w, "a"))
        return jnp.sum(out * r), out

    js2d.set_k2_pallas(True)
    try:
        (_, out), (dx, dw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), _dhwio(w))
    finally:
        js2d.set_k2_pallas(False)
    return np.asarray(out), np.asarray(dx), np.asarray(dw).transpose(4, 3, 0, 1, 2)


@pytest.mark.parametrize("cin,cout,shape", [
    (16, 32, (1, 4, 16, 16)),   # 8 * 16 = 128 lanes: the k2 Pallas kernel runs
    (24, 24, (1, 4, 6, 8)),     # the refiner's width
    (24, 48, (2, 2, 4, 6)),     # Cin != Cout
])
def test_conv3x3_train_matches_k2_and_conv3d(rng, cin, cout, shape):
    x = rng.standard_normal((*shape, cin)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, 3, 3, 3)) * 0.1).astype(np.float32)
    r = rng.standard_normal((*shape, cout)).astype(np.float32)

    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    conv3x3.reset_launches()
    y = conv3x3_train(xt, wt)
    dx, dw = torch.autograd.grad((y * _t(r)).sum(), (xt, wt))
    assert not conv3x3.launches  # a CPU tensor runs the plain version

    want_y, want_dx, want_dw = _k2_reference(x, w, r)
    for got, want, name in ((y, want_y, "y"), (dx, want_dx, "dx"), (dw, want_dw, "dw")):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4, err_msg=name)

    xf, wf = _t(x).requires_grad_(), _t(w).requires_grad_()
    yf = F.conv3d(xf.permute(0, 4, 1, 2, 3), wf, padding=1).permute(0, 2, 3, 4, 1)
    dxf, dwf = torch.autograd.grad((yf * _t(r)).sum(), (xf, wf))
    for got, want, name in ((y, yf, "y"), (dx, dxf, "dx"), (dw, dwf, "dw")):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)

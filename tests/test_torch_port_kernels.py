"""The fused conv3x3_gn op against the JAX package's Pallas kernels it
replaces.

On the CPU the JAX side runs the Pallas kernels in interpret mode, as
tests/test_bd.py does: bdx through NoBottleneck under ``set_bd_fused``, bk3
through ``conv3d`` under ``set_bd_pallas``. Those comparisons use 2e-3, the
tolerance tests/test_bd.py holds the kernels to against XLA. Function-level
comparisons with JAX's plain ops are f32 at 1e-4 (conv summation order).
The CUDA kernel itself is tested in tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.models.blocks import NoBottleneck as JNoBottleneck
from multimodal_pl_tpu.ops import bd as jbd
from multimodal_pl_tpu.ops.conv import conv3d as jconv3d
from multimodal_pl_tpu.ops.norm import group_norm as jgroup_norm
from multimodal_pl_tpu_torch.convert import state_dict_from_jax
from multimodal_pl_tpu_torch.models.blocks import NoBottleneck
from multimodal_pl_tpu_torch.ops import conv3x3
from multimodal_pl_tpu_torch.ops.conv3x3 import conv3x3_gn, conv3x3_gn_reference
from multimodal_pl_tpu_torch.ops.norm import group_norm_fold

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dhwio(w):
    return jnp.asarray(w.transpose(2, 3, 4, 1, 0))


def test_nobottleneck_plain_matches_bdx_interpret(rng):
    """Port NoBottleneck(128) (both convs through conv3x3_gn with the GN fold
    prologue, residual in the epilogue) == JAX NoBottleneck(128) on its
    fused bdx Pallas path."""
    x = rng.standard_normal((1, 4, 6, 8, 128)).astype(np.float32)
    jblk = JNoBottleneck(128, stride=1)
    params = jblk.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jbd.set_bd_fused(True)
    try:
        want = jblk.apply(params, jnp.asarray(x))
    finally:
        jbd.set_bd_fused(False)
    blk = NoBottleneck(128, 128, conv_impl="plain")
    blk.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = blk(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)


def test_prologue_off_matches_bk3_interpret(rng):
    """conv3x3_gn_reference without prologue == JAX conv3d on the bk3 Pallas
    band kernel."""
    x = rng.standard_normal((1, 4, 10, 10, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 128, 3, 3, 3)) * 0.05).astype(np.float32)
    jbd.set_bd_pallas(True)
    try:
        want = jconv3d(jnp.asarray(x), _dhwio(w), padding=1)
    finally:
        jbd.set_bd_pallas(False)
    got = conv3x3_gn_reference(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("with_res", [True, False])
@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 32)])
def test_reference_matches_jax_ops(rng, prologue, with_res, cin, cout):
    """conv3x3_gn_reference == JAX conv3d(relu(group_norm(x))) (+ res):
    zero padding applies to the normalized tensor."""
    x = (rng.standard_normal((2, 3, 5, 6, cin)) * 2 + 0.7).astype(np.float32)
    w = (rng.standard_normal((cout, cin, 3, 3, 3)) * 0.1).astype(np.float32)
    scale = rng.standard_normal(cin).astype(np.float32)
    bias = (rng.standard_normal(cin) + 0.5).astype(np.float32)
    res = rng.standard_normal((2, 3, 5, 6, cout)).astype(np.float32) if with_res else None
    jx = jnp.asarray(x)
    if prologue:
        jx = jax.nn.relu(jgroup_norm(jx, jnp.asarray(scale), jnp.asarray(bias), 16))
        a, b = group_norm_fold(_t(x), _t(scale), _t(bias), 16)
    else:
        a = b = None
    want = jconv3d(jx, _dhwio(w), padding=1)
    if with_res:
        want = want + jnp.asarray(res)
    got = conv3x3_gn_reference(_t(x), _t(w), a, b, None if res is None else _t(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_cpu_tensor_takes_plain_version_without_launch(rng):
    x = _t(rng.standard_normal((1, 2, 3, 4, 16)).astype(np.float32))
    w = _t(rng.standard_normal((16, 16, 3, 3, 3)).astype(np.float32))
    a, b = group_norm_fold(x, torch.ones(16), torch.zeros(16), 16)
    conv3x3.reset_launches()
    assert torch.equal(conv3x3_gn(x, w, a, b, res=x), conv3x3_gn_reference(x, w, a, b, res=x))
    assert conv3x3.launch_totals() == dict.fromkeys(conv3x3.SPECS, 0)
    with pytest.raises(ValueError):
        conv3x3_gn(x, w, a, None)


def test_pack_weight_tap_order(rng):
    w = _t(rng.standard_normal((32, 16, 3, 3, 3)).astype(np.float32))
    wp = conv3x3.pack_weight(w)
    assert wp.shape == (27, 16, 32)
    assert torch.equal(wp[1 * 9 + 2 * 3 + 0], w[:, :, 1, 2, 0].T)

"""The trilinear upsample (``multimodal_pl_tpu_torch/ops/resize.py``) on
the CPU, where its autograd Function runs the plain versions of the resize
kernels (``F.interpolate`` forward, the library's interpolation gradient
backward), against ``jax.image.resize`` and ``jax.grad`` of the JAX package's
``upsample_trilinear``: f = 2, 4, 8, with and without the skip added.

f32, on the same numpy inputs, standard-normal x and dy: the forward at
rtol 1e-5, atol 1e-6 (8 taps summed in different orders; every weight is
exact in f32 at these factors); the gradient at rtol 1e-5, atol 1e-6 * f^3:
each input element sums (2f)^3 weighted dy taps whose weights add up to f^3,
and the f32 rounding of the two frameworks' summation orders grows with that
sum (1.1e-5 seen at f = 4 and 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.ops import resize as jresize
from multimodal_pl_tpu_torch.ops import resize

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_function_matches_jax(factor, skip):
    rng = np.random.default_rng(factor + 10 * skip)
    x = rng.standard_normal((2, 2, 3, 2, 5)).astype(np.float32)
    out_shape = (2, 2 * factor, 3 * factor, 2 * factor, 5)
    s = rng.standard_normal(out_shape).astype(np.float32) if skip else None
    dy = rng.standard_normal(out_shape).astype(np.float32)

    def jloss(x, s):
        y = jresize.upsample_trilinear(x, factor)
        return jnp.sum((y if s is None else y + s) * dy), y if s is None else y + s

    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1) if skip else 0, has_aux=True)(
        jnp.asarray(x), None if s is None else jnp.asarray(s))
    jdx, jds = jgrads if skip else (jgrads, None)

    xt = torch.from_numpy(x).requires_grad_()
    st = None if s is None else torch.from_numpy(s).requires_grad_()
    resize.reset_launches()
    y = resize.upsample_trilinear(xt, factor, skip=st)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "_UpsampleBackward"
    grads = torch.autograd.grad(y, [t for t in (xt, st) if t is not None], torch.from_numpy(dy))
    assert not resize.launches and not resize.bwd_launches  # CPU: the plain versions

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6 * factor ** 3)
    if skip:
        assert torch.equal(grads[1], torch.from_numpy(dy))  # the skip's gradient is dy
        np.testing.assert_array_equal(np.asarray(jds), dy)
    with torch.no_grad():  # without autograd the same plain forward, no Function
        again = resize.upsample_trilinear(xt, factor, skip=st)
    assert again.grad_fn is None and torch.equal(again, y.detach())
    plain = resize.upsample_trilinear(xt.detach(), factor, skip=st, impl="plain")
    assert torch.equal(plain.detach(), y.detach())


@pytest.mark.parametrize("call", ["forward", "backward", "factor", "impl"])
def test_resize_kernels_refuse_what_they_cannot_take(call):
    """The kernel wrappers take CUDA tensors only and raise for a CPU tensor
    (no quiet plain fallback); factors other than 2, 4, 8 and an unknown
    impl raise too."""
    x = torch.zeros((1, 2, 2, 2, 8))
    with pytest.raises(ValueError):
        if call == "forward":
            resize.upsample_forward(x, 2)
        elif call == "backward":
            resize.upsample_backward(torch.zeros((1, 4, 4, 4, 8)), 2)
        elif call == "factor":
            resize.upsample_forward(x, 3)
        else:
            resize.upsample_trilinear(x, 2, impl="cuda")

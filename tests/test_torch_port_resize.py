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

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.ops import resize as jresize
from multimodal_pl_tpu_torch.ops import resize
from multimodal_pl_tpu_torch.tools import resize_plans

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


# (factor, C, dtype, B, D, H, W) of x at every resize3d call of a serving
# tile batch and of the B = 1 and B = 3 train steps, of
# tests/test_torch_port_cuda.py::test_resize_kernels_match_plain, and with
# axes of length 1
GPU_SHAPES = [
    (2, 32, "bfloat16", 2, 3, 5, 7), (2, 256, "bfloat16", 1, 2, 3, 3),
    (8, 13, "float32", 2, 2, 3, 3), (4, 13, "float32", 2, 4, 5, 6),
    (2, 13, "float32", 2, 8, 6, 5), (2, 2, "bfloat16", 3, 8, 8, 8),
    (2, 24, "float32", 2, 4, 3, 5), (4, 6, "bfloat16", 1, 1, 2, 1),
    (8, 13, "float32", 2, 3, 5, 3), (4, 13, "float32", 2, 3, 7, 9),
    (2, 13, "float32", 1, 5, 11, 13), (2, 2, "bfloat16", 4, 6, 9, 11),
    (2, 6, "bfloat16", 2, 3, 3, 1), (2, 256, "bfloat16", 2, 4, 12, 12),
    (2, 32, "bfloat16", 1, 3, 17, 19)]
PLAN_SHAPES = sorted(
    {key[:7] for keys in resize_plans.main_path_keys() for key in keys}
    | set(GPU_SHAPES)
    | {(f, 5, dt, 1, 1, 1, 1) for f in (2, 4, 8) for dt in ("bfloat16", "float32")}
    | {(f, 3, "float32", 2, 1, 2, 1) for f in (2, 4, 8)})


@functools.cache
def _readers(n, f):
    """reads[o, i]: output o reads input i with a nonzero weight, from the
    tap rule of the plain version (i0, i1, l of F.interpolate)."""
    reads = np.zeros((n * f, n), bool)
    for o in range(n * f):
        i0, i1, l = resize.taps(o, n, f)
        reads[o, i0] |= (1 - l) != 0
        reads[o, i1] |= l != 0
    return reads


def test_resize_plans_cover_every_element_once():
    """The wrapper's launch plans against brute force, at every forward and
    backward shape of the serving batch and the B = 1 and B = 3 steps (as
    chip_smoke.py derives them from the model's configuration), the GPU
    tests' shapes and axes of length 1 (f = 2, 4, 8): the forward blocks
    write every output row exactly once, each from the staged source rows
    and planes its taps name; the backward blocks write every input
    exactly once, and each block's od, oh and ow ranges are exactly the
    outputs that read its tile (clamped edges included); every plan fits the
    H100's 232,448 bytes of shared memory a block, and some GPU-test shape
    takes a plan above the 48 KB a block gets without asking."""
    above_48k = False
    for (f, c, dtype, b, d, h, w), skip in itertools.product(PLAN_SHAPES, (False, True)):
        esz = 2 if dtype == "bfloat16" else 4
        shape = (b, d, h, w, c)
        fp = resize.fwd_plan(b, d, h, w, c, f, esz, skip)
        bp = resize.bwd_plan(b, d, h, w, c, f, esz)
        assert fp.smem <= 232448 and bp.smem <= 232448, (shape, f, fp, bp)
        assert fp.smem == (resize.fwd_smem(h, w, c, f, fp.hs, esz) if fp.staged else 0)
        if (f, c, dtype, b, d, h, w) in GPU_SHAPES:
            above_48k |= max(fp.smem, bp.smem) > 48 * 1024
        taps_d, taps_h = ([resize.taps(o, n, f)[:2] for o in range(n * f)] for n in (d, h))

        rows = np.zeros((b, d * f, h * f, fp.csplit), np.int64)  # (row, part) written
        parts = {}
        for blk in range(fp.grid):
            t = resize.fwd_block(fp, shape, f, esz, blk)
            (od0, od1), (oh0, oh1), (j0, _) = t["od"], t["oh"], t["j"]
            if od0 >= od1:
                continue
            cp = blk % fp.csplit
            parts.setdefault(cp, t["chunks"])
            assert parts[cp] == t["chunks"]
            rows[t["n"], od0:od1, oh0:oh1, cp] += 1
            assert all(taps_d[o] == (t["d0"], t["d1"]) for o in range(od0, od1))
            assert all(j0 <= i < j0 + t["nrows"] for o in range(oh0, oh1) for i in taps_h[o])
        assert (rows == 1).all(), (shape, f, fp)
        chunks = [parts[cp] for cp in range(fp.csplit)]  # the parts tile each row
        assert chunks[0][0] == 0 and chunks[-1][1] == -(-w * f * c * esz // 16)
        assert all(a[1] == b_[0] < b_[1] for a, b_ in zip(chunks, chunks[1:]))

        if skip:  # the backward plan does not depend on the skip
            continue
        inputs = np.zeros((b, d, h, w), np.int64)
        for blk in range(bp.grid):
            t = resize.bwd_block(bp, shape, f, blk)
            inputs[t["n"], slice(*t["d"]), slice(*t["h"]), slice(*t["w"])] += 1
            for ax, n in (("d", d), ("h", h), ("w", w)):
                outs = np.flatnonzero(_readers(n, f)[:, slice(*t[ax])].any(1))
                assert np.array_equal(outs, np.arange(*t["o" + ax])), (shape, f, bp, blk, ax)
            assert t["od"][1] - t["od"][0] <= f * bp.dt + f
            assert t["oh"][1] - t["oh"][0] <= f * bp.th + f
            assert t["ow"][1] - t["ow"][0] <= f * bp.tw + f
        assert (inputs == 1).all(), (shape, f, bp)
    assert above_48k

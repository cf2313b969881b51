"""The CUDA kernels (conv3x3_gn, conv3x3_train, the gn_relu forward and
backward on both routes, the GroupNorm fold statistics, the resize3d
upsample forward and backward) against their plain PyTorch versions on the
GPU, the model's gradients and feam2 on the card, the ablation U-Nets on the
card (kernel vs plain, and their trunks bit-equal to the FEAM's), the train
step (bit-equal reruns; with and without remat) and the step ladder's full
rung (``tools/step_ablate.py``, bit-equal to it) on the card, and the device
data pipeline.

These tests need an NVIDIA GPU (the kernel has no CPU mode) and skip
without one. The file imports no JAX, so it also runs where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_port_cuda.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from multimodal_pl_tpu_torch.data.dataset import AMOSDataset
from multimodal_pl_tpu_torch.data.device_cache import DeviceDataPipeline
from multimodal_pl_tpu_torch.models import UNet3DFEAM
from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu, norm, resize
from multimodal_pl_tpu_torch.ops.conv3x3 import conv3x3_gn, conv3x3_gn_reference, conv3x3_train
from multimodal_pl_tpu_torch.ops.gn_relu import group_norm_relu
from multimodal_pl_tpu_torch.ops.norm import group_norm_fold

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout,prologue,with_res", [
    ((2, 5, 9, 21), 32, 32, True, True),
    ((1, 4, 12, 12), 256, 128, True, False),
    ((3, 3, 7, 17), 64, 64, False, False),
    ((1, 2, 5, 33), 16, 48, True, True),
    ((11, 4, 6, 20), 24, 24, True, True),   # the refiner's width, B = 11
    ((2, 3, 5, 17), 48, 24, False, False),
    ((2, 2, 6, 6), 192, 192, True, True),   # deep: K split across blocks
    ((2, 2, 6, 6), 192, 192, False, False),
    ((2, 4, 12, 12), 24, 96, True, False),  # Cin = 24: one zero-padded chunk
    ((2, 4, 12, 12), 96, 24, False, True),  # Cout = 24
    ((1, 4, 6, 8), 320, 288, True, True),   # Cout past 256: two output blocks
])
def test_cuda_kernel_matches_plain(cuda_device, shape, cin, cout, prologue, with_res):
    """bf16 kernel vs the f32 plain version on the same bf16 inputs:
    max|k - p| <= 1e-2 * max|p| (bf16 output rounding plus f32 summation
    order)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    b_, d, h, w_ = shape
    x = torch.randn((b_, d, h, w_, cin), generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g) * 0.05).to(cuda_device, torch.bfloat16)
    a = b = res = None
    if prologue:
        a, b = group_norm_fold(x, torch.randn(cin, generator=g).to(cuda_device),
                               torch.randn(cin, generator=g).to(cuda_device), 8)
    if with_res:
        res = torch.randn((b_, d, h, w_, cout), generator=g).to(cuda_device, torch.bfloat16)
    conv3x3.reset_launches()
    got = conv3x3_gn(x, w, a, b, res).float()
    torch.cuda.synchronize()
    want = conv3x3_gn_reference(x, w, a, b, res).float()
    assert sum(conv3x3.launch_totals().values()) == 1
    err = (got - want).abs().max().item()
    assert err <= 1e-2 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout", [((2, 5, 9, 21), 32, 32), ((2, 2, 6, 6), 192, 192)])
def test_cuda_kernel_is_deterministic(cuda_device, shape, cin, cout):
    """Two calls give the same bits, with and without the K split (no float
    atomics: split-K partials are summed in a fixed order)."""
    g = torch.Generator(device="cpu").manual_seed(4)
    x = torch.randn((*shape, cin), generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g) * 0.05).to(cuda_device, torch.bfloat16)
    a, b = group_norm_fold(x, torch.ones(cin, device=cuda_device),
                           torch.zeros(cin, device=cuda_device), 8)
    first = conv3x3_gn(x, w, a, b, res=None)
    second = conv3x3_gn(x, w, a, b, res=None)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,groups,mean", [((2, 4, 6, 8), 32, 16, 0.0),
                                                 ((2, 16, 48, 48), 64, 16, 100.0),
                                                 ((11, 8, 24, 24), 24, 4, 0.5),
                                                 ((1, 2, 6, 6), 256, 16, -3.0)])
def test_fold_kernel_matches_plain(cuda_device, shape, c, groups, mean):
    """The fold statistics kernel (one read, Chan merges) against the plain
    two-pass fold, std 1 around ``mean``: both rows within rel 1e-5 of their
    largest magnitude (f32 summation order only), the same bits twice, one
    counted call."""
    g = torch.Generator(device="cpu").manual_seed(5)
    x = (torch.randn((*shape, c), generator=g) + mean).to(cuda_device, torch.bfloat16)
    sc = (1 + 0.1 * torch.randn(c, generator=g)).to(cuda_device)
    bi = (0.1 * torch.randn(c, generator=g)).to(cuda_device)
    norm.fold_launches.clear()
    ka, kb = group_norm_fold(x, sc, bi, groups, impl="kernel")
    torch.cuda.synchronize()
    assert sum(norm.fold_launches.values()) == 1
    pa, pb = group_norm_fold(x, sc, bi, groups)
    for k, p in ((ka, pa), (kb, pb)):
        assert (k - p).abs().max().item() <= 1e-5 * p.abs().max().item()
    ka2, kb2 = group_norm_fold(x, sc, bi, groups, impl="kernel")
    assert torch.equal(ka, ka2) and torch.equal(kb, kb2)


@pytest.mark.cuda
def test_cuda_kernel_64bit_offsets(cuda_device):
    """Flip-TTA tile batches reach B = 32 at 64 x 192 x 192 x 32, past 2**31
    elements: the last sample of a B = 32 launch equals a B = 1 launch on it
    (the kernel's work per sample does not depend on the batch)."""
    if torch.cuda.get_device_properties(cuda_device).total_memory < 24 * 2 ** 30:
        pytest.skip("needs 24 GiB of device memory")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    shape = (32, 64, 192, 192, 32)
    assert torch.Size(shape).numel() > 2 ** 31
    x = torch.randn(shape, generator=g, device=cuda_device, dtype=torch.bfloat16)
    w = (torch.randn((32, 32, 3, 3, 3), generator=g, device=cuda_device) * 0.05).to(torch.bfloat16)
    a = torch.rand((32, 32), generator=g, device=cuda_device) + 0.5
    b = torch.randn((32, 32), generator=g, device=cuda_device)
    big = conv3x3_gn(x, w, a, b, res=x)
    last = conv3x3_gn(x[31:].contiguous(), w, a[31:].contiguous(), b[31:].contiguous(),
                      res=x[31:].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(big[31:], last)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
def test_conv3x3_gn_raises_under_autograd(cuda_device):
    """The kernel has no backward: with grad mode on and an input requiring
    grad it raises instead of returning a detached result."""
    x = torch.randn((1, 2, 4, 16, 32), device=cuda_device, dtype=torch.bfloat16)
    w = torch.randn((32, 32, 3, 3, 3), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        conv3x3_gn(x, w.requires_grad_())
    with torch.no_grad():
        assert conv3x3_gn(x, w).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,groups", [((1, 8, 24, 40), 32, 16), ((2, 5, 9, 13), 24, 4),
                                            ((2, 1, 1, 1), 192, 12)])
def test_gn_relu_kernel_matches_plain(cuda_device, shape, c, groups):
    """Through autograd: the forward and backward kernels against the plain
    versions (impl='plain' on the card). Forward max|k - p| <= 1e-2 * max|p|
    (bf16 output rounding; the statistics' summation order differs); dx by
    the same rule; ds, dt by relative norm <= 1e-2 (a pre-activation within
    f32 rounding of 0 may take the other side of the ReLU and move one term
    of a sum)."""
    g = torch.Generator(device="cpu").manual_seed(1)
    x = (torch.randn((*shape, c), generator=g) * 2 + 0.5).to(cuda_device, torch.bfloat16)
    sc = torch.randn(c, generator=g).to(cuda_device).requires_grad_()
    bi = torch.randn(c, generator=g).to(cuda_device).requires_grad_()
    gn_relu.reset_launches()
    k = group_norm_relu(x.requires_grad_(), sc, bi, groups)
    torch.cuda.synchronize()
    assert sum(gn_relu.launches.values()) == 1
    p = group_norm_relu(x, sc, bi, groups, impl="plain")
    assert (k.float() - p.float()).abs().max().item() <= 1e-2 * p.float().abs().max().item()
    r = torch.randn(k.shape, generator=g).to(cuda_device, torch.bfloat16)
    gk = torch.autograd.grad(k, (x, sc, bi), r)
    assert sum(gn_relu.bwd_launches.values()) == 1
    gp = torch.autograd.grad(p, (x, sc, bi), r)
    assert gk[0].dtype == torch.bfloat16 and gk[1].dtype == gk[2].dtype == torch.float32
    assert (gk[0].float() - gp[0].float()).abs().max() <= 1e-2 * gp[0].float().abs().max()
    for a, b in zip(gk[1:], gp[1:]):
        assert _rel(a, b) <= 1e-2


# (shape (B, D, H, W), C, groups, route): C = 24, 192 and 256, B = 11; each
# route forced at small shapes, and the wrapper's choice (None) at shapes
# where a sample fits a cluster for the forward but not for the backward, or
# exceeds it for both
GN_CASES = [((2, 4, 12, 12), 24, 4, "cluster"), ((2, 4, 12, 12), 24, 4, "grid"),
            ((11, 8, 24, 24), 24, 4, "grid"), ((11, 2, 6, 6), 24, 6, None),
            ((2, 2, 6, 6), 192, 12, "cluster"), ((2, 2, 6, 6), 192, 12, "grid"),
            ((1, 4, 12, 12), 256, 16, "cluster"), ((4, 8, 24, 24), 256, 16, None),
            ((1, 16, 48, 48), 128, 16, "grid"), ((1, 32, 96, 96), 32, 16, None),
            # B = 3, the production batch: the backward's cluster holds all
            # three samples where they fit, else both take the grid route
            ((3, 4, 12, 12), 256, 16, "cluster"), ((3, 4, 12, 12), 256, 16, "grid"),
            ((3, 8, 24, 24), 128, 16, None), ((3, 16, 48, 48), 64, 16, None)]


def _gn_inputs(shape, c, mean=0.5):
    g = torch.Generator(device="cpu").manual_seed(7)
    x = (torch.randn((*shape, c), generator=g) * 2 + mean).to("cuda", torch.bfloat16)
    sc = (1 + 0.3 * torch.randn(c, generator=g)).to("cuda")
    bi = (0.3 * torch.randn(c, generator=g)).to("cuda")
    dy = torch.randn((*shape, c), generator=g).to("cuda", torch.bfloat16)
    return x, sc, bi, dy


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,groups,path", GN_CASES)
def test_gn_relu_forward_kernel_routes(cuda_device, shape, c, groups, path):
    """Kernel A on the given route against its plain version: y within
    1e-2 * max|y| (bf16 output rounding), the groups' mean and inv within
    rel 1e-5 (f32 summation order); the same bits on a second call."""
    x, sc, bi, _ = _gn_inputs(shape, c)
    y, stats = gn_relu.gn_relu_forward(x, sc, bi, groups, path=path)
    torch.cuda.synchronize()
    yp, stats_p = gn_relu._reference(x, sc, bi, groups)
    assert (y.float() - yp.float()).abs().max() <= 1e-2 * yp.float().abs().max()
    assert ((stats - stats_p).abs().amax((0, 2)) <= 1e-5 * stats_p.abs().amax((0, 2))).all()
    y2, stats2 = gn_relu.gn_relu_forward(x, sc, bi, groups, path=path)
    assert torch.equal(y, y2) and torch.equal(stats, stats2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,groups,path", GN_CASES)
def test_gn_relu_backward_kernel_routes(cuda_device, shape, c, groups, path):
    """Kernel B on the given route against its plain version on the same
    inputs and the same forward statistics: dx within 1e-2 * max|dx| (bf16
    output rounding), ds and dt by relative norm <= 1e-3 (f32 summation
    order); the same bits on a second call."""
    x, sc, bi, dy = _gn_inputs(shape, c)
    _, stats = gn_relu.gn_relu_forward(x, sc, bi, groups)
    gn_relu.reset_launches()
    dx, ds, dt = gn_relu.gn_relu_backward(x, dy, sc, bi, stats, groups, path=path)
    torch.cuda.synchronize()
    assert sum(gn_relu.bwd_launches.values()) == 1
    dxp, dsp, dtp = gn_relu.group_norm_relu_backward_reference(x, dy, sc, bi, stats, groups)
    assert (dx.float() - dxp.float()).abs().max() <= 1e-2 * dxp.float().abs().max()
    assert _rel(ds, dsp) <= 1e-3 and _rel(dt, dtp) <= 1e-3
    again = gn_relu.gn_relu_backward(x, dy, sc, bi, stats, groups, path=path)
    assert all(torch.equal(a, b) for a, b in zip((dx, ds, dt), again))


@pytest.mark.cuda
def test_gn_relu_forward_two_pass_at_large_mean(cuda_device):
    """mean 100, std 2: the kernel's shifted statistics match the plain
    two-pass ones (rel 1e-5) on both routes, where one-pass moments would
    cancel."""
    x, sc, bi, _ = _gn_inputs((2, 4, 12, 12), 64, mean=100.0)
    _, stats_p = gn_relu._reference(x, sc, bi, 16)
    for path in gn_relu.PATHS:
        _, stats = gn_relu.gn_relu_forward(x, sc, bi, 16, path=path)
        assert ((stats - stats_p).abs().amax((0, 2)) <= 1e-5 * stats_p.abs().amax((0, 2))).all()


@pytest.mark.cuda
def test_gn_relu_kernels_raise_on_bad_input(cuda_device):
    """An f32 input, an f32 incoming gradient or C not a multiple of 8 raise
    instead of launching."""
    x, sc, bi, dy = _gn_inputs((1, 2, 4, 4), 16)
    _, stats = gn_relu.gn_relu_forward(x, sc, bi, 4)
    with pytest.raises(ValueError, match="bf16"):
        gn_relu.gn_relu_forward(x.float(), sc, bi, 4)
    with pytest.raises(ValueError, match="bf16"):
        gn_relu.gn_relu_backward(x, dy.float(), sc, bi, stats, 4)
    x12 = torch.randn((1, 2, 4, 4, 12), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        gn_relu.gn_relu_forward(x12, sc[:12], bi[:12], 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        gn_relu.gn_relu_backward(x12, x12, sc[:12], bi[:12], stats[:, :, :4], 4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout", [((1, 8, 24, 40), 32, 32), ((2, 6, 12, 20), 24, 24),
                                            ((2, 4, 8, 16), 48, 24), ((1, 4, 6, 8), 256, 128)])
def test_conv3x3_train_matches_plain(cuda_device, shape, cin, cout):
    """Forward and dx through the kernel, dw through the library's
    convolution backward, against f32 autograd of the plain version (TF32
    off) on the same bf16 inputs: relative Frobenius <= 1e-2 (bf16 rounding
    of the outputs and of the incoming gradient's use)."""
    g = torch.Generator(device="cpu").manual_seed(2)
    x = torch.randn((*shape, cin), generator=g).to(cuda_device, torch.bfloat16).requires_grad_()
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g) * 0.05).to(
        cuda_device, torch.bfloat16).requires_grad_()
    gy = torch.randn((*shape, cout), generator=g).to(cuda_device, torch.bfloat16)
    conv3x3.reset_launches()
    y = conv3x3_train(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), gy)
    torch.cuda.synchronize()
    totals = conv3x3.launch_totals()
    assert totals[conv3x3.TRAIN_FWD] == 1 and totals[conv3x3.TRAIN_DX] == 1
    xf, wf = x.detach().float().requires_grad_(), w.detach().float().requires_grad_()
    yf = conv3x3_gn_reference(xf, wf)
    dxf, dwf = torch.autograd.grad(yf, (xf, wf), gy.float())
    for got, want in ((y, yf), (dx, dxf), (dw, dwf)):
        assert _rel(got, want) <= 1e-2


@pytest.mark.cuda
def test_model_gradients_on_the_card_match_plain(cuda_device):
    """A loss through the kernel model on the card reaches every stride-1
    conv's weight, and its gradients are as close to an f32 plain model's as
    the bf16 plain model's are (within twice its relative Frobenius error,
    plus 1e-3): bf16 rounding through ~30 layers, not the kernels, sets the
    gap."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(layers=(1, 1, 1, 1, 1), base=16, deep_up=True)
    model = UNet3DFEAM(**kw).to(cuda_device)
    plain = UNet3DFEAM(conv_impl="plain", gn_impl="plain", **kw).to(cuda_device)
    plain.load_state_dict(model.state_dict())
    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn((1, 32, 32, 32, 1), generator=g).to(cuda_device)
    r = torch.randn((1, 32, 32, 32, 14), generator=g).to(cuda_device)
    grads = []
    for net, dtype in ((model, torch.bfloat16), (plain, torch.bfloat16), (plain, torch.float32)):
        conv3x3.reset_launches()
        loss = (net(x.to(dtype), aux=False).float() * r).sum()
        grads.append(torch.autograd.grad(loss, list(net.parameters()), allow_unused=True))
        if net is model:
            assert conv3x3.launch_totals()[conv3x3.TRAIN_FWD] == 14
    names = [n for n, _ in model.named_parameters()]
    for name, gk in zip(names, grads[0]):
        if name.endswith("conv1.weight") or name.endswith("conv2.weight"):
            assert gk is not None and gk.abs().sum() > 0, name
    kernel, plain16, plain32 = (torch.cat([t.flatten() for t in gs if t is not None])
                                for gs in grads)
    assert _rel(kernel, plain32) <= 2 * _rel(plain16, plain32) + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape,factor,skip,dtype", [
    ((2, 3, 5, 7, 32), 2, True, torch.bfloat16),    # the decoder's upsample + skip
    ((1, 2, 3, 3, 256), 2, True, torch.bfloat16),   # the deepest decoder scale
    ((2, 2, 3, 3, 13), 8, False, torch.float32),    # the attention maps' x8 ...
    ((2, 4, 5, 6, 13), 4, False, torch.float32),    # ... x4
    ((2, 8, 6, 5, 13), 2, False, torch.float32),    # ... and x2
    ((3, 8, 8, 8, 2), 2, False, torch.bfloat16),    # the refiner's logits
    ((2, 4, 3, 5, 24), 2, True, torch.float32),     # the refiner's width, f32
    ((1, 1, 2, 1, 6), 4, True, torch.bfloat16),     # axes of length 1, C = 6
    ((2, 3, 5, 3, 13), 8, False, torch.float32),    # 13 f32 channels, odd H and W, x8 ...
    ((2, 3, 7, 9, 13), 4, False, torch.float32),    # ... x4
    ((1, 5, 11, 13, 13), 2, True, torch.float32),   # ... x2 (+ skip)
    ((4, 6, 9, 11, 2), 2, False, torch.bfloat16),   # the logits, B = 4, odd extents
    ((2, 3, 3, 1, 6), 2, True, torch.bfloat16),     # a 24-byte output row (C = 6, W = 1)
    ((2, 4, 12, 12, 256), 2, False, torch.bfloat16),  # a backward plan above 48 KB
    ((1, 3, 17, 19, 32), 2, True, torch.bfloat16),  # extents the tiles do not divide
])
def test_resize_kernels_match_plain(cuda_device, shape, factor, skip, dtype):
    """resize3d forward (with the skip fused) and backward against the plain
    versions in f32 on the same inputs: max|k - p| <= 1e-2 * max|p| (bf16
    output rounding; f32 summation order); one counted call each; the
    backward is one kernel launch that allocates nothing but dx, and gives
    the same bits twice (gather form, no atomics)."""
    g = torch.Generator(device="cpu").manual_seed(6)
    b, d, h, w, c = shape
    out = (b, d * factor, h * factor, w * factor, c)
    x = torch.randn(shape, generator=g).to(cuda_device, dtype)
    sk = torch.randn(out, generator=g).to(cuda_device, dtype) if skip else None
    dy = torch.randn(out, generator=g).to(cuda_device, dtype)
    resize.reset_launches()
    y = resize.upsample_forward(x, factor, sk)
    torch.cuda.synchronize()
    kernels = resize.kernel_launches()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    dx = resize.upsample_backward(dy, factor)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - allocs == 1  # dx alone
    assert resize.kernel_launches() - kernels == 1
    dx2 = resize.upsample_backward(dy, factor)
    torch.cuda.synchronize()
    assert sum(resize.launches.values()) == 1 and sum(resize.bwd_launches.values()) == 2
    want = resize.upsample_trilinear_reference(x.float(), factor,
                                                None if sk is None else sk.float())
    dwant = resize.upsample_trilinear_backward_reference(dy.float(), factor)
    assert y.dtype == dx.dtype == dtype
    assert (y.float() - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    assert (dx.float() - dwant).abs().max().item() <= 1e-2 * dwant.abs().max().item()
    assert torch.equal(dx, dx2)


@pytest.mark.cuda
def test_resize_function_routes_through_the_kernels(cuda_device):
    """upsample_trilinear under autograd on a CUDA tensor: one forward and
    one backward kernel call, the skip's gradient is dy; impl='plain' launches
    none."""
    g = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn((1, 4, 4, 4, 16), generator=g).to(cuda_device).requires_grad_()
    sk = torch.randn((1, 8, 8, 8, 16), generator=g).to(cuda_device).requires_grad_()
    dy = torch.randn((1, 8, 8, 8, 16), generator=g).to(cuda_device)
    resize.reset_launches()
    gx, gs = torch.autograd.grad(resize.upsample_trilinear(x, 2, sk), (x, sk), dy)
    assert sum(resize.launches.values()) == 1 and sum(resize.bwd_launches.values()) == 1
    assert torch.equal(gs, dy)
    resize.reset_launches()
    px, _ = torch.autograd.grad(resize.upsample_trilinear(x, 2, sk, impl="plain"), (x, sk), dy)
    assert not resize.launches and not resize.bwd_launches
    assert (gx - px).abs().max().item() <= 1e-5 * px.abs().max().item()


@pytest.mark.cuda
def test_feam2_on_the_card_matches_plain(cuda_device):
    """UNet3DFEAM(token_update='pre', deep_up=True), bf16 on the kernels
    against the plain model with the same weights, tokens and mask: logits
    rel L2 <= 3e-2 (chip_smoke phase 3's limit); the token updates (new -
    old, alpha times the masked means of bf16 features) rel L2 <= 3e-2."""
    from multimodal_pl_tpu_torch.models import init_class_tokens

    kw = dict(layers=(1, 1, 1, 1, 1), base=16, deep_up=True, token_update="pre")
    model = UNet3DFEAM(**kw).to(cuda_device).eval()
    plain = UNet3DFEAM(conv_impl="plain", gn_impl="plain", **kw).to(cuda_device).eval()
    plain.load_state_dict(model.state_dict())
    g = torch.Generator(device="cpu").manual_seed(8)
    tokens = {k: v.to(cuda_device) for k, v in init_class_tokens(
        g, 14, {"t1": 64, "t2": 32, "t3": 16}).items()}
    x = torch.randn((1, 32, 64, 64, 1), generator=g).to(cuda_device, torch.bfloat16)
    mask = torch.randint(0, 14, (1, 32, 64, 64), generator=g).to(cuda_device)
    with torch.inference_mode():
        resize.reset_launches()
        lk, ak, _, _, tk = model(x, tokens, mask)
        assert sum(resize.launches.values()) == 7  # 4 decoder upsamples, 3 attention maps
        lp, ap, _, _, tp = plain(x, tokens, mask)
    assert _rel(lk, lp) <= 3e-2
    for a, b_ in zip(ak, ap):
        assert a.shape == (1, 32, 64, 64, 13) and _rel(a, b_) <= 3e-2
    for k in tokens:
        assert _rel(tk[k] - tokens[k], tp[k] - tokens[k]) <= 3e-2


@pytest.fixture(scope="module")
def amos_ds(tmp_path_factory):
    from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

    root = str(tmp_path_factory.mktemp("amos"))
    make_synthetic_amos(root, n_ct=4, n_mri=2, shape=(48, 48, 40), seed=0, spread_ids=False)
    atlas = np.load(os.path.join(root, "atlas_mm.npy"))
    return AMOSDataset(os.path.join(root, "imagesTr"), crop_size=(24, 32, 32), usage="train",
                       atlas=atlas, cache=True)


@pytest.mark.cuda
def test_device_pipeline_on_the_card(cuda_device, amos_ds):
    """Batches on the card in the step's layout and dtypes; with the same
    seed, the same bits (augmented, mirrored); without augmentation, the
    host-path crops at the drawn corners."""
    def batches(**kw):
        pipe = DeviceDataPipeline(amos_ds, compute_dtype=torch.bfloat16, seed=3, **kw)
        return [{k: v.clone() for k, v in b.items()} for b in pipe.batches(2, epochs=2)]

    first, second = batches(mirror=True), batches(mirror=True)
    for a, b in zip(first, second):
        assert a["image"].is_cuda and a["image"].dtype == torch.bfloat16
        assert a["image"].shape == (2, 24, 32, 32, 1) and a["catlas"].shape == (13, 24, 32, 32)
        assert a["label"].dtype == torch.uint8
        assert a["sup_mask"].dtype == a["label_t"].dtype == torch.float32
        assert all(torch.equal(a[k], b[k]) for k in a)
    pipe = DeviceDataPipeline(amos_ds, compute_dtype=torch.float32, augment=False)
    idxs, starts, flips, p, n = next(pipe.draws(1))
    got = pipe.assemble(idxs, starts, flips, p, n)
    _, image, label, catlas = amos_ds._prepared(int(idxs[0]))
    a, b, c = (int(v) for v in starts[0])
    want = image.transpose(2, 0, 1)[a:a + 24, b:b + 32, c:c + 32]
    assert torch.equal(got["image"][0, ..., 0].cpu(), torch.from_numpy(np.ascontiguousarray(want)))


def test_device_pipeline_without_a_gpu_raises(amos_ds, monkeypatch):
    """Constructed for the card (the default device) where none is visible:
    raises, never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceDataPipeline(amos_ds)


@pytest.mark.cuda
def test_remat_step_on_the_card_equals_step(cuda_device):
    """tiny_step_config, bf16, B = 2, from a state after one step: the step
    with remat against the step without, on the kernels; total loss rel
    <= 1e-6 and every gradient leaf within rel 1e-3 of the step's (the
    step is deterministic, so the recompute gives the same bits: 0 on the
    H100); a second run of the step gives the same loss and gradients bit
    for bit."""
    from multimodal_pl_tpu_torch.train.state import (
        build_models, create_train_state, tiny_step_config)
    from multimodal_pl_tpu_torch.train.step import make_train_step

    cfg = tiny_step_config(compute_dtype=torch.bfloat16)
    g = torch.Generator(device="cpu").manual_seed(0)
    sup = torch.zeros(14)
    sup[5] = 1
    batch = {"image": torch.randn((2, 32, 32, 32, 1), generator=g),
             "label": torch.randint(0, 14, (2, 32, 32, 32), generator=g).to(torch.uint8),
             "catlas": torch.rand((13, 32, 32, 32), generator=g), "sup_mask": sup,
             "label_t": torch.tensor([0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1.])}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    wf = torch.tensor(0.05, device=cuda_device)

    def step(c):
        return make_train_step(*(m.to(cuda_device) for m in build_models(c)), c)

    state = create_train_state(torch.Generator().manual_seed(0), cfg).to(cuda_device)
    state, _ = step(cfg)(state, batch, torch.tensor(1.0, device=cuda_device), wf)
    runs = [step(c).grads(state, batch, wf)
            for c in (cfg, cfg, dataclasses.replace(cfg, remat=True))]
    (want, wg, _), (again, rerun, _), (got, gg, _) = runs
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    leaves = [(i, k) for i in (0, 1) for k in wg[i] if float(wg[i][k].norm()) > 0]
    assert leaves
    for i, k in leaves:
        assert _rel(gg[i][k], wg[i][k]) <= 1e-3, k
    assert torch.equal(again, want)
    assert all(torch.equal(rerun[i][k], wg[i][k]) for i in (0, 1) for k in wg[i])


def _dp_batches(device="cpu"):
    """Two seeded B = 1 shards at 32^3 with different supervised organs
    (5: in the labeled modality, so the refiner trains; 3: not)."""
    out = []
    for seed, organ in ((1, 5), (2, 3)):
        g = torch.Generator(device="cpu").manual_seed(seed)
        sup = torch.zeros(14)
        sup[organ] = 1
        out.append({k: v.to(device) for k, v in {
            "image": torch.randn((1, 32, 32, 32, 1), generator=g),
            "label": torch.randint(0, 14, (1, 32, 32, 32), generator=g).to(torch.uint8),
            "catlas": torch.rand((13, 32, 32, 32), generator=g), "sup_mask": sup,
            "label_t": torch.tensor([0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1.])}.items()})
    return out


@pytest.mark.cuda
def test_nccl_world_one_step_and_predictor_equal_the_single_ones(cuda_device):
    """A one-rank NCCL group (--mesh data:1 without torchrun): the
    data-parallel step (kernels, bf16) gives the single step's state and
    metrics bit for bit, and the sharded predictor the single predictor's
    label map and blended logits."""
    from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
    from multimodal_pl_tpu_torch.parallel import init_data_parallel, make_sharded_train_step
    from multimodal_pl_tpu_torch.parallel.sharded_infer import ShardedSlidingWindowPredictor
    from multimodal_pl_tpu_torch.tools import spawn
    from multimodal_pl_tpu_torch.train.state import (
        build_models, create_train_state, tiny_step_config)
    from multimodal_pl_tpu_torch.train.step import make_train_step

    cfg = tiny_step_config(compute_dtype=torch.bfloat16)
    batch = _dp_batches(cuda_device)[0]
    lr, wf = torch.tensor(1.0, device=cuda_device), torch.tensor(0.05, device=cuda_device)
    state = create_train_state(torch.Generator().manual_seed(0), cfg).to(cuda_device)
    want, wm = make_train_step(*(m.to(cuda_device) for m in build_models(cfg)), cfg)(
        state, batch, lr, wf)
    model = UNet3DFEAM(layers=(1, 1, 1, 1, 1), deep_up=True,
                       generator=torch.Generator().manual_seed(0)).to(cuda_device).eval()
    vol = np.random.default_rng(0).standard_normal((40, 72, 56)).astype(np.float32)
    kw = dict(window_batch=3, compute_dtype=torch.bfloat16, device=cuda_device,
              bucket=(8, 8, 8))
    single = {o: SlidingWindowPredictor(lambda t: model(t, aux=False), (16, 32, 32), 14,
                                        output=o, **kw)(vol) for o in ("argmax", "logits")}
    with init_data_parallel("data:1", "cuda") as dp:
        assert torch.distributed.get_backend() == "nccl"
        step = make_sharded_train_step(*(m.to(cuda_device) for m in build_models(cfg)), cfg,
                                       dp.group)
        got, gm = step(state, batch, lr, wf)
        sharded = {o: ShardedSlidingWindowPredictor(lambda t: model(t, aux=False), (16, 32, 32),
                                                    14, dp.group, output=o, **kw)(vol)
                   for o in ("argmax", "logits")}
    assert spawn.states_unequal(got, want) == []
    assert all(torch.equal(gm[k], wm[k]) for k in wm)
    assert all(torch.equal(sharded[o], single[o]) for o in single)


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card(cuda_device):
    """Two spawned ranks on cuda:0 over gloo (NCCL takes one rank per card),
    one step each (kernels, bf16) on its own shard from one state: the same
    bits on both ranks, equal to the in-process (g0 + g1) / 2 reference;
    each rank's kernel launches are those of a single step."""
    from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu, resize
    from multimodal_pl_tpu_torch.tools import spawn
    from multimodal_pl_tpu_torch.train.state import (
        build_models, create_train_state, tiny_step_config)
    from multimodal_pl_tpu_torch.train.step import make_train_step

    cfg = tiny_step_config(compute_dtype=torch.bfloat16)
    state = create_train_state(torch.Generator().manual_seed(0), cfg)
    ranks = spawn.run(spawn.dp_step, 2, cfg, state, _dp_batches(), 1.0, 0.05, "cuda:0",
                      timeout=300)
    step = make_train_step(*(m.to(cuda_device) for m in build_models(cfg)), cfg)
    batches = _dp_batches(cuda_device)
    lr, wf = torch.tensor(1.0, device=cuda_device), torch.tensor(0.05, device=cuda_device)
    ref, rm = spawn.reference_step(step, state.to(cuda_device), batches, lr, wf)
    conv3x3.reset_launches()
    gn_relu.reset_launches()
    resize.reset_launches()
    step(state.to(cuda_device), batches[0], lr, wf)
    single = {"conv3x3": conv3x3.launches, "gn_relu": gn_relu.launches,
              "gn_relu_backward": gn_relu.bwd_launches, "resize": resize.launches,
              "resize_backward": resize.bwd_launches}
    ref = spawn._cpu(ref)
    for got, m, launches in ranks:
        assert spawn.states_unequal(got, ref) == []
        assert m["loss"] == float(rm["loss"])
        assert all(launches[k] == single[k] and sum(single[k].values()) > 0 for k in single)


def _ablation(name, **kw):
    from multimodal_pl_tpu_torch import models

    cls, extra = {"baseline": (models.UNet3DBaseline, {}), "deepsup": (models.UNet3DDeepSup, {}),
                  "eam3": (models.UNet3DEAM, {"num_eams": 3}),
                  "eam2": (models.UNet3DEAM, {"num_eams": 2}),
                  "dynhead": (models.UNet3DDynHead, {})}[name]
    return cls(layers=(1, 1, 1, 1, 1), base=16, **extra, **kw)


def _outputs(out):
    return [out] if isinstance(out, torch.Tensor) else [t for o in out for t in _outputs(o)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["baseline", "deepsup", "eam3", "eam2", "dynhead"])
def test_ablation_on_the_card_matches_plain(cuda_device, name):
    """Each ablation U-Net in bf16 on the kernels against the plain model
    with the same weights: every output (logits, deep maps, the EAM
    cascade's tokens and attention maps, DynHead's 2-channel logits) within
    rel L2 3e-2 (chip_smoke phase 3's limit); the stride-1 convs, folds,
    GroupNorm -> ReLU heads and decoder upsamples go through the kernels."""
    model = _ablation(name).to(cuda_device).eval()
    plain = _ablation(name, conv_impl="plain", gn_impl="plain").to(cuda_device).eval()
    plain.load_state_dict(model.state_dict())
    g = torch.Generator(device="cpu").manual_seed(10)
    x = torch.randn((2, 32, 64, 64, 1), generator=g).to(cuda_device, torch.bfloat16)
    args = (x, torch.tensor([0, 3], device=cuda_device)) if name == "dynhead" else (x,)
    with torch.inference_mode():
        conv3x3.reset_launches()
        norm.fold_launches.clear()
        gn_relu.reset_launches()
        resize.reset_launches()
        got = _outputs(model(*args))
        torch.cuda.synchronize()
        # layers (1, 1, 1, 1, 1): 2 fused convs in layer0 and in each decoder stage
        assert conv3x3.launch_totals()[conv3x3.FUSED] == 10
        assert conv3x3.launch_totals()[conv3x3.PROLOGUE_OFF] == 4
        assert sum(norm.fold_launches.values()) == 10 and sum(resize.launches.values()) == 4
        assert sum(gn_relu.launches.values()) == {"deepsup": 20, "dynhead": 18}.get(name, 17)
        want = _outputs(plain(*args))
    assert len(got) == {"baseline": 1, "deepsup": 4, "eam3": 5, "eam2": 4, "dynhead": 1}[name]
    for a, b_ in zip(got, want, strict=True):
        assert a.shape == b_.shape and bool(torch.isfinite(a).all())
        assert _rel(a, b_) <= 3e-2


@pytest.mark.cuda
def test_ablation_trunks_on_the_card_are_the_feam_bit_for_bit(cuda_device):
    """On the kernels, with the FEAM's weights, UNet3DBaseline,
    UNet3DDeepSup(aux=False) and UNet3DEAM(aux=False) give the bits of
    UNet3DFEAM(aux=False)."""
    feam = UNet3DFEAM(layers=(1, 1, 1, 1, 1), base=16).to(cuda_device).eval()
    sd = feam.state_dict()
    x = torch.randn((2, 32, 64, 64, 1), generator=torch.Generator().manual_seed(11)).to(
        cuda_device, torch.bfloat16)
    with torch.inference_mode():
        want = feam(x, aux=False)
        for name in ("baseline", "deepsup", "eam3", "eam2"):
            net = _ablation(name).to(cuda_device).eval()
            own = net.state_dict()
            net.load_state_dict({k: sd.get(k, v) for k, v in own.items()})
            got = net(x) if name == "baseline" else net(x, aux=False)
            assert torch.equal(got, want), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,groups", [((2, 5, 8, 13), 32, 16), ((4, 8, 12, 24), 256, 16),
                                            ((1, 4, 6, 8), 24, 4), ((4, 16, 48, 96), 32, 16)])
def test_gn_slab_entry_points_match_plain(cuda_device, shape, c, groups):
    """The slab statistics kernel (gn_moments_bf16) vs its plain twin:
    (mean, M2) within rel 1e-5; the normalize and the fold from two slabs'
    moments (gn_apply_bf16, merged in rank order) vs the plain merge and
    normalize: y within 1e-2 * max|plain|, rows within rel 1e-5; and given
    gn_relu_fwd_bf16's own statistics, on each of its routes that the shape
    takes, the normalize gives that kernel's output bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((*shape, c), generator=g) * 2 + 3).to(cuda_device, torch.bfloat16)
    sc = (1 + 0.1 * torch.randn(c, generator=g)).to(cuda_device)
    bi = (0.1 * torch.randn(c, generator=g)).to(cuda_device)
    m = gn_relu.gn_moments(x, groups)
    for k, p in zip(m.unbind(1), gn_relu.group_moments_reference(x, groups).unbind(1)):
        assert _rel(k, p) <= 1e-5
    slabs = [t.contiguous() for t in x.chunk(2, dim=2)]
    moments = torch.stack([gn_relu.gn_moments(s, groups) for s in slabs])
    count = float(slabs[0].numel() // (shape[0] * groups))
    stats = gn_relu.merge_moments_reference(moments, count)
    y = gn_relu.gn_apply(slabs[0], moments, sc, bi, groups)
    yp = gn_relu.group_norm_relu_from_stats_reference(slabs[0], stats, sc, bi)
    assert (y.float() - yp.float()).abs().max() <= 1e-2 * yp.float().abs().max()
    for k, p in zip(gn_relu.gn_apply(slabs[0], moments, sc, bi, groups, fold=True),
                    gn_relu.fold_from_stats_reference(stats, sc, bi)):
        assert _rel(k, p) <= 1e-5
    routes = 0
    for path in gn_relu.PATHS:
        try:
            want, own = gn_relu.gn_relu_forward(x, sc, bi, groups, path=path)
        except ValueError:  # the shape does not fit one cluster
            continue
        routes += 1
        assert torch.equal(gn_relu.gn_apply(x, own, sc, bi, groups), want), path
    assert routes >= 1


@pytest.mark.cuda
def test_space_two_gloo_ranks_on_one_card(cuda_device):
    """Two gloo ranks on cuda:0 split a bf16 tile batch's H axis (kernels):
    the same bits on both ranks, logits within rel L2 3e-2 of the one-rank
    kernel forward; every GroupNorm on the slab kernels (27 gn_moments, 10
    folds and 17 normalizes by gn_apply), none on gn_relu_fwd or the fold
    kernel, 14 conv3x3_gn and 4 resize3d calls."""
    from multimodal_pl_tpu_torch.tools import spawn

    kw = {"layers": (1, 1, 1, 1, 1), "base": 16, "deep_up": True}
    model = UNet3DFEAM(**kw, generator=torch.Generator().manual_seed(3)).eval()
    x = torch.randn((2, 16, 64, 32, 1), generator=torch.Generator().manual_seed(4)).to(
        torch.bfloat16)
    ranks = spawn.run(spawn.sp_forward, 2, kw, model.state_dict(), x, "cuda:0", timeout=300)
    with torch.inference_mode():
        want = model.to(cuda_device)(x.to(cuda_device), aux=False).float().cpu()
    assert torch.equal(ranks[0][0], ranks[1][0])
    assert _rel(ranks[0][0].float(), want) <= 3e-2
    for _, launches, _ in ranks:
        # layers (1, 1, 1, 1, 1): 10 folds (5 stride-1 blocks), 17 GN -> ReLU
        assert sum(launches["gn_moments"].values()) == 10 + 17
        modes = {m: sum(n for k, n in launches["gn_apply"].items() if k[0] == m)
                 for m in ("fold", "relu")}
        assert modes == {"fold": 10, "relu": 17}
        assert sum(launches["gn_relu"].values()) == sum(launches["fold"].values()) == 0
        assert sum(launches["conv3x3"].values()) == 14 and sum(launches["resize"].values()) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,groups", [((1, 8, 6, 16), 32, 16), ((1, 4, 4, 12), 256, 16),
                                            ((11, 4, 6, 8), 24, 4), ((1, 16, 48, 96), 32, 16)])
def test_gn_bwd_slab_entry_points_match_plain(cuda_device, shape, c, groups):
    """The slab backward's two kernels (gn_bwd_sums_bf16, gn_bwd_dx_bf16)
    vs their plain twins on one slab of two, from the slabs' moments: the
    sums and ds, dt within rel 1e-3, dx within 1e-2 * max|plain|; and on a
    whole sample (its own sums, gn_relu_fwd_bf16's statistics) they give
    gn_relu_bwd_bf16's grid route bit for bit."""
    g = torch.Generator().manual_seed(1)
    x = (torch.randn((*shape, c), generator=g) * 2 + 1).to(cuda_device, torch.bfloat16)
    dy = torch.randn((*shape, c), generator=g).to(cuda_device, torch.bfloat16)
    sc = (1 + 0.1 * torch.randn(c, generator=g)).to(cuda_device)
    bi = (0.1 * torch.randn(c, generator=g)).to(cuda_device)
    slabs, dys = ([t.contiguous() for t in v.chunk(2, dim=2)] for v in (x, dy))
    moments = torch.stack([gn_relu.gn_moments(s, groups) for s in slabs])
    count = slabs[0].numel() // (shape[0] * groups)
    stats_p = gn_relu.merge_moments_reference(moments, float(count))
    parts = [gn_relu.gn_bwd_sums(s, d, moments, sc, bi, groups) for s, d in zip(slabs, dys)]
    sums_p = [gn_relu.gn_bwd_sums_reference(s, d, sc, bi, stats_p) for s, d in zip(slabs, dys)]
    for (_, k), p in zip(parts, sums_p):
        assert _rel(k, p) <= 1e-3
    total, total_p = parts[0][1] + parts[1][1], sums_p[0] + sums_p[1]
    dx, ds, dt = gn_relu.gn_bwd_dx(slabs[0], dys[0], parts[0][0], sc, bi, parts[0][1], total,
                                   groups, 2 * count)
    dxp, dsp, dtp = gn_relu.gn_bwd_dx_reference(slabs[0], dys[0], sc, bi, stats_p, sums_p[0],
                                                total_p, 2 * count)
    assert (dx.float() - dxp.float()).abs().max() <= 1e-2 * dxp.float().abs().max()
    assert _rel(ds, dsp) <= 1e-3 and _rel(dt, dtp) <= 1e-3
    _, own = gn_relu.gn_relu_forward(x, sc, bi, groups, path="grid")
    want = gn_relu.gn_relu_backward(x, dy, sc, bi, own, groups, path="grid")
    stats, sums = gn_relu.gn_bwd_sums(x, dy, own, sc, bi, groups)
    assert torch.equal(stats, own)
    got = gn_relu.gn_bwd_dx(x, dy, stats, sc, bi, sums, sums, groups, 2 * count)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# the spatial step's eight slab shapes (C, groups, D, H, W): rank 0 of 2 at
# B = 1 x 64 x 192 x 192, 35 gn_bwd_sums calls per step
SLAB_SHAPES = [(32, 16, 64, 96, 192), (64, 16, 32, 48, 96), (128, 16, 16, 24, 48),
               (256, 16, 8, 12, 24), (256, 16, 4, 6, 12), (128, 16, 8, 12, 24),
               (64, 16, 16, 24, 48), (32, 16, 32, 48, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,groups,d,h,w", SLAB_SHAPES)
def test_gn_bwd_sums_one_launch_at_the_slab_shapes(cuda_device, c, groups, d, h, w):
    """gn_bwd_sums_bf16 at each slab shape of the spatial step: its sums
    and statistics against the plain twin (from two slabs' moments), and on
    a whole sample (the forward's statistics) with gn_bwd_dx_bf16
    gn_relu_bwd_bf16's grid route bit for bit, on either of its routes: one
    launch where sums_plan puts the sample's blocks in one cluster (the
    4 x 6 x 12 slab), two elsewhere."""
    g = torch.Generator().manual_seed(3)
    x = (torch.randn((1, d, h, w, c), generator=g) * 2 + 1).to(cuda_device, torch.bfloat16)
    dy = torch.randn((1, d, h, w, c), generator=g).to(cuda_device, torch.bfloat16)
    other = (torch.randn((1, d, h, w, c), generator=g) * 2 + 1).to(cuda_device, torch.bfloat16)
    sc = (1 + 0.1 * torch.randn(c, generator=g)).to(cuda_device)
    bi = (0.1 * torch.randn(c, generator=g)).to(cuda_device)
    moments = torch.stack([gn_relu.gn_moments(t, groups) for t in (x, other)])
    stats_p = gn_relu.merge_moments_reference(moments, float(d * h * w * (c // groups)))
    stats, sums = gn_relu.gn_bwd_sums(x, dy, moments, sc, bi, groups)
    assert _rel(stats, stats_p) <= 1e-5
    assert _rel(sums, gn_relu.gn_bwd_sums_reference(x, dy, sc, bi, stats_p)) <= 1e-3
    _, own = gn_relu.gn_relu_forward(x, sc, bi, groups, path="grid")
    want = gn_relu.gn_relu_backward(x, dy, sc, bi, own, groups, path="grid")
    stats, sums = gn_relu.gn_bwd_sums(x, dy, own, sc, bi, groups)
    got = gn_relu.gn_bwd_dx(x, dy, stats, sc, bi, sums, sums, groups, d * h * w * (c // groups))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cluster = gn_relu.sums_plan(1, d * h * w, c,
                                gn_relu.limits(cuda_device.index or 0).stats_clusters[1])[2]
    assert cluster == (gn_relu.STATS_CLUSTER if (d, h, w) == (4, 6, 12) else 0)


@pytest.mark.cuda
def test_spatial_step_two_gloo_ranks_on_one_card(cuda_device):
    """The spatial train step on two gloo ranks on cuda:0 (bf16, kernels,
    a 32 x 64 x 32 patch, tiny_step_config): both ranks' new states bit-equal,
    the loss within rel 3e-2 of the one-rank kernel step's; every segmenter
    GroupNorm -> ReLU on the slab kernels forward (gn_moments, gn_apply) and
    backward (gn_bwd_sums, gn_bwd_dx, as many), the refiner's on the unsplit
    ones."""
    from multimodal_pl_tpu_torch.tools import spawn
    from multimodal_pl_tpu_torch.train.state import (
        build_models,
        create_train_state,
        tiny_step_config,
    )
    from multimodal_pl_tpu_torch.train.step import make_train_step

    cfg = tiny_step_config(compute_dtype=torch.bfloat16)
    p = (32, 64, 32)
    g = torch.Generator().manual_seed(2)
    batch = {"image": torch.randn((1, *p, 1), generator=g).to(torch.bfloat16),
             "label": torch.randint(0, 14, (1, *p), generator=g).to(torch.uint8),
             "catlas": torch.rand((13, *p), generator=g).to(torch.bfloat16),
             "sup_mask": torch.tensor([0.0] * 5 + [1.0] + [0.0] * 8),
             "label_t": torch.tensor([0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1.0])}
    state = create_train_state(torch.Generator().manual_seed(0), cfg)
    ranks = spawn.run(spawn.sp_step, 2, cfg, state, batch, 5e-4, 0.05, "cuda:0", timeout=300)
    (s0, m0, calls, _), (s1, _, _, _) = ranks
    assert spawn.states_unequal(s0, s1) == []
    step = make_train_step(*(m.to(cuda_device) for m in build_models(cfg)), cfg)
    _, m = step(state.to(cuda_device), {k: v.to(cuda_device) for k, v in batch.items()},
                torch.tensor(5e-4, device=cuda_device), torch.tensor(0.05, device=cuda_device))
    assert abs(m0["loss"] - float(m["loss"])) <= 3e-2 * abs(float(m["loss"]))
    sums, dxs = (sum(calls[k].values()) for k in ("gn_bwd_sums", "gn_bwd_dx"))
    relu = sum(n for k, n in calls["gn_apply"].items() if k[0] == "relu")
    assert sums == dxs == relu == sum(calls["gn_moments"].values()) > 0
    assert sum(calls["gn_relu_backward"].values()) > 0  # the refiner's, unsplit


@pytest.mark.cuda
def test_ladder_full_rung_on_the_card_is_train_step(cuda_device):
    """tools/step_ablate.py: the full rung of the ladder against TrainStep on
    the kernels, tiny_step_config, bf16, B = 2, the ladder's batch with organ
    5 supervised: every tensor of the new state bit for bit (the step is
    deterministic on the card), and the launches of the hand-written kernels
    do not rise down the ladder."""
    from multimodal_pl_tpu_torch.tools import step_ablate
    from multimodal_pl_tpu_torch.train.loop import to_device
    from multimodal_pl_tpu_torch.train.state import (
        build_models, create_train_state, tiny_step_config)
    from multimodal_pl_tpu_torch.train.step import TrainStep

    cfg = tiny_step_config(compute_dtype=torch.bfloat16)
    host = step_ablate.ladder_batch((32, 32, 32), 2)
    host["sup_mask"] = np.eye(14, dtype=np.float32)[5]
    batch = to_device(host, cfg, cuda_device)
    models = tuple(m.to(cuda_device) for m in build_models(cfg))
    state = create_train_state(torch.Generator().manual_seed(0), cfg).to(cuda_device)
    lr, wf = torch.tensor(5e-4, device=cuda_device), torch.tensor(0.05, device=cuda_device)
    got, m = step_ablate.AblatedStep(*models, cfg)(state, batch, lr, wf)
    want, wm = TrainStep(*models, cfg)(state, batch, lr, wf)
    for group in ("params", "rparams", "dparams", "tokens"):
        a, b = getattr(got, group), getattr(want, group)
        assert all(torch.equal(a[k], b[k]) for k in b), group
    for i in range(2):
        assert all(torch.equal(got.momentum[i][k], want.momentum[i][k]) for k in want.momentum[i])
    assert torch.equal(m["loss"], wm["loss"]) and float(wm["refine_loss"]) > 0
    calls = []
    for _, kw in step_ablate.RUNGS:
        before = step_ablate.kernel_calls()
        step_ablate.AblatedStep(*models, cfg, **kw)(state, batch, lr, wf)
        calls.append(sum(step_ablate.kernel_calls().values()) - sum(before.values()))
    assert calls[0] > 0 and calls == sorted(calls, reverse=True), calls

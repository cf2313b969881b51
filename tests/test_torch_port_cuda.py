"""The CUDA kernels (conv3x3_gn, conv3x3_train, gn_relu) against their plain
PyTorch versions on the GPU, and the model's gradients on the card.

These tests need an NVIDIA GPU (the kernel has no CPU mode) and skip
without one. The file imports no JAX, so it also runs where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_port_cuda.py``.
"""

import pytest
import torch

from multimodal_pl_tpu_torch.models import UNet3DFEAM
from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu
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
    """Forward: the same one-pass formula; the statistics' summation order
    differs, so max|k - p| <= 1e-2 * max|p| (bf16 output rounding). The
    backward is the same recompute on both sides."""
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
    gp = torch.autograd.grad(p, (x, sc, bi), r)
    for a, b in zip(gk, gp):
        assert torch.equal(a, b)


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

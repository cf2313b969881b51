"""The conv3x3_gn CUDA kernel against its plain PyTorch version on the GPU.

These tests need an NVIDIA GPU (the kernel has no CPU mode) and skip
without one. The file imports no JAX, so it also runs where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_port_cuda.py``.
"""

import pytest
import torch

from multimodal_pl_tpu_torch.ops import conv3x3
from multimodal_pl_tpu_torch.ops.conv3x3 import conv3x3_gn, conv3x3_gn_reference
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
                               torch.randn(cin, generator=g).to(cuda_device), 16)
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

"""Building blocks of the 3D U-Net family (channels-last), port of the voxel
classes of ``multimodal_pl_tpu/models/blocks.py``.

Parameter names follow the reference ``state_dict`` (``gn1.weight``,
``conv1.weight``, ``downsample.0.weight``, ...). Parameters are f32; each op
casts them to the activation dtype, as the JAX package does.

Routing of the 3x3x3 convs of :class:`NoBottleneck`:

- stride 1: both convs run ``conv3x3_gn`` with the previous GroupNorm folded
  into its prologue; conv2 also adds the residual in its epilogue when the
  block has no projection;
- stride 2: conv1 is the library conv (after GN -> ReLU); conv2 runs
  ``conv3x3_gn`` with the prologue off after a GN -> ReLU in torch.

``conv_impl='kernel'`` calls :func:`~multimodal_pl_tpu_torch.ops.conv3x3.conv3x3_gn`
(the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor);
``conv_impl='plain'`` calls the plain version everywhere.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from multimodal_pl_tpu_torch.ops.conv import conv3d, standardize_kernel
from multimodal_pl_tpu_torch.ops.conv3x3 import conv3x3_gn, conv3x3_gn_reference
from multimodal_pl_tpu_torch.ops.norm import group_norm, group_norm_fold

CONV_IMPLS = {"kernel": conv3x3_gn, "plain": conv3x3_gn_reference}


def conv3x3_impl(conv_impl: str):
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl must be one of {sorted(CONV_IMPLS)}, got {conv_impl!r}")
    return CONV_IMPLS[conv_impl]


@torch.no_grad()
def init_default_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initializers: conv/linear weights U(+-1/sqrt(fan_in))
    (torch's kaiming_uniform(a=sqrt(5)) default), zero biases, unit norm
    scales. Draws from ``generator`` in module order."""
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            if name == "weight" and p.ndim >= 2:
                bound = 1.0 / math.sqrt(p[0].numel())
                p.uniform_(-bound, bound, generator=generator)
            elif name == "weight":
                p.fill_(1.0)
            else:
                p.zero_()
    return module


class WSConv3d(nn.Module):
    """(Optionally weight-standardized) 3D conv — reference unet3D.py:16-35,
    torch-convention symmetric padding."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, bias: bool = False, weight_std: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.weight_std = stride, padding, weight_std

    def kernel_for(self, dtype: torch.dtype) -> torch.Tensor:
        """The kernel as the forward uses it: cast to ``dtype``, then
        standardized (f32 statistics) when weight_std."""
        w = self.weight.to(dtype)
        return standardize_kernel(w) if self.weight_std else w

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return conv3d(x, self.kernel_for(x.dtype), self.stride, self.padding, bias)


class GroupNorm(nn.Module):
    """torch-compatible GroupNorm (eps 1e-5, contiguous channel groups) with
    f32 two-pass statistics."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.num_groups, self.eps = num_groups, eps

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)

    def fold(self, x):
        """(a, b) rows (B, C) f32 with ``self(x) == x * a + b``."""
        return group_norm_fold(x, self.weight, self.bias, self.num_groups, self.eps)


class GNReLUConv(nn.Sequential):
    """GroupNorm -> ReLU -> 1x1x1 conv head (reference fusionConv / deepout /
    precls_conv / downsample: an nn.Sequential, so keys are .0 and .2)."""

    def __init__(self, cin: int, cout: int, num_groups: int = 16, stride: int = 1,
                 weight_std: bool = False, bias: bool = True):
        super().__init__(
            GroupNorm(num_groups, cin), nn.ReLU(),
            WSConv3d(cin, cout, kernel=1, stride=stride, padding=0, bias=bias,
                     weight_std=weight_std))


class NoBottleneck(nn.Module):
    """Pre-activation residual block — reference unet3D.py:40-73.

    GN -> ReLU -> conv3(s) -> GN -> ReLU -> conv3(1), plus a GN-ReLU-conv1(s)
    projection shortcut when the stride or the channel count changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, group: int = 16,
                 weight_std: bool = True, conv_impl: str = "kernel"):
        super().__init__()
        self.stride = stride
        self.gn1 = GroupNorm(group, inplanes)
        self.conv1 = WSConv3d(inplanes, planes, 3, stride, 1, weight_std=weight_std)
        self.gn2 = GroupNorm(group, planes)
        self.conv2 = WSConv3d(planes, planes, 3, 1, 1, weight_std=weight_std)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = GNReLUConv(inplanes, planes, group, stride,
                                         weight_std=weight_std, bias=False)
        self.conv3x3 = conv3x3_impl(conv_impl)

    def forward(self, x):
        x = x.contiguous()
        if self.stride == 1:
            a, b = self.gn1.fold(x)
            out = self.conv3x3(x, self.conv1.kernel_for(x.dtype), a, b)
            a, b = self.gn2.fold(out)
            res = x if self.downsample is None else None
            out = self.conv3x3(out, self.conv2.kernel_for(x.dtype), a, b, res=res)
            return out if res is not None else out + self.downsample(x)
        out = self.conv1(torch.relu(self.gn1(x)))
        out = torch.relu(self.gn2(out)).contiguous()
        out = self.conv3x3(out, self.conv2.kernel_for(x.dtype))
        return out + self.downsample(x)


class ResStage(nn.Sequential):
    """A stack of NoBottleneck blocks — reference _make_layer
    (unet3D.py:1029-1049). Only the first block strides / changes channels."""

    def __init__(self, inplanes: int, planes: int, blocks: int, stride: int = 1,
                 group: int = 16, weight_std: bool = True, conv_impl: str = "kernel"):
        super().__init__(*[
            NoBottleneck(inplanes if i == 0 else planes, planes,
                         stride if i == 0 else 1, group, weight_std, conv_impl)
            for i in range(blocks)])

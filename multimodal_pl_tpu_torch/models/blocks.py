"""Building blocks of the 3D U-Net family (channels-last), port of the voxel
classes of ``multimodal_pl_tpu/models/blocks.py``.

Parameter names follow the reference ``state_dict`` (``gn1.weight``,
``conv1.weight``, ``downsample.0.weight``, ...). Parameters are f32; each op
casts them to the activation dtype, as the JAX package does.

Routing of :class:`NoBottleneck` and :class:`GNReLUConv`, by grad mode:

- without autograd recording (inference, the train step's gradient-free
  refiner pass):
  - stride 1: both convs run ``conv3x3_gn`` with the previous GroupNorm
    folded into its prologue (the fold rows from the statistics kernel with
    ``conv_impl='kernel'``); conv2 also adds the residual in its epilogue
    when the block has no projection;
  - stride 2: conv1 is the library conv (after GN -> ReLU); conv2 runs
    ``conv3x3_gn`` with the prologue off after a GN -> ReLU in torch;
  - the heads run GN -> ReLU in torch;
- while autograd records (grad mode on and the input or a weight requires
  grad), the route the JAX package trains: every GN -> ReLU is
  ``group_norm_relu``, every stride-1 conv ``conv3x3_train``, the stride-2
  conv1 the library conv.

``conv_impl`` / ``gn_impl`` = ``'kernel'`` calls the ops that launch the
CUDA kernels on a CUDA tensor (their plain versions on a CPU tensor);
``'plain'`` calls the plain versions everywhere. The Cin=1 stem and the 1x1
heads are library convs, as XLA runs them in the JAX package.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from multimodal_pl_tpu_torch.ops.conv import conv3d, standardize_kernel
from multimodal_pl_tpu_torch.ops.conv3x3 import (
    conv3x3_gn,
    conv3x3_gn_reference,
    conv3x3_train,
)
from multimodal_pl_tpu_torch.ops.gn_relu import IMPLS as GN_IMPLS
from multimodal_pl_tpu_torch.ops.gn_relu import group_norm_relu
from multimodal_pl_tpu_torch.ops.norm import group_norm, group_norm_fold

# stride-1 3x3x3 convs without and with autograd recording
CONV_IMPLS = {"kernel": conv3x3_gn, "plain": conv3x3_gn_reference}
TRAIN_CONV_IMPLS = {"kernel": conv3x3_train, "plain": conv3x3_gn_reference}


def conv3x3_impl(conv_impl: str):
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl must be one of {sorted(CONV_IMPLS)}, got {conv_impl!r}")
    return CONV_IMPLS[conv_impl]


def check_gn_impl(gn_impl: str) -> str:
    if gn_impl not in GN_IMPLS:
        raise ValueError(f"gn_impl must be one of {GN_IMPLS}, got {gn_impl!r}")
    return gn_impl


def recording(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Autograd records this op: grad mode on and x or the weight needs grad."""
    return torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad)


def conv3x3_s1(x: torch.Tensor, w: torch.Tensor, conv_impl: str) -> torch.Tensor:
    """Stride-1 3x3x3 SAME conv outside a residual block (the refiner's conv1):
    ``conv3x3_train`` while autograd records, else ``conv3x3_gn`` with the
    prologue off."""
    table = TRAIN_CONV_IMPLS if recording(x, w) else CONV_IMPLS
    return table[conv_impl](x.contiguous(), w)


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

    def fold(self, x, impl: str):
        """(a, b) rows (B, C) f32 with ``self(x) == x * a + b``; impl='kernel'
        computes them with the statistics kernel on a CUDA tensor
        (:func:`~multimodal_pl_tpu_torch.ops.norm.group_norm_fold`)."""
        return group_norm_fold(x, self.weight, self.bias, self.num_groups, self.eps, impl)

    def relu(self, x, gn_impl: str):
        """relu(self(x)) through :func:`~multimodal_pl_tpu_torch.ops.gn_relu.group_norm_relu`
        (eps 1e-5, the kernel's)."""
        return group_norm_relu(x, self.weight, self.bias, self.num_groups, gn_impl)


class GNReLUConv(nn.Sequential):
    """GroupNorm -> ReLU -> 1x1x1 conv head (reference fusionConv / deepout /
    precls_conv / downsample: an nn.Sequential, so keys are .0 and .2). While
    autograd records, the GN -> ReLU is ``group_norm_relu``."""

    def __init__(self, cin: int, cout: int, num_groups: int = 16, stride: int = 1,
                 weight_std: bool = False, bias: bool = True, gn_impl: str = "kernel"):
        super().__init__(
            GroupNorm(num_groups, cin), nn.ReLU(),
            WSConv3d(cin, cout, kernel=1, stride=stride, padding=0, bias=bias,
                     weight_std=weight_std))
        self.gn_impl = check_gn_impl(gn_impl)

    def forward(self, x):
        gn, relu, conv = self
        if recording(x, gn.weight):
            return conv(gn.relu(x, self.gn_impl))
        return conv(relu(gn(x)))


class NoBottleneck(nn.Module):
    """Pre-activation residual block — reference unet3D.py:40-73.

    GN -> ReLU -> conv3(s) -> GN -> ReLU -> conv3(1), plus a GN-ReLU-conv1(s)
    projection shortcut when the stride or the channel count changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, group: int = 16,
                 weight_std: bool = True, conv_impl: str = "kernel",
                 gn_impl: str = "kernel"):
        super().__init__()
        self.stride = stride
        self.gn1 = GroupNorm(group, inplanes)
        self.conv1 = WSConv3d(inplanes, planes, 3, stride, 1, weight_std=weight_std)
        self.gn2 = GroupNorm(group, planes)
        self.conv2 = WSConv3d(planes, planes, 3, 1, 1, weight_std=weight_std)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = GNReLUConv(inplanes, planes, group, stride,
                                         weight_std=weight_std, bias=False, gn_impl=gn_impl)
        self.conv3x3 = conv3x3_impl(conv_impl)
        self.conv_impl = conv_impl
        self.conv3x3_train = TRAIN_CONV_IMPLS[conv_impl]
        self.gn_impl = check_gn_impl(gn_impl)

    def forward(self, x):
        x = x.contiguous()
        if recording(x, self.conv2.weight):
            return self._train_forward(x)
        if self.stride == 1:
            a, b = self.gn1.fold(x, self.conv_impl)
            out = self.conv3x3(x, self.conv1.kernel_for(x.dtype), a, b)
            a, b = self.gn2.fold(out, self.conv_impl)
            res = x if self.downsample is None else None
            out = self.conv3x3(out, self.conv2.kernel_for(x.dtype), a, b, res=res)
            return out if res is not None else out + self.downsample(x)
        out = self.conv1(torch.relu(self.gn1(x)))
        out = torch.relu(self.gn2(out)).contiguous()
        out = self.conv3x3(out, self.conv2.kernel_for(x.dtype))
        return out + self.downsample(x)

    def _train_forward(self, x):
        """The voxel route of the JAX NoBottleneck (models/blocks.py:183-202)."""
        out = self.gn1.relu(x, self.gn_impl)
        if self.stride == 1:
            out = self.conv3x3_train(out, self.conv1.kernel_for(x.dtype))
        else:
            out = self.conv1(out)
        out = self.gn2.relu(out, self.gn_impl)
        out = self.conv3x3_train(out, self.conv2.kernel_for(x.dtype))
        return out + (x if self.downsample is None else self.downsample(x))


class ResStage(nn.Sequential):
    """A stack of NoBottleneck blocks — reference _make_layer
    (unet3D.py:1029-1049). Only the first block strides / changes channels."""

    def __init__(self, inplanes: int, planes: int, blocks: int, stride: int = 1,
                 group: int = 16, weight_std: bool = True, conv_impl: str = "kernel",
                 gn_impl: str = "kernel"):
        super().__init__(*[
            NoBottleneck(inplanes if i == 0 else planes, planes,
                         stride if i == 0 else 1, group, weight_std, conv_impl, gn_impl)
            for i in range(blocks)])

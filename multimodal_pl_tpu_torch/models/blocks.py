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
  - stride 2: conv1 is the library conv after ``group_norm_relu``; conv2
    runs ``conv3x3_gn`` with the prologue off after ``group_norm_relu``;
  - the heads and projections run ``group_norm_relu`` before their 1x1 conv;
- while autograd records (grad mode on and the input or a weight requires
  grad), the route the JAX package trains: every GN -> ReLU is
  ``group_norm_relu``, every stride-1 conv ``conv3x3_train``, the stride-2
  conv1 the library conv.

``conv_impl`` / ``gn_impl`` = ``'kernel'`` calls the ops that launch the
CUDA kernels on a CUDA tensor (their plain versions on a CPU tensor);
``'plain'`` calls the plain versions everywhere. The Cin=1 stem and the 1x1
heads are library convs, as XLA runs them in the JAX package.

``space`` (a :class:`multimodal_pl_tpu_torch.parallel.spatial.SpatialGroup`
of more than one rank, or None) splits each sample's H axis over the ranks
of a group, on either route: every 3x3x3 conv runs on the slab with its
neighbours' boundary rows attached and is cropped back to the slab's rows
(a stride-1 conv attaches one row each side and none at a global edge, where
its own zero padding is the right one; a stride-2 conv one row below, zero at
the edge, and pads H by nothing); every GroupNorm takes the whole samples'
statistics (the slabs' moments gathered and merged). The residual of a
fused block is the halo-extended input. The halo, the crop and the
GroupNorm -> ReLU carry their gradients across the slabs, so the training
route differentiates through the split. A group of one rank is no split.
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
from multimodal_pl_tpu_torch.ops.norm import group_norm, group_norm_fold, split

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
                 padding: int = 1, bias: bool = False, weight_std: bool = True, space=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.weight_std = stride, padding, weight_std
        self.space = space

    def kernel_for(self, dtype: torch.dtype) -> torch.Tensor:
        """The kernel as the forward uses it: cast to ``dtype``, then
        standardized (f32 statistics) when weight_std."""
        w = self.weight.to(dtype)
        return standardize_kernel(w) if self.weight_std else w

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        w = self.kernel_for(x.dtype)
        if not split(self.space) or w.shape[2] == 1:
            return conv3d(x, w, self.stride, self.padding, bias)
        if self.stride == 1:
            ext, lo = self.space.halo_rows(x, 1, 1)
            return self.space.crop_rows(conv3d(ext, w, 1, self.padding, bias), lo, x.shape[2])
        if (w.shape[2], self.stride, self.padding) != (3, 2, 1):
            raise NotImplementedError(f"H-split conv: kernel {w.shape[2]}, stride {self.stride}")
        ext, _ = self.space.halo_rows(x, 1, 0, "zero")
        return conv3d(ext, w, 2, (1, 0, 1), bias)


class GroupNorm(nn.Module):
    """torch-compatible GroupNorm (eps 1e-5, contiguous channel groups) with
    f32 two-pass statistics."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5, space=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.num_groups, self.eps, self.space = num_groups, eps, space

    def forward(self, x):
        if split(self.space):
            raise NotImplementedError("GroupNorm without the ReLU or the fold is not H-split "
                                      "(ROADMAP.md queue 1)")
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)

    def fold(self, x, impl: str):
        """(a, b) rows (B, C) f32 with ``self(x) == x * a + b``; impl='kernel'
        computes them with the statistics kernel on a CUDA tensor
        (:func:`~multimodal_pl_tpu_torch.ops.norm.group_norm_fold`)."""
        return group_norm_fold(x, self.weight, self.bias, self.num_groups, self.eps, impl,
                               self.space)

    def relu(self, x, gn_impl: str):
        """relu(self(x)) through :func:`~multimodal_pl_tpu_torch.ops.gn_relu.group_norm_relu`
        (eps 1e-5, the kernel's)."""
        return group_norm_relu(x, self.weight, self.bias, self.num_groups, gn_impl, self.space)


class GNReLUConv(nn.Sequential):
    """GroupNorm -> ReLU -> 1x1x1 conv head (reference fusionConv / deepout /
    precls_conv / downsample: an nn.Sequential, so keys are .0 and .2). The
    GN -> ReLU is ``group_norm_relu`` (its kernel with gn_impl='kernel' on a
    CUDA tensor, with or without autograd)."""

    def __init__(self, cin: int, cout: int, num_groups: int = 16, stride: int = 1,
                 weight_std: bool = False, bias: bool = True, gn_impl: str = "kernel",
                 space=None):
        super().__init__(
            GroupNorm(num_groups, cin, space=space), nn.ReLU(),
            WSConv3d(cin, cout, kernel=1, stride=stride, padding=0, bias=bias,
                     weight_std=weight_std, space=space))
        self.gn_impl = check_gn_impl(gn_impl)

    def forward(self, x):
        gn, _, conv = self
        return conv(gn.relu(x, self.gn_impl))


class NoBottleneck(nn.Module):
    """Pre-activation residual block — reference unet3D.py:40-73.

    GN -> ReLU -> conv3(s) -> GN -> ReLU -> conv3(1), plus a GN-ReLU-conv1(s)
    projection shortcut when the stride or the channel count changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, group: int = 16,
                 weight_std: bool = True, conv_impl: str = "kernel",
                 gn_impl: str = "kernel", space=None):
        super().__init__()
        self.stride, self.space = stride, space
        self.gn1 = GroupNorm(group, inplanes, space=space)
        self.conv1 = WSConv3d(inplanes, planes, 3, stride, 1, weight_std=weight_std, space=space)
        self.gn2 = GroupNorm(group, planes, space=space)
        self.conv2 = WSConv3d(planes, planes, 3, 1, 1, weight_std=weight_std, space=space)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = GNReLUConv(inplanes, planes, group, stride,
                                         weight_std=weight_std, bias=False, gn_impl=gn_impl,
                                         space=space)
        self.conv3x3 = conv3x3_impl(conv_impl)
        self.conv_impl = conv_impl
        self.conv3x3_train = TRAIN_CONV_IMPLS[conv_impl]
        self.gn_impl = check_gn_impl(gn_impl)

    def forward(self, x):
        x = x.contiguous()
        if recording(x, self.conv2.weight):
            return self._train_forward(x)
        h = x.shape[2]
        if self.stride == 1:
            a, b = self.gn1.fold(x, self.conv_impl)
            xe, lo = self._halo(x)
            out = self._crop(self.conv3x3(xe, self.conv1.kernel_for(x.dtype), a, b), lo, h)
            a, b = self.gn2.fold(out, self.conv_impl)
            res = xe if self.downsample is None else None
            oe, _ = self._halo(out)
            out = self._crop(self.conv3x3(oe, self.conv2.kernel_for(x.dtype), a, b, res=res),
                             lo, h)
            return out if res is not None else out + self.downsample(x)
        out = self.conv1(self.gn1.relu(x, self.gn_impl))
        out = self.gn2.relu(out, self.gn_impl)
        oe, lo = self._halo(out)
        out = self._crop(self.conv3x3(oe, self.conv2.kernel_for(x.dtype)), lo, out.shape[2])
        return out + self.downsample(x)

    def _halo(self, x):
        """x with one neighbour row each side under an H split (none at a
        global edge), and the rows attached below; else (x, 0)."""
        return self.space.halo_rows(x, 1, 1) if split(self.space) else (x, 0)

    def _crop(self, y, lo: int, rows: int):
        return self.space.crop_rows(y, lo, rows) if split(self.space) else y

    def _train_forward(self, x):
        """The voxel route of the JAX NoBottleneck (models/blocks.py:183-202);
        under a split each stride-1 conv runs on the halo-extended slab."""
        out = self.gn1.relu(x, self.gn_impl)
        if self.stride == 1:
            out = self._conv3x3_train(out, self.conv1.kernel_for(x.dtype))
        else:
            out = self.conv1(out)
        out = self.gn2.relu(out, self.gn_impl)
        out = self._conv3x3_train(out, self.conv2.kernel_for(x.dtype))
        return out + (x if self.downsample is None else self.downsample(x))

    def _conv3x3_train(self, x, w):
        xe, lo = self._halo(x)
        return self._crop(self.conv3x3_train(xe, w), lo, x.shape[2])


class ResStage(nn.Sequential):
    """A stack of NoBottleneck blocks — reference _make_layer
    (unet3D.py:1029-1049). Only the first block strides / changes channels."""

    def __init__(self, inplanes: int, planes: int, blocks: int, stride: int = 1,
                 group: int = 16, weight_std: bool = True, conv_impl: str = "kernel",
                 gn_impl: str = "kernel", space=None):
        super().__init__(*[
            NoBottleneck(inplanes if i == 0 else planes, planes,
                         stride if i == 0 else 1, group, weight_std, conv_impl, gn_impl, space)
            for i in range(blocks)])

"""Modality (CT vs MRI) style discriminators, port of
``multimodal_pl_tpu/models/discriminator.py`` (reference
unet3D.py:1814-1956).

Stride-2 k4 p1 Conv3d + LeakyReLU(0.2) pyramids over (organ probability,
atlas) channel pairs, a global mean pool and a Linear head (two logits; one
for :class:`StyleDiscriminatorOutput`); :class:`StyleDiscriminatorLinear`
is three Linears with LeakyReLU between them. The JAX package runs these
convs in XLA, so here they are library convs. Layer names follow the JAX
modules (``block1``, ``block2``, ``block3``, ``block4a``, ..., ``head``,
``fc1-3``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_pl_tpu_torch.models.blocks import WSConv3d, init_default_
from multimodal_pl_tpu_torch.models.eam import _linear


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _conv(cin: int, cout: int, kernel: int = 4, stride: int = 2) -> WSConv3d:
    return WSConv3d(cin, cout, kernel, stride, 1, bias=True, weight_std=False)


def _voxels(x):
    """A (B, D, H, W, C) tensor, or C planes (B, D, H, W) stacked last."""
    return torch.stack(list(x), dim=-1) if isinstance(x, (tuple, list)) else x


class NormStyleDiscriminator(nn.Module):
    """depth = number of stride-2 convs (reference: 6, which needs a patch
    edge of at least 2**(depth-1))."""

    def __init__(self, ndf: int = 32, depth: int = 6, in_channel: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.names = [f"block{i + 1}" if i < 3 else "block4" + "abcdefg"[i - 3]
                      for i in range(depth)]
        chans = [in_channel] + [ndf * min(2 ** i, 8) for i in range(depth)]
        for i, name in enumerate(self.names):
            self.add_module(name, _conv(chans[i], chans[i + 1]))
        self.head = nn.Linear(chans[-1], 2)
        init_default_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x):
        x = _voxels(x)
        for name in self.names:
            x = _lrelu(getattr(self, name)(x))
        return _linear(self.head, x.mean(dim=(1, 2, 3)))


class DeepStyleDiscriminator(nn.Module):
    """The pyramid also consumes the three per-scale attention maps through
    3x3x3 stride-1 ``min_block`` convs."""

    def __init__(self, ndf: int = 32, in_channel: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.block1 = _conv(in_channel, ndf)
        self.min_block1 = _conv(1, ndf, 3, 1)
        self.block2 = _conv(ndf * 2, ndf * 2)
        self.min_block2 = _conv(1, ndf * 2, 3, 1)
        self.block3 = _conv(ndf * 4, ndf * 4)
        self.min_block3 = _conv(1, ndf * 4, 3, 1)
        self.block4a = _conv(ndf * 8, ndf * 8)
        self.block4b = _conv(ndf * 8, ndf * 8)
        self.block4c = _conv(ndf * 8, ndf * 8)
        self.head = nn.Linear(ndf * 8, 2)
        init_default_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x, attn_maps: Sequence[torch.Tensor]):
        """attn_maps: [scale 8, scale 4, scale 2] single-channel maps
        (B, d, h, w, 1)."""
        x = _lrelu(self.block1(_voxels(x)))
        x = torch.cat([x, _lrelu(self.min_block1(attn_maps[2]))], -1)
        x = _lrelu(self.block2(x))
        x = torch.cat([x, _lrelu(self.min_block2(attn_maps[1]))], -1)
        x = _lrelu(self.block3(x))
        x = torch.cat([x, _lrelu(self.min_block3(attn_maps[0]))], -1)
        for block in (self.block4a, self.block4b, self.block4c):
            x = _lrelu(block(x))
        return _linear(self.head, x.mean(dim=(1, 2, 3)))


class StyleDiscriminatorOutput(NormStyleDiscriminator):
    """get_style_discriminator_output (unet3D.py:1832-1849): the depth-6
    pyramid of NormStyleDiscriminator (ndf, 2, 4, 8, 8, 8 x ndf), a mean pool
    and one logit."""

    def __init__(self, ndf: int = 32, in_channel: int = 2,
                 generator: torch.Generator | None = None):
        generator = generator or torch.Generator().manual_seed(0)
        super().__init__(ndf, 6, in_channel, generator)
        self.head = init_default_(nn.Linear(ndf * 8, 1), generator)


class StyleDiscriminatorLinear(nn.Module):
    """get_style_discriminator_linear (unet3D.py:1950-1956): Linear(in,
    ndf) -> LeakyReLU -> Linear(ndf, 2 ndf) -> LeakyReLU -> Linear(2 ndf, 1)
    over the last axis."""

    def __init__(self, in_features: int, ndf: int = 64,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, ndf)
        self.fc2 = nn.Linear(ndf, ndf * 2)
        self.fc3 = nn.Linear(ndf * 2, 1)
        init_default_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x):
        x = _lrelu(_linear(self.fc1, x))
        x = _lrelu(_linear(self.fc2, x))
        return _linear(self.fc3, x)

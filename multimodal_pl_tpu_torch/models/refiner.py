"""The lightweight refiner U-Net, port of the voxel path of
``multimodal_pl_tpu/models/refiner.py:57-123`` (reference unet3D_g,
unet3D.py:1507-1623).

It turns (per-organ probability, atlas) channel pairs into binary
pseudo-label logits. It runs at half resolution: a stride-2 stem (conv0) and
a final x2 trilinear upsample of the logits. GroupNorm groups are 4 in the
residual stages, init_filter // 2 in the fusion head and init_filter // 4 in
the classifier head. Parameter names are the reference ``state_dict``'s
(``conv0``, ``conv1``, ``layer0-4``, ``fusionConv``, ``x*_resb``,
``precls_conv``), the layout ``train/torch_import.py`` maps.

The routing by grad mode is :mod:`multimodal_pl_tpu_torch.models.blocks`'s;
the stride-1 conv1 runs ``conv3x3_train`` while autograd records and
``conv3x3_gn`` with the prologue off otherwise. ``conv_impl`` also routes
the five x2 upsamples (four with their skip added) to the resize kernels.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from multimodal_pl_tpu_torch.models.blocks import (
    GNReLUConv,
    ResStage,
    WSConv3d,
    conv3x3_impl,
    conv3x3_s1,
    init_default_,
)
from multimodal_pl_tpu_torch.ops.resize import upsample_trilinear


class RefinerUNet3D(nn.Module):
    def __init__(self, layers: Sequence[int] = (1, 1, 1, 1, 1), num_classes: int = 2,
                 weight_std: bool = True, init_filter: int = 24, in_channel: int = 2,
                 conv_impl: str = "kernel", gn_impl: str = "kernel",
                 generator: torch.Generator | None = None):
        super().__init__()
        f, ws = init_filter, weight_std
        conv3x3_impl(conv_impl)
        self.conv_impl = conv_impl

        def stage(cin, cout, blocks, stride):
            return ResStage(cin, cout, blocks, stride, group=4, weight_std=ws,
                            conv_impl=conv_impl, gn_impl=gn_impl)

        self.conv0 = WSConv3d(in_channel, f, 3, 2, 1, weight_std=ws)
        self.conv1 = WSConv3d(f, f, 3, 1, 1, weight_std=ws)
        self.layer0 = stage(f, f, layers[0], 1)
        self.layer1 = stage(f, f * 2, layers[1], 2)
        self.layer2 = stage(f * 2, f * 4, layers[2], 2)
        self.layer3 = stage(f * 4, f * 8, layers[3], 2)
        self.layer4 = stage(f * 8, f * 8, layers[4], 2)
        self.fusionConv = GNReLUConv(f * 8, f * 8, f // 2, weight_std=ws, bias=False,
                                     gn_impl=gn_impl)
        self.x8_resb = stage(f * 8, f * 4, 1, 1)
        self.x4_resb = stage(f * 4, f * 2, 1, 1)
        self.x2_resb = stage(f * 2, f, 1, 1)
        self.x1_resb = stage(f, f, 1, 1)
        self.precls_conv = GNReLUConv(f, num_classes, f // 4, gn_impl=gn_impl)
        init_default_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x):
        """x: (B, D, H, W, in_channel), or a tuple of in_channel planes
        (B, D, H, W) with D, H, W multiples of 32. Returns logits
        (B, D, H, W, num_classes)."""
        if isinstance(x, (tuple, list)):
            x = torch.stack(list(x), dim=-1)
        x = self.conv0(x)
        x = conv3x3_s1(x, self.conv1.kernel_for(x.dtype), self.conv_impl)
        skip0 = x = self.layer0(x)
        skip1 = x = self.layer1(x)
        skip2 = x = self.layer2(x)
        skip3 = x = self.layer3(x)
        x = self.fusionConv(self.layer4(x))
        impl = self.conv_impl
        x = self.x8_resb(upsample_trilinear(x, 2, skip3, impl))
        x = self.x4_resb(upsample_trilinear(x, 2, skip2, impl))
        x = self.x2_resb(upsample_trilinear(x, 2, skip1, impl))
        x = self.x1_resb(upsample_trilinear(x, 2, skip0, impl))
        return upsample_trilinear(self.precls_conv(x), 2, impl=impl)

"""The flagship FEAM segmenter, port of ``UNet3DFEAM`` and ``Encoder`` of
``multimodal_pl_tpu/models/unet3d.py`` (voxel branch; reference
``unet3D_with_feam3``, unet3D.py:938-1190).

Structure (layers=(1,2,2,2,2), base=32): conv1 1->32; encoder stages
32,64,128,256,256 (stride 2 from stage 1); GN-ReLU-1x1 fusion; decoder: x2
trilinear upsample + additive skip + a 1-block stage at 128/64/32/32;
deep-supervision heads and EAMs at the first three decoder scales; a
GN-ReLU-1x1 classifier.

``forward(x, tokens, aux=True)`` returns ``(logits, attn_maps, deep_maps,
features, tokens)`` as the JAX model does. ``aux=False`` returns only the
logits and skips the EAMs, the deep heads and the full-resolution resizes of
the attention maps: none of them feeds the logits, and eager PyTorch has no
dead-code elimination to drop them as XLA does under ``jit``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from multimodal_pl_tpu_torch.models.blocks import (
    GNReLUConv,
    ResStage,
    WSConv3d,
    init_default_,
)
from multimodal_pl_tpu_torch.models.eam import EAM, attn_to_map
from multimodal_pl_tpu_torch.ops.resize import resize_trilinear, upsample_trilinear


class UNet3DFEAM(nn.Module):
    """FEAM segmenter with ``token_update='post'`` (feam3): tokens are
    consumed detached and returned unchanged; the caller updates them."""

    def __init__(self, layers: Sequence[int] = (1, 2, 2, 2, 2), num_classes: int = 14,
                 weight_std: bool = True, use_cm: Sequence[bool] = (True, True, True),
                 deep_up: bool = False, base: int = 32, token_update: str = "post",
                 conv_impl: str = "kernel", generator: torch.Generator | None = None):
        super().__init__()
        if token_update != "post":
            raise NotImplementedError(
                f"token_update={token_update!r}: only 'post' (feam3) is ported")
        b, nc, ws = base, num_classes, weight_std
        self.num_classes, self.use_cm, self.deep_up = nc, tuple(use_cm), deep_up

        def stage(cin, cout, blocks, stride):
            return ResStage(cin, cout, blocks, stride, weight_std=ws, conv_impl=conv_impl)

        self.conv1 = WSConv3d(1, b, 3, 1, 1, weight_std=ws)
        self.layer0 = stage(b, b, layers[0], 1)
        self.layer1 = stage(b, b * 2, layers[1], 2)
        self.layer2 = stage(b * 2, b * 4, layers[2], 2)
        self.layer3 = stage(b * 4, b * 8, layers[3], 2)
        self.layer4 = stage(b * 8, b * 8, layers[4], 2)
        self.fusionConv = GNReLUConv(b * 8, b * 8, 16, weight_std=ws, bias=False)
        self.x8_resb = stage(b * 8, b * 4, 1, 1)
        self.x4_resb = stage(b * 4, b * 2, 1, 1)
        self.x2_resb = stage(b * 2, b, 1, 1)
        self.x1_resb = stage(b, b, 1, 1)
        self.deepout1 = GNReLUConv(b * 4, nc, 16)
        self.deepout2 = GNReLUConv(b * 2, nc, 16)
        self.deepout3 = GNReLUConv(b, nc, 16)
        self.precls_conv = GNReLUConv(b, nc, 16)
        self.eam84 = EAM(b * 4, num_heads=4)
        self.eam42 = EAM(b * 2, num_heads=4)
        self.eam21 = EAM(b, num_heads=4)
        init_default_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor, tokens: Dict[str, torch.Tensor] | None = None,
                aux: bool = True):
        """x: (B, D, H, W, 1) with D, H, W multiples of 16; tokens:
        {'t1': (C-1, 4*base), 't2': (C-1, 2*base), 't3': (C-1, base)}, needed
        only when aux. Returns (logits, attn_maps, deep_maps, features,
        tokens), or the logits alone when not aux."""
        full_spatial = tuple(x.shape[1:4])
        x = self.conv1(x)
        skip0 = x = self.layer0(x)
        skip1 = x = self.layer1(x)
        skip2 = x = self.layer2(x)
        skip3 = x = self.layer3(x)
        x = self.fusionConv(self.layer4(x))

        attn_maps, deep_maps, features = [], [], []
        scales = ((skip3, self.x8_resb, self.deepout1, self.eam84, "t1"),
                  (skip2, self.x4_resb, self.deepout2, self.eam42, "t2"),
                  (skip1, self.x2_resb, self.deepout3, self.eam21, "t3"))
        for i, (skip, resb, deep, eam, key) in enumerate(scales):
            x = resb(upsample_trilinear(x, 2) + skip)
            if not aux:
                continue
            deep_maps.append(deep(x))
            features.append(x.detach())
            if self.use_cm[i]:
                x_t = x.reshape(x.shape[0], -1, x.shape[-1])
                tok = tokens[key].detach().to(x.dtype)
                _, attn = eam(x_t, tok[None])
                amap = attn_to_map(attn, x.shape[1:4])
                if self.deep_up:
                    amap = resize_trilinear(amap, full_spatial)
                attn_maps.append(amap)

        x = self.x1_resb(upsample_trilinear(x, 2) + skip0)
        logits = self.precls_conv(x)
        if not aux:
            return logits
        return logits, attn_maps, deep_maps, features, dict(tokens)

"""The flagship FEAM segmenter, port of ``UNet3DFEAM`` and ``Encoder`` of
``multimodal_pl_tpu/models/unet3d.py`` (voxel branch; reference
``unet3D_with_feam3``, unet3D.py:938-1190, and with ``token_update='pre'``
``unet3D_with_feam2``, unet3D.py:721-936).

Structure (layers=(1,2,2,2,2), base=32): conv1 1->32; encoder stages
32,64,128,256,256 (stride 2 from stage 1); GN-ReLU-1x1 fusion; decoder: x2
trilinear upsample + additive skip + a 1-block stage at 128/64/32/32;
deep-supervision heads and EAMs at the first three decoder scales; a
GN-ReLU-1x1 classifier.

``forward(x, tokens, mask=None, aux=True)`` returns ``(logits, attn_maps,
deep_maps, features, tokens)`` as the JAX model does. With
``token_update='pre'`` (feam2) and a label ``mask``, each EAM scale first
moves its class tokens by the EMA of the masked class means of the detached
features (JAX ``maybe_pre_update``, unet3d.py:193-199) and the EAM consumes
the updated tokens, which ``forward`` returns; with ``'post'`` (feam3), or
without a mask, the tokens come back unchanged. ``aux=False`` returns only the
logits and skips the EAMs, the deep heads and the full-resolution resizes of
the attention maps: none of them feeds the logits, and eager PyTorch has no
dead-code elimination to drop them as XLA does under ``jit``. ``deep=False``
skips the deep heads alone (``deep_maps`` is empty): the train step's loss
takes no deep outputs (``train/step.py:154-161`` of the JAX package).

``remat=True`` checkpoints the stages that the JAX model wraps in
``nn.remat`` (the encoder ``layer0-4`` and the decoder ``x8/x4/x2/x1_resb``;
JAX ``unet3d.py:82, 186``) while autograd records: their activations are
dropped after the forward and recomputed in the backward. The stem, the
heads and the EAMs are not checkpointed.

``conv_impl`` selects the hand-written CUDA kernels of the conv path, the
stride-1 convs and the trilinear upsamples (the decoder's upsample + skip
and the attention maps' resize), or their plain versions; ``gn_impl`` the
GroupNorm -> ReLU kernel or its plain version.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from multimodal_pl_tpu_torch.models.blocks import (
    GNReLUConv,
    ResStage,
    WSConv3d,
    init_default_,
)
from multimodal_pl_tpu_torch.models.eam import EAM, attn_to_map
from multimodal_pl_tpu_torch.models.tokens import ema_update_tokens
from multimodal_pl_tpu_torch.ops.resize import resize_nearest, upsample_trilinear


class UNet3DFEAM(nn.Module):
    """FEAM segmenter. ``token_update='post'`` (feam3): tokens are consumed
    detached and returned unchanged; the caller updates them. ``'pre'``
    (feam2): the forward updates them from ``mask`` before each EAM."""

    def __init__(self, layers: Sequence[int] = (1, 2, 2, 2, 2), num_classes: int = 14,
                 weight_std: bool = True, use_cm: Sequence[bool] = (True, True, True),
                 deep_up: bool = False, base: int = 32, token_update: str = "post",
                 token_alpha: float = 0.01, conv_impl: str = "kernel", gn_impl: str = "kernel",
                 remat: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        if token_update not in ("post", "pre"):
            raise ValueError(f"token_update must be 'post' or 'pre', got {token_update!r}")
        b, nc, ws = base, num_classes, weight_std
        self.num_classes, self.use_cm, self.deep_up = nc, tuple(use_cm), deep_up
        self.token_update, self.token_alpha = token_update, token_alpha
        self.remat, self.conv_impl = remat, conv_impl

        def stage(cin, cout, blocks, stride):
            return ResStage(cin, cout, blocks, stride, weight_std=ws, conv_impl=conv_impl,
                            gn_impl=gn_impl)

        def head(cin, cout, **kw):
            return GNReLUConv(cin, cout, 16, gn_impl=gn_impl, **kw)

        self.conv1 = WSConv3d(1, b, 3, 1, 1, weight_std=ws)
        self.layer0 = stage(b, b, layers[0], 1)
        self.layer1 = stage(b, b * 2, layers[1], 2)
        self.layer2 = stage(b * 2, b * 4, layers[2], 2)
        self.layer3 = stage(b * 4, b * 8, layers[3], 2)
        self.layer4 = stage(b * 8, b * 8, layers[4], 2)
        self.fusionConv = head(b * 8, b * 8, weight_std=ws, bias=False)
        self.x8_resb = stage(b * 8, b * 4, 1, 1)
        self.x4_resb = stage(b * 4, b * 2, 1, 1)
        self.x2_resb = stage(b * 2, b, 1, 1)
        self.x1_resb = stage(b, b, 1, 1)
        self.deepout1 = head(b * 4, nc)
        self.deepout2 = head(b * 2, nc)
        self.deepout3 = head(b, nc)
        self.precls_conv = head(b, nc)
        self.eam84 = EAM(b * 4, num_heads=4)
        self.eam42 = EAM(b * 2, num_heads=4)
        self.eam21 = EAM(b, num_heads=4)
        init_default_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor, tokens: Dict[str, torch.Tensor] | None = None,
                mask: torch.Tensor | None = None, aux: bool = True, deep: bool = True):
        """x: (B, D, H, W, 1) with D, H, W multiples of 16; tokens:
        {'t1': (C-1, 4*base), 't2': (C-1, 2*base), 't3': (C-1, base)}, needed
        only when aux; mask: (B, D, H, W) labels, read only with
        token_update='pre'. Returns (logits, attn_maps, deep_maps, features,
        tokens), or the logits alone when not aux; deep_maps is empty when
        not deep."""
        full_spatial = tuple(x.shape[1:4])
        stage = self._stage
        x = self.conv1(x)
        skip0 = x = stage(self.layer0, x)
        skip1 = x = stage(self.layer1, x)
        skip2 = x = stage(self.layer2, x)
        skip3 = x = stage(self.layer3, x)
        x = self.fusionConv(stage(self.layer4, x))

        attn_maps, deep_maps, features = [], [], []
        new_tokens = dict(tokens) if aux else {}
        pre = self.token_update == "pre" and mask is not None
        scales = ((skip3, self.x8_resb, self.deepout1, self.eam84, "t1"),
                  (skip2, self.x4_resb, self.deepout2, self.eam42, "t2"),
                  (skip1, self.x2_resb, self.deepout3, self.eam21, "t3"))
        for i, (skip, resb, head, eam, key) in enumerate(scales):
            x = stage(resb, upsample_trilinear(x, 2, skip, self.conv_impl))
            if not aux:
                continue
            if deep:
                deep_maps.append(head(x))
            features.append(x.detach())
            if pre:
                m = resize_nearest(mask[..., None].to(x.dtype), x.shape[1:4])[..., 0]
                new_tokens[key] = ema_update_tokens(new_tokens[key], x.detach(), m,
                                                    self.token_alpha)
            if self.use_cm[i]:
                x_t = x.reshape(x.shape[0], -1, x.shape[-1])
                tok = new_tokens[key].detach().to(x.dtype)
                _, attn = eam(x_t, tok[None])
                amap = attn_to_map(attn, x.shape[1:4])
                if self.deep_up:
                    amap = upsample_trilinear(amap, full_spatial[0] // amap.shape[1],
                                              impl=self.conv_impl)
                attn_maps.append(amap)

        x = stage(self.x1_resb, upsample_trilinear(x, 2, skip0, self.conv_impl))
        logits = self.precls_conv(x)
        if not aux:
            return logits
        return logits, attn_maps, deep_maps, features, new_tokens

    def _stage(self, stage: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """stage(x), checkpointed when ``remat`` is set and autograd records.

        The stage's parameter tensors go into the checkpoint as inputs and
        the stage runs on them through ``functional_call``: the recompute in
        the backward then uses exactly the tensors of the forward. (A
        checkpoint of ``stage`` itself would read the module's attributes
        again in the backward, where the train step's ``functional_call``
        has already put the module's own parameters back.) Non-reentrant
        checkpointing keeps grad mode on in the forward, so the forward and
        the recompute take the same training route of the blocks; the stages
        draw no random numbers, so no RNG state is saved."""
        if not (self.remat and torch.is_grad_enabled()):
            return stage(x)
        names, tensors = zip(*stage.named_parameters())

        def run(x, *params):
            return functional_call(stage, dict(zip(names, params)), (x,))

        return checkpoint(run, x, *tensors, use_reentrant=False, preserve_rng_state=False)

"""The 3D U-Net family, port of ``multimodal_pl_tpu/models/unet3d.py``
(voxel branch): the flagship FEAM segmenter ``UNet3DFEAM`` (reference
``unet3D_with_feam3``, unet3D.py:938-1190, and with ``token_update='pre'``
``unet3D_with_feam2``, unet3D.py:721-936) and the ablations
``UNet3DDeepSup`` (:280-429), ``UNet3DEAM`` (:431-582; ``num_eams=2`` is
the truncated ``unet3D_with_eam_baseline``, :1370-1504), ``UNet3DBaseline``
(:584-718) and the DoDNet-style dynamic head ``UNet3DDynHead``
(:1625-1806).

All five share one trunk (:class:`Trunk`, JAX ``Encoder`` and the decoder
stages), under the reference's flat ``state_dict`` names (``conv1``,
``layer0-4``, ``fusionConv``, ``x8/x4/x2/x1_resb``): with the same weights
the Baseline's, the DeepSup's and the EAM ablation's logits are the FEAM's
``aux=False`` logits bit for bit, since their other branches never feed the
logits.

Structure (layers=(1,2,2,2,2), base=32): conv1 1->32; encoder stages
32,64,128,256,256 (stride 2 from stage 1); GN-ReLU-1x1 fusion; decoder: x2
trilinear upsample + additive skip + a 1-block stage at 128/64/32/32;
deep-supervision heads and EAMs at the first three decoder scales; a
GN-ReLU-1x1 classifier.

``UNet3DFEAM.forward(x, tokens, mask=None, aux=True)`` returns ``(logits,
attn_maps, deep_maps, features, tokens)`` as the JAX model does. With
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

``space`` (a :class:`multimodal_pl_tpu_torch.parallel.spatial.SpatialGroup`)
splits each tile's H axis over the ranks of a group, for serving and for the
spatial train step (``models/blocks.py``; every upsample, the decoder's x2
and the attention maps' x2/x4/x8, takes one source row each side, the edge
row repeated at the global edges). Under a split of more than one rank,
``UNet3DFEAM`` runs with or without autograd, with ``aux=True`` (the train
step's forward: the EAM scores are per voxel, so slab-local; the maps and
features are the slab's rows) or ``aux=False``, and ``UNet3DBaseline``
runs. ``deep_up=False`` with ``aux`` (its maps feed the discriminator at
their own scales), the feam2 token pre-update, ``remat`` under autograd and
the other ablations raise NotImplementedError (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from multimodal_pl_tpu_torch.models.blocks import (
    GNReLUConv,
    GroupNorm,
    ResStage,
    WSConv3d,
    init_default_,
)
from multimodal_pl_tpu_torch.models.eam import EAM, _linear, attn_to_map
from multimodal_pl_tpu_torch.models.tokens import ema_update_tokens
from multimodal_pl_tpu_torch.ops.norm import split
from multimodal_pl_tpu_torch.ops.resize import resize_nearest, upsample_trilinear

NEXT_SLICE = "ROADMAP.md queue 1, the rest of the spatial slice"


def unsplit_only(name: str, space) -> None:
    """Raises NotImplementedError for a part of the model that has no H
    split yet, under a split of more than one rank."""
    if split(space):
        raise NotImplementedError(f"{name} under --mesh space:N is not ported: {NEXT_SLICE}")


class Trunk(nn.Module):
    """conv1, the five encoder stages, the GN-ReLU-1x1 fusion head and the
    four one-block decoder stages (x2 trilinear upsample + additive skip) of
    every U-Net of the family; the subclasses add their heads."""

    def __init__(self, layers: Sequence[int], base: int, weight_std: bool, conv_impl: str,
                 gn_impl: str, remat: bool = False, space=None):
        super().__init__()
        b, ws = base, weight_std
        self.remat, self.conv_impl, self.gn_impl, self.space = remat, conv_impl, gn_impl, space

        def stage(cin, cout, blocks, stride):
            return ResStage(cin, cout, blocks, stride, weight_std=ws, conv_impl=conv_impl,
                            gn_impl=gn_impl, space=space)

        self.conv1 = WSConv3d(1, b, 3, 1, 1, weight_std=ws, space=space)
        self.layer0 = stage(b, b, layers[0], 1)
        self.layer1 = stage(b, b * 2, layers[1], 2)
        self.layer2 = stage(b * 2, b * 4, layers[2], 2)
        self.layer3 = stage(b * 4, b * 8, layers[3], 2)
        self.layer4 = stage(b * 8, b * 8, layers[4], 2)
        self.fusionConv = self.head(b * 8, b * 8, weight_std=ws, bias=False)
        self.x8_resb = stage(b * 8, b * 4, 1, 1)
        self.x4_resb = stage(b * 4, b * 2, 1, 1)
        self.x2_resb = stage(b * 2, b, 1, 1)
        self.x1_resb = stage(b, b, 1, 1)

    def head(self, cin: int, cout: int, **kw) -> GNReLUConv:
        return GNReLUConv(cin, cout, 16, gn_impl=self.gn_impl, space=self.space, **kw)

    def encode(self, x: torch.Tensor):
        """x: (B, D, H, W, 1) -> ((skip0, skip1, skip2, skip3), the fusion
        head's output at 1/16 scale). Under a split, x is this rank's H slab
        (``parallel.spatial.check_divisible`` holds its size)."""
        if self.remat and torch.is_grad_enabled():
            unsplit_only("remat (checkpointed stages)", self.space)
        stage = self._stage
        x = self.conv1(x)
        skip0 = x = stage(self.layer0, x)
        skip1 = x = stage(self.layer1, x)
        skip2 = x = stage(self.layer2, x)
        skip3 = x = stage(self.layer3, x)
        return (skip0, skip1, skip2, skip3), self.fusionConv(stage(self.layer4, x))

    def decode(self, x: torch.Tensor, skips):
        """Yields the output of each decoder stage in turn (1/8, 1/4, 1/2
        and full scale) from the encoder's bottom ``x`` and ``skips``."""
        for skip, resb in zip(reversed(skips),
                              (self.x8_resb, self.x4_resb, self.x2_resb, self.x1_resb)):
            x = self._stage(resb, self._upsample(x, skip))
            yield x

    def _upsample(self, x: torch.Tensor, skip: torch.Tensor | None,
                  factor: int = 2) -> torch.Tensor:
        """upsample_trilinear(x, factor, skip); under a split on x's slab with
        one source row each side (the edge row repeated at a global edge, as
        the half-pixel sampling clamps: an output row reads at most one
        source row beyond its slab at any factor), upsampled without the
        skip, which is added to the slab's rows in the pass that crops them
        out."""
        if not split(self.space):
            return upsample_trilinear(x, factor, skip, self.conv_impl)
        xe, _ = self.space.halo_rows(x, 1, 1, "repeat")
        return self.space.crop_rows(upsample_trilinear(xe, factor, None, self.conv_impl), factor,
                                    factor * x.shape[2], add=skip)

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


class UNet3DFEAM(Trunk):
    """FEAM segmenter. ``token_update='post'`` (feam3): tokens are consumed
    detached and returned unchanged; the caller updates them. ``'pre'``
    (feam2): the forward updates them from ``mask`` before each EAM."""

    def __init__(self, layers: Sequence[int] = (1, 2, 2, 2, 2), num_classes: int = 14,
                 weight_std: bool = True, use_cm: Sequence[bool] = (True, True, True),
                 deep_up: bool = False, base: int = 32, token_update: str = "post",
                 token_alpha: float = 0.01, conv_impl: str = "kernel", gn_impl: str = "kernel",
                 remat: bool = False, generator: torch.Generator | None = None, space=None):
        if token_update not in ("post", "pre"):
            raise ValueError(f"token_update must be 'post' or 'pre', got {token_update!r}")
        super().__init__(layers, base, weight_std, conv_impl, gn_impl, remat, space)
        b, nc = base, num_classes
        self.num_classes, self.use_cm, self.deep_up = nc, tuple(use_cm), deep_up
        self.token_update, self.token_alpha = token_update, token_alpha
        self.deepout1 = self.head(b * 4, nc)
        self.deepout2 = self.head(b * 2, nc)
        self.deepout3 = self.head(b, nc)
        self.precls_conv = self.head(b, nc)
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
        not deep. Under an H split x is this rank's slab and so is every
        output; aux needs deep_up and no token pre-update."""
        if aux and not self.deep_up:
            unsplit_only("UNet3DFEAM(deep_up=False, aux=True): its attention maps feed the "
                         "discriminator at their own scales", self.space)
        if aux and self.token_update == "pre" and mask is not None:
            unsplit_only("the feam2 token pre-update (class means over the whole tile)",
                         self.space)
        full_spatial = tuple(x.shape[1:4])
        skips, x = self.encode(x)
        attn_maps, deep_maps, features = [], [], []
        new_tokens = dict(tokens) if aux else {}
        pre = self.token_update == "pre" and mask is not None
        scales = ((self.deepout1, self.eam84, "t1"), (self.deepout2, self.eam42, "t2"),
                  (self.deepout3, self.eam21, "t3"))
        for i, x in enumerate(self.decode(x, skips)):
            if i == 3 or not aux:
                continue
            head, eam, key = scales[i]
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
                amap = attn_to_map(eam.scores(x_t, tok[None]), x.shape[1:4])
                if self.deep_up:
                    amap = self._upsample(amap, None, full_spatial[0] // amap.shape[1])
                attn_maps.append(amap)

        logits = self.precls_conv(x)
        if not aux:
            return logits
        return logits, attn_maps, deep_maps, features, new_tokens


class UNet3DBaseline(Trunk):
    """Plain residual U-Net (reference unet3D_baseline :584-718): the trunk
    and the GN-ReLU-1x1 classifier. ``forward(x)`` returns the logits."""

    def __init__(self, layers: Sequence[int] = (1, 2, 2, 2, 2), num_classes: int = 14,
                 weight_std: bool = True, base: int = 32, conv_impl: str = "kernel",
                 gn_impl: str = "kernel", generator: torch.Generator | None = None, space=None):
        super().__init__(layers, base, weight_std, conv_impl, gn_impl, space=space)
        self.precls_conv = self.head(base, num_classes)
        init_default_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips, x = self.encode(x)
        for x in self.decode(x, skips):
            pass
        return self.precls_conv(x)


class UNet3DDeepSup(Trunk):
    """Deep-supervision-only ablation (reference unet3D_with_deepsup
    :280-429). ``forward(x, aux=True)`` returns (logits, [three deep maps at
    1/8, 1/4, 1/2 scale]), or the logits alone when not aux (the deep heads
    are then skipped)."""

    def __init__(self, layers: Sequence[int] = (1, 2, 2, 2, 2), num_classes: int = 14,
                 weight_std: bool = True, base: int = 32, conv_impl: str = "kernel",
                 gn_impl: str = "kernel", generator: torch.Generator | None = None, space=None):
        unsplit_only("UNet3DDeepSup", space)
        super().__init__(layers, base, weight_std, conv_impl, gn_impl)
        b, nc = base, num_classes
        self.deepout1 = self.head(b * 4, nc)
        self.deepout2 = self.head(b * 2, nc)
        self.deepout3 = self.head(b, nc)
        self.precls_conv = self.head(b, nc)
        init_default_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor, aux: bool = True):
        skips, x = self.encode(x)
        heads = (self.deepout1, self.deepout2, self.deepout3)
        deep = []
        for i, x in enumerate(self.decode(x, skips)):
            if aux and i < 3:
                deep.append(heads[i](x))
        logits = self.precls_conv(x)
        return (logits, deep) if aux else logits


class UNet3DEAM(Trunk):
    """Cascaded learnable class tokens (reference unet3D_with_eam :431-582;
    ``num_eams=2`` is the truncated unet3D_with_eam_baseline :1370-1504).

    ``class_token`` (num_classes, 4*base), the background row included, is
    a trainable parameter broadcast over the batch. ``eam84`` runs at the
    1/8 scale and ``linear84_2_42`` projects its tokens to 2*base; with
    num_eams >= 2 ``eam42`` runs at the 1/4 scale; with num_eams >= 3
    ``linear42_2_21`` projects to base and ``eam21`` runs at the 1/2 scale.
    ``forward(x, aux=True)`` returns (logits, tokens (B, num_classes, width
    of the last projection or EAM), [attention maps (B, d, h, w,
    num_classes)]), or the logits alone when not aux (the cascade is then
    skipped)."""

    def __init__(self, layers: Sequence[int] = (1, 2, 2, 2, 2), num_classes: int = 14,
                 weight_std: bool = True, base: int = 32, num_eams: int = 3,
                 conv_impl: str = "kernel", gn_impl: str = "kernel",
                 generator: torch.Generator | None = None, space=None):
        unsplit_only("UNet3DEAM", space)
        super().__init__(layers, base, weight_std, conv_impl, gn_impl)
        b, nc = base, num_classes
        self.num_eams = num_eams
        self.class_token = nn.Parameter(torch.empty(nc, b * 4))
        self.eam84 = EAM(b * 4, num_heads=4)
        self.linear84_2_42 = nn.Linear(b * 4, b * 2)
        self.cascade = [("eam84", "linear84_2_42")]   # (EAM, projection after it) per scale
        if num_eams >= 2:
            self.eam42 = EAM(b * 2, num_heads=4)
            self.cascade.append(("eam42", None))
        if num_eams >= 3:
            self.linear42_2_21 = nn.Linear(b * 2, b)
            self.eam21 = EAM(b, num_heads=4)
            self.cascade[1] = ("eam42", "linear42_2_21")
            self.cascade.append(("eam21", None))
        self.precls_conv = self.head(b, nc)
        generator = generator or torch.Generator().manual_seed(0)
        init_default_(self, generator)
        with torch.no_grad():
            self.class_token.normal_(generator=generator)

    def forward(self, x: torch.Tensor, aux: bool = True):
        skips, x = self.encode(x)
        cm = self.class_token[None].to(x.dtype)
        attn_maps = []
        for i, x in enumerate(self.decode(x, skips)):
            if not aux or i >= len(self.cascade):
                continue
            eam, linear = self.cascade[i]
            cm, attn = getattr(self, eam)(x.reshape(x.shape[0], -1, x.shape[-1]), cm)
            attn_maps.append(attn_to_map(attn, x.shape[1:4]))
            if linear is not None:
                cm = _linear(getattr(self, linear), cm)
        logits = self.precls_conv(x)
        return (logits, cm, attn_maps) if aux else logits


class UNet3DDynHead(Trunk):
    """DoDNet-style task-conditioned dynamic head (reference unet3D
    :1625-1806).

    The task conditioning is GroupNorm -> ReLU (``gap_gn``, through
    ``group_norm_relu``) and a global mean over the encoder's bottom,
    concatenated with the one-hot task id; the ``controller`` (a Linear)
    maps it to 162 parameters: the weights (64 + 64 + 16, indexed [c_in,
    c_out]) and the biases (8 + 8 + 2) of two 8 -> 8 and one 8 -> 2
    per-sample 1x1x1 convs applied to the 8-channel classifier output, as
    per-sample products (JAX einsums). ``forward(x, task_id)`` returns the
    2-channel logits."""

    def __init__(self, layers: Sequence[int] = (1, 2, 2, 2, 2), num_tasks: int = 7,
                 weight_std: bool = True, base: int = 32, conv_impl: str = "kernel",
                 gn_impl: str = "kernel", generator: torch.Generator | None = None, space=None):
        unsplit_only("UNet3DDynHead (its gap_gn pools over the whole tile)", space)
        super().__init__(layers, base, weight_std, conv_impl, gn_impl)
        b = base
        self.num_tasks = num_tasks
        self.gap_gn = GroupNorm(16, b * 8)
        self.controller = nn.Linear(b * 8 + num_tasks, 162)
        self.precls_conv = self.head(b, 8)
        init_default_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor, task_id: torch.Tensor) -> torch.Tensor:
        """x: (B, D, H, W, 1); task_id: (B,) ints below num_tasks."""
        skips, bottom = self.encode(x)
        pooled = self.gap_gn.relu(bottom, self.gn_impl).mean(dim=(1, 2, 3))
        onehot = F.one_hot(task_id.long(), self.num_tasks).to(pooled.dtype)
        params = _linear(self.controller, torch.cat([pooled, onehot], dim=-1))
        for xd in self.decode(bottom, skips):
            pass
        h = self.precls_conv(xd)                                   # (B, D, H, W, 8)
        w1 = params[:, 0:64].reshape(-1, 8, 8)
        w2 = params[:, 64:128].reshape(-1, 8, 8)
        w3 = params[:, 128:144].reshape(-1, 8, 2)
        for i, (w, bias) in enumerate(((w1, params[:, 144:152]), (w2, params[:, 152:160]),
                                       (w3, params[:, 160:162]))):
            h = torch.einsum("bdhwc,bco->bdhwo", h, w) + bias[:, None, None, None, :]
            if i < 2:
                h = torch.relu(h)
        return h

"""EAM: class-token cross-attention over flattened voxel features, port of
``multimodal_pl_tpu/models/eam.py`` (reference unet3D.py:142-212 EAM,
:214-278 EAM_bk, :76-140 EAM_identity).

Class tokens are the queries; voxel features are keys and values. Each
module returns the updated tokens and the pre-softmax scores, in f32
whatever the input dtype; the head-averaged scores are the per-class
attention map. :class:`EAM` scales the scores after the product and returns
them unscaled; :class:`EAMBK` and :class:`EAMIdentity` scale the queries in
the working dtype before the product and return the scaled scores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_pl_tpu_torch.ops.norm import layer_norm


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def _attend(q, k, v, scale: float, *, scale_before_softmax: bool):
    """q: (B, h, Nt, dh); k, v: (B, h, N, dh). Returns (out (B, Nt, h*dh),
    scores (B, h, Nt, N) f32). scale_before_softmax: the product is scaled
    in f32 before the softmax and the unscaled product returned; else q is
    scaled in its own dtype first and the product is both softmaxed and
    returned (JAX ``_attend``, eam.py:50-61)."""
    if not scale_before_softmax:
        q = q * scale
    attn = q.float() @ k.float().transpose(-1, -2)
    scores = attn * scale if scale_before_softmax else attn
    attnf = torch.softmax(scores, dim=-1).to(v.dtype)
    out = (attnf.float() @ v.float()).to(v.dtype)
    b, h, nt, dh = out.shape
    return out.transpose(1, 2).reshape(b, nt, h * dh), attn


def _broadcast_tokens(tokens: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A singleton token batch broadcasts over the voxel batch."""
    if tokens.shape[0] != x.shape[0]:
        tokens = tokens.expand(x.shape[0], *tokens.shape[1:])
    return tokens


class EAM(nn.Module):
    """Pre-norm cross-attention. norm2 is shared between the voxel features
    and the output-projection branch, as in the reference (:191 and :206);
    the softmax is over scaled scores."""

    def __init__(self, dim: int, num_heads: int = 4):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.kv = nn.Linear(dim, dim * 2, bias=False)
        self.q = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, tokens: torch.Tensor):
        """x: (B, N, C) voxels; tokens: (B or 1, Nt, C). Returns
        (out (B, Nt, C), raw scores (B, heads, Nt, N) f32)."""
        tokens = _broadcast_tokens(tokens, x)
        h = self.num_heads
        k, v = _linear(self.kv, self.norm2(x)).chunk(2, dim=-1)
        q = _linear(self.q, self.norm3(tokens))
        out, attn = _attend(*(_split_heads(t, h) for t in (q, k, v)), (self.dim // h) ** -0.5,
                            scale_before_softmax=True)
        out = _linear(self.proj, self.norm2(out)) + out
        return out, attn

    def scores(self, x: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The raw scores of :meth:`forward` (B, heads, Nt, N) f32, the same
        bits, without the softmax over the voxels and the token update: a
        score is per voxel, so the scores of an H slab are the slab's
        columns of the whole tile's (the train step's forward uses only
        these)."""
        tokens = _broadcast_tokens(tokens, x)
        h = self.num_heads
        k, _ = _linear(self.kv, self.norm2(x)).chunk(2, dim=-1)
        q = _linear(self.q, self.norm3(tokens))
        return _split_heads(q, h).float() @ _split_heads(k, h).float().transpose(-1, -2)


class EAMBK(nn.Module):
    """Un-normed variant with biased kv and q projections (reference
    unet3D.py:214-278)."""

    def __init__(self, dim: int, num_heads: int = 4):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.kv = nn.Linear(dim, dim * 2)
        self.q = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, tokens: torch.Tensor):
        """As :meth:`EAM.forward`; the scores are the scaled ones."""
        tokens = _broadcast_tokens(tokens, x)
        h = self.num_heads
        k, v = _linear(self.kv, x).chunk(2, dim=-1)
        q = _linear(self.q, tokens)
        out, attn = _attend(*(_split_heads(t, h) for t in (q, k, v)), (self.dim // h) ** -0.5,
                            scale_before_softmax=False)
        out = _linear(self.proj, self.norm2(out)) + out
        return out, attn


class EAMIdentity(nn.Module):
    """No-projection variant: q = tokens, k = v = x (reference
    unet3D.py:76-140)."""

    def __init__(self, dim: int, num_heads: int = 4):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.proj = nn.Linear(dim, dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, tokens: torch.Tensor):
        """As :meth:`EAM.forward`; the scores are the scaled ones."""
        tokens = _broadcast_tokens(tokens, x)
        h = self.num_heads
        xs = _split_heads(x, h)
        out, attn = _attend(_split_heads(tokens, h), xs, xs, (self.dim // h) ** -0.5,
                            scale_before_softmax=False)
        out = _linear(self.proj, self.norm2(out)) + out
        return out, attn


def attn_to_map(attn: torch.Tensor, spatial) -> torch.Tensor:
    """Head-averaged raw scores (B, h, Nt, N) -> (B, *spatial, Nt)
    channels-last class map (unet3D.py:1136)."""
    b, _, nt, _ = attn.shape
    return attn.mean(dim=1).transpose(1, 2).reshape(b, *spatial, nt)

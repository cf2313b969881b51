"""EAM: class-token cross-attention over flattened voxel features, port of
``multimodal_pl_tpu/models/eam.py`` (reference unet3D.py:142-212).

Class tokens are the queries; voxel features are keys and values. The module
returns the updated tokens and the raw (unscaled, pre-softmax) scores, in
f32 whatever the input dtype; the head-averaged raw scores are the per-class
attention map.
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
        if tokens.shape[0] != x.shape[0]:
            tokens = tokens.expand(x.shape[0], *tokens.shape[1:])
        h = self.num_heads
        scale = (self.dim // h) ** -0.5
        k, v = _linear(self.kv, self.norm2(x)).chunk(2, dim=-1)
        q = _linear(self.q, self.norm3(tokens))
        q, k, v = (_split_heads(t, h) for t in (q, k, v))
        attn = q.float() @ k.float().transpose(-1, -2)
        attnf = torch.softmax(attn * scale, dim=-1).to(v.dtype)
        out = (attnf.float() @ v.float()).to(v.dtype)
        b, _, nt, dh = out.shape
        out = out.transpose(1, 2).reshape(b, nt, h * dh)
        out = _linear(self.proj, self.norm2(out)) + out
        return out, attn


def attn_to_map(attn: torch.Tensor, spatial) -> torch.Tensor:
    """Head-averaged raw scores (B, h, Nt, N) -> (B, *spatial, Nt)
    channels-last class map (unet3D.py:1136)."""
    b, _, nt, _ = attn.shape
    return attn.mean(dim=1).transpose(1, 2).reshape(b, *spatial, nt)

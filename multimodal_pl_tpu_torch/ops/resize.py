"""Spatial resizing ops, port of ``multimodal_pl_tpu/ops/resize.py``.

- ``upsample_trilinear`` / ``resize_trilinear``: half-pixel-center linear
  interpolation == ``F.interpolate(mode='trilinear', align_corners=False)``.
- ``resize_nearest``: torch's ``mode='nearest'`` floor convention
  (src = floor(dst * in / out)).

All ops are channels-last: (N, D, H, W, C).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def resize_trilinear(x: torch.Tensor, out_spatial: Sequence[int]) -> torch.Tensor:
    """Trilinear resize of an NDHWC tensor to ``out_spatial``. Only growing
    axes are supported: ``jax.image.resize`` antialiases when it shrinks, and
    the model only ever upsamples."""
    out_spatial = tuple(int(s) for s in out_spatial)
    if any(o < i for o, i in zip(out_spatial, x.shape[1:4])):
        raise ValueError(f"resize_trilinear shrinks {tuple(x.shape[1:4])} -> {out_spatial}")
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=out_spatial,
                      mode="trilinear", align_corners=False)
    return y.permute(0, 2, 3, 4, 1)


def upsample_trilinear(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """x{factor} trilinear upsampling (align_corners=False)."""
    _, d, h, w, _ = x.shape
    return resize_trilinear(x, (d * factor, h * factor, w * factor))


def _nearest_indices(in_size: int, out_size: int, device) -> torch.Tensor:
    idx = (torch.arange(out_size, device=device) * in_size) // out_size
    return idx.clamp(0, in_size - 1)


def resize_nearest(x: torch.Tensor, out_spatial: Sequence[int]) -> torch.Tensor:
    """Nearest resize (torch floor convention) of the NDHWC spatial axes."""
    for ax, out in zip((1, 2, 3), out_spatial):
        x = x.index_select(ax, _nearest_indices(x.shape[ax], int(out), x.device))
    return x

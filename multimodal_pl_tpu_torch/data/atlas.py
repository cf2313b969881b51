"""Per-sample atlas resizing, a copy of ``resize_atlas_nearest`` from
``multimodal_pl_tpu/data/atlas.py`` (reference MOTSDataset.py:357): torch
nearest interpolation, floor-convention indexing, in numpy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _nearest_idx(in_size: int, out_size: int) -> np.ndarray:
    return np.minimum((np.arange(out_size) * in_size) // out_size, in_size - 1)


def resize_atlas_nearest(atlas: np.ndarray, out_shape: Sequence[int]) -> np.ndarray:
    """(L, D, H, W) -> (L, *out_shape) with torch F.interpolate('nearest')
    floor-convention indexing (MOTSDataset.py:357)."""
    d = _nearest_idx(atlas.shape[1], out_shape[0])
    h = _nearest_idx(atlas.shape[2], out_shape[1])
    w = _nearest_idx(atlas.shape[3], out_shape[2])
    return np.ascontiguousarray(atlas[:, d[:, None, None], h[None, :, None], w[None, None, :]])

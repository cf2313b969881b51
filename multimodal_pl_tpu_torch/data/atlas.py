"""Per-sample atlas resizing and the organ cores of an atlas, copies of
``resize_atlas_nearest``, ``atlas_cores`` and ``atlas_cores_weighted`` from
``multimodal_pl_tpu/data/atlas.py``: torch nearest interpolation with
floor-convention indexing, in numpy (reference MOTSDataset.py:357), and
the per-organ centres of atlas support (:126-141, :504-519).
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


def atlas_cores(atlas: np.ndarray) -> np.ndarray:
    """Per-organ center-of-mass voxel of atlas support (MOTSDataset.py:126-141)."""
    cores = np.zeros((atlas.shape[0], 3), np.int32)
    for g in range(atlas.shape[0]):
        idx = np.nonzero(atlas[g] > 0)
        if idx[0].size:
            cores[g] = [int(np.mean(ax)) for ax in idx]
    return cores


def atlas_cores_weighted(atlas: np.ndarray) -> np.ndarray:
    """Per-organ PROBABILITY-WEIGHTED center of mass, the multi-source
    variant's core definition (MOTSDataset.py:504-519): for each organ
    channel, sum(coord * prob) / sum(prob) over positive voxels, truncated
    to int (torch ``.int()``). Channels with no support map to (0, 0, 0)."""
    cores = np.zeros((atlas.shape[0], 3), np.int32)
    for g in range(atlas.shape[0]):
        ch = atlas[g]
        total = ch.sum(dtype=np.float64)
        if total <= 0:
            continue
        pos = ch > 0
        w = ch[pos].astype(np.float64)
        for dim, grid in enumerate(np.indices(ch.shape, sparse=True)):
            coords = np.broadcast_to(grid, ch.shape)[pos]
            cores[g, dim] = int((coords * w).sum() / total)
    return cores

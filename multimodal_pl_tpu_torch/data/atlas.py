"""The organ atlas: its generation, per-sample resizing and the organ cores
of an atlas, copies of ``generate_atlas``, ``resize_atlas_nearest``,
``atlas_cores`` and ``atlas_cores_weighted`` from
``multimodal_pl_tpu/data/atlas.py``.

Generation (reference preprocess/atlas_gen_mm.py:73-151): mean shape over
the 70% train split, per-case per-organ order-0 zoom accumulated and
count-normalized, then Gaussian-smoothed (sigma=3), saved as (num_fg, D, H,
W) ``atlas_mm.npy``; host work in numpy and scipy, on no device. The
per-sample resize is torch nearest interpolation with floor-convention
indexing, in numpy (MOTSDataset.py:357); the cores are the per-organ
centres of atlas support (:126-141, :504-519).
"""

from __future__ import annotations

import glob
import os
import random
from typing import Sequence

import numpy as np
from scipy.ndimage import gaussian_filter, zoom

from multimodal_pl_tpu_torch.data.nifti import read_nifti


def _nearest_idx(in_size: int, out_size: int) -> np.ndarray:
    return np.minimum((np.arange(out_size) * in_size) // out_size, in_size - 1)


def resize_atlas_nearest(atlas: np.ndarray, out_shape: Sequence[int]) -> np.ndarray:
    """(L, D, H, W) -> (L, *out_shape) with torch F.interpolate('nearest')
    floor-convention indexing (MOTSDataset.py:357)."""
    d = _nearest_idx(atlas.shape[1], out_shape[0])
    h = _nearest_idx(atlas.shape[2], out_shape[1])
    w = _nearest_idx(atlas.shape[3], out_shape[2])
    return np.ascontiguousarray(atlas[:, d[:, None, None], h[None, :, None], w[None, None, :]])


def generate_atlas(
    label_dir: str,
    out_path: str | None = None,
    num_fg: int = 13,
    split_seed: int = 1,
    train_frac: float = 0.7,
    sigma: float = 3.0,
    files: Sequence[str] | None = None,
) -> np.ndarray:
    """Build the (num_fg, D*, H*, W*) organ-probability atlas.

    D*,H*,W* is the rounded mean training-split shape (atlas_gen_mm.py:100-112).
    """
    if files is None:
        files = sorted(glob.glob(os.path.join(label_dir, "*.nii.gz"))) + sorted(
            glob.glob(os.path.join(label_dir, "*.nii"))
        )
    files = list(files)
    rng = random.Random(split_seed)
    rng.shuffle(files)
    train_files = files[: int(train_frac * len(files))]
    if not train_files:
        raise ValueError(f"no label files found under {label_dir}")

    shapes = []
    vols = []
    for f in train_files:
        arr = read_nifti(f).data
        vols.append(arr)
        shapes.append(arr.shape)
    mean_shape = [int(np.round(np.mean([s[i] for s in shapes]))) for i in range(3)]

    catlas = np.zeros((num_fg, *mean_shape), np.float64)
    count = np.zeros((num_fg, 1, 1, 1), np.float64)
    for arr in vols:
        factors = [mean_shape[i] / arr.shape[i] for i in range(3)]
        for label in range(1, num_fg + 1):
            m = (arr == label).astype(np.float32)
            if m.sum() > 0:
                catlas[label - 1] += zoom(m, factors, order=0)
                count[label - 1] += 1
    for i in range(num_fg):
        if count[i] > 0:
            catlas[i] = gaussian_filter(catlas[i] / count[i], sigma=sigma)
    catlas = catlas.astype(np.float32)
    if out_path:
        np.save(out_path, catlas)
    return catlas


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

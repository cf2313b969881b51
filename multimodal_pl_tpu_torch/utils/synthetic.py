"""Synthetic AMOS-like cases, a copy of
``multimodal_pl_tpu/data/synthetic.py`` writing through the port's own
``data/nifti.py::write_nifti`` and ``data/supervision.py``, so that scripts
driving the port need nothing of the JAX package to make their data. A test
pins every file it writes to the original's, byte for byte (the NIfTI volumes
after gunzip, since gzip stamps the time).

Small CT/MRI NIfTI volumes with ellipsoid "organs" (labels 1..13) in the
layout the dataset reads (imagesTr/ + labelsTr/, amos_XXXX_0000 naming), a
matching atlas and a supervision csv. ``scanner_layout`` and
``write_nifti_affine`` turn such a case into a raw scan, as a scanner stores
it (axes permuted and reversed, another voxel size), for the preprocessing
entry point.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np
from scipy.ndimage import gaussian_filter

from multimodal_pl_tpu_torch.data.nifti import write_nifti
from multimodal_pl_tpu_torch.data.supervision import generate_supervision_csv

# CT ids spread across the supervision ranges, so a fixture set supervises
# different organs, including labeled-modality ones (the refiner's rows)
_SPREAD_CT_IDS = [40, 80, 130, 170, 240, 290, 360, 430, 455, 475, 30, 120, 230, 350]


def make_case(rng: np.random.Generator, shape=(96, 96, 80), num_fg: int = 13,
              modality: str = "ct", organ_r_frac: float = 0.11):
    """(image, label) with ellipsoid organs at stable relative positions; a
    voxel inside several goes to the nearest centre, and a crowded organ's
    radius grows until it keeps a trainable core."""
    D, H, W = shape
    label = np.zeros(shape, np.uint8)
    image = rng.normal(0, 20, shape).astype(np.float32)
    grid = [(0.3, 0.35, 0.4), (0.3, 0.65, 0.4), (0.5, 0.35, 0.5), (0.5, 0.65, 0.5),
            (0.7, 0.5, 0.45), (0.4, 0.5, 0.6), (0.6, 0.3, 0.6), (0.6, 0.7, 0.6),
            (0.35, 0.5, 0.3), (0.65, 0.5, 0.7), (0.45, 0.25, 0.45), (0.45, 0.75, 0.45),
            (0.55, 0.5, 0.35)]
    base_r = organ_r_frac * min(shape)
    zz, yy, xx = np.ogrid[:D, :H, :W]
    ndist = np.full((num_fg, *shape), np.inf, np.float32)
    for organ in range(1, num_fg + 1):
        cz, cy, cx = grid[organ - 1]
        c = np.array([cz * D, cy * H, cx * W]) + rng.normal(0, 1.5, 3)
        r = base_r * rng.uniform(0.8, 1.3)
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        ndist[organ - 1] = np.sqrt(d2) / r
    boost = np.ones((num_fg, 1, 1, 1), np.float32)
    floor = max(64, min(600, int(0.25 * 4.19 * base_r ** 3)))
    for _ in range(6):
        nd = ndist / boost
        nearest = np.argmin(nd, axis=0)
        inside = np.take_along_axis(nd, nearest[None], 0)[0] < 1.0
        counts = np.bincount((nearest[inside]).ravel(), minlength=num_fg)
        starving = counts < floor
        if not starving.any():
            break
        boost[starving, 0, 0, 0] *= 1.3
    label[inside] = (nearest[inside] + 1).astype(np.uint8)
    for organ in range(1, num_fg + 1):
        image[label == organ] += 150 + 20 * organ
    if modality == "ct":
        image += -50
    else:
        image = np.abs(image) * 2 + 30
    image = gaussian_filter(image, 1.0)
    return image.astype(np.float32), label


def make_synthetic_amos(root: str, n_ct: int = 4, n_mri: int = 2, shape=(96, 96, 80),
                        seed: int = 0, num_fg: int = 13, spread_ids: bool = True,
                        organ_r_frac: float = 0.11):
    """Write imagesTr/labelsTr cases, ``atlas_mm.npy`` and
    ``supervise_mask.csv`` under ``root``; CT ids spread across the
    supervision ranges (or 1..n_ct), MRI ids from 500.
    Returns (images_dir, atlas_path, csv_path)."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "imagesTr")
    lab_dir = os.path.join(root, "labelsTr")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    if spread_ids:
        ct_ids = list(_SPREAD_CT_IDS)
        nxt = 1
        while len(ct_ids) < n_ct:
            if nxt not in ct_ids:
                ct_ids.append(nxt)
            nxt += 1
        ct_ids = ct_ids[:n_ct]
    else:
        ct_ids = list(range(1, n_ct + 1))
    ids = sorted(ct_ids) + list(range(500, 500 + n_mri))
    labels_sum = np.zeros((num_fg, *shape), np.float32)
    for cid in ids:
        modality = "mri" if cid >= 500 else "ct"
        img, lab = make_case(rng, shape, num_fg, modality, organ_r_frac)
        write_nifti(os.path.join(img_dir, f"amos_{cid:04d}_0000.nii.gz"), img, (1, 1, 2))
        write_nifti(os.path.join(lab_dir, f"amos_{cid:04d}.nii.gz"), lab, (1, 1, 2))
        for organ in range(1, num_fg + 1):
            labels_sum[organ - 1] += lab == organ
    atlas = np.stack([gaussian_filter(labels_sum[i] / len(ids), 3) for i in range(num_fg)])
    atlas_path = os.path.join(root, "atlas_mm.npy")
    np.save(atlas_path, atlas.astype(np.float32))
    csv_path = os.path.join(root, "supervise_mask.csv")
    generate_supervision_csv(ids, csv_path)
    return img_dir, atlas_path, csv_path


def scanner_layout(ras_zyx: np.ndarray, perm, signs, spacing):
    """(stored (Z, Y, X) array, 4 x 4 affine) of a scan of the RAS volume
    ``ras_zyx`` whose index axis j (x fastest) runs along world axis
    ``perm[j]``, reversed where ``signs[j] < 0``, with world voxel size
    ``spacing`` (x, y, z): ``data/preprocess.reorient_to_ras`` gives back
    ``ras_zyx`` and ``spacing``."""
    idx = np.transpose(np.transpose(ras_zyx, (2, 1, 0)), perm)
    for j in range(3):
        if signs[j] < 0:
            idx = np.flip(idx, axis=j)
    affine = np.eye(4)
    affine[:3, :3] = 0
    for j in range(3):
        affine[perm[j], j] = signs[j] * spacing[perm[j]]
    return np.ascontiguousarray(np.transpose(idx, (2, 1, 0))), affine


def write_nifti_affine(path: str, data: np.ndarray, affine: np.ndarray) -> None:
    """``write_nifti`` with the pixdim and sform of ``affine`` (which
    ``write_nifti`` writes axis-aligned)."""
    write_nifti(path, data, tuple(np.linalg.norm(affine[:3, :3], axis=0)))
    with gzip.open(path, "rb") as f:
        raw = bytearray(f.read())
    for row in range(3):
        struct.pack_into("<4f", raw, 280 + 16 * row, *affine[row])
    with gzip.open(path, "wb") as f:
        f.write(bytes(raw))

"""Offline preprocessing: orientation, spacing resample, body-mask cropping;
a copy of ``multimodal_pl_tpu/data/preprocess.py`` on the port's own NIfTI
reader and writer.

Reference: preprocess/forward_crop.py + preprocess/transforms.py:41-54 —
MONAI Load/Orient(RAS)/Spacing(1,1,2), drop labels >= 14, crop to label
extent, body-mask crop (threshold + erosion + largest connected component;
CT -200 / MRI 25), MRI "hand-removal" crop, write spacing-(1,1,2) NIfTI.

SimpleITK/MONAI are replaced with numpy/scipy: orientation comes from the
NIfTI affine (axis permutation + flips to RAS), resampling is scipy.zoom
(order 1 images / 0 labels), connected components are scipy.ndimage.label.
This is host work in both packages: no device is used, so nothing here
takes a ``device``. The reference's thresholds are kept as they are: the
body threshold switches at ``case_id > 410`` (not at the modality rule's
500) and the hand-removal crop runs at ``case_id > 500``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from scipy import ndimage

from multimodal_pl_tpu_torch.data.nifti import read_nifti, write_nifti


def reorient_to_ras(data: np.ndarray, affine: np.ndarray):
    """Permute/flip axes so the array is RAS-ordered (MONAI Orientationd).

    data is (Z, Y, X) index order; affine maps (x_idx, y_idx, z_idx) -> world.
    Returns (data_ras, spacing_ras) with data still (Z, Y, X)-style indexing
    of the reoriented volume.
    """
    R = affine[:3, :3]
    # column j of R = world direction of index axis j (x-fastest order)
    perm = np.argmax(np.abs(R), axis=0)  # world axis dominated by each index axis
    signs = np.sign(R[perm, range(3)])
    spacing = np.linalg.norm(R, axis=0)
    # index-axis order such that output axes follow world (x, y, z)
    order = np.argsort(perm)
    xyz = np.transpose(data, (2, 1, 0))
    xyz = np.transpose(xyz, tuple(order))
    for world_axis in range(3):
        if signs[order[world_axis]] < 0:
            xyz = np.flip(xyz, axis=world_axis)
    out = np.transpose(xyz, (2, 1, 0))
    sp = spacing[list(order)]
    return np.ascontiguousarray(out), (float(sp[0]), float(sp[1]), float(sp[2]))


def resample_spacing(image: np.ndarray, label: np.ndarray, spacing_xyz,
                     target_xyz=(1.0, 1.0, 2.0)):
    """Spacingd(pixdim=(1,1,2), bilinear/nearest). Arrays are (Z, Y, X)."""
    sx, sy, sz = spacing_xyz
    tz, ty, tx = target_xyz[2], target_xyz[1], target_xyz[0]
    factors = (sz / tz, sy / ty, sx / tx)
    img = ndimage.zoom(image.astype(np.float32), factors, order=1)
    lab = ndimage.zoom(label, factors, order=0)
    return img, lab


def largest_component(mask: np.ndarray, min_voxels: float = 1e6) -> np.ndarray | None:
    """Largest connected component above min_voxels (forward_crop.py:37-59)."""
    labeled, n = ndimage.label(mask)
    if n == 0:
        return None
    counts = np.bincount(labeled.ravel())
    counts[0] = 0
    big = np.argmax(counts)
    if counts[big] < min_voxels:
        return None
    return (labeled == big).astype(np.uint8)


def get_body(vol: np.ndarray, threshold: float = -200, min_voxels: float = 1e6) -> np.ndarray:
    """Threshold + erosion + largest component body mask (forward_crop.py:62-82)."""
    m = (vol >= threshold).astype(np.uint8)
    m = ndimage.binary_erosion(m, structure=np.ones((2, 2, 2)))
    comp = largest_component(m, min_voxels)
    if comp is None:
        comp = (vol > threshold).astype(np.float32)
        comp = ndimage.binary_erosion(comp, structure=np.ones((10, 10, 10)))
        comp = ndimage.binary_dilation(comp, structure=np.ones((10, 10, 10))).astype(np.uint8)
    return comp


def _bbox(mask: np.ndarray, margin: int):
    idx = np.nonzero(mask)
    lo = [max(0, int(np.min(ax)) - margin) for ax in idx]
    hi = [int(np.max(ax)) + margin for ax in idx]
    return lo, hi


def preprocess_case(image_path: str, label_path: str, out_image: str, out_label: str,
                    case_id: int, max_label: int = 14) -> Tuple[tuple, tuple]:
    """Full per-case offline pipeline (forward_crop.py:99-225).

    Returns (pre_shape, post_shape) for logging.
    """
    img_n = read_nifti(image_path)
    lab_n = read_nifti(label_path)

    image, spacing = reorient_to_ras(img_n.data, img_n.affine)
    label, _ = reorient_to_ras(lab_n.data, lab_n.affine)
    image, label = resample_spacing(image, label, spacing)
    pre_shape = image.shape

    label = label.copy()
    label[label >= max_label] = 0

    # crop empty X extent around labels (forward_crop.py:157-162)
    if label.any():
        _, _, x_idx = np.nonzero(label != 0)
        xmin, xmax = max(0, int(x_idx.min()) - 1), int(x_idx.max()) + 1
        image = image[:, :, xmin:xmax]
        label = label[:, :, xmin:xmax]

    # body-component crop (thresholds: CT -200 / MRI 25, :166-183)
    threshold = 25 if case_id > 410 else -200
    body = get_body(image, threshold)
    lo, hi = _bbox(body, 3)
    image_c = image[lo[0] : hi[0], lo[1] : hi[1], lo[2] : hi[2]]
    label_c = label[lo[0] : hi[0], lo[1] : hi[1], lo[2] : hi[2]]

    # MRI hand-removal crop (:185-207)
    if case_id > 500:
        upper = image[:, :, : image_c.shape[2] // 2 + 10]
        body_up = get_body(upper, threshold, min_voxels=1e5)
        if body_up is not None and body_up.any():
            lo_u, hi_u = _bbox(body_up, 5)
            if (hi[0] - lo[0]) - (hi_u[0] - lo_u[0]) > 30:
                image_c = image_c[lo_u[0] : hi_u[0]]
                label_c = label_c[lo_u[0] : hi_u[0]]

    os.makedirs(os.path.dirname(out_image), exist_ok=True)
    os.makedirs(os.path.dirname(out_label), exist_ok=True)
    write_nifti(out_image, image_c.astype(np.float32), (1, 1, 2))
    write_nifti(out_label, label_c.astype(np.uint8), (1, 1, 2))
    return pre_shape, image_c.shape

"""Config-driven spatial + intensity augmentation recipes, a copy of
``multimodal_pl_tpu/data/transforms.py`` (numpy and scipy).

Reference: preprocess/transforms.py:78-209 (get_transforms) — the MONAI
train/val/test recipe (percentile intensity scaling, random rotate / zoom /
translate / shear / flip, spatial crop, noise / smooth / scale / shift /
contrast). Rebuilt on scipy.ndimage affine transforms so the offline stage
has no MONAI dependency. The one-shot affine composes rotate+zoom+translate+
shear into a single resample (one interpolation instead of MONAI's four).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


@dataclass
class AugmentConfig:
    """Mirrors the `augmentation:` block of the reference YAML configs."""

    patch_size: Optional[Tuple[int, int, int]] = None
    p_rotate: float = 0.2
    rotation: Tuple[float, float] = (-10.0, 10.0)        # degrees
    p_zoom: float = 0.2
    min_zoom: float = 0.9
    max_zoom: float = 1.1
    p_translate: float = 0.2
    translate_percentage: float = 5.0
    p_shear: float = 0.2
    shear_range: float = 0.1
    p_flip: float = 0.5
    flip_axes: Tuple[int, ...] = (0, 1, 2)
    p_gaussian_noise: float = 0.1
    gaussian_noise_std: float = 0.01
    p_gaussian_smooth: float = 0.2
    gaussian_smooth_sigma: Tuple[float, float] = (0.5, 1.0)
    p_intensity_scale: float = 0.15
    intensity_scale_factors: float = 0.25
    p_intensity_shift: float = 0.15
    intensity_shift_offsets: float = 0.1
    p_adjust_contrast: float = 0.15
    adjust_contrast_gamma: Tuple[float, float] = (0.7, 1.5)


def scale_intensity_range(img: np.ndarray, a_min: float, a_max: float,
                          b_min: float = 0.0, b_max: float = 1.0,
                          clip: bool = True) -> np.ndarray:
    """MONAI ScaleIntensityRanged (transforms.py:90-94)."""
    out = (img - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    if clip:
        out = np.clip(out, b_min, b_max)
    return out


def percentile_window(img: np.ndarray, lo: float = 0.5, hi: float = 99.5) -> np.ndarray:
    """Foreground-percentile windowing to [0, 1] (the config values the
    reference reads from data_info statistics)."""
    a_min, a_max = np.percentile(img, [lo, hi])
    return scale_intensity_range(img, float(a_min), float(a_max))


def _compose_affine(rng: np.random.Generator, cfg: AugmentConfig) -> Optional[np.ndarray]:
    """Random rotation/zoom/shear 3x3 (None if no spatial aug triggered)."""
    m = np.eye(3)
    hit = False
    if rng.random() < cfg.p_rotate:
        hit = True
        for axis_pair in ((0, 1), (0, 2), (1, 2)):
            ang = np.deg2rad(rng.uniform(*cfg.rotation))
            r = np.eye(3)
            i, j = axis_pair
            r[i, i] = r[j, j] = np.cos(ang)
            r[i, j] = -np.sin(ang)
            r[j, i] = np.sin(ang)
            m = m @ r
    if rng.random() < cfg.p_zoom:
        hit = True
        m = m @ np.diag([1.0 / rng.uniform(cfg.min_zoom, cfg.max_zoom) for _ in range(3)])
    if rng.random() < cfg.p_shear:
        hit = True
        s = np.eye(3)
        s[0, 1], s[0, 2] = rng.uniform(-cfg.shear_range, cfg.shear_range, 2)
        s[1, 2] = rng.uniform(-cfg.shear_range, cfg.shear_range)
        m = m @ s
    return m if hit else None


def spatial_augment(image: np.ndarray, label: np.ndarray, rng: np.random.Generator,
                    cfg: AugmentConfig):
    """Random rotate+zoom+shear (single resample), translate, flips.

    image/label: (D, H, W). Returns transformed copies (bilinear / nearest).
    """
    m = _compose_affine(rng, cfg)
    offset = np.zeros(3)
    if rng.random() < cfg.p_translate:
        offset = np.array([
            rng.uniform(-s * cfg.translate_percentage / 100, s * cfg.translate_percentage / 100)
            for s in image.shape
        ])
        if m is None:
            m = np.eye(3)
    if m is not None:
        center = (np.asarray(image.shape) - 1) / 2
        shift = center - m @ center + offset
        image = ndimage.affine_transform(image, m, offset=shift, order=1, mode="constant")
        label = ndimage.affine_transform(label, m, offset=shift, order=0, mode="constant")
    for ax in cfg.flip_axes:
        if rng.random() < cfg.p_flip:
            image = np.flip(image, ax)
            label = np.flip(label, ax)
    return np.ascontiguousarray(image), np.ascontiguousarray(label)


def rand_spatial_crop(image: np.ndarray, label: np.ndarray, roi: Sequence[int],
                      rng: np.random.Generator):
    """MONAI RandSpatialCropd (random center, fixed size)."""
    starts = [rng.integers(0, max(s - r, 0) + 1) for s, r in zip(image.shape, roi)]
    sl = tuple(slice(st, st + r) for st, r in zip(starts, roi))
    return image[sl], label[sl]


def intensity_recipe(image: np.ndarray, rng: np.random.Generator, cfg: AugmentConfig):
    """MONAI-side intensity augs (noise/smooth/scale/shift/gamma)."""
    x = image
    if rng.random() < cfg.p_gaussian_noise:
        x = x + rng.normal(0, cfg.gaussian_noise_std, x.shape).astype(x.dtype)
    if rng.random() < cfg.p_gaussian_smooth:
        x = ndimage.gaussian_filter(x, rng.uniform(*cfg.gaussian_smooth_sigma))
    if rng.random() < cfg.p_intensity_scale:
        x = x * (1.0 + rng.uniform(-cfg.intensity_scale_factors, cfg.intensity_scale_factors))
    if rng.random() < cfg.p_intensity_shift:
        x = x + rng.uniform(-cfg.intensity_shift_offsets, cfg.intensity_shift_offsets)
    if rng.random() < cfg.p_adjust_contrast:
        gamma = rng.uniform(*cfg.adjust_contrast_gamma)
        lo, hi = x.min(), x.max()
        span = max(hi - lo, 1e-8)
        x = ((x - lo) / span) ** gamma * span + lo
    return x


def get_transforms(split: str, cfg: AugmentConfig, seed: int = 0):
    """The reference's split-keyed transform factory (transforms.py:78-209).

    Returns fn(image, label) -> (image, label) closures with their own RNG.
    """
    rng = np.random.default_rng(seed)

    def train(image, label):
        image = percentile_window(image)
        image, label = spatial_augment(image, label, rng, cfg)
        if cfg.patch_size:
            image, label = rand_spatial_crop(image, label, cfg.patch_size, rng)
        image = intensity_recipe(image, rng, cfg)
        return image, label

    def val(image, label):
        image = percentile_window(image)
        if cfg.patch_size:
            image, label = rand_spatial_crop(image, label, cfg.patch_size, rng)
        return image, label

    if split == "train":
        return train
    if split in ("val", "test"):
        return val
    raise ValueError("Please use 'test', 'val', or 'train' as split arg.")

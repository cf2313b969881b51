"""Intensity augmentation (the reference's batchgenerators recipe) and
``mask_aug``, copies from ``multimodal_pl_tpu/data/augment.py``: its
``intensity_augment`` as two steps,
its random draws in its order (:func:`draw_intensity`) and their application
(:func:`apply_intensity`), so that a data-parallel rank can draw another
rank's batch without building it.

Reference recipe (MOTSDataset.py:33-52): per-sample, applied on the collated
batch, keys follow batchgenerators semantics:
  GaussianNoise      p=0.1  (variance uniform in (0, 0.1))
  GaussianBlur       p=0.2, sigma U(0.5, 1.0), per-channel p=0.5
  BrightnessMultiplicative p=0.15, factor U(0.75, 1.25)
  BrightnessAdditive p=0.15 (mu=0, sigma=0.1), per-channel p=0.5
  Contrast           p=0.15, factor U(0.75, 1.25), preserve range

Implemented in numpy for the host input pipeline; seeds are explicit.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter


def draw_intensity(rng: np.random.Generator, batch: int, shape) -> list:
    """The random draws of ``intensity_augment`` for ``batch`` samples of
    ``shape`` (D, H, W, C), in its order: per sample, a dict of what each
    transform that fires takes (the noise array itself, the blur sigma or
    None per channel, factors, per-channel shifts or None)."""
    out = []
    for _ in range(batch):
        d = {}
        if rng.random() < 0.1:  # GaussianNoiseTransform(p_per_sample=0.1)
            var = rng.uniform(0, 0.1)
            d["noise"] = rng.normal(0.0, np.sqrt(var), shape)
        if rng.random() < 0.2:  # GaussianBlurTransform
            d["blur"] = [rng.uniform(0.5, 1.0) if rng.random() < 0.5 else None
                         for _ in range(shape[-1])]
        if rng.random() < 0.15:  # BrightnessMultiplicativeTransform((0.75, 1.25))
            d["scale"] = rng.uniform(0.75, 1.25)
        if rng.random() < 0.15:  # BrightnessTransform(0.0, 0.1, per_channel p=0.5)
            d["shift"] = [rng.normal(0.0, 0.1) if rng.random() < 0.5 else None
                          for _ in range(shape[-1])]
        if rng.random() < 0.15:  # ContrastAugmentationTransform(preserve_range)
            d["contrast"] = rng.uniform(0.75, 1.25)
        out.append(d)
    return out


def apply_intensity(image: np.ndarray, draws: list) -> np.ndarray:
    """image: (B, D, H, W, C) with ``draw_intensity``'s draws for it.
    Returns the augmented copy."""
    out = image.copy()
    for i, d in enumerate(draws):
        x = out[i]
        if "noise" in d:
            x = x + d["noise"].astype(x.dtype)
        for c, sigma in enumerate(d.get("blur", ())):
            if sigma is not None:
                x[..., c] = gaussian_filter(x[..., c], sigma)
        if "scale" in d:
            x = x * d["scale"]
        for c, shift in enumerate(d.get("shift", ())):
            if shift is not None:
                x[..., c] = x[..., c] + shift
        if "contrast" in d:
            mn, mx = x.min(), x.max()
            mean = x.mean()
            x = (x - mean) * d["contrast"] + mean
            x = np.clip(x, mn, mx)
        out[i] = x
    return out


def mask_aug(mask: np.ndarray, aug_times: int = 2) -> np.ndarray:
    """Duplicate each sample aug_times times (reference utils.py:76-114)."""
    if aug_times <= 1:
        return mask
    return np.repeat(mask, aug_times, axis=0)

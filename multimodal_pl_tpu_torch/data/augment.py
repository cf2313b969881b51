"""Intensity augmentation (the reference's batchgenerators recipe), a copy of
``intensity_augment`` from ``multimodal_pl_tpu/data/augment.py``.

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


def intensity_augment(image: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """image: (B, D, H, W, C). Returns augmented copy."""
    out = image.copy()
    b = out.shape[0]
    for i in range(b):
        x = out[i]
        if rng.random() < 0.1:  # GaussianNoiseTransform(p_per_sample=0.1)
            var = rng.uniform(0, 0.1)
            x = x + rng.normal(0.0, np.sqrt(var), x.shape).astype(x.dtype)
        if rng.random() < 0.2:  # GaussianBlurTransform
            for c in range(x.shape[-1]):
                if rng.random() < 0.5:
                    sigma = rng.uniform(0.5, 1.0)
                    x[..., c] = gaussian_filter(x[..., c], sigma)
        if rng.random() < 0.15:  # BrightnessMultiplicativeTransform((0.75, 1.25))
            x = x * rng.uniform(0.75, 1.25)
        if rng.random() < 0.15:  # BrightnessTransform(0.0, 0.1, per_channel p=0.5)
            for c in range(x.shape[-1]):
                if rng.random() < 0.5:
                    x[..., c] = x[..., c] + rng.normal(0.0, 0.1)
        if rng.random() < 0.15:  # ContrastAugmentationTransform(preserve_range)
            factor = rng.uniform(0.75, 1.25)
            mn, mx = x.min(), x.max()
            mean = x.mean()
            x = (x - mean) * factor + mean
            x = np.clip(x, mn, mx)
        out[i] = x
    return out

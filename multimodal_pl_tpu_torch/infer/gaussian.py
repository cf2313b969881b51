"""Gaussian patch-importance map (reference evaluate_amos.py:184-197).

A copy of ``multimodal_pl_tpu/infer/gaussian.py``: that module is JAX-free
but importing it runs ``multimodal_pl_tpu/infer/__init__.py``, which imports
JAX. tests/test_torch_port_infer.py pins the two equal.

sigma = tile/8, normalized to max 1, zeros replaced by the smallest positive
value.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter


def gaussian_importance_map(patch_size, sigma_scale: float = 1.0 / 8) -> np.ndarray:
    tmp = np.zeros(patch_size)
    center = [i // 2 for i in patch_size]
    sigmas = [i * sigma_scale for i in patch_size]
    tmp[tuple(center)] = 1
    g = gaussian_filter(tmp, sigmas, 0, mode="constant", cval=0)
    g = (g / np.max(g)).astype(np.float32)
    g[g == 0] = np.min(g[g != 0])
    return g

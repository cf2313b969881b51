"""Determinism helpers (reference utils.py:116-149 seedfix), the port of
``multimodal_pl_tpu/utils/prng.py``.

The host-side numpy generators of the data pipeline are seeded explicitly;
seedfix seeds python, numpy and torch for any remaining library code and
returns the root ``torch.Generator`` (the JAX version returns a PRNGKey).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seedfix(seed: int) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)

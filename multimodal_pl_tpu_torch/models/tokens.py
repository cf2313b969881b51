"""Class-token state, port of ``multimodal_pl_tpu/models/tokens.py:29-41``.

Tokens are explicit state passed to the model's forward, not parameters: the
reference kept them as plain tensors (unet3D.py:1016-1021). Their EMA update
(``renew_tokens``) belongs to training and is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

TOKEN_DIMS = {"t1": 128, "t2": 64, "t3": 32}


def init_class_tokens(generator: torch.Generator, num_classes: int = 14,
                      dims: Dict[str, int] | None = None) -> Dict[str, torch.Tensor]:
    """Standard-normal tokens (num_classes - 1, dim) per scale, as torch.randn
    (unet3D.py:1016-1021), drawn from ``generator``."""
    dims = dims or TOKEN_DIMS
    return {name: torch.randn((num_classes - 1, dim), generator=generator)
            for name, dim in dims.items()}

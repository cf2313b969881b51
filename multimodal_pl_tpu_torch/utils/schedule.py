"""Learning-rate schedules (reference utils.py:53-60), a copy of
``multimodal_pl_tpu/utils/schedule.py``."""

from __future__ import annotations


def lr_poly(base_lr: float, it: float, max_iter: float, power: float) -> float:
    return base_lr * ((1.0 - float(it) / max_iter) ** power)


def adjust_learning_rate(epoch: int, base_lr: float, num_epochs: int, power: float = 0.9) -> float:
    """Poly decay per epoch — the value the reference writes into the
    optimizer's param_group (utils.py:56-60)."""
    return lr_poly(base_lr, epoch, num_epochs, power)

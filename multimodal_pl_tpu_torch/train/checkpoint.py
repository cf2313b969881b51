"""Checkpoint and resume of the whole :class:`TrainState`, port of
``multimodal_pl_tpu/train/checkpoint.py``.

One ``torch.save`` holds params, rparams, dparams, momentum, tokens, step and
epoch (the reference lost the EMA class tokens on save), so a resumed run
continues bit for bit. Files are ``ckpt_<step>.pt``, written to a temporary
name and renamed into place. :func:`restore_checkpoint` and
:func:`latest_checkpoint` also take the JAX package's orbax directories
``ckpt_<step>/`` (read by ``convert.read_orbax_train_state``).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import torch

from multimodal_pl_tpu_torch.train.state import TrainState


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"ckpt_{step}.pt"))
    tmp = path + ".tmp"
    blob = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    blob["momentum"] = list(blob["momentum"])
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, device="cpu") -> TrainState:
    """The TrainState of a ``ckpt_<step>.pt``, or of an orbax ``ckpt_<step>/``
    directory of the JAX package."""
    if os.path.isdir(path):
        from multimodal_pl_tpu_torch.convert import read_orbax_train_state

        return read_orbax_train_state(path).to(device)
    blob = torch.load(path, map_location=device, weights_only=True)
    blob["momentum"] = tuple(blob["momentum"])
    return TrainState(**blob)


def checkpoint_step(ckpt_dir: str, name: str) -> Optional[int]:
    """The step of ``ckpt_dir/name`` if it is a checkpoint: a file
    ``ckpt_<step>.pt`` or an orbax directory ``ckpt_<step>``; else None."""
    m = re.fullmatch(r"ckpt_(\d+)(\.pt)?", name)
    if m is None or m.group(2) is None and not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(m.group(1))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of the highest step in ``ckpt_dir``, of either kind."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = {d: checkpoint_step(ckpt_dir, d) for d in os.listdir(ckpt_dir)}
    steps = {d: s for d, s in steps.items() if s is not None}
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps, key=steps.get))

"""Checkpoint and resume of the whole :class:`TrainState`, port of
``multimodal_pl_tpu/train/checkpoint.py``.

One ``torch.save`` holds params, rparams, dparams, momentum, tokens, step and
epoch (the reference lost the EMA class tokens on save), so a resumed run
continues bit for bit. Files are ``ckpt_<step>.pt``, written to a temporary
name and renamed into place.
"""

from __future__ import annotations

import dataclasses
import os
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
    blob = torch.load(path, map_location=device, weights_only=True)
    blob["momentum"] = tuple(blob["momentum"])
    return TrainState(**blob)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [d for d in os.listdir(ckpt_dir) if d.startswith("ckpt_") and d.endswith(".pt")]
    if not cands:
        return None
    best = max(cands, key=lambda d: int(d[len("ckpt_"):-len(".pt")]))
    return os.path.join(ckpt_dir, best)

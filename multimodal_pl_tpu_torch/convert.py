"""Checkpoint conversion and loading for the FEAM segmenter.

- :func:`state_dict_from_jax` turns the JAX package's params (flax nested
  dicts of arrays) and class tokens into a reference-style ``state_dict``
  (the layout of ``multimodal_pl_tpu/train/torch_import.py:154``), which the
  port's model loads as it is.
- :func:`load_feam_state_dict` loads such a dict (a reference ``.pth`` or an
  ``.npz`` written by :func:`save_npz`) into the port's model with
  ``strict=True``, after stripping DataParallel's ``module.`` prefix, and
  returns the class tokens ``class_token{1,2,3}`` when present.

Conventions: conv weights (kd, kh, kw, in, out) -> (out, in, kd, kh, kw);
linear weights (in, out) -> (out, in); norm scale -> weight; the heads'
``gn``/``conv`` -> nn.Sequential indices ``0``/``2``; ``blockJ`` -> ``J``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_HEAD_NAMES = {"fusion": "fusionConv", "precls": "precls_conv"}
_TOKEN_KEYS = {"t1": "class_token1", "t2": "class_token2", "t3": "class_token3"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _torch_key(path) -> str:
    path = list(path[1:] if path[0] == "encoder" else path)
    out = []
    for p in path[:-1]:
        if p.startswith("block"):
            out.append(p[len("block"):])
        else:
            out.append({**_HEAD_NAMES, "gn": "0", "conv": "2"}.get(p, p))
    out.append({"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1]))
    return ".".join(out)


def _torch_value(path, value) -> torch.Tensor:
    a = np.array(value, dtype=np.float32)  # a writable copy
    if path[-1] == "kernel" and a.ndim == 5:
        a = a.transpose(4, 3, 0, 1, 2)
    elif path[-1] == "kernel" and a.ndim == 2:
        a = a.T
    return torch.from_numpy(np.ascontiguousarray(a))


def state_dict_from_jax(params: Mapping, tokens: Optional[Mapping] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX FEAM params (``{'params': {...}}`` or the inner dict, numpy or
    JAX arrays) and optional tokens {'t1','t2','t3'} -> reference-style
    state_dict of f32 tensors (tokens as ``class_token{1,2,3}``)."""
    p = params["params"] if "params" in params else params
    sd = {_torch_key(path): _torch_value(path, v) for path, v in _flatten(p)}
    for key, name in _TOKEN_KEYS.items():
        if tokens and key in tokens:
            sd[name] = torch.from_numpy(np.array(tokens[key], dtype=np.float32))
    return sd


def load_feam_state_dict(model: torch.nn.Module, sd: Mapping
                         ) -> Optional[Dict[str, torch.Tensor]]:
    """Load a reference-style state_dict into ``model`` (strict). Returns the
    tokens {'t1','t2','t3'} found under ``class_token{1,2,3}``, or None."""
    sd = {re.sub(r"^module\.", "", k):
          v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
          for k, v in sd.items()}
    tokens = {key: sd.pop(name).float() for key, name in _TOKEN_KEYS.items() if name in sd}
    model.load_state_dict(sd, strict=True)
    return tokens or None


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A state_dict from a reference ``.pth`` or from an ``.npz`` written by
    :func:`save_npz`."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def save_npz(path: str, sd: Mapping[str, torch.Tensor]) -> None:
    """Write a state_dict as an ``.npz`` of f32 arrays."""
    np.savez(path, **{k: v.detach().cpu().float().numpy() for k, v in sd.items()})

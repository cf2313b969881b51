"""Checkpoint conversion and loading.

- :func:`state_dict_from_jax` turns the JAX package's params (flax nested
  dicts of arrays) and class tokens into a reference-style ``state_dict``
  (the layout of ``multimodal_pl_tpu/train/torch_import.py:154``), which the
  port's model loads as it is. The same mapping serves the refiner (the
  inverse of ``torch_import.refiner_state_dict_to_params``), the
  discriminators and their variants (``blockN``/``min_blockN``/``head``,
  ``fc1-3``), the ablation U-Nets (the trunk's flat names; ``class_token``,
  ``linear84_2_42``, ``gap_gn``, ``controller`` as the JAX tree names them:
  their original torch source is absent) and the EAM variants.
- :func:`train_state_from_jax` carries a whole JAX ``TrainState`` across as
  the port's :class:`~multimodal_pl_tpu_torch.train.state.TrainState`.
- :func:`read_orbax_train_state` reads a JAX ``TrainState`` that the JAX
  package's ``train/checkpoint.py`` wrote (orbax, a ``ckpt_<step>/``
  directory) with ``tensorstore`` alone, and carries it across as the
  port's ``TrainState``;
- :func:`read_checkpoint` gives the segmenter's state_dict from any of the
  formats a user holds: a reference ``.pth``, an ``.npz`` written by
  :func:`save_npz`, a ``ckpt_<step>.pt`` of ``mpl-train-torch`` or a
  ``ckpt_<step>/`` of ``mpl-train``;
- :func:`load_feam_state_dict` loads such a dict into the port's model with
  ``strict=True``, after stripping DataParallel's ``module.`` prefix, and
  returns the class tokens ``class_token{1,2,3}`` when present.

Conventions: conv weights (kd, kh, kw, in, out) -> (out, in, kd, kh, kw);
linear weights (in, out) -> (out, in); norm scale -> weight; the heads'
``gn``/``conv`` -> nn.Sequential indices ``0``/``2``; a stage's ``blockJ``
-> ``J`` (a ``blockN`` that holds the parameters itself, a discriminator
layer, keeps its name).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import types
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from multimodal_pl_tpu_torch.train.state import TrainState

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
    for i, p in enumerate(path[:-1]):
        if p.startswith("block") and i < len(path) - 2:  # a stage's blockJ
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


def train_state_from_jax(state) -> TrainState:
    """A JAX ``TrainState`` (params, rparams, dparams, momentum, tokens,
    step, epoch) -> the port's TrainState of f32 CPU tensors."""
    sd = state_dict_from_jax
    return TrainState(
        params=sd(state.params), rparams=sd(state.rparams), dparams=sd(state.dparams),
        momentum=(sd(state.momentum[0]), sd(state.momentum[1])),
        tokens={k: torch.from_numpy(np.array(v, dtype=np.float32))
                for k, v in state.tokens.items()},
        step=torch.tensor(int(state.step)), epoch=torch.tensor(int(state.epoch)))


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


def read_orbax_train_state(path: str) -> TrainState:
    """The JAX ``TrainState`` in an orbax checkpoint directory (``ckpt_<step>/``
    of ``multimodal_pl_tpu/train/checkpoint.py``, OCDBT-backed zarr) as the
    port's TrainState of f32 CPU tensors. Each array is opened with
    ``tensorstore`` under its tree path (the keys of ``_METADATA``'s
    ``tree_metadata`` joined by '.'); neither orbax nor JAX is imported."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(f"reading the orbax checkpoint {path} needs the 'tensorstore' "
                          "package, which is not installed") from e
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt"):
        raise ValueError(f"{path}: only OCDBT orbax checkpoints are read")
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        spec = {"driver": driver, "kvstore": {"driver": "ocdbt", "base": f"file://{path}",
                                              "path": ".".join(keys) + "/"}}
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = ts.open(spec, open=True).result().read().result()
    fields = {f.name for f in dataclasses.fields(TrainState)}
    if set(tree) != fields:
        raise ValueError(f"{path}: tree {sorted(tree)} is not a TrainState {sorted(fields)}")
    tree["momentum"] = (tree["momentum"]["0"], tree["momentum"]["1"])
    return train_state_from_jax(types.SimpleNamespace(**tree))


def _with_tokens(sd: Mapping, tokens: Mapping) -> Dict[str, torch.Tensor]:
    out = dict(sd)
    out.update({_TOKEN_KEYS[k]: v for k, v in tokens.items() if k in _TOKEN_KEYS})
    return out


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The segmenter's state_dict (with the class tokens as
    ``class_token{1,2,3}`` where the checkpoint holds them) from a reference
    ``.pth``, an ``.npz`` written by :func:`save_npz`, a ``ckpt_<step>.pt``
    that ``mpl-train-torch`` wrote (its ``params`` and ``tokens``) or a
    ``ckpt_<step>/`` orbax directory that ``mpl-train`` wrote."""
    if os.path.isdir(path):
        state = read_orbax_train_state(path)
        return _with_tokens(state.params, state.tokens)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if {f.name for f in dataclasses.fields(TrainState)} <= set(blob):
        return _with_tokens(blob["params"], blob["tokens"])
    return dict(blob)


def save_npz(path: str, sd: Mapping[str, torch.Tensor]) -> None:
    """Write a state_dict as an ``.npz`` of f32 arrays."""
    np.savez(path, **{k: v.detach().cpu().float().numpy() for k, v in sd.items()})

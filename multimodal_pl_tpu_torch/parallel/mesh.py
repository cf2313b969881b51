"""Data-parallel process groups and batch sharding, port of
``multimodal_pl_tpu/parallel/mesh.py``.

The JAX package runs one process over a ``jax.sharding.Mesh``; the port runs
one process per GPU, started by ``torchrun`` (which sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``), in one ``torch.distributed`` process
group: NCCL for CUDA devices, gloo for the CPU. ``--mesh data:N`` names N
ranks and raises unless the world size is N. :func:`init_mesh` also takes a
``space`` axis (``--mesh space:N`` or ``data:M,space:N``, M * N ranks): each
run of N consecutive ranks is one group that splits every tile's H axis
(:mod:`multimodal_pl_tpu_torch.parallel.spatial`, serving only), and the M
groups each run every window, as the JAX package replicates over ``data``.
The train step has no H split yet: :func:`init_data_parallel`, the
trainer's, raises NotImplementedError for a ``space`` axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterator, List

import numpy as np
import torch
import torch.distributed as dist


def parse_mesh(spec: str) -> Dict[str, int]:
    """'data:8' or 'data:4,space:2' -> {axis name: size}, in order (the axes
    of the JAX package's ``make_mesh``)."""
    axes = {}
    for part in spec.split(","):
        name, size = part.split(":")
        axes[name.strip()] = int(size)
    return axes


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the data-parallel group: rank, world size,
    device and the process group (the default one, never None: a step or
    predictor given None runs without collectives); with a ``space`` axis,
    this rank's SpatialGroup."""

    rank: int
    world: int
    device: torch.device
    group: dist.ProcessGroup
    space: object = None


def barrier(device) -> None:
    """Wait for every rank of the default group; an NCCL group waits on this
    rank's device (without it NCCL guesses one)."""
    device = torch.device(device)
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()


def rank_device(name) -> torch.device:
    """The device of this rank for ``--device name`` (a name or a
    torch.device): a bare ``cuda`` is ``cuda:LOCAL_RANK``; any other is taken
    as it is."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


@contextlib.contextmanager
def _process_group(spec: str, n: int, device) -> Iterator[torch.device]:
    """The default group of ``n`` ranks for ``--mesh spec`` (its device is
    yielded), for the duration of the ``with`` block.

    The world comes from ``torchrun``'s ``RANK``/``WORLD_SIZE`` (a plain
    process is rank 0 of 1). Raises ValueError when ``n`` is not the world
    size. A group that already exists (a caller that set it up, as
    ``tools/spawn.py`` does) is used and left in place; otherwise one is
    created (NCCL for a CUDA device, gloo for the CPU; a CUDA rank first makes
    its device current, or NCCL binds every rank to ``cuda:0``) and destroyed
    on exit."""
    created = not dist.is_initialized()
    world = dist.get_world_size() if not created else int(os.environ.get("WORLD_SIZE", 1))
    if n != world:
        raise ValueError(f"mesh {spec} needs {n} devices, have {world}: the world size is "
                         f"{world} (one process per device; launch with torchrun "
                         f"--nproc_per_node {n})")
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if created:
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "MASTER_ADDR" in os.environ:  # torchrun's rendezvous
            dist.init_process_group(backend, rank=int(os.environ.get("RANK", 0)),
                                    world_size=world)
        else:  # a plain process: a group of one needs no rendezvous
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield device
    finally:
        if created:
            dist.destroy_process_group()


@contextlib.contextmanager
def init_data_parallel(spec: str, device) -> Iterator[DataParallel]:
    """The data-parallel group of ``--mesh spec`` on ``device`` (a bare
    ``cuda``: ``cuda:LOCAL_RANK``), for the duration of the ``with`` block
    (:func:`_process_group`). Raises ValueError when the mesh's size is not
    the world size, NotImplementedError for a ``space`` axis: the trainer
    builds the data-parallel step only, as JAX's does (the spatial step is
    ``parallel.spatial.make_spatial_train_step``)."""
    axes = parse_mesh(spec)
    if "space" in axes:
        raise NotImplementedError(
            f"--mesh {spec}: mpl-train-torch trains with data:N only (ROADMAP.md queue 1); the "
            "H-split step is parallel.spatial.make_spatial_train_step, and mpl-evaluate-torch "
            "serves with space:N")
    if set(axes) != {"data"}:
        raise ValueError(f"--mesh {spec}: the port's mesh has one axis, data:N")
    with _process_group(spec, axes["data"], device) as device:
        yield DataParallel(rank=dist.get_rank(), world=dist.get_world_size(), device=device,
                           group=dist.group.WORLD)


@contextlib.contextmanager
def init_mesh(spec: str, device) -> Iterator[DataParallel]:
    """The serving mesh of ``--mesh spec`` (``data:M``, ``space:N`` or
    ``data:M,space:N``) on ``device``, for the duration of the ``with``
    block: the default group of M * N ranks (:func:`_process_group`) and,
    with a space axis, this rank's group of the N consecutive ranks that
    split each tile's H axis (``dist.new_group``, one per run of N ranks,
    made on every rank in the same order) as ``space``."""
    axes = parse_mesh(spec)
    if not set(axes) <= {"data", "space"} or not axes:
        raise ValueError(f"--mesh {spec}: the axes are data:M and space:N")
    n = axes.get("space", 1)
    with _process_group(spec, axes.get("data", 1) * n, device) as device:
        rank, world = dist.get_rank(), dist.get_world_size()
        space = None
        if "space" in axes:
            from multimodal_pl_tpu_torch.parallel.spatial import SpatialGroup

            groups = [dist.new_group(list(range(i, i + n))) for i in range(0, world, n)]
            space = SpatialGroup.of(groups[rank // n])
        yield DataParallel(rank=rank, world=world, device=device, group=dist.group.WORLD,
                           space=space)


def shard_batch(per_device_batches: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-device batch dicts into the JAX sharded step's global layout:
    image and label concatenated on the batch axis, catlas, sup_mask and
    label_t stacked on a new leading device axis. (The port's ranks each take
    their own batch dict; this layout is what the JAX step and the tests
    compare with.)"""
    out: Dict[str, np.ndarray] = {}
    for k in ("image", "label"):
        out[k] = np.concatenate([b[k] for b in per_device_batches], axis=0)
    for k in ("catlas", "sup_mask", "label_t"):
        out[k] = np.stack([b[k] for b in per_device_batches], axis=0)
    return out

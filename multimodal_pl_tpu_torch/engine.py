"""Engine: the runtime context of the reference's training scripts, port of
``multimodal_pl_tpu/engine.py``.

An API shim for the reference's Engine (engine.py:10-77): the same entry
points (``get_train_loader``, ``get_test_loader``, ``data_parallel``,
``all_reduce_tensor``, ``world_size``, ``local_rank``) over the port's
pieces: prefetching dataset iterators and a ``torch.distributed`` process
group (:func:`multimodal_pl_tpu_torch.parallel.mesh.init_data_parallel`).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch
import torch.distributed as dist


def extant_file(x: str) -> str:
    """argparse type checking file existence (reference utils.py:62-70)."""
    if not os.path.exists(x):
        raise argparse.ArgumentTypeError(f"{x} does not exist")
    return x


class Engine:
    """Context manager exposing the reference surface. ``world_size`` and
    ``local_rank`` are those of the default process group, if there is one
    (under ``torchrun``), else 1 and 0."""

    def __init__(self, custom_parser: Optional[argparse.ArgumentParser] = None):
        self.parser = custom_parser or argparse.ArgumentParser()
        self.inject_default_parser()
        grouped = dist.is_available() and dist.is_initialized()
        self.world_size = dist.get_world_size() if grouped else 1
        self.local_rank = int(os.environ.get("LOCAL_RANK", 0)) if grouped else 0
        self.distributed = self.world_size > 1

    def inject_default_parser(self):
        p = self.parser
        p.add_argument("-d", "--devices", default="", help="set data parallel training")
        p.add_argument("-c", "--continue", type=extant_file, metavar="FILE",
                       dest="continue_fpath", help="continue from one certain checkpoint")

    def get_train_loader(self, dataset, batch_size: int = 1, collate_fn=None, epochs: int = 1):
        """Prefetching train iterator (replaces torch DataLoader + sampler)."""
        return dataset.batches(batch_size=batch_size, shuffle=True, augment=True,
                               epochs=epochs), None

    def get_test_loader(self, dataset):
        def it():
            for i in range(len(dataset)):
                yield dataset[i]

        return it(), None

    def data_parallel(self, step_fn_or_model):
        """Data parallelism is a property of the step
        (:func:`multimodal_pl_tpu_torch.parallel.make_sharded_train_step`), not
        a model wrapper; returned unchanged for API compatibility."""
        return step_fn_or_model

    def all_reduce_tensor(self, tensor: torch.Tensor, norm: bool = True) -> torch.Tensor:
        """The tensor summed over the ranks (divided by the world size when
        ``norm``), as the reference's engine.py:57-58; without a
        multi-rank group, the tensor's mean (its single-process fallback)."""
        if not self.distributed:
            return torch.mean(tensor)
        out = tensor.clone()
        dist.all_reduce(out)
        return out / self.world_size if norm else out

    def __enter__(self):
        return self

    def __exit__(self, exc_type, value, tb):
        if exc_type is not None:
            print("An exception occurred during Engine initialization, "
                  "give up running process")
            return False

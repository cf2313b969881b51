"""Data parallelism over ``torch.distributed``, port of
``multimodal_pl_tpu/parallel``.

The reference trained with NCCL data-parallel DDP over 3 GPUs
(run_amos_atlas_final.sh:2-5); the JAX package runs it as a ``data`` mesh
with a ``shard_map``'d step. The port runs one process per GPU under
``torchrun`` (NCCL; gloo on the CPU): the data-parallel train step
(gradients averaged before the non-finite guard, token EMA statistics
summed), per-rank batches, and sliding-window inference with the windows
spread over the ranks; and for serving, each tile's H axis split over a
group of ranks (``parallel/spatial.py``, the ``space`` axis).
"""

from multimodal_pl_tpu_torch.parallel.mesh import (
    init_data_parallel,
    init_mesh,
    parse_mesh,
    shard_batch,
)
from multimodal_pl_tpu_torch.parallel.sharded_step import make_sharded_train_step

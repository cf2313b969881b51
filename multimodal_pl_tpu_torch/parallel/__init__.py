"""Data parallelism over ``torch.distributed``, port of
``multimodal_pl_tpu/parallel``.

The reference trained with NCCL data-parallel DDP over 3 GPUs
(run_amos_atlas_final.sh:2-5); the JAX package runs it as a ``data`` mesh
with a ``shard_map``'d step. The port runs one process per GPU under
``torchrun`` (NCCL; gloo on the CPU): the data-parallel train step
(gradients averaged before the non-finite guard, token EMA statistics
summed), per-rank batches, and sliding-window inference with the windows
spread over the ranks. The ``space`` axis (``parallel/spatial.py``) is not
ported.
"""

from multimodal_pl_tpu_torch.parallel.mesh import init_data_parallel, parse_mesh, shard_batch
from multimodal_pl_tpu_torch.parallel.sharded_step import make_sharded_train_step

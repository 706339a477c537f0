"""Multi-device training and serving over ``torch.distributed``.

The port's counterpart of ``deeprank_gnn_tpu/parallel``: one process is
one rank is one shard, where JAX has one device of a ``Mesh``.

- ``distributed.py``: multi-process start-up (``initialize`` from the
  ``DEEPRANK_*`` variables or ``torchrun``'s);
- ``mesh.py``: the ``(dp, ep)`` mesh of ranks and the graph-parallel
  placement of a batch (each rank a contiguous range of the graphs, in
  both layouts);
- ``step.py``: the graph-parallel train and eval steps (global loss
  summed in rank order from one all-gather, gradients summed by one
  all-reduce), and the scanned mesh step's parts;
- ``halo.py``: the explicit halo-exchange edge-parallel layout
  (``layout="halo"``);
- ``collectives.py``: the all-to-all, all-gather and all-reduce those
  issue, differentiable, with a byte counter.
"""

from deeprank_gnn_tpu_torch.parallel.halo import (
    HaloBatch,
    cross_shard_max_pool,
    ginet_apply_halo,
    halo_exchange,
    halo_gin_aggregate,
    make_halo_eval_step,
    make_halo_train_step,
    partition_batch,
    shard_halo_batch,
)
from deeprank_gnn_tpu_torch.parallel.mesh import Mesh, make_halo_mesh, make_mesh
from deeprank_gnn_tpu_torch.parallel.step import make_sharded_train_step

__all__ = [
    "Mesh",
    "make_mesh",
    "make_sharded_train_step",
    "HaloBatch",
    "make_halo_mesh",
    "partition_batch",
    "shard_halo_batch",
    "halo_exchange",
    "halo_gin_aggregate",
    "cross_shard_max_pool",
    "ginet_apply_halo",
    "make_halo_train_step",
    "make_halo_eval_step",
]

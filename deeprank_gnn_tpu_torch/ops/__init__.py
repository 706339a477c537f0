"""Sparse segment / gather / coalesce primitives for padded graph batches,
and the CUDA kernels beneath them.

The port's counterpart of ``deeprank_gnn_tpu/ops``, with its exports: the
segment reductions (:mod:`.segment`), edge coalescing (:mod:`.coalesce`)
and the pooling reductions (:mod:`.pooling`) are plain torch over the hand
kernels of :mod:`.kernels` (K1, K2, K3 in ``ops/csrc``), each of which
runs its plain PyTorch version on a CPU tensor.
"""

from deeprank_gnn_tpu_torch.ops.segment import (
    segment_sum,
    segment_mean,
    segment_max,
    segment_min,
    segment_softmax,
    gather,
)
from deeprank_gnn_tpu_torch.ops.coalesce import coalesce_edges
from deeprank_gnn_tpu_torch.ops.pooling import (
    community_pooling_x,
    community_pooling_pos,
    max_pool_x,
    graph_mean_pool,
)

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "gather",
    "coalesce_edges",
    "community_pooling_x",
    "community_pooling_pos",
    "max_pool_x",
    "graph_mean_pool",
]

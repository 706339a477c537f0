"""Hierarchical community-pooling reductions over padded batches.

The port's counterpart of ``deeprank_gnn_tpu/ops/pooling.py``, reproducing
the device-side math of the reference's community pooling (reference
`community_pooling.py:161-251`):

- node features are **max**-pooled over cluster members
  (`scatter_max`, `community_pooling.py:201`);
- positions are **mean**-pooled (`community_pooling.py:213-214`);
- the per-graph readout is a mean over nodes (`ginet.py:133-134`);
- `max_pool_x` is a plain cluster max-pool (`ginet.py:114`).

The cluster assignments arrive precomputed from the host batcher.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeprank_gnn_tpu_torch.ops.dense import member_max_pool
from deeprank_gnn_tpu_torch.ops.segment import segment_max, segment_mean


def community_pooling_x(
    x: torch.Tensor,
    assign: torch.Tensor,
    num_clusters: int,
    mem_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Max-pool node features over cluster members. [N,F]x[N] -> [C,F].
    With a member table (`GraphBatch.mem0_idx`) the pool is a row
    gather (`member_max_pool` with a singleton graph axis)."""
    if mem_idx is not None:
        return member_max_pool(x[None], mem_idx[None])[0]
    return segment_max(x, assign, num_clusters)


def community_pooling_pos(
    pos: torch.Tensor, assign: torch.Tensor, num_clusters: int
) -> torch.Tensor:
    """Mean-pool node positions over cluster members. [N,3]x[N] -> [C,3]."""
    return segment_mean(pos, assign, num_clusters)


def max_pool_x(
    x: torch.Tensor,
    assign: torch.Tensor,
    num_clusters: int,
    mem_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """PyG `max_pool_x` equivalent (reference `ginet.py:114`)."""
    return community_pooling_x(x, assign, num_clusters, mem_idx)


def graph_mean_pool(
    x: torch.Tensor, graph_ids: torch.Tensor, num_graphs: int
) -> torch.Tensor:
    """Per-graph mean readout (`scatter_mean(x, batch)`, reference
    `ginet.py:133-134`), count clamped to 1. [N,F]x[N] -> [G,F]."""
    return segment_mean(x, graph_ids, num_graphs)

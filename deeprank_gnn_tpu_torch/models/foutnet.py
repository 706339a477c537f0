"""FoutNet: pairwise interface convolution (reference `foutnet.py`).

The port's counterpart of ``deeprank_gnn_tpu/models/foutnet.py``. The
FoutLayer (Fout et al., NIPS 2017) computes, per node,
``x Wc + mean_{j in N(i)} (x_j Wn) + b``. The reference implements the
neighbor mean with a per-node Python loop (reference `foutnet.py:69-73`);
here it is one segment mean over the row-sorted edges, whose sum runs on
the sorted segment sum kernel (K1): two launches per sparse batch. The
reference yields NaN for an isolated node (``torch.mean`` of an empty
slice); interface graphs have none by construction, and the JAX package
and the port give 0 there. There is no dropout (reference `foutnet.py:123`
is dead code).

On a ``DenseGraphBatch`` the neighbor mean is the dense edge-to-slot mean
(``ops/dense.py``), the JAX package's streaming branch, or, when the batch
carries the precomputed operators, the stored sum aggregation ``agg_x``
divided by the in-degree at level 1 and the stored pooled adjacency at
level 2 (JAX ``foutnet.py:118-138``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from deeprank_gnn_tpu_torch.data.batch import GraphBatch
from deeprank_gnn_tpu_torch.data.dense_batch import DenseGraphBatch
from deeprank_gnn_tpu_torch.models.common import SingleTowerNet, uniform_init
from deeprank_gnn_tpu_torch.ops.dense import (
    adj_conv,
    cluster_max_pool,
    edge_mean_to_slots,
    gather_nodes,
    masked_mean,
)
from deeprank_gnn_tpu_torch.ops.pooling import (
    community_pooling_x,
    graph_mean_pool,
    max_pool_x,
)
from deeprank_gnn_tpu_torch.ops.segment import gather, segment_mean


class FoutLayer(nn.Module):
    """Parameters of one FoutLayer (reference `foutnet.py:15-54`): ``Wc``
    and ``Wn`` in the raw ``[in, out]`` layout (applied as ``x @ Wc``) and
    ``bias``, all seeded with uniform(size=in_channels)."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Wc = nn.Parameter(uniform_init((in_channels, out_channels), in_channels, generator))
        self.Wn = nn.Parameter(uniform_init((in_channels, out_channels), in_channels, generator))
        self.bias = nn.Parameter(uniform_init((out_channels,), in_channels, generator))


def fout_layer(
    layer: FoutLayer,
    x: torch.Tensor,
    edge_index: torch.Tensor,
    num_nodes: int,
    row_ptr: torch.Tensor,
) -> torch.Tensor:
    """FoutLayer (reference `foutnet.py:56-82`) over row-sorted edges with
    CSR pointers ``row_ptr``: the neighbor mean's sum runs on K1."""
    row, col = edge_index[0], edge_index[1]
    gamma = segment_mean(gather(x @ layer.Wn, col), row, num_nodes, row_ptr=row_ptr)
    return x @ layer.Wc + gamma + layer.bias


def fout_layer_dense(
    layer: FoutLayer, x: torch.Tensor, row: torch.Tensor, col: torch.Tensor, size: int
) -> torch.Tensor:
    """FoutLayer in the dense layout (JAX ``foutnet.py:110-116``)."""
    gamma = edge_mean_to_slots(gather_nodes(x @ layer.Wn, col), row, size)
    return x @ layer.Wc + gamma + layer.bias


class FoutNet(SingleTowerNet):
    """Single-tower hierarchical net (reference `foutnet.py:90-126`):
    two FoutLayers (16 and 32 channels) with community pooling between
    them, a cluster max pool, a per-graph mean and the fc head 32 -> 64 ->
    ``output_shape``. ``input_shape_edge`` is unused, as in the reference.
    See :class:`~deeprank_gnn_tpu_torch.models.common.SingleTowerNet`."""

    def __init__(
        self,
        input_shape: int,
        output_shape: int = 1,
        input_shape_edge: Optional[int] = None,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(FoutLayer, input_shape, output_shape, device, generator)

    def _pooled_dense(self, batch: DenseGraphBatch) -> torch.Tensor:
        c0g, c1g = batch.pool0_mask.shape[1], batch.pool1_mask.shape[1]
        if batch.agg_x is not None:
            # the neighbor mean is the sum operator over the in-degree, and
            # both commute with the Wn projection
            c1, c2 = self.conv1, self.conv2
            mean_x = batch.agg_x / torch.clamp(batch.deg0, min=1.0)[..., None]
            h = torch.relu(batch.x @ c1.Wc + mean_x @ c1.Wn + c1.bias)
            hp = cluster_max_pool(h, batch.assign0, c0g, batch.mem0_idx)
            deg1 = torch.clamp(batch.adj1.to(torch.float32).sum(dim=-1), min=1.0)
            h2 = torch.relu(hp @ c2.Wc + adj_conv(hp @ c2.Wn, batch.adj1) / deg1[..., None]
                            + c2.bias)
        else:
            h = torch.relu(fout_layer_dense(self.conv1, batch.x, batch.row, batch.col,
                                            batch.x.shape[1]))
            hp = cluster_max_pool(h, batch.assign0, c0g, batch.mem0_idx)
            h2 = torch.relu(fout_layer_dense(self.conv2, hp, batch.pe_row, batch.pe_col, c0g))
        return masked_mean(cluster_max_pool(h2, batch.assign1, c1g, batch.mem1_idx),
                           batch.pool1_mask)

    def _pooled(self, batch: GraphBatch) -> torch.Tensor:
        n, c0, c1 = batch.num_nodes, batch.num_clusters0, batch.num_clusters1
        h = torch.relu(fout_layer(self.conv1, batch.x, batch.edge_index, n, batch.edge_rowptr))
        hp = community_pooling_x(h, batch.assign0, c0, batch.mem0_idx)
        h2 = torch.relu(fout_layer(self.conv2, hp, batch.pe_index, c0, batch.pe_rowptr))
        hq = max_pool_x(h2, batch.assign1, c1, batch.mem1_idx)
        return graph_mean_pool(hq, batch.pool1_graph, batch.num_graphs)

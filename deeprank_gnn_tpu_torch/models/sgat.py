"""sGAT: simplified edge-scaled attention network (reference `sGAT.py`).

The port's counterpart of ``deeprank_gnn_tpu/models/sgat.py``. Per edge:
``alpha = ([x_row || x_col] W) * edge_attr``; per node the edge values are
mean-aggregated over the *row* side only (the loader direction-doubles
edges, so ``undirected=True`` skips the col-side scatter — reference quirk
Q10, `sGAT.py:81-87`). The concat-matmul is two node-level products
(``x @ W[:in]`` and ``x @ W[in:]``) followed by gathers: the same math over
N nodes instead of E edges. The row mean's sum runs on the sorted segment
sum kernel (K1): two launches per sparse batch. There is no dropout
(reference `sGAT.py:136` is dead code).

On a ``DenseGraphBatch`` the mean is the dense edge-to-slot mean
(``ops/dense.py``), the JAX package's streaming branch, or, when the batch
carries the edge-weighted operators, ``xr * rowsum(ea) + (A_w x) Wc`` over
the in-degree, from the stored ``wagg_x``, ``ea_rowsum0``, ``wadj1`` and
``ea_rowsum1`` (JAX ``sgat.py:130-159``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from deeprank_gnn_tpu_torch.data.batch import GraphBatch
from deeprank_gnn_tpu_torch.data.dense_batch import DenseGraphBatch
from deeprank_gnn_tpu_torch.models.common import SingleTowerNet, uniform_init
from deeprank_gnn_tpu_torch.ops.dense import (
    cluster_max_pool,
    edge_mean_to_slots,
    edge_sum_to_slots,
    gather_nodes,
    masked_mean,
)
from deeprank_gnn_tpu_torch.ops.pooling import (
    community_pooling_x,
    graph_mean_pool,
    max_pool_x,
)
from deeprank_gnn_tpu_torch.ops.segment import gather, segment_mean, segment_sum


class SGATLayer(nn.Module):
    """Parameters of one sGraphAttentionLayer (reference `sGAT.py:19-60`):
    ``weight`` in the raw ``[2*in, out]`` layout and ``bias``, seeded with
    uniform(size=2*in_channels)."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        size = 2 * in_channels
        self.weight = nn.Parameter(uniform_init((size, out_channels), size, generator))
        self.bias = nn.Parameter(uniform_init((out_channels,), size, generator))


def sgat_layer(
    layer: SGATLayer,
    x: torch.Tensor,
    edge_index: torch.Tensor,
    edge_attr: torch.Tensor,
    num_nodes: int,
    row_ptr: torch.Tensor,
    *,
    undirected: bool = True,
) -> torch.Tensor:
    """sGraphAttentionLayer (reference `sGAT.py:62-93`) over row-sorted
    edges with CSR pointers ``row_ptr``: the row mean's sum runs on K1.
    ``undirected=False`` averages each edge into both endpoints jointly
    (the reference's second ``scatter_mean`` into ``col`` sharing one
    buffer), a plain segment mean: those ids are not sorted."""
    row, col = edge_index[0], edge_index[1]
    in_ch = x.shape[1]
    xr = x @ layer.weight[:in_ch]
    xc = x @ layer.weight[in_ch:]
    alpha = (gather(xr, row) + gather(xc, col)) * edge_attr
    if undirected:
        out = segment_mean(alpha, row, num_nodes, row_ptr=row_ptr)
    else:
        out = segment_mean(torch.cat([alpha, alpha]), torch.cat([row, col]), num_nodes)
    return out + layer.bias


def sgat_layer_dense(
    layer: SGATLayer,
    x: torch.Tensor,
    row: torch.Tensor,
    col: torch.Tensor,
    edge_attr: torch.Tensor,
    size: int,
) -> torch.Tensor:
    """sGraphAttentionLayer in the dense layout (JAX ``sgat.py:121-128``)."""
    in_ch = x.shape[-1]
    xr = x @ layer.weight[:in_ch]
    xc = x @ layer.weight[in_ch:]
    alpha = (gather_nodes(xr, row) + gather_nodes(xc, col)) * edge_attr
    return edge_mean_to_slots(alpha, row, size) + layer.bias


class sGAT(SingleTowerNet):
    """Single-tower hierarchical net (reference `sGAT.py:101-139`): two
    sGraphAttentionLayers (16 and 32 channels) with community pooling
    between them, a cluster max pool, a per-graph mean and the fc head
    32 -> 64 -> ``output_shape``. ``input_shape_edge`` is unused, as in the
    reference. See
    :class:`~deeprank_gnn_tpu_torch.models.common.SingleTowerNet`."""

    def __init__(
        self,
        input_shape: int,
        output_shape: int = 1,
        input_shape_edge: Optional[int] = None,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(SGATLayer, input_shape, output_shape, device, generator)

    def _pooled_dense(self, batch: DenseGraphBatch) -> torch.Tensor:
        c0g, c1g = batch.pool0_mask.shape[1], batch.pool1_mask.shape[1]
        if batch.wagg_x is not None:
            in_ch = batch.x.shape[-1]
            w1, w2 = self.conv1.weight, self.conv2.weight
            xr = batch.x @ w1[:in_ch]
            h = torch.relu((xr * batch.ea_rowsum0[..., None] + batch.wagg_x @ w1[in_ch:])
                           / torch.clamp(batch.deg0, min=1.0)[..., None] + self.conv1.bias)
            hp = cluster_max_pool(h, batch.assign0, c0g, batch.mem0_idx)
            wagg2 = torch.bmm(batch.wadj1, hp @ w2[16:])
            deg1 = torch.clamp(batch.adj1.to(torch.float32).sum(dim=-1), min=1.0)
            h2 = torch.relu((hp @ w2[:16] * batch.ea_rowsum1[..., None] + wagg2)
                            / deg1[..., None] + self.conv2.bias)
        else:
            h = torch.relu(sgat_layer_dense(self.conv1, batch.x, batch.row, batch.col,
                                            batch.edge_attr, batch.x.shape[1]))
            hp = cluster_max_pool(h, batch.assign0, c0g, batch.mem0_idx)
            pe_attr = edge_sum_to_slots(batch.edge_attr, batch.edge_to_pe,
                                        batch.pe_mask.shape[1])
            h2 = torch.relu(sgat_layer_dense(self.conv2, hp, batch.pe_row, batch.pe_col,
                                             pe_attr, c0g))
        return masked_mean(cluster_max_pool(h2, batch.assign1, c1g, batch.mem1_idx),
                           batch.pool1_mask)

    def _pooled(self, batch: GraphBatch) -> torch.Tensor:
        n, c0, c1 = batch.num_nodes, batch.num_clusters0, batch.num_clusters1
        h = torch.relu(sgat_layer(self.conv1, batch.x, batch.edge_index, batch.edge_attr, n,
                                  batch.edge_rowptr))
        hp = community_pooling_x(h, batch.assign0, c0, batch.mem0_idx)
        pe_attr = segment_sum(batch.edge_attr, batch.edge_to_pe, batch.pe_mask.shape[0])
        h2 = torch.relu(sgat_layer(self.conv2, hp, batch.pe_index, pe_attr, c0,
                                   batch.pe_rowptr))
        hq = max_pool_x(h2, batch.assign1, c1, batch.mem1_idx)
        return graph_mean_pool(hq, batch.pool1_graph, batch.num_graphs)

"""GINet: edge-gated two-tower hierarchical GNN (reference `ginet.py`).

The port's counterpart of ``deeprank_gnn_tpu/models/ginet.py`` (sparse
layout, paper mode), with the reference's behavioral quirks:

- **Q1** (reference `ginet.py:66`): the attention logit is softmaxed
  over a size-1 axis, so the attention weight is identically 1.0 and its
  Jacobian identically 0 — the fc_attention / fc_edge_attr branch is
  dead. The conv therefore reduces to ``z = segment_sum((x @ W.T)[col],
  row)``; the dead parameters exist (same state-dict names as the
  reference) and are never read.
- **Q2** (reference `ginet.py:101,118-130`): BOTH towers run on the
  *interface* edges, not the internal edges.

On a sparse ``GraphBatch`` the edge aggregations always run as the sorted
segment sum kernel (K1), from the batch's CSR row pointers (``collate``
only builds row-sorted batches): two launches per batch on the fused path.
On a ``DenseGraphBatch`` they run as the per-graph GIN aggregation kernel
(K3), also twice per batch fused, and pooling is a max by assignment per
graph (``ops/dense.py``). Both layouts give the same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from deeprank_gnn_tpu_torch.data.batch import GraphBatch
from deeprank_gnn_tpu_torch.data.dense_batch import DenseGraphBatch
from deeprank_gnn_tpu_torch.device import resolve_device, set_fp32_numerics
from deeprank_gnn_tpu_torch.models.common import (
    dropout,
    linear,
    linear_init,
    uniform_init,
)
from deeprank_gnn_tpu_torch.ops.dense import masked_mean, slot_max_pool
from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import fused_gin_conv
from deeprank_gnn_tpu_torch.ops.pooling import (
    community_pooling_x,
    graph_mean_pool,
    max_pool_x,
)
from deeprank_gnn_tpu_torch.ops.segment import gather, segment_sum


def _linear_module(weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> nn.Linear:
    """An ``nn.Linear`` holding the given tensors (built uninitialized,
    so it draws nothing from the global RNG)."""
    m = nn.utils.skip_init(
        nn.Linear, weight.shape[1], weight.shape[0], bias=bias is not None
    )
    with torch.no_grad():
        m.weight.copy_(weight)
        if bias is not None:
            m.bias.copy_(bias)
    return m


class GINetConvLayer(nn.Module):
    """Parameters of one GINet conv (reference `ginet.py:22-48`): every
    tensor seeded with uniform(size=in_channels)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        number_edge_features: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        fe = number_edge_features
        self.fc = _linear_module(
            uniform_init((out_channels, in_channels), in_channels, generator)
        )
        self.fc_edge_attr = _linear_module(uniform_init((fe, fe), in_channels, generator))
        self.fc_attention = _linear_module(
            uniform_init((1, 2 * out_channels + fe), in_channels, generator)
        )


def ginet_conv(
    conv: GINetConvLayer,
    x: torch.Tensor,
    edge_index: torch.Tensor,
    num_nodes: int,
    row_ptr: torch.Tensor,
) -> torch.Tensor:
    """One GINet conv layer in paper mode (reference `ginet.py:50-73`):
    per quirk Q1 exactly ``segment_sum(W x[col], row)``, over row-sorted
    edges with CSR pointers ``row_ptr``."""
    row, col = edge_index[0], edge_index[1]
    xw = linear(x, conv.fc.weight)
    return segment_sum(gather(xw, col), row, num_nodes, row_ptr=row_ptr)


class GINet(nn.Module):
    """Two-tower hierarchical GINet (reference `ginet.py:81-141`).

    ``fuse=True`` (default) runs both towers at double width in one pass
    (:meth:`_towers_fused`); ``fuse=False`` runs them one by one
    (:meth:`_tower`) — the same numbers, since segment ops are
    column-independent. Parameters are drawn on the CPU from
    ``generator`` and moved to ``device``.
    """

    dropout_rate = 0.4  # reference `ginet.py:97`

    def __init__(
        self,
        input_shape: int,
        output_shape: int = 1,
        input_shape_edge: int = 1,
        attention: bool = False,
        internal_tower: bool = False,
        *,
        fuse: bool = True,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        if attention or internal_tower:
            raise NotImplementedError(
                "GINet(attention=True) and GINet(internal_tower=True) are not "
                "ported yet: see ROADMAP.md, queue 1 (the rest of the model zoo)"
            )
        super().__init__()
        dev = resolve_device(device)
        if dev.type == "cuda":
            set_fp32_numerics()
        self.fuse = fuse
        fe = input_shape_edge
        self.conv1 = GINetConvLayer(input_shape, 16, fe, generator)
        self.conv2 = GINetConvLayer(16, 32, fe, generator)
        self.conv1_ext = GINetConvLayer(input_shape, 16, fe, generator)
        self.conv2_ext = GINetConvLayer(16, 32, fe, generator)
        self.fc1 = _linear_module(*linear_init(64, 128, generator))
        self.fc2 = _linear_module(*linear_init(128, output_shape, generator))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.fc1.weight.device

    def _tower(
        self, conv1: GINetConvLayer, conv2: GINetConvLayer, batch: GraphBatch
    ) -> torch.Tensor:
        n, c0, c1 = batch.num_nodes, batch.num_clusters0, batch.num_clusters1
        # Q2 parity: the shipped reference runs BOTH towers on interface edges
        h = torch.relu(ginet_conv(conv1, batch.x, batch.edge_index, n, batch.edge_rowptr))
        # community pooling: max over cluster members
        hp = community_pooling_x(h, batch.assign0, c0, batch.mem0_idx)
        h2 = torch.relu(ginet_conv(conv2, hp, batch.pe_index, c0, batch.pe_rowptr))
        hq = max_pool_x(h2, batch.assign1, c1, batch.mem1_idx)
        return graph_mean_pool(hq, batch.pool1_graph, batch.num_graphs)

    def _towers_fused(self, batch: GraphBatch) -> torch.Tensor:
        """Paper-mode towers fused: per quirk Q2 both towers run on the
        interface edges with independent weights, so their features
        concatenate and every gather/segment pass runs ONCE at double
        width. Returns [G, 64] = [tower | tower_ext]."""
        n, c0, c1 = batch.num_nodes, batch.num_clusters0, batch.num_clusters1
        row, col = batch.edge_index[0], batch.edge_index[1]
        xw = torch.cat(
            [linear(batch.x, self.conv1.fc.weight),
             linear(batch.x, self.conv1_ext.fc.weight)],
            dim=1,
        )
        h = torch.relu(segment_sum(gather(xw, col), row, n, row_ptr=batch.edge_rowptr))
        hp = community_pooling_x(h, batch.assign0, c0, batch.mem0_idx)
        hw = torch.cat(
            [linear(hp[:, :16], self.conv2.fc.weight),
             linear(hp[:, 16:], self.conv2_ext.fc.weight)],
            dim=1,
        )
        prow, pcol = batch.pe_index[0], batch.pe_index[1]
        h2 = torch.relu(segment_sum(gather(hw, pcol), prow, c0, row_ptr=batch.pe_rowptr))
        hq = max_pool_x(h2, batch.assign1, c1, batch.mem1_idx)
        return graph_mean_pool(hq, batch.pool1_graph, batch.num_graphs)

    def _towers_dense_fused(self, batch: DenseGraphBatch) -> torch.Tensor:
        """Dense-layout analog of :meth:`_towers_fused`: one K3 launch per
        conv level at double width (the JAX package's branch without
        precomputed operators). Returns [G, 64]."""
        c0g, c1g = batch.pool0_mask.shape[1], batch.pool1_mask.shape[1]
        xw = torch.cat(
            [linear(batch.x, self.conv1.fc.weight),
             linear(batch.x, self.conv1_ext.fc.weight)],
            dim=-1,
        )
        h = torch.relu(fused_gin_conv(xw, batch.row, batch.col))
        hp = slot_max_pool(h, batch.assign0, c0g)
        hw = torch.cat(
            [linear(hp[..., :16], self.conv2.fc.weight),
             linear(hp[..., 16:], self.conv2_ext.fc.weight)],
            dim=-1,
        )
        h2 = torch.relu(fused_gin_conv(hw, batch.pe_row, batch.pe_col))
        hq = slot_max_pool(h2, batch.assign1, c1g)
        return masked_mean(hq, batch.pool1_mask)

    def _tower_dense(
        self, conv1: GINetConvLayer, conv2: GINetConvLayer, batch: DenseGraphBatch
    ) -> torch.Tensor:
        """One dense tower (the JAX package's non-attention branch): the
        same numbers as :meth:`_tower`."""
        c0g, c1g = batch.pool0_mask.shape[1], batch.pool1_mask.shape[1]
        xw = linear(batch.x, conv1.fc.weight)
        h = torch.relu(fused_gin_conv(xw, batch.row, batch.col))
        hp = slot_max_pool(h, batch.assign0, c0g)
        hw = linear(hp, conv2.fc.weight)
        h2 = torch.relu(fused_gin_conv(hw, batch.pe_row, batch.pe_col))
        hq = slot_max_pool(h2, batch.assign1, c1g)
        return masked_mean(hq, batch.pool1_mask)

    def forward(
        self, batch, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """[G, output_shape] scores of a padded batch, a sparse
        ``GraphBatch`` or a ``DenseGraphBatch`` (moved to the model's device
        first). Dropout follows ``self.training`` and draws from
        ``generator``."""
        batch = batch.to(self.device)
        if isinstance(batch, DenseGraphBatch):
            if self.fuse:
                h = self._towers_dense_fused(batch)
            else:
                t1 = self._tower_dense(self.conv1, self.conv2, batch)
                t2 = self._tower_dense(self.conv1_ext, self.conv2_ext, batch)
                h = torch.cat([t1, t2], dim=1)
        elif self.fuse:
            h = self._towers_fused(batch)
        else:
            t1 = self._tower(self.conv1, self.conv2, batch)
            t2 = self._tower(self.conv1_ext, self.conv2_ext, batch)
            h = torch.cat([t1, t2], dim=1)
        h = torch.relu(linear(h, self.fc1.weight, self.fc1.bias))
        h = dropout(h, self.dropout_rate, generator, self.training)
        return linear(h, self.fc2.weight, self.fc2.bias)

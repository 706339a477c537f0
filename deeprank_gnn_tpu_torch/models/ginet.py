"""GINet: edge-gated two-tower hierarchical GNN (reference `ginet.py`).

The port's counterpart of ``deeprank_gnn_tpu/models/ginet.py``, with the
reference's behavioral quirks:

- **Q1** (reference `ginet.py:66`): the attention logit is softmaxed
  over a size-1 axis, so the attention weight is identically 1.0 and its
  Jacobian identically 0 — the fc_attention / fc_edge_attr branch is
  dead. The conv therefore reduces to ``z = segment_sum((x @ W.T)[col],
  row)``; the dead parameters exist (same state-dict names as the
  reference) and are never read.
- **Q2** (reference `ginet.py:101,118-130`): BOTH towers run on the
  *interface* edges, not the internal edges.

``attention=True`` is the JAX package's "fixed" mode: a real softmax of
the attention logits over each node's edges, where fc_attention and
fc_edge_attr are live. ``internal_tower=True`` runs the second tower on the
internal edges (sparse layout only, as in the JAX package). Either one
unfuses the towers, as the JAX rule ``fuse = not (attention or
internal_tower)`` does.

On a sparse ``GraphBatch`` the edge aggregations always run as the sorted
segment sum kernel (K1), from the batch's CSR row pointers (``collate``
only builds row-sorted batches): two launches per batch on the fused path,
four unfused. The attention softmax takes its denominator from the sorted
scatter-gather kernel (K2), once per conv and tower. On a
``DenseGraphBatch`` the paper-mode aggregations run as the per-graph GIN
aggregation kernel (K3), twice per batch fused; the attention conv runs as
the fused attention conv kernel (K4) over per-graph CSRs that a batch builds
once for all four convs, and pooling is the ``cluster_max_pool`` dispatch. A
dense batch with precomputed operators
(``collate_dense(precompute_ops=True)``, the device store) takes the
operator path in paper mode: level 1 is one product of the stored
aggregation with both towers' weights and a tiled pool, level 2 the stored
pooled adjacency (``adj_conv``); no hand kernel runs there. Both layouts
and both dense paths give the same numbers.

``dense_fast`` (the engine's ``NeuralNet(dense_fast=True)``; the JAX
package's ``DRGNN_DENSE_FAST`` environment variable, read at its
``models/ginet.py:233, 310``) runs the paper-mode dense aggregations with
bf16 operands and fp32 accumulation: K3's fast variant and
``adj_conv(exact=False)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from deeprank_gnn_tpu_torch.data.batch import GraphBatch
from deeprank_gnn_tpu_torch.data.dense_batch import DenseGraphBatch
from deeprank_gnn_tpu_torch.device import resolve_device, set_fp32_numerics
from deeprank_gnn_tpu_torch.models.common import (
    dropout,
    linear,
    linear_init,
    linear_module,
    uniform_init,
)
from deeprank_gnn_tpu_torch.ops.dense import (
    adj_conv,
    cluster_max_pool,
    edge_sum_to_slots,
    masked_mean,
    tiled_cluster_max_pool,
)
from deeprank_gnn_tpu_torch.ops.kernels.attention_conv import (
    AttentionCSR,
    attention_csr,
    fused_attention_conv,
)
from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import fused_gin_conv
from deeprank_gnn_tpu_torch.ops.pooling import (
    community_pooling_x,
    graph_mean_pool,
    max_pool_x,
)
from deeprank_gnn_tpu_torch.ops.segment import gather, segment_softmax, segment_sum


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
        self.fc = linear_module(
            uniform_init((out_channels, in_channels), in_channels, generator)
        )
        self.fc_edge_attr = linear_module(uniform_init((fe, fe), in_channels, generator))
        self.fc_attention = linear_module(
            uniform_init((1, 2 * out_channels + fe), in_channels, generator)
        )


def ginet_conv(
    conv: GINetConvLayer,
    x: torch.Tensor,
    edge_index: torch.Tensor,
    edge_attr: Optional[torch.Tensor],
    num_nodes: int,
    row_ptr: torch.Tensor,
    *,
    attention: bool = False,
) -> torch.Tensor:
    """One GINet conv layer (reference `ginet.py:50-73`) over row-sorted
    edges with CSR pointers ``row_ptr``. Paper mode (``attention=False``):
    per quirk Q1 exactly ``segment_sum(W x[col], row)``. With
    ``attention`` each message is weighted by the softmax, over its row's
    edges, of ``leaky_relu([W x[row] | W x[col] | edge_attr W_e] . a)``."""
    row, col = edge_index[0], edge_index[1]
    xw = linear(x, conv.fc.weight)
    msg = gather(xw, col)
    if attention:
        xrow = gather(xw, row)
        ed = linear(edge_attr, conv.fc_edge_attr.weight)
        logits = linear(torch.cat([xrow, msg, ed], dim=1), conv.fc_attention.weight)
        alpha = segment_softmax(F.leaky_relu(logits)[:, 0], row, num_nodes, row_ptr=row_ptr)
        msg = msg * alpha[:, None]
    return segment_sum(msg, row, num_nodes, row_ptr=row_ptr)


def ginet_conv_dense(
    conv: GINetConvLayer,
    x: torch.Tensor,
    row: torch.Tensor,
    col: torch.Tensor,
    edge_attr: torch.Tensor,
    by_row: Optional[AttentionCSR] = None,
    by_col: Optional[AttentionCSR] = None,
) -> torch.Tensor:
    """The attention conv in the dense layout (the JAX package's
    ``conv_att``, ``models/ginet.py:314-327``): the same numbers as
    :func:`ginet_conv` with ``attention``; pad edges (sentinel row or col)
    drop out of the softmax and the sum. The logit ``[xw_r | xw_c | e W_e] .
    a`` is taken apart into ``p[r] + q[c] + b_e`` (``p = xw . a[:F]``, ``q =
    xw . a[F:2F]``, ``b = (e W_e) . a[2F:] = e . (W_e^T a[2F:])``, the last an
    elementwise product and a sum over the few edge features, whose backward
    is a reduction rather than a product of inner size G * E), and K4
    computes the softmax and the weighted sum, on a card over the CSRs
    ``by_row`` and (for a backward) ``by_col``."""
    xw = linear(x, conv.fc.weight)
    f = xw.shape[-1]
    a = conv.fc_attention.weight[0]
    p = torch.matmul(xw, a[:f])
    q = torch.matmul(xw, a[f:2 * f])
    b = (edge_attr * torch.matmul(conv.fc_edge_attr.weight.t(), a[2 * f:])).sum(dim=-1)
    return fused_attention_conv(xw, p, q, b, row, col, by_row, by_col)


class DenseAttention(NamedTuple):
    """What the dense attention convs of one batch share: the pooled edge
    attributes (``edge_attr`` summed onto the pooled edges, the same in both
    towers) and, on a card, the CSRs of conv1's edges and of the pooled
    edges, by row and, for a backward, by col (``None`` without one, and
    all four on the CPU, whose plain version reads none)."""

    pe_attr: torch.Tensor
    rows: Optional[AttentionCSR]
    cols: Optional[AttentionCSR]
    pe_rows: Optional[AttentionCSR]
    pe_cols: Optional[AttentionCSR]

    @classmethod
    def of(cls, batch: DenseGraphBatch) -> "DenseAttention":
        """Built once a batch: the CSRs on a card only, the col ones only
        where autograd records."""
        s, c0g = batch.x.shape[1], batch.pool0_mask.shape[1]
        card = batch.x.device.type == "cuda"
        backward = card and torch.is_grad_enabled()
        return cls(
            pe_attr=edge_sum_to_slots(batch.edge_attr, batch.edge_to_pe, batch.pe_row.shape[1]),
            rows=attention_csr(batch.row, batch.col, s) if card else None,
            cols=attention_csr(batch.col, batch.row, s) if backward else None,
            pe_rows=attention_csr(batch.pe_row, batch.pe_col, c0g) if card else None,
            pe_cols=attention_csr(batch.pe_col, batch.pe_row, c0g) if backward else None,
        )


class GINet(nn.Module):
    """Two-tower hierarchical GINet (reference `ginet.py:81-141`).

    ``fuse=True`` (default) runs both towers at double width in one pass
    (:meth:`_towers_fused`); ``fuse=False`` runs them one by one
    (:meth:`_tower`) — the same numbers, since segment ops are
    column-independent. ``attention`` or ``internal_tower`` always run the
    towers one by one. ``dense_fast`` rounds the operands of the paper-mode
    dense aggregations to bf16 (K3 and ``adj_conv`` with ``exact=False``).
    Parameters are drawn on the CPU from ``generator`` and moved to
    ``device``.
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
        dense_fast: bool = False,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        if dev.type == "cuda":
            set_fp32_numerics()
        self.dense_fast = dense_fast
        self.attention = attention
        self.internal_tower = internal_tower
        self.fuse = fuse and not (attention or internal_tower)
        fe = input_shape_edge
        self.conv1 = GINetConvLayer(input_shape, 16, fe, generator)
        self.conv2 = GINetConvLayer(16, 32, fe, generator)
        self.conv1_ext = GINetConvLayer(input_shape, 16, fe, generator)
        self.conv2_ext = GINetConvLayer(16, 32, fe, generator)
        self.fc1 = linear_module(*linear_init(64, 128, generator))
        self.fc2 = linear_module(*linear_init(128, output_shape, generator))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.fc1.weight.device

    def _tower(
        self,
        conv1: GINetConvLayer,
        conv2: GINetConvLayer,
        batch: GraphBatch,
        internal: bool = False,
    ) -> torch.Tensor:
        n, c0, c1 = batch.num_nodes, batch.num_clusters0, batch.num_clusters1
        if internal:
            edge_index, edge_attr, row_ptr = batch.iedge_index, batch.iedge_attr, batch.iedge_rowptr
            to_pooled, pooled_index, pooled_ptr = batch.iedge_to_pie, batch.pie_index, batch.pie_rowptr
        else:
            # Q2 parity: the shipped reference runs BOTH towers here
            edge_index, edge_attr, row_ptr = batch.edge_index, batch.edge_attr, batch.edge_rowptr
            to_pooled, pooled_index, pooled_ptr = batch.edge_to_pe, batch.pe_index, batch.pe_rowptr
        att = self.attention
        h = torch.relu(ginet_conv(conv1, batch.x, edge_index, edge_attr, n, row_ptr, attention=att))
        # community pooling: max over cluster members
        hp = community_pooling_x(h, batch.assign0, c0, batch.mem0_idx)
        # pooled edge attrs, duplicates summed (torch-sparse coalesce,
        # reference `community_pooling.py:204-205`); only attention reads them
        pooled_attr = (segment_sum(edge_attr, to_pooled, pooled_index.shape[1])
                       if att else None)
        h2 = torch.relu(
            ginet_conv(conv2, hp, pooled_index, pooled_attr, c0, pooled_ptr, attention=att))
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
        """Dense-layout analog of :meth:`_towers_fused` (JAX
        ``models/ginet.py:225-291``). Returns [G, 64].

        Level 1 takes the first of: the striped feature-major operator
        ``agg_x_fm`` (one product ``relu(W_cat . agg_x_fm)`` for both towers,
        since ``relu(P (x W)) == relu((P x) W)``, then the tiled pool), the
        node-major operator ``agg_x``, or K3 on the edges. Level 2 applies
        the stored pooled adjacency ``adj1`` when the batch has it, else
        K3."""
        c0g, c1g = batch.pool0_mask.shape[1], batch.pool1_mask.shape[1]
        exact = not self.dense_fast
        if batch.agg_x_fm is not None:
            w_cat = torch.cat([self.conv1.fc.weight, self.conv1_ext.fc.weight], dim=0)
            h = torch.relu(torch.einsum("of,gfrt->gort", w_cat, batch.agg_x_fm))
            hp = tiled_cluster_max_pool(h, batch.node_mask_fm, batch.tile_mem0,
                                        batch.tile_assign0)
        else:
            src = batch.agg_x if batch.agg_x is not None else batch.x
            h = torch.cat(
                [linear(src, self.conv1.fc.weight), linear(src, self.conv1_ext.fc.weight)],
                dim=-1,
            )
            if batch.agg_x is None:
                h = fused_gin_conv(h, batch.row, batch.col, exact)
            h = torch.relu(h)
            hp = cluster_max_pool(h, batch.assign0, c0g, batch.mem0_idx)
        hw = torch.cat(
            [linear(hp[..., :16], self.conv2.fc.weight),
             linear(hp[..., 16:], self.conv2_ext.fc.weight)],
            dim=-1,
        )
        if batch.adj1 is not None:
            h2 = torch.relu(adj_conv(hw, batch.adj1, exact))
        else:
            h2 = torch.relu(fused_gin_conv(hw, batch.pe_row, batch.pe_col, exact))
        hq = cluster_max_pool(h2, batch.assign1, c1g, batch.mem1_idx)
        return masked_mean(hq, batch.pool1_mask)

    def _tower_dense(
        self, conv1: GINetConvLayer, conv2: GINetConvLayer, batch: DenseGraphBatch,
        att: Optional[DenseAttention] = None,
    ) -> torch.Tensor:
        """One dense tower (the JAX package's ``_tower_dense``): the same
        numbers as :meth:`_tower`. With attention, ``att`` is the batch's
        :class:`DenseAttention`."""
        c0g, c1g = batch.pool0_mask.shape[1], batch.pool1_mask.shape[1]
        if self.attention:
            h = torch.relu(ginet_conv_dense(
                conv1, batch.x, batch.row, batch.col, batch.edge_attr, att.rows, att.cols))
            hp = cluster_max_pool(h, batch.assign0, c0g, batch.mem0_idx)
            h2 = torch.relu(ginet_conv_dense(
                conv2, hp, batch.pe_row, batch.pe_col, att.pe_attr, att.pe_rows, att.pe_cols))
        else:
            exact = not self.dense_fast
            xw = linear(batch.x, conv1.fc.weight)
            h = torch.relu(fused_gin_conv(xw, batch.row, batch.col, exact))
            hp = cluster_max_pool(h, batch.assign0, c0g, batch.mem0_idx)
            hw = linear(hp, conv2.fc.weight)
            h2 = torch.relu(fused_gin_conv(hw, batch.pe_row, batch.pe_col, exact))
        hq = cluster_max_pool(h2, batch.assign1, c1g, batch.mem1_idx)
        return masked_mean(hq, batch.pool1_mask)

    def forward(
        self, batch, generator: Optional[torch.Generator] = None,
        dropout_rows: Optional[Tuple[int, int]] = None,
    ) -> torch.Tensor:
        """[G, output_shape] scores of a padded batch, a sparse
        ``GraphBatch``, a ``DenseGraphBatch`` or a rank's
        ``parallel.halo.HaloBatch`` (moved to the model's device first).
        Dropout follows ``self.training`` and draws from ``generator``;
        ``dropout_rows = (num_rows, lo)`` says that the batch's graphs are
        rows ``lo...`` of a global batch of ``num_rows`` (a graph-parallel
        mesh), so that the mask is drawn at the global shape
        (``models.common.dropout``)."""
        batch = batch.to(self.device)
        if getattr(batch, "is_halo", False):
            from deeprank_gnn_tpu_torch.parallel.halo import ginet_apply_halo

            return ginet_apply_halo(self, batch, generator)
        if isinstance(batch, DenseGraphBatch):
            if self.internal_tower:
                # the dense batch carries no internal edges; going on would
                # silently run the Q2 wiring (the JAX package raises too)
                raise NotImplementedError(
                    "GINet(internal_tower=True) needs layout='sparse' (the "
                    "dense batch carries interface edges only)"
                )
            if self.fuse:
                h = self._towers_dense_fused(batch)
            else:
                att = DenseAttention.of(batch) if self.attention else None
                t1 = self._tower_dense(self.conv1, self.conv2, batch, att)
                t2 = self._tower_dense(self.conv1_ext, self.conv2_ext, batch, att)
                h = torch.cat([t1, t2], dim=1)
        elif self.fuse:
            h = self._towers_fused(batch)
        else:
            t1 = self._tower(self.conv1, self.conv2, batch)
            t2 = self._tower(self.conv1_ext, self.conv2_ext, batch, self.internal_tower)
            h = torch.cat([t1, t2], dim=1)
        h = torch.relu(linear(h, self.fc1.weight, self.fc1.bias))
        h = dropout(h, self.dropout_rate, generator, self.training, dropout_rows)
        return linear(h, self.fc2.weight, self.fc2.bias)

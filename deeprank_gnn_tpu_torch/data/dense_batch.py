"""Dense per-graph batch layout: every graph padded to uniform capacities.

The port's counterpart of ``deeprank_gnn_tpu/data/dense_batch.py``. Where
the sparse :class:`~deeprank_gnn_tpu_torch.data.batch.GraphBatch`
concatenates the graphs of a batch into flat arrays, this layout keeps a
graph axis: ``[G, Ng, ...]`` node slots and ``[G, Eg]`` edges, indices local
to their graph. Edge aggregation is then kernel K3
(:mod:`deeprank_gnn_tpu_torch.ops.kernels.gin_conv`), one block per graph,
and pooling a max by assignment per graph.

The node slots follow the JAX package's run-padded layout (its
``cluster_sort``): each graph's nodes are renumbered so that the members of
a level-0 cluster are contiguous, in file order, and each cluster's run is
padded to a multiple of 8 slots. Edges keep their file order, so the rows of
a graph are not sorted; K3 takes them as they are. Integer fields are
bitwise those of the JAX package's streaming collate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeprank_gnn_tpu_torch.data.batch import TensorFields, make_graph_plan
from deeprank_gnn_tpu_torch.data.dataset import GraphSample
from deeprank_gnn_tpu_torch.ops.dense import TILE_R


@dataclass(frozen=True)
class DenseGraphBatch(TensorFields):
    """Per-graph uniformly padded batch; a padding index equals the
    capacity of the axis it indexes."""

    x: torch.Tensor  # [G, Ng, F] float32
    node_mask: torch.Tensor  # [G, Ng] bool
    row: torch.Tensor  # [G, Eg] int32, pad -> Ng
    col: torch.Tensor  # [G, Eg] int32, pad -> Ng
    edge_attr: torch.Tensor  # [G, Eg, Fe] float32
    edge_mask: torch.Tensor  # [G, Eg] bool

    assign0: torch.Tensor  # [G, Ng] int32 cluster id, pad -> C0g
    pool0_mask: torch.Tensor  # [G, C0g] bool
    edge_to_pe: torch.Tensor  # [G, Eg] int32 pooled-edge slot, pad -> Pg
    pe_row: torch.Tensor  # [G, Pg] int32, pad -> C0g
    pe_col: torch.Tensor  # [G, Pg] int32, pad -> C0g
    pe_mask: torch.Tensor  # [G, Pg] bool
    assign1: torch.Tensor  # [G, C0g] int32, pad -> C1g
    pool1_mask: torch.Tensor  # [G, C1g] bool

    y: torch.Tensor  # [G] float32
    y_mask: torch.Tensor  # [G] bool

    @property
    def num_graphs(self) -> int:
        return self.x.shape[0]

    @property
    def nodes_per_graph(self) -> int:
        return self.x.shape[1]


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult if mult > 1 else max(n, 1)


def collate_dense(
    graphs: Sequence[GraphSample],
    *,
    ng: Optional[int] = None,
    eg: Optional[int] = None,
    pg: Optional[int] = None,
    c0g: Optional[int] = None,
    c1g: Optional[int] = None,
    g_pad: Optional[int] = None,
    node_mult: int = 8,
    edge_mult: int = 128,
    plans=None,
    precompute_ops: bool = False,
) -> Tuple[DenseGraphBatch, List[str]]:
    """Collate graphs into a :class:`DenseGraphBatch` of CPU tensors.

    A capacity left ``None`` comes from this batch (rounded up to
    ``node_mult`` or ``edge_mult``); ``g_pad`` pads the graph axis.
    ``plans``: the graphs' :class:`~deeprank_gnn_tpu_torch.data.batch.GraphPlan`
    (cluster renumbering and pooled-edge coalescing, as the sparse layout
    uses them), which the loader caches across epochs.

    ``precompute_ops=True`` (the JAX package's precomputed aggregation
    operators and member tables) is not ported yet and raises.
    """
    if precompute_ops:
        raise NotImplementedError(
            "collate_dense(precompute_ops=True): see ROADMAP.md, queue 1 "
            "(the device store)"
        )
    if not graphs:
        raise ValueError("empty batch")
    g = g_pad or len(graphs)
    f = graphs[0].num_features
    fe = graphs[0].edge_attr.shape[1]
    if plans is None:
        plans = [make_graph_plan(s) for s in graphs]

    # per-graph cluster histograms; the node capacity covers the
    # run-padded layout (each cluster padded to a TILE_R multiple)
    hist0 = [np.bincount(p.cluster0, minlength=max(p.k0, 1)) for p in plans]
    padded_sizes = [int((-(-h // TILE_R) * TILE_R).sum()) for h in hist0]
    ng = ng or _round_up(max(padded_sizes), max(node_mult, TILE_R))
    eg = eg or _round_up(max(s.edge_index.shape[1] for s in graphs), edge_mult)
    pg = pg or _round_up(max(p.pe_uniq.shape[0] for p in plans), edge_mult)
    c0g = c0g or _round_up(max(p.k0 for p in plans), node_mult)
    c1g = c1g or _round_up(max(p.k1 for p in plans), node_mult)

    x = np.zeros((g, ng, f), dtype=np.float32)
    node_mask = np.zeros((g, ng), dtype=bool)
    row = np.full((g, eg), ng, dtype=np.int32)
    col = np.full((g, eg), ng, dtype=np.int32)
    edge_attr = np.zeros((g, eg, fe), dtype=np.float32)
    edge_mask = np.zeros((g, eg), dtype=bool)
    assign0 = np.full((g, ng), c0g, dtype=np.int32)
    pool0_mask = np.zeros((g, c0g), dtype=bool)
    edge_to_pe = np.full((g, eg), pg, dtype=np.int32)
    pe_row = np.full((g, pg), c0g, dtype=np.int32)
    pe_col = np.full((g, pg), c0g, dtype=np.int32)
    pe_mask = np.zeros((g, pg), dtype=bool)
    assign1 = np.full((g, c0g), c1g, dtype=np.int32)
    pool1_mask = np.zeros((g, c1g), dtype=bool)
    y = np.zeros(g, dtype=np.float32)
    y_mask = np.zeros(g, dtype=bool)
    mols: List[str] = []

    for gi, s in enumerate(graphs):
        n, e = s.num_nodes, s.edge_index.shape[1]
        plan = plans[gi]
        k0, k1 = plan.k0, plan.k1
        if n > ng or e > eg or k0 > c0g or k1 > c1g:
            raise ValueError(f"graph {s.mol} exceeds dense capacities")
        # run-padded layout: cluster c occupies the slot run
        # [off[c], off[c] + pad8(len_c)); pos maps node ids to their slots
        # (stable file order within a cluster)
        lens = hist0[gi]
        padded = -(-lens // TILE_R) * TILE_R
        if int(padded.sum()) > ng:
            raise ValueError(f"graph {s.mol} exceeds run-padded node capacity")
        off = np.zeros(len(lens) + 1, dtype=np.int64)
        off[1:] = np.cumsum(padded)
        srt = np.argsort(plan.cluster0, kind="stable")
        ids_sorted = plan.cluster0[srt]
        starts = np.searchsorted(ids_sorted, ids_sorted, "left")
        pos = np.empty(n, dtype=np.int64)
        pos[srt] = off[ids_sorted] + np.arange(n) - starts
        x[gi, pos] = s.x
        node_mask[gi, pos] = True
        assign0[gi, pos] = plan.cluster0
        row[gi, :e] = pos[s.edge_index[0]]
        col[gi, :e] = pos[s.edge_index[1]]
        edge_attr[gi, :e] = s.edge_attr
        edge_mask[gi, :e] = True
        pool0_mask[gi, :k0] = True
        p = plan.pe_uniq.shape[0]
        edge_to_pe[gi, :e][plan.pe_keep] = plan.pe_inv
        pe_row[gi, :p] = plan.pe_uniq[:, 0]
        pe_col[gi, :p] = plan.pe_uniq[:, 1]
        pe_mask[gi, :p] = True
        assign1[gi, :k0] = plan.cluster1
        pool1_mask[gi, :k1] = True
        if s.y is not None:
            y[gi] = s.y
            y_mask[gi] = True
        mols.append(s.mol)

    t = torch.from_numpy
    batch = DenseGraphBatch(
        x=t(x), node_mask=t(node_mask), row=t(row), col=t(col),
        edge_attr=t(edge_attr), edge_mask=t(edge_mask),
        assign0=t(assign0), pool0_mask=t(pool0_mask), edge_to_pe=t(edge_to_pe),
        pe_row=t(pe_row), pe_col=t(pe_col), pe_mask=t(pe_mask),
        assign1=t(assign1), pool1_mask=t(pool1_mask), y=t(y), y_mask=t(y_mask),
    )
    return batch, mols

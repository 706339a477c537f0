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

``precompute_ops=True`` adds the JAX package's precomputed aggregation
operators and member tables (the operator path of the models, and what the
device store holds by default): message passing is a linear operator on
node features that depends only on the batch's structure, so its action on
the raw features is computed once here, with numpy in the JAX package's
order, and the models run plain products on it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeprank_gnn_tpu_torch.data.batch import TensorFields, make_graph_plan
from deeprank_gnn_tpu_torch.data.dataset import GraphSample
from deeprank_gnn_tpu_torch.ops.dense import TILE_R


# the operators weighted by the edge attribute, collated beside the plain
# ones whenever the edges carry one feature
WEIGHTED_OPERATORS = ("wagg_x", "ea_rowsum0", "wadj1", "ea_rowsum1")


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

    # precomputed aggregation operators (precompute_ops=True; None otherwise)
    agg_x: Optional[torch.Tensor] = None  # [G, Ng, F] = P0 @ x
    deg0: Optional[torch.Tensor] = None  # [G, Ng] in-degree (row counts)
    adj1: Optional[torch.Tensor] = None  # [G, C0g, C0g] pooled-edge P1, 0/1 float32
    # edge-attribute-weighted operators (``WEIGHTED_OPERATORS``: FoutNet
    # reads ``wagg_x`` and ``wadj1``, sGAT all four; only with one edge
    # feature)
    wagg_x: Optional[torch.Tensor] = None  # [G, Ng, F] = A_w @ x
    ea_rowsum0: Optional[torch.Tensor] = None  # [G, Ng] sum of edge_attr by row
    wadj1: Optional[torch.Tensor] = None  # [G, C0g, C0g] pe_attr-weighted P1
    ea_rowsum1: Optional[torch.Tensor] = None  # [G, C0g] sum of pe_attr by row
    # cluster member tables, pad sentinel = source capacity
    mem0_idx: Optional[torch.Tensor] = None  # [G, C0g, M0] int32, pad -> Ng
    mem1_idx: Optional[torch.Tensor] = None  # [G, C1g, M1] int32, pad -> C0g
    # striped feature-major action and tile tables: member slot r of tile t
    # is node slot 8t + r (``ops.dense.tiled_cluster_max_pool``)
    agg_x_fm: Optional[torch.Tensor] = None  # [G, F, 8, T] = P0 @ x striped
    node_mask_fm: Optional[torch.Tensor] = None  # [G, 8, T] bool
    tile_mem0: Optional[torch.Tensor] = None  # [G, C0g, MT] int32, pad -> T
    tile_assign0: Optional[torch.Tensor] = None  # [G, T] int32, pad -> C0g

    @property
    def num_graphs(self) -> int:
        return self.x.shape[0]

    @property
    def nodes_per_graph(self) -> int:
        return self.x.shape[1]

    def graph_slice(self, lo: int, hi: int) -> "DenseGraphBatch":
        """Graphs ``[lo, hi)`` as a batch of their own: every field has
        the graph axis first and indices local to their graph, so this is a
        view of each field (on whatever device it lies)."""
        return self._map(lambda t: t[lo:hi])


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
    m0g: Optional[int] = None,
    m1g: Optional[int] = None,
    mt0g: Optional[int] = None,
    g_pad: Optional[int] = None,
    node_mult: int = 8,
    edge_mult: int = 128,
    plans=None,
    num_features: Optional[int] = None,
    num_edge_features: Optional[int] = None,
    precompute_ops: bool = False,
) -> Tuple[DenseGraphBatch, List[str]]:
    """Collate graphs into a :class:`DenseGraphBatch` of CPU tensors (JAX
    ``data/dense_batch.py:96-424``).

    A capacity left ``None`` comes from this batch (rounded up to
    ``node_mult`` or ``edge_mult``); ``g_pad`` pads the graph axis.
    ``plans``: the graphs' :class:`~deeprank_gnn_tpu_torch.data.batch.GraphPlan`
    (cluster renumbering and pooled-edge coalescing, as the sparse layout
    uses them), which the loader caches across epochs.

    ``precompute_ops=True`` also fills the operator fields: ``agg_x`` (the
    level-0 sum aggregation of the raw features, exact fp32 by
    ``np.add.at`` in edge order), ``deg0``, ``adj1`` (0/1, held as float32),
    the member tables (capacities ``m0g``/``m1g``), the striped
    feature-major ``agg_x_fm``/``node_mask_fm`` and the tile tables
    (``mt0g`` tiles per cluster), and with one edge feature sGAT's weighted
    operators.

    ``graphs`` may be empty when every capacity, ``g_pad``,
    ``num_features`` and ``num_edge_features`` are given: the device
    store's all-padding slot.
    """
    if not graphs and not (
        g_pad and ng and eg and pg and c0g and c1g and num_features and num_edge_features
    ):
        raise ValueError("empty batch")
    g = g_pad or len(graphs)
    f = num_features or graphs[0].num_features
    fe = num_edge_features or graphs[0].edge_attr.shape[1]
    if plans is None:
        plans = [make_graph_plan(s) for s in graphs]

    # per-graph cluster histograms; the node capacity covers the
    # run-padded layout (each cluster padded to a TILE_R multiple)
    hist0 = [np.bincount(p.cluster0, minlength=max(p.k0, 1)) for p in plans]
    if graphs:
        padded_sizes = [int((-(-h // TILE_R) * TILE_R).sum()) for h in hist0]
        ng = ng or _round_up(max(padded_sizes), max(node_mult, TILE_R))
        eg = eg or _round_up(max(s.edge_index.shape[1] for s in graphs), edge_mult)
        pg = pg or _round_up(max(p.pe_uniq.shape[0] for p in plans), edge_mult)
        c0g = c0g or _round_up(max(p.k0 for p in plans), node_mult)
        c1g = c1g or _round_up(max(p.k1 for p in plans), node_mult)
    if precompute_ops:
        if graphs:
            m0g = m0g or _round_up(
                max(int(np.bincount(p.cluster0, minlength=1).max()) for p in plans), 8)
            m1g = m1g or _round_up(
                max(int(np.bincount(p.cluster1, minlength=1).max()) for p in plans), 8)
        else:
            m0g = m0g or 8
            m1g = m1g or 8

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
    ops = {}
    if precompute_ops:
        t_cap = ng // TILE_R
        if mt0g is None:
            mt0g = max([int((-(-h // TILE_R)).max()) if h.size else 1 for h in hist0] + [1])
        ops = dict(
            agg_x=np.zeros((g, ng, f), dtype=np.float32),
            deg0=np.zeros((g, ng), dtype=np.float32),
            # entries are 0/1 (coalesced-unique pooled pairs): exact in any
            # float type; the JAX package holds them as bfloat16
            adj1=np.zeros((g, c0g, c0g), dtype=np.float32),
            mem0_idx=np.full((g, c0g, m0g), ng, dtype=np.int32),
            mem1_idx=np.full((g, c1g, m1g), c0g, dtype=np.int32),
            tile_mem0=np.full((g, c0g, mt0g), t_cap, dtype=np.int32),
            tile_assign0=np.full((g, t_cap), c0g, dtype=np.int32),
        )
        if fe == 1:
            ops.update(
                wagg_x=np.zeros((g, ng, f), dtype=np.float32),
                ea_rowsum0=np.zeros((g, ng), dtype=np.float32),
                wadj1=np.zeros((g, c0g, c0g), dtype=np.float32),
                ea_rowsum1=np.zeros((g, c0g), dtype=np.float32),
            )

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
        srow = pos[s.edge_index[0]].astype(np.int32)
        scol = pos[s.edge_index[1]].astype(np.int32)
        x[gi, pos] = s.x
        node_mask[gi, pos] = True
        assign0[gi, pos] = plan.cluster0
        row[gi, :e] = srow
        col[gi, :e] = scol
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
        if precompute_ops:
            _fill_ops(ops, gi, s, plan, pos, srow, padded)
        mols.append(s.mol)

    if precompute_ops:
        # the striped feature-major action and mask: the level-1 conv and
        # the tiled pool never touch a node-major array
        t_cap = ng // TILE_R
        ops["agg_x_fm"] = np.ascontiguousarray(
            ops["agg_x"].reshape(g, t_cap, TILE_R, f).transpose(0, 3, 2, 1))
        ops["node_mask_fm"] = np.ascontiguousarray(
            node_mask.reshape(g, t_cap, TILE_R).transpose(0, 2, 1))

    t = torch.from_numpy
    batch = DenseGraphBatch(
        x=t(x), node_mask=t(node_mask), row=t(row), col=t(col),
        edge_attr=t(edge_attr), edge_mask=t(edge_mask),
        assign0=t(assign0), pool0_mask=t(pool0_mask), edge_to_pe=t(edge_to_pe),
        pe_row=t(pe_row), pe_col=t(pe_col), pe_mask=t(pe_mask),
        assign1=t(assign1), pool1_mask=t(pool1_mask), y=t(y), y_mask=t(y_mask),
        **{k: t(v) for k, v in ops.items()},
    )
    return batch, mols


def _fill_ops(ops: dict, gi: int, s: GraphSample, plan, pos, srow, padded) -> None:
    """Graph ``gi``'s operator fields (JAX ``dense_batch.py:320-395``)."""
    # member tables: node slots per level-0 cluster, level-0 cluster ids
    # per level-1 cluster (stable file order within each cluster)
    for assign, values, mem in ((plan.cluster0, pos, ops["mem0_idx"][gi]),
                                (plan.cluster1, None, ops["mem1_idx"][gi])):
        order = np.argsort(assign, kind="stable")
        sorted_ids = assign[order]
        rank = np.arange(len(order)) - np.searchsorted(sorted_ids, sorted_ids, "left")
        if len(rank) and rank.max() >= mem.shape[1]:
            raise ValueError(f"graph {s.mol} exceeds member capacity {mem.shape[1]}")
        mem[sorted_ids, rank] = values[order] if values is not None else order
    # tile tables: cluster c owns the contiguous tile run
    # [off[c] / R, (off[c] + pad8(len_c)) / R)
    nt = padded // TILE_R
    tot = int(nt.sum())
    tstart = np.zeros(len(nt) + 1, dtype=np.int64)
    tstart[1:] = np.cumsum(nt)
    tile_ids = np.arange(tot, dtype=np.int64)
    cl_of = np.repeat(np.arange(len(nt)), nt)
    ops["tile_mem0"][gi][cl_of, tile_ids - tstart[cl_of]] = tile_ids
    ops["tile_assign0"][gi, :tot] = cl_of
    # level-0 sum aggregation of the raw features (exact fp32, duplicate
    # edges counted) and in-degrees; the level-1 pooled adjacency (pooled
    # pairs are coalesced-unique)
    ng = ops["deg0"].shape[1]
    np.add.at(ops["agg_x"][gi], srow, s.x[s.edge_index[1]])
    ops["deg0"][gi, :] += np.bincount(srow, minlength=ng)[:ng].astype(np.float32)
    p_uniq = plan.pe_uniq
    ops["adj1"][gi][p_uniq[:, 0], p_uniq[:, 1]] = 1.0
    if "wagg_x" in ops:
        ea = s.edge_attr[:, 0].astype(np.float32)
        np.add.at(ops["wagg_x"][gi], srow, ea[:, None] * s.x[s.edge_index[1]])
        np.add.at(ops["ea_rowsum0"][gi], srow, ea)
        # pe_attr: the coalesced (summed) edge attributes of each pooled
        # pair, torch-sparse coalesce semantics
        pe_attr = np.zeros(p_uniq.shape[0], dtype=np.float32)
        np.add.at(pe_attr, plan.pe_inv, ea[plan.pe_keep])
        ops["wadj1"][gi][p_uniq[:, 0], p_uniq[:, 1]] = pe_attr
        np.add.at(ops["ea_rowsum1"][gi], p_uniq[:, 0], pe_attr)

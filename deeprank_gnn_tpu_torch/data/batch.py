"""Padded graph batching with host-precomputed pooling plans (sparse layout),
and the loader of both layouts (the dense collate is ``data/dense_batch.py``).

The port's counterpart of ``deeprank_gnn_tpu/data/batch.py``. The host
does the integers: graph offsets, consecutive cluster renumbering, the
pooled-edge coalescing pattern and the cluster member tables are computed
once per graph with numpy, and the batch is padded to static capacities.
The device then runs only gathers, matrix products and segment reductions.

Padding conventions (consumed by :mod:`deeprank_gnn_tpu_torch.ops.segment`):

- padded edge endpoints point at row ``num_nodes_padded`` and drop out of
  reductions through the dump row;
- padded segment ids equal the segment count;
- boolean masks accompany every padded axis.

Where the JAX batch carries the Pallas kernel's window width, this one
carries CSR row pointers for each of the four edge families, as the JAX
package requires all four row-sorted: ``edge_rowptr [N+1]`` over
``edge_index[0]``, ``pe_rowptr [C0+1]`` over ``pe_index[0]``,
``iedge_rowptr [N+1]`` over ``iedge_index[0]`` and ``pie_rowptr [C0+1]``
over ``pie_index[0]``. Padding edges carry row ``n_pad`` (pooled:
``c0_pad``), so they sort last and lie past ``rowptr[N]``; pooled edges are
row-sorted because ``np.unique(axis=0)`` sorts them lexicographically. The
interface and internal edges must come row-sorted per graph (both datasets
sort them on load); :func:`collate` refuses a batch whose edges are not, so
every batch can run the sorted kernels.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeprank_gnn_tpu_torch.data.dataset import GraphSample
from deeprank_gnn_tpu_torch.device import resolve_device


class TensorFields:
    """Moves every tensor field of a frozen batch dataclass at once."""

    @property
    def device(self) -> torch.device:
        return self.x.device

    def _map(self, fn):
        # fields that are None (the dense batch's optional operators) stay so
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                changes[f.name] = fn(v)
        return dataclasses.replace(self, **changes)

    def to(self, device, non_blocking: bool = False):
        """Every tensor moved to ``device`` (those already there stay)."""
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self):
        """Every CPU tensor in page-locked host memory, so that a
        ``non_blocking`` copy to the card is asynchronous; tensors already
        on a card (a device-store batch) are left where they are."""
        return self._map(lambda t: t.pin_memory() if t.device.type == "cpu" else t)


@dataclass(frozen=True)
class GraphBatch(TensorFields):
    """A padded batch of residue interface graphs (all tensors padded)."""

    # level-0 graph
    x: torch.Tensor  # [N, F] float32 node features
    pos: torch.Tensor  # [N, 3] float32
    node_graph: torch.Tensor  # [N] int32 graph id, pad -> G
    node_mask: torch.Tensor  # [N] bool
    edge_index: torch.Tensor  # [2, E] int32, pad endpoints -> N
    edge_attr: torch.Tensor  # [E, Fe] float32
    edge_mask: torch.Tensor  # [E] bool
    iedge_index: torch.Tensor  # [2, Ei] int32 internal edges
    iedge_attr: torch.Tensor  # [Ei, Fe]
    iedge_mask: torch.Tensor  # [Ei] bool

    # level-0 -> level-1 community pooling plan
    assign0: torch.Tensor  # [N] int32 cluster id in [0, C0), pad -> C0
    pool0_graph: torch.Tensor  # [C0] int32 graph id of pooled node
    pool0_mask: torch.Tensor  # [C0] bool
    edge_to_pe: torch.Tensor  # [E] int32 slot of pooled edge, pad/selfloop -> E
    pe_index: torch.Tensor  # [2, E] int32 pooled (coalesced) interface edges
    pe_mask: torch.Tensor  # [E] bool
    iedge_to_pie: torch.Tensor  # [Ei] int32 slot of pooled internal edge
    pie_index: torch.Tensor  # [2, Ei] int32 pooled internal edges
    pie_mask: torch.Tensor  # [Ei] bool

    # level-1 -> level-2 pooling plan (max_pool_x stage)
    assign1: torch.Tensor  # [C0] int32 cluster id in [0, C1), pad -> C1
    pool1_graph: torch.Tensor  # [C1] int32
    pool1_mask: torch.Tensor  # [C1] bool

    # targets
    y: torch.Tensor  # [G] float32 (class index stored as float for class tasks)
    y_mask: torch.Tensor  # [G] bool — False for padding graphs or missing targets

    # CSR row pointers of the row-sorted edge families (the sorted segment
    # sum kernel reads them); int32
    edge_rowptr: torch.Tensor  # [N+1] over edge_index[0]
    pe_rowptr: torch.Tensor  # [C0+1] over pe_index[0]
    iedge_rowptr: torch.Tensor  # [N+1] over iedge_index[0]
    pie_rowptr: torch.Tensor  # [C0+1] over pie_index[0]

    # cluster member tables: node ids per level-0 cluster / cluster ids per
    # level-1 cluster, pad sentinel = source length. Cluster max-pooling
    # then runs as row gathers (`ops.dense.member_max_pool`).
    mem0_idx: Optional[torch.Tensor] = None  # [C0, M0] int32, pad -> N
    mem1_idx: Optional[torch.Tensor] = None  # [C1, M1] int32, pad -> C0

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.y.shape[0]

    @property
    def num_clusters0(self) -> int:
        return self.pool0_graph.shape[0]

    @property
    def num_clusters1(self) -> int:
        return self.pool1_graph.shape[0]


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult if mult > 1 else n


@dataclass
class GraphPlan:
    """Per-graph pooling plan — batch-independent, so computable once
    per sample and reused across epochs (pooled-edge coalescing never
    crosses graphs; batch assembly is then pure concatenation)."""

    cluster0: np.ndarray  # [N] consecutive ids
    k0: int
    cluster1: np.ndarray  # [k0]
    k1: int
    pe_uniq: np.ndarray  # [P, 2] pooled coalesced interface edges
    pe_inv: np.ndarray  # [E_kept] slot per kept original edge
    pe_keep: np.ndarray  # [E] bool — edges surviving self-loop removal
    pie_uniq: np.ndarray  # [Pi, 2] pooled coalesced internal edges
    pie_inv: np.ndarray  # [Ei_kept]
    pie_keep: np.ndarray  # [Ei] bool


def _pool_edges_plan(c0, edge_index):
    mapped = c0[edge_index]
    keep = mapped[0] != mapped[1]
    if keep.any():
        uniq, inv = np.unique(mapped[:, keep].T, axis=0, return_inverse=True)
    else:
        uniq = np.zeros((0, 2), dtype=np.int64)
        inv = np.zeros(0, dtype=np.int64)
    return uniq.astype(np.int32), inv.astype(np.int32), keep


def make_graph_plan(s: GraphSample) -> GraphPlan:
    u0, c0 = np.unique(s.cluster0, return_inverse=True)
    u1, c1 = np.unique(s.cluster1, return_inverse=True)
    c0 = c0.astype(np.int32)
    pe_uniq, pe_inv, pe_keep = _pool_edges_plan(c0, s.edge_index)
    pie_uniq, pie_inv, pie_keep = _pool_edges_plan(c0, s.internal_edge_index)
    return GraphPlan(
        cluster0=c0,
        k0=len(u0),
        cluster1=c1.astype(np.int32),
        k1=len(u1),
        pe_uniq=pe_uniq,
        pe_inv=pe_inv,
        pe_keep=pe_keep,
        pie_uniq=pie_uniq,
        pie_inv=pie_inv,
        pie_keep=pie_keep,
    )


def _row_ptr(rows: np.ndarray, n: int) -> np.ndarray:
    """CSR pointers [n+1] of sorted rows: ``ptr[k]`` is the first edge
    whose row is >= k, so rows >= n (padding) lie past ``ptr[n]``."""
    return np.searchsorted(rows, np.arange(n + 1)).astype(np.int32)


def collate(
    graphs: Sequence[GraphSample],
    *,
    n_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    ie_pad: Optional[int] = None,
    c0_pad: Optional[int] = None,
    c1_pad: Optional[int] = None,
    g_pad: Optional[int] = None,
    node_mult: int = 128,
    edge_mult: int = 512,
    plans: Optional[Sequence[GraphPlan]] = None,
    m0: Optional[int] = None,
    m1: Optional[int] = None,
) -> Tuple[GraphBatch, List[str]]:
    """Collate graphs into one padded :class:`GraphBatch` of CPU tensors.

    Offsets edge indices and cluster ids per graph exactly as PyG batch
    collation + `get_preloaded_cluster` do in the reference
    (`community_pooling.py:25-30`). The pooling plans (consecutive
    cluster renumbering + pooled-edge coalescing) are per-graph and
    batch-independent; pass precomputed ``plans`` (see
    :func:`make_graph_plan`) to make collation pure array assembly —
    the loader caches them across epochs.
    """
    if not graphs:
        raise ValueError("empty batch")
    g = len(graphs)
    for s in graphs:
        if s.cluster0 is None or s.cluster1 is None:
            raise ValueError(
                f"graph {s.mol} has no precomputed clusters; run PreCluster"
            )
    if plans is None:
        plans = [make_graph_plan(s) for s in graphs]

    n_tot = sum(s.num_nodes for s in graphs)
    e_tot = sum(s.edge_index.shape[1] for s in graphs)
    ie_tot = sum(s.internal_edge_index.shape[1] for s in graphs)
    c0_tot = sum(p.k0 for p in plans)
    c1_tot = sum(p.k1 for p in plans)

    n_pad = n_pad or _round_up(n_tot, node_mult)
    e_pad = e_pad or _round_up(e_tot, edge_mult)
    ie_pad = ie_pad or _round_up(ie_tot, edge_mult)
    c0_pad = c0_pad or _round_up(c0_tot, node_mult)
    c1_pad = c1_pad or _round_up(c1_tot, node_mult)
    g_pad = g_pad or g

    f = graphs[0].num_features
    fe = graphs[0].edge_attr.shape[1]

    x = np.zeros((n_pad, f), dtype=np.float32)
    pos = np.zeros((n_pad, 3), dtype=np.float32)
    node_graph = np.full(n_pad, g_pad, dtype=np.int32)
    node_mask = np.zeros(n_pad, dtype=bool)
    edge_index = np.full((2, e_pad), n_pad, dtype=np.int32)
    edge_attr = np.zeros((e_pad, fe), dtype=np.float32)
    edge_mask = np.zeros(e_pad, dtype=bool)
    iedge_index = np.full((2, ie_pad), n_pad, dtype=np.int32)
    iedge_attr = np.zeros((ie_pad, fe), dtype=np.float32)
    iedge_mask = np.zeros(ie_pad, dtype=bool)
    assign0 = np.full(n_pad, c0_pad, dtype=np.int32)
    pool0_graph = np.full(c0_pad, g_pad, dtype=np.int32)
    pool0_mask = np.zeros(c0_pad, dtype=bool)
    assign1 = np.full(c0_pad, c1_pad, dtype=np.int32)
    pool1_graph = np.full(c1_pad, g_pad, dtype=np.int32)
    pool1_mask = np.zeros(c1_pad, dtype=bool)
    y = np.zeros(g_pad, dtype=np.float32)
    y_mask = np.zeros(g_pad, dtype=bool)

    edge_to_pe = np.full(e_pad, e_pad, dtype=np.int32)
    pe_index = np.full((2, e_pad), c0_pad, dtype=np.int32)
    pe_mask = np.zeros(e_pad, dtype=bool)
    iedge_to_pie = np.full(ie_pad, ie_pad, dtype=np.int32)
    pie_index = np.full((2, ie_pad), c0_pad, dtype=np.int32)
    pie_mask = np.zeros(ie_pad, dtype=bool)

    mols: List[str] = []
    n_off = e_off = ie_off = c0_off = c1_off = p_off = pi_off = 0
    for gi, s in enumerate(graphs):
        n, e, ie = s.num_nodes, s.edge_index.shape[1], s.internal_edge_index.shape[1]
        plan = plans[gi]
        cluster0, cluster1, k0, k1 = plan.cluster0, plan.cluster1, plan.k0, plan.k1
        if cluster1.shape[0] != k0:
            raise ValueError(
                f"graph {s.mol}: depth_1 length {cluster1.shape[0]} != "
                f"depth_0 cluster count {k0}"
            )
        x[n_off : n_off + n] = s.x
        pos[n_off : n_off + n] = s.pos
        node_graph[n_off : n_off + n] = gi
        node_mask[n_off : n_off + n] = True
        edge_index[:, e_off : e_off + e] = s.edge_index + n_off
        edge_attr[e_off : e_off + e] = s.edge_attr
        edge_mask[e_off : e_off + e] = True
        iedge_index[:, ie_off : ie_off + ie] = s.internal_edge_index + n_off
        iedge_attr[ie_off : ie_off + ie] = s.internal_edge_attr
        iedge_mask[ie_off : ie_off + ie] = True
        assign0[n_off : n_off + n] = cluster0 + c0_off
        pool0_graph[c0_off : c0_off + k0] = gi
        pool0_mask[c0_off : c0_off + k0] = True
        assign1[c0_off : c0_off + k0] = cluster1 + c1_off
        pool1_graph[c1_off : c1_off + k1] = gi
        pool1_mask[c1_off : c1_off + k1] = True
        if s.y is not None:
            y[gi] = s.y
            y_mask[gi] = True
        # pooled-edge assembly from the per-graph plan: cluster ids are
        # strictly increasing with graph index, so concatenating the
        # per-graph (sorted) coalesced edge lists reproduces the global
        # torch-sparse sorted coalesce order
        npe = plan.pe_uniq.shape[0]
        if p_off + npe > e_pad:
            raise ValueError("coalesced edges exceed edge capacity")
        edge_to_pe[e_off : e_off + e][plan.pe_keep] = plan.pe_inv + p_off
        pe_index[:, p_off : p_off + npe] = plan.pe_uniq.T + c0_off
        pe_mask[p_off : p_off + npe] = True
        npie = plan.pie_uniq.shape[0]
        if pi_off + npie > ie_pad:
            raise ValueError("coalesced internal edges exceed capacity")
        iedge_to_pie[ie_off : ie_off + ie][plan.pie_keep] = plan.pie_inv + pi_off
        pie_index[:, pi_off : pi_off + npie] = plan.pie_uniq.T + c0_off
        pie_mask[pi_off : pi_off + npie] = True
        mols.append(s.mol)
        n_off += n
        e_off += e
        ie_off += ie
        c0_off += k0
        c1_off += k1
        p_off += npe
        pi_off += npie

    # per-graph row-sorted edges at increasing offsets are globally
    # row-sorted; the row pointers below would be wrong for any others
    for family, index in (("interface", edge_index), ("internal", iedge_index)):
        if (np.diff(index[0]) < 0).any():
            raise ValueError(
                f"{family} edges are not row-sorted by source node; HDF5DataSet "
                "and GraphListDataSet sort them (see data.dataset.row_sorted)"
            )

    # flat cluster member tables (see GraphBatch field docs): pooling
    # as row gathers. M comes from the caller's dataset-wide caps when
    # given (stable shapes across batches), else from this batch.
    mem0_idx = _flat_member_table(assign0, c0_pad, n_pad, m0)
    mem1_idx = _flat_member_table(assign1, c1_pad, c0_pad, m1)

    t = torch.from_numpy
    batch = GraphBatch(
        x=t(x),
        pos=t(pos),
        node_graph=t(node_graph),
        node_mask=t(node_mask),
        edge_index=t(edge_index),
        edge_attr=t(edge_attr),
        edge_mask=t(edge_mask),
        iedge_index=t(iedge_index),
        iedge_attr=t(iedge_attr),
        iedge_mask=t(iedge_mask),
        assign0=t(assign0),
        pool0_graph=t(pool0_graph),
        pool0_mask=t(pool0_mask),
        edge_to_pe=t(edge_to_pe),
        pe_index=t(pe_index),
        pe_mask=t(pe_mask),
        iedge_to_pie=t(iedge_to_pie),
        pie_index=t(pie_index),
        pie_mask=t(pie_mask),
        assign1=t(assign1),
        pool1_graph=t(pool1_graph),
        pool1_mask=t(pool1_mask),
        y=t(y),
        y_mask=t(y_mask),
        edge_rowptr=t(_row_ptr(edge_index[0], n_pad)),
        pe_rowptr=t(_row_ptr(pe_index[0], c0_pad)),
        iedge_rowptr=t(_row_ptr(iedge_index[0], n_pad)),
        pie_rowptr=t(_row_ptr(pie_index[0], c0_pad)),
        mem0_idx=t(mem0_idx),
        mem1_idx=t(mem1_idx),
    )
    return batch, mols


def _flat_member_table(
    assign: np.ndarray, c: int, pad_val: int, m: Optional[int] = None
) -> np.ndarray:
    """[len] assignment (pad -> c) -> [c, M] member table (pad ->
    pad_val), members in stable source order per cluster."""
    idx = np.flatnonzero(assign < c)
    a = assign[idx]
    order = np.argsort(a, kind="stable")
    sa = a[order]
    members = idx[order]
    starts = np.searchsorted(sa, sa, "left")
    rank = np.arange(len(sa)) - starts
    need = int(rank.max()) + 1 if len(rank) else 1
    if m is None:
        m = max(8, -(-need // 8) * 8)
    elif need > m:
        raise ValueError(f"cluster size {need} exceeds member cap {m}")
    tab = np.full((c, m), pad_val, np.int32)
    tab[sa, rank] = members
    return tab


def _caps_from_sizes(sizes, bs: int, node_mult: int, edge_mult: int) -> dict:
    return {
        "n_pad": _round_up(bs * max(s["n"] for s in sizes), node_mult),
        "e_pad": _round_up(bs * max(s["e"] for s in sizes), edge_mult),
        "ie_pad": _round_up(bs * max(s["ie"] for s in sizes), edge_mult),
        "c0_pad": _round_up(max(1, bs * max(s["c0"] for s in sizes)), node_mult),
        "c1_pad": _round_up(max(1, bs * max(s["c1"] for s in sizes)), node_mult),
        # member-table capacities (max cluster sizes): stable shapes for
        # the flat pooling gathers across batches
        "m0": max(8, -(-max(s.get("m0", 0) for s in sizes) // 8) * 8),
        "m1": max(8, -(-max(s.get("m1", 0) for s in sizes) // 8) * 8),
    }


class GraphLoader:
    """Size-bucketed batch iterator over a dataset.

    ``layout="sparse"`` pads every batch to `batch_size` graphs and to
    node/edge bucket multiples. With ``num_buckets > 1`` graphs are
    partitioned into size-quantile buckets (by node count), each with its
    own static capacity. Bucket membership and capacities are computed
    once at construction and are stable across epochs; batches never mix
    buckets. ``padding_stats`` reports the realized efficiency
    (valid/padded entries) of the last completed epoch.

    ``layout="dense"`` yields :class:`~deeprank_gnn_tpu_torch.data.
    dense_batch.DenseGraphBatch` batches (``collate_dense``) with
    per-graph capacities fixed over the dataset at construction, in the
    same shuffle order; it has no buckets, and a streamed dense epoch keeps
    no padding statistics, as in the JAX package.

    ``device_cache`` (dense layout; JAX ``data/batch.py:432-500``): ``True``
    packs the dense-collated dataset into ``device`` memory once
    (``data/device_store.py``) and each batch is gathered there, in the
    streamed epoch's shuffle order; when the store's estimate exceeds
    ``device_cache_bytes`` the loader prints so and streams. ``"chunked"``
    rotates a host-packed store through the device two chunks at a time
    (chunk order shuffled, then the order within each chunk; batches never
    span chunks). ``precompute_ops`` (default: on exactly when the cache
    is) adds the precomputed operators to dense batches; ``store_pack``
    ("lossless" or "bf16") packs the store. ``store_sharding`` is
    multi-device and not ported yet.

    Streamed batches come out as CPU tensors, which the engine moves to its
    device (`data/prefetch.py`); store batches are already on ``device``,
    apart from ``y`` and ``y_mask``, taken from the store's host copy.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 32,
        shuffle: bool = False,
        seed: int = 0,
        node_mult: int = 128,
        edge_mult: int = 512,
        drop_last: bool = False,
        static_shapes: bool = True,
        layout: str = "sparse",
        cache_samples: bool = True,
        num_buckets: int = 1,
        host_batch_slice: Optional[slice] = None,
        device_cache: bool = False,
        device_cache_bytes: int = 2 * 1024**3,
        store_sharding=None,
        precompute_ops: Optional[bool] = None,
        store_pack: str = "lossless",
        *,
        device="cuda",
    ):
        if layout not in ("sparse", "dense"):
            raise ValueError(f"unknown layout {layout!r}")
        if host_batch_slice is not None or store_sharding is not None:
            raise NotImplementedError(
                "host_batch_slice and store_sharding: see ROADMAP.md, queue 1 (multi-device)"
            )
        if device_cache not in (False, True, "chunked"):
            raise ValueError("device_cache must be False, True or 'chunked'")
        if device_cache and layout != "dense":
            raise ValueError("device_cache requires layout='dense'")
        if store_pack not in ("lossless", "bf16"):
            raise ValueError("store_pack must be 'lossless' or 'bf16'")
        # the device the store lives on: checked only when there is a store
        self.device = resolve_device(device) if device_cache else torch.device(device)
        self.device_cache = device_cache
        self.device_cache_bytes = device_cache_bytes
        self.store_pack = store_pack
        # the operator fields default on with the store (built once) and
        # off for streaming (host work and bytes every batch)
        self._precompute_requested = precompute_ops is not None
        if precompute_ops is None:
            precompute_ops = bool(device_cache)
        if precompute_ops and layout != "dense":
            raise ValueError("precompute_ops requires layout='dense'")
        self.precompute_ops = precompute_ops
        self._store = None
        self._chunk_store = None
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.node_mult = node_mult
        self.edge_mult = edge_mult
        self.drop_last = drop_last
        self.layout = layout
        # loaded GraphSamples are immutable; caching them avoids
        # re-reading the HDF5 every epoch (disable for datasets larger
        # than host memory)
        self.cache_samples = cache_samples
        self._sample_cache: dict = {}
        self._plan_cache: dict = {}
        self._rng = np.random.RandomState(seed)
        self._caps = None
        self._dense_caps = None
        self._buckets = None  # list of (indices ndarray, caps dict)
        self.padding_stats: dict = {}

        def _scan_sizes():
            sizes, idx = [], []
            for i in range(len(dataset)):
                try:
                    sizes.append(dataset.graph_sizes(i))
                    idx.append(i)
                except Exception:
                    # molecule vanished / unreadable: the iterator will
                    # skip it too (robustness parity with the reference's
                    # skip-and-continue handling)
                    pass
            return sizes, np.asarray(idx)

        if layout == "dense" and len(dataset) > 0:
            sizes, _ = _scan_sizes()
            self._dense_caps = {
                # the node capacity covers the run-padded cluster layout
                "ng": max(8, -(-max(s["np8"] for s in sizes) // 8) * 8),
                "eg": max(128, -(-max(s["e"] for s in sizes) // 128) * 128),
                "c0g": max(8, -(-max(s["c0"] for s in sizes) // 8) * 8),
                "c1g": max(8, -(-max(s["c1"] for s in sizes) // 8) * 8),
                # member-table and tile-table capacities of the operators
                "m0g": max(8, -(-max(s["m0"] for s in sizes) // 8) * 8),
                "m1g": max(8, -(-max(s["m1"] for s in sizes) // 8) * 8),
                "mt0g": max(1, max(s["mt0"] for s in sizes)),
            }
            # the pooled-edge capacity is bounded by the edge capacity
            self._dense_caps["pg"] = self._dense_caps["eg"]
        if static_shapes and layout == "sparse" and len(dataset) > 0:
            sizes, idx = _scan_sizes()
            # one bucket needs at least batch_size graphs to be worth a
            # separate shape
            nb = max(1, min(num_buckets, len(sizes) // max(1, batch_size)))
            if nb <= 1:
                self._caps = _caps_from_sizes(
                    sizes, batch_size, node_mult, edge_mult
                )
            else:
                order = np.argsort([s["n"] for s in sizes], kind="stable")
                splits = np.array_split(order, nb)
                self._buckets = []
                for part in splits:
                    if len(part) == 0:
                        continue
                    bsizes = [sizes[j] for j in part]
                    self._buckets.append(
                        (
                            idx[part],
                            _caps_from_sizes(
                                bsizes, batch_size, node_mult, edge_mult
                            ),
                        )
                    )

    def __len__(self) -> int:
        if self._buckets is not None:
            total = 0
            for indices, _ in self._buckets:
                n = len(indices)
                if self.drop_last:
                    total += n // self.batch_size
                else:
                    total += (n + self.batch_size - 1) // self.batch_size
            return total
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _get_sample(self, i: int):
        if not self.cache_samples:
            return self.dataset.get(i)
        if i not in self._sample_cache:
            self._sample_cache[i] = self.dataset.get(i)
        return self._sample_cache[i]

    def _get_plan(self, i: int, sample):
        if not self.cache_samples:
            return make_graph_plan(sample)
        if i not in self._plan_cache:
            self._plan_cache[i] = make_graph_plan(sample)
        return self._plan_cache[i]

    def _emit_sparse(self, idx, caps) -> Optional[Tuple[GraphBatch, List[str]]]:
        pairs = [(int(i), self._get_sample(int(i))) for i in idx]
        pairs = [(i, s) for i, s in pairs if s is not None]
        if not pairs:
            return None
        graphs = [s for _, s in pairs]
        plans = [self._get_plan(i, s) for i, s in pairs]
        out = collate(
            graphs,
            g_pad=self.batch_size,
            node_mult=self.node_mult,
            edge_mult=self.edge_mult,
            plans=plans,
            **(caps or {}),
        )
        st = self._epoch_stats
        batch = out[0]
        st["valid_edges"] += int(batch.edge_mask.sum())
        st["padded_edges"] += batch.edge_mask.shape[0]
        st["valid_nodes"] += int(batch.node_mask.sum())
        st["padded_nodes"] += batch.node_mask.shape[0]
        st["num_batches"] += 1
        return out

    def _iter_dense(self):
        from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense

        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            pairs = [(int(i), self._get_sample(int(i))) for i in idx]
            pairs = [(i, s) for i, s in pairs if s is not None]
            if not pairs:
                continue
            yield collate_dense(
                [s for _, s in pairs],
                g_pad=self.batch_size,
                plans=[self._get_plan(i, s) for i, s in pairs],
                precompute_ops=self.precompute_ops,
                **(self._dense_caps or {}),
            )

    def _maybe_build_store(self) -> bool:
        """Build the device store on first use; False when the dataset is
        empty or the store's estimate exceeds the byte budget (then the
        loader streams from here on, and drops the operators unless they
        were asked for)."""
        if self._store is not None:
            return True
        if self._dense_caps is None or len(self.dataset) == 0:
            return False
        from deeprank_gnn_tpu_torch.data.device_store import (
            build_store_from_loader,
            estimate_store_bytes,
        )

        nf, ef = self.dataset.feature_dims()
        est = estimate_store_bytes(
            len(self.dataset), num_features=nf, num_edge_features=ef,
            precompute_ops=self.precompute_ops, pack=self.store_pack, **self._dense_caps,
        )
        if est > self.device_cache_bytes:
            print(
                f"device_cache: padded store ~{est / 1e9:.2f} GB exceeds "
                f"budget {self.device_cache_bytes / 1e9:.2f} GB; streaming "
                f"(device_cache='chunked' rotates it through HBM instead)"
            )
            self.device_cache = False
            if not self._precompute_requested:
                # the operators were on only because of the store; a
                # streamed epoch does not pay their host work unasked
                self.precompute_ops = False
            return False
        self._store = build_store_from_loader(self)
        return self._store is not None

    def _maybe_build_chunks(self) -> bool:
        """Build the rotating chunk store (``device_cache="chunked"``),
        chunks of half the byte budget."""
        if self._chunk_store is not None:
            return True
        if self._dense_caps is None or len(self.dataset) == 0:
            return False
        from deeprank_gnn_tpu_torch.data.device_store import build_chunked_store_from_loader

        self._chunk_store = build_chunked_store_from_loader(
            self, chunk_bytes=max(1, self.device_cache_bytes // 2))
        return self._chunk_store is not None

    def _count_store_batch(self, counts_from, sel) -> None:
        """Padding statistics of the store batch of slots ``sel``:
        ``batch_size`` graphs at the store's capacities."""
        st = self._epoch_stats
        st["valid_edges"] += int(counts_from.edge_counts[sel].sum())
        st["padded_edges"] += self.batch_size * counts_from.caps["eg"]
        st["valid_nodes"] += int(counts_from.node_counts[sel].sum())
        st["padded_nodes"] += self.batch_size * counts_from.caps["ng"]
        st["num_batches"] += 1

    def _iter_chunked(self):
        """Epoch over the rotating chunk store: the next chunk's copy is
        started before the current chunk's batches are gathered."""
        cs = self._chunk_store
        corder = np.arange(cs.num_chunks)
        if self.shuffle:
            self._rng.shuffle(corder)
        cur = cs.upload(int(corder[0]))
        for pos, ci in enumerate(corder):
            ci = int(ci)
            nxt = cs.upload(int(corder[pos + 1])) if pos + 1 < len(corder) else None
            start, clen = cs.chunk_ranges[ci]
            local = np.arange(clen)
            if self.shuffle:
                self._rng.shuffle(local)
            for bstart in range(0, clen, self.batch_size):
                sel = local[bstart: bstart + self.batch_size]
                if self.drop_last and len(sel) < self.batch_size:
                    break
                batch, mols = cs.batch(cur, ci, sel, self.batch_size)
                self._count_store_batch(cs, start + sel)
                yield batch, mols
            cur = nxt  # the chunk's matrices are freed once unreferenced
        self._finish_epoch_stats()

    def _iter_device(self):
        """Epoch of batches gathered from the resident store, in the
        streamed epoch's order."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        store = self._store
        for start in range(0, len(order), self.batch_size):
            idx = order[start: start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            slots = np.asarray(
                [store.slot_of_index[int(i)] for i in idx if int(i) in store.slot_of_index],
                dtype=np.int64,
            )
            if len(slots) == 0:
                continue
            batch, mols = store.batch(slots, self.batch_size)
            self._count_store_batch(store, slots)
            yield batch, mols
        self._finish_epoch_stats()

    def _new_epoch_stats(self) -> None:
        self._epoch_stats = {
            "valid_edges": 0,
            "padded_edges": 0,
            "valid_nodes": 0,
            "padded_nodes": 0,
            "num_batches": 0,
        }

    def device_epoch_plan(self):
        """The plan of one epoch over the resident store, for a scanned
        epoch (``train/scan.py``): ``(slots [B, batch_size] int32,
        mols_per_batch)``, each row the store slots of one batch with the
        store's pad slot after them, or None when there is no store (the
        layout is not dense, ``device_cache`` is not True, the dataset is
        empty or over the byte budget). It draws the loader's RNG as an
        iterated epoch does, so a scanned and a looped run see the same
        batches, and sets the same ``padding_stats`` (JAX
        ``data/batch.py:728-781``)."""
        if not (self.device_cache is True and self._maybe_build_store()):
            return None
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        self._new_epoch_stats()
        store = self._store
        rows, mols_per_batch = [], []
        for start in range(0, len(order), self.batch_size):
            idx = order[start: start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            slots = np.asarray(
                [store.slot_of_index[int(i)] for i in idx if int(i) in store.slot_of_index],
                dtype=np.int32,
            )
            if len(slots) == 0:
                continue
            row = np.full(self.batch_size, store.pad_slot, dtype=np.int32)
            row[: len(slots)] = slots
            rows.append(row)
            mols_per_batch.append([store.mols[int(s)] for s in slots])
            self._count_store_batch(store, slots)
        self._finish_epoch_stats()
        if not rows:
            return None
        return np.stack(rows), mols_per_batch

    def chunk_epoch_plan(self):
        """The plan of one epoch over the rotating chunk store: a list of
        ``(ci, slots [B, batch_size] int32, mols_per_batch)`` in the epoch's
        chunk order, slots local to chunk ``ci`` with its own pad slot
        (``clen``) after them, or None when there is no chunk store. It draws
        the loader's RNG as an iterated chunked epoch does (the chunk order,
        then each chunk's order), and restores it when the plan comes out
        empty, so that the looped epoch the caller falls back to draws what a
        looped run would (JAX ``data/batch.py:812-875``)."""
        if not (self.device_cache == "chunked" and self._maybe_build_chunks()):
            return None
        cs = self._chunk_store
        rng_state = self._rng.get_state()
        self._new_epoch_stats()
        corder = np.arange(cs.num_chunks)
        if self.shuffle:
            self._rng.shuffle(corder)
        plan = []
        for ci in corder:
            ci = int(ci)
            start, clen = cs.chunk_ranges[ci]
            local = np.arange(clen)
            if self.shuffle:
                self._rng.shuffle(local)
            rows, mols_per_batch = [], []
            for bstart in range(0, clen, self.batch_size):
                sel = local[bstart: bstart + self.batch_size]
                if self.drop_last and len(sel) < self.batch_size:
                    break
                row = np.full(self.batch_size, clen, dtype=np.int32)
                row[: len(sel)] = sel
                rows.append(row)
                mols_per_batch.append([cs.mols[start + int(i)] for i in sel])
                self._count_store_batch(cs, start + sel)
            if rows:
                plan.append((ci, np.stack(rows), mols_per_batch))
        self._finish_epoch_stats()
        if not plan:
            self._rng.set_state(rng_state)
            return None
        return plan

    def _finish_epoch_stats(self) -> None:
        st = self._epoch_stats
        if st["padded_edges"]:
            st["edge_efficiency"] = st["valid_edges"] / st["padded_edges"]
            st["node_efficiency"] = st["valid_nodes"] / st["padded_nodes"]
        self.padding_stats = st

    def __iter__(self) -> Iterator[Tuple[GraphBatch, List[str]]]:
        self._new_epoch_stats()
        if self.layout == "dense":
            if self.device_cache == "chunked" and self._maybe_build_chunks():
                yield from self._iter_chunked()
            elif self.device_cache is True and self._maybe_build_store():
                yield from self._iter_device()
            else:
                yield from self._iter_dense()
            return
        # per-bucket static shapes
        if self._buckets is not None:
            chunks = []
            for indices, caps in self._buckets:
                order = indices.copy()
                if self.shuffle:
                    self._rng.shuffle(order)
                for start in range(0, len(order), self.batch_size):
                    sel = order[start : start + self.batch_size]
                    if self.drop_last and len(sel) < self.batch_size:
                        continue
                    chunks.append((sel, caps))
            if self.shuffle:
                self._rng.shuffle(chunks)
            for sel, caps in chunks:
                out = self._emit_sparse(sel, caps)
                if out is not None:
                    yield out
            self._finish_epoch_stats()
            return
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            out = self._emit_sparse(idx, self._caps)
            if out is not None:
                yield out
        self._finish_epoch_stats()

"""Explicit halo-exchange edge-parallel layout (``layout="halo"``).

The port's counterpart of ``deeprank_gnn_tpu/parallel/halo.py``, with one
process per shard where JAX has one device of a ``shard_map``:

- **Row-range partitioning.** The collated batch's nodes are split into D
  contiguous chunks of ``Nl = N / D``; every edge lives on the rank that
  owns its row (destination), so every segment sum is local.
- **Host-planned halo.** :func:`partition_batch` (numpy, the JAX
  package's bookkeeping) plans which local rows each rank ships to each
  peer: ``send_idx[d, p]``. On the device the exchange is one all-to-all of
  the boundary rows only (:func:`halo_exchange`, ``H`` rows per peer), not
  an all-gather of the node array.
- **Local and remote groups.** Each rank's edges split into those whose
  source is local (they aggregate from local rows) and those whose source
  is remote (they read the received halo). Both groups keep the loader's
  row order, so each local sum runs on the sorted segment sum kernel (K1)
  from the group's CSR row pointers, which the plan builds per rank.
- **Small levels replicate.** After conv1 the per-rank partial cluster
  maxes combine with one all-gather (:func:`cross_shard_max_pool`), after
  which the pooled graph, readout and head run replicated on every rank.

A rank's :class:`HaloBatch` holds its slice of the sharded fields and the
replicated ones; the models dispatch on it (``is_halo``). The steps
(:func:`make_halo_train_step`, :func:`make_halo_eval_step`) compute the
same replicated loss on every rank, run each rank's backward scaled by
``1 / D`` through the collectives' transposes
(``parallel/collectives.py``) and sum the parameter gradients once: the
single-device gradient, as ``shard_map``'s transpose gives it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, ClassVar, List, Optional

import numpy as np
import torch
from torch.nn import functional as F

from deeprank_gnn_tpu_torch.data.batch import (
    GraphBatch,
    TensorFields,
    _flat_member_table,
    _row_ptr,
)
from deeprank_gnn_tpu_torch.models.common import dropout, linear
from deeprank_gnn_tpu_torch.models.foutnet import FoutNet, fout_layer
from deeprank_gnn_tpu_torch.models.ginet import ginet_conv
from deeprank_gnn_tpu_torch.models.sgat import sGAT, sgat_layer
from deeprank_gnn_tpu_torch.ops.dense import member_counts, member_max_partial
from deeprank_gnn_tpu_torch.ops.pooling import graph_mean_pool, max_pool_x
from deeprank_gnn_tpu_torch.ops.segment import _dump_row, gather, segment_count, segment_sum
from deeprank_gnn_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    all_to_all,
)
from deeprank_gnn_tpu_torch.parallel.mesh import Mesh, make_halo_mesh
from deeprank_gnn_tpu_torch.parallel.step import MeshSteps


@dataclass(frozen=True)
class HaloBatch(TensorFields):
    """A row-range-partitioned :class:`GraphBatch`.

    From :func:`partition_batch` (numpy arrays): every sharded field has a
    leading rank axis ``[D, ...]`` and the others are replicated. A rank's
    view (:meth:`local`, :func:`shard_halo_batch`: torch tensors) holds its
    own block of each sharded field and the process ``group``."""

    # -- sharded, leading axis D --
    x: Any  # [D, Nl, F] node features (chunked)
    assign0: Any  # [D, Nl] global cluster id, pad -> C0
    send_idx: Any  # [D, D, H] local rows shard d sends to peer p
    loc_rows: Any  # [D, El] local row ids, pad -> Nl
    loc_cols: Any  # [D, El] local col ids
    loc_e2pe: Any  # [D, El] pooled-edge slot, pad -> Pe
    loc_eattr: Any  # [D, El, Fe]
    rem_rows: Any  # [D, Er] local row ids, pad -> Nl
    rem_cols: Any  # [D, Er] ids into [xw | halo], i.e. Nl + s*H + j
    rem_e2pe: Any  # [D, Er]
    rem_eattr: Any  # [D, Er, Fe]
    # internal-edge family (GINet(internal_tower=True))
    isend_idx: Any  # [D, D, Hi]
    iloc_rows: Any  # [D, Eli]
    iloc_cols: Any  # [D, Eli]
    iloc_e2pie: Any  # [D, Eli]
    iloc_eattr: Any  # [D, Eli, Fe]
    irem_rows: Any  # [D, Eri]
    irem_cols: Any  # [D, Eri]
    irem_e2pie: Any  # [D, Eri]
    irem_eattr: Any  # [D, Eri, Fe]
    # CSR row pointers of the four local groups (K1 reads them)
    loc_rowptr: Any  # [D, Nl+1]
    rem_rowptr: Any  # [D, Nl+1]
    iloc_rowptr: Any  # [D, Nl+1]
    irem_rowptr: Any  # [D, Nl+1]
    # per-shard LOCAL node ids per level-0 cluster, pad -> Nl
    mem0_loc: Any  # [D, C0, Ml]

    # -- replicated pooled-level plan and targets --
    pe_index: Any  # [2, Pe] pooled interface edges, pad -> C0
    pie_index: Any  # [2, Pie] pooled internal edges, pad -> C0
    pe_rowptr: Any  # [C0+1]
    pie_rowptr: Any  # [C0+1]
    assign1: Any  # [C0] level-2 cluster id, pad -> C1
    pool1_graph: Any  # [C1] graph id, pad -> G
    mem1_idx: Any  # [C1, M1], pad -> C0
    y: Any  # [G]
    y_mask: Any  # [G]

    # a rank's view: the process group its collectives run over
    group: Any = None

    is_halo: ClassVar[bool] = True

    @property
    def num_shards(self) -> int:
        return self.send_idx.shape[-2]  # send_idx [*, D, H]

    @property
    def nl(self) -> int:
        return self.x.shape[-2]

    @property
    def num_clusters0(self) -> int:
        return self.assign1.shape[0]

    @property
    def num_clusters1(self) -> int:
        return self.pool1_graph.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.y.shape[0]

    def local(self, rank: int, group=None) -> "HaloBatch":
        """Rank ``rank``'s view as CPU tensors: its block of every sharded
        field, the replicated ones as they are."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "group":
                continue
            v = v[rank] if f.name in _SHARDED_FIELDS else v
            kw[f.name] = torch.from_numpy(np.ascontiguousarray(v))
        return HaloBatch(**kw, group=group)


_SHARDED_FIELDS = frozenset(
    {
        "x", "assign0", "send_idx",
        "loc_rows", "loc_cols", "loc_e2pe", "loc_eattr",
        "rem_rows", "rem_cols", "rem_e2pe", "rem_eattr",
        "isend_idx",
        "iloc_rows", "iloc_cols", "iloc_e2pie", "iloc_eattr",
        "irem_rows", "irem_cols", "irem_e2pie", "irem_eattr",
        "loc_rowptr", "rem_rowptr", "iloc_rowptr", "irem_rowptr",
        "mem0_loc",
    }
)


def shard_halo_batch(hb: HaloBatch, mesh: Mesh) -> HaloBatch:
    """This rank's view of a partitioned batch (CPU tensors; the caller
    moves it to the rank's device)."""
    if hb.num_shards != mesh.size:
        raise ValueError(f"batch partitioned over {hb.num_shards} shards, mesh has "
                         f"{mesh.size} ranks")
    return hb.local(mesh.rank, mesh.group)


# ---------------------------------------------------------------------------
# host-side partitioning (numpy; the JAX package's bookkeeping)


def _round8(n: int) -> int:
    return max(8, ((n + 7) // 8) * 8)


def _split_edge_family(rows, cols, e2p, eattr, mask, nl: int, d: int, p_cap: int):
    """Partition one (row-sorted) edge family into per-shard local /
    remote groups plus the all-to-all send plan."""
    rows = rows[mask]
    cols = cols[mask]
    e2p = e2p[mask]
    eattr = eattr[mask]
    fe = eattr.shape[1]
    owner = rows // nl
    col_owner = cols // nl

    per = []  # (loc_r, loc_c, loc_p, loc_a, rem_r, rem_c, rem_c_owner, rem_p, rem_a)
    need: List[List[np.ndarray]] = []
    for dd in range(d):
        sel = owner == dd
        r, c, p2, a = rows[sel] - dd * nl, cols[sel], e2p[sel], eattr[sel]
        co = col_owner[sel]
        loc = co == dd
        per.append((r[loc], c[loc] - dd * nl, p2[loc], a[loc],
                    r[~loc], c[~loc], co[~loc], p2[~loc], a[~loc]))
        need.append(
            [np.unique(c[~loc][co[~loc] == s]) for s in range(d)]
        )

    h = _round8(max((len(u) for row in need for u in row), default=1))
    send_idx = np.zeros((d, d, h), dtype=np.int32)
    for dd in range(d):
        for s in range(d):
            u = need[dd][s]
            send_idx[s, dd, : len(u)] = u - s * nl

    el = _round8(max(len(p[0]) for p in per))
    er = _round8(max(len(p[4]) for p in per))
    loc_rows = np.full((d, el), nl, np.int32)
    loc_cols = np.zeros((d, el), np.int32)
    loc_e2p = np.full((d, el), p_cap, np.int32)
    loc_eattr = np.zeros((d, el, fe), np.float32)
    rem_rows = np.full((d, er), nl, np.int32)
    rem_cols = np.zeros((d, er), np.int32)
    rem_e2p = np.full((d, er), p_cap, np.int32)
    rem_eattr = np.zeros((d, er, fe), np.float32)
    for dd, (lr, lc, lp, la, rr, rc, rco, rp, ra) in enumerate(per):
        k = len(lr)
        loc_rows[dd, :k] = lr
        loc_cols[dd, :k] = lc
        loc_e2p[dd, :k] = lp
        loc_eattr[dd, :k] = la
        k = len(rr)
        rem_rows[dd, :k] = rr
        # position of each remote col within its owner's sorted need set
        j = np.empty(k, np.int64)
        for s in range(d):
            m = rco == s
            j[m] = np.searchsorted(need[dd][s], rc[m])
        rem_cols[dd, :k] = nl + rco * h + j
        rem_e2p[dd, :k] = rp
        rem_eattr[dd, :k] = ra
    return send_idx, loc_rows, loc_cols, loc_e2p, loc_eattr, \
        rem_rows, rem_cols, rem_e2p, rem_eattr


def _shard_row_ptrs(rows: np.ndarray, nl: int, what: str) -> np.ndarray:
    """``[D, Nl+1]`` CSR pointers of each shard's rows, which must be
    nondecreasing with their padding (``Nl``) last: K1 reads them."""
    if (np.diff(rows, axis=1) < 0).any():
        raise ValueError(f"halo partition: {what} rows are not nondecreasing on every shard")
    return np.stack([_row_ptr(r, nl) for r in rows])


def partition_batch(batch: GraphBatch, d: int) -> HaloBatch:
    """Row-range-partition a collated (CPU) :class:`GraphBatch` over ``d``
    shards and plan the halo exchanges (JAX ``parallel/halo.py:275-359``,
    with the CSR row pointers of every shard's four edge groups in place
    of JAX's sorted-window flag). Pure integer bookkeeping on the host."""
    n = batch.num_nodes
    c0 = batch.num_clusters0
    x = batch.x.numpy()
    assign0 = batch.assign0.numpy()
    if n % d:
        extra = d * (-(-n // d)) - n
        x = np.pad(x, ((0, extra), (0, 0)))
        assign0 = np.pad(assign0, (0, extra), constant_values=c0)
        n += extra
    nl = n // d

    (send_idx, loc_rows, loc_cols, loc_e2pe, loc_eattr,
     rem_rows, rem_cols, rem_e2pe, rem_eattr) = _split_edge_family(
        batch.edge_index[0].numpy(), batch.edge_index[1].numpy(),
        batch.edge_to_pe.numpy(), batch.edge_attr.numpy(),
        batch.edge_mask.numpy(), nl, d, batch.pe_mask.shape[0],
    )
    (isend_idx, iloc_rows, iloc_cols, iloc_e2pie, iloc_eattr,
     irem_rows, irem_cols, irem_e2pie, irem_eattr) = _split_edge_family(
        batch.iedge_index[0].numpy(), batch.iedge_index[1].numpy(),
        batch.iedge_to_pie.numpy(), batch.iedge_attr.numpy(),
        batch.iedge_mask.numpy(), nl, d, batch.pie_mask.shape[0],
    )

    # per-shard local member tables (the partial pooling's gathers): one
    # member cap across shards
    assign_l = assign0.reshape(d, nl)
    need = 1
    for dd in range(d):
        a = assign_l[dd][assign_l[dd] < c0]
        if len(a):
            need = max(need, int(np.bincount(a).max()))
    ml = max(8, -(-need // 8) * 8)
    mem0_loc = np.stack(
        [_flat_member_table(assign_l[dd], c0, nl, ml) for dd in range(d)]
    )
    mem1_idx = (
        batch.mem1_idx.numpy()
        if batch.mem1_idx is not None
        else _flat_member_table(batch.assign1.numpy(), batch.num_clusters1, c0)
    )

    return HaloBatch(
        x=x.reshape(d, nl, -1),
        assign0=assign0.reshape(d, nl),
        send_idx=send_idx,
        loc_rows=loc_rows, loc_cols=loc_cols,
        loc_e2pe=loc_e2pe, loc_eattr=loc_eattr,
        rem_rows=rem_rows, rem_cols=rem_cols,
        rem_e2pe=rem_e2pe, rem_eattr=rem_eattr,
        isend_idx=isend_idx,
        iloc_rows=iloc_rows, iloc_cols=iloc_cols,
        iloc_e2pie=iloc_e2pie, iloc_eattr=iloc_eattr,
        irem_rows=irem_rows, irem_cols=irem_cols,
        irem_e2pie=irem_e2pie, irem_eattr=irem_eattr,
        loc_rowptr=_shard_row_ptrs(loc_rows, nl, "local interface"),
        rem_rowptr=_shard_row_ptrs(rem_rows, nl, "remote interface"),
        iloc_rowptr=_shard_row_ptrs(iloc_rows, nl, "local internal"),
        irem_rowptr=_shard_row_ptrs(irem_rows, nl, "remote internal"),
        mem0_loc=mem0_loc,
        pe_index=batch.pe_index.numpy(),
        pie_index=batch.pie_index.numpy(),
        pe_rowptr=batch.pe_rowptr.numpy(),
        pie_rowptr=batch.pie_rowptr.numpy(),
        assign1=batch.assign1.numpy(),
        pool1_graph=batch.pool1_graph.numpy(),
        mem1_idx=mem1_idx,
        y=batch.y.numpy(),
        y_mask=batch.y_mask.numpy(),
    )


# ---------------------------------------------------------------------------
# device-side primitives (on a rank's view; collectives over v.group)


def halo_exchange(values: torch.Tensor, send_idx: torch.Tensor, group) -> torch.Tensor:
    """Exchange boundary node rows: ``values [Nl, F]`` this rank's node
    data, ``send_idx [D, H]`` the rows each peer needs from it. Returns
    the table ``[Nl + D*H, F]`` that ``rem_cols`` indexes (halo row
    ``Nl + s*H + j`` is row ``send_idx[s -> me][j]`` of rank ``s``)."""
    d, h = send_idx.shape
    f = values.shape[-1]
    send = values.index_select(0, send_idx.reshape(-1)).reshape(d, h, f)
    recv = all_to_all(send, group)
    return torch.cat([values, recv.reshape(d * h, f)], dim=0)


def _raw_segment_max(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment max with -inf for an empty segment (combinable across
    shards)."""
    ids = _dump_row(ids, num_segments).to(torch.int64)
    shape = (num_segments + 1,) + tuple(data.shape[1:])
    idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full(shape, float("-inf"))
    out.scatter_reduce_(0, idx, data, reduce="amax", include_self=True)
    return out[:num_segments]


def cross_shard_max_pool(h: torch.Tensor, assign: torch.Tensor, num_clusters: int,
                         mem_idx: Optional[torch.Tensor], group) -> torch.Tensor:
    """Community max-pool whose clusters may span ranks: the local partial
    max, then one all-gather and a max over the ranks, with
    torch-scatter's empty-cluster 0 fill on the global member counts. The
    counts ride as an extra column of the same all-gather. The max over
    the ranks is ``amax``, whose backward splits a tie evenly, as JAX's
    reduce-max does (``torch.max(dim=)`` would not)."""
    if mem_idx is not None:
        part = member_max_partial(h[None], mem_idx[None], assign[None])[0]
        cnt = member_counts(mem_idx, h.shape[0])
    else:
        part = _raw_segment_max(h, assign, num_clusters)
        cnt = segment_count(assign, num_clusters)
    packed = torch.cat([part, cnt[:, None]], dim=1)
    ag = all_gather(packed, group)  # [D, C, F+1]
    pooled = torch.amax(ag[..., :-1], dim=0)
    gcnt = ag[..., -1].sum(dim=0)
    return torch.where(gcnt[:, None] > 0, pooled,
                       torch.zeros((), dtype=pooled.dtype, device=pooled.device))


def _family(v: HaloBatch, internal: bool):
    """``(send_idx, loc_rows, loc_cols, loc_rowptr, rem_rows, rem_cols,
    rem_rowptr)`` of the interface or the internal edges."""
    if internal:
        return (v.isend_idx, v.iloc_rows, v.iloc_cols, v.iloc_rowptr,
                v.irem_rows, v.irem_cols, v.irem_rowptr)
    return (v.send_idx, v.loc_rows, v.loc_cols, v.loc_rowptr,
            v.rem_rows, v.rem_cols, v.rem_rowptr)


def halo_gin_aggregate(xw: torch.Tensor, v: HaloBatch, *, internal: bool = False) -> torch.Tensor:
    """``segment_sum(xw[col], row)`` across ranks: the local-source edges
    sum from this rank's rows, the remote-source ones from the received
    halo; each sum is one K1 launch. Returns ``[Nl, F]``."""
    send_idx, lr, lc, lptr, rr, rc, rptr = _family(v, internal)
    combined = halo_exchange(xw, send_idx, v.group)
    z = segment_sum(gather(xw, lc), lr, v.nl, row_ptr=lptr)
    return z + segment_sum(gather(combined, rc), rr, v.nl, row_ptr=rptr)


def _joint_segment_softmax(logit_loc, rows_loc, logit_rem, rows_rem, n):
    """Per-destination softmax over edges split into the local and remote
    groups (both groups of a row live on its owner rank, so this is
    rank-local). Plain torch, as the JAX package composes it."""
    m = torch.maximum(
        _raw_segment_max(logit_loc, rows_loc, n),
        _raw_segment_max(logit_rem, rows_rem, n),
    )
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    m = torch.where(torch.isfinite(m), m, zero)
    mrow = torch.cat([m, m.new_zeros(1)])

    def part(logit, rows):
        safe = torch.clamp(rows, 0, n).long()
        e = torch.exp(logit - mrow[safe])
        return torch.where(rows < n, e, zero)

    e_loc, e_rem = part(logit_loc, rows_loc), part(logit_rem, rows_rem)
    denom = segment_sum(e_loc[:, None], rows_loc, n) + segment_sum(e_rem[:, None], rows_rem, n)
    drow = torch.cat([denom[:, 0], denom.new_ones(1)])
    return (
        e_loc / torch.clamp(drow[torch.clamp(rows_loc, 0, n).long()], min=1e-16),
        e_rem / torch.clamp(drow[torch.clamp(rows_rem, 0, n).long()], min=1e-16),
    )


def _ginet_tower_halo(model, conv1, conv2, v: HaloBatch, internal: bool) -> torch.Tensor:
    """One GINet tower on a rank's view (the semantics of
    ``models.ginet.GINet._tower``; reference `ginet.py:99-141`)."""
    c0, c1, g = v.num_clusters0, v.num_clusters1, v.num_graphs
    send_idx, lr, lc, lptr, rr, rc, rptr = _family(v, internal)
    if internal:
        le, re_, lp, rp = v.iloc_eattr, v.irem_eattr, v.iloc_e2pie, v.irem_e2pie
        p_index, p_ptr = v.pie_index, v.pie_rowptr
    else:
        le, re_, lp, rp = v.loc_eattr, v.rem_eattr, v.loc_e2pe, v.rem_e2pe
        p_index, p_ptr = v.pe_index, v.pe_rowptr
    p_cap = p_index.shape[1]

    xw = linear(v.x, conv1.fc.weight)
    if model.attention:
        combined = halo_exchange(xw, send_idx, v.group)
        msg_loc, msg_rem = gather(xw, lc), gather(combined, rc)

        def logits(msg, rows, eattr):
            xrow = gather(xw, torch.clamp(rows, 0, v.nl - 1))
            ed = linear(eattr, conv1.fc_edge_attr.weight)
            lg = linear(torch.cat([xrow, msg, ed], dim=1), conv1.fc_attention.weight)
            return F.leaky_relu(lg[:, 0])

        a_loc, a_rem = _joint_segment_softmax(
            logits(msg_loc, lr, le), lr, logits(msg_rem, rr, re_), rr, v.nl
        )
        z = segment_sum(msg_loc * a_loc[:, None], lr, v.nl, row_ptr=lptr) + segment_sum(
            msg_rem * a_rem[:, None], rr, v.nl, row_ptr=rptr
        )
    else:
        # paper parity (quirk Q1): the plain segment sum of W x[col]
        z = halo_gin_aggregate(xw, v, internal=internal)
    h = torch.relu(z)

    hp = cross_shard_max_pool(h, v.assign0, c0, v.mem0_loc, v.group)  # replicated from here
    # pooled edge attributes (torch-sparse coalesce sums them): the
    # per-rank partials summed over the ranks; only attention reads them
    pa = None
    if model.attention:
        pa = all_reduce(segment_sum(le, lp, p_cap) + segment_sum(re_, rp, p_cap), v.group)
    h2 = torch.relu(ginet_conv(conv2, hp, p_index, pa, c0, p_ptr, attention=model.attention))
    hq = max_pool_x(h2, v.assign1, c1, v.mem1_idx)
    return graph_mean_pool(hq, v.pool1_graph, g)


def _ginet_towers_halo_fused(model, v: HaloBatch) -> torch.Tensor:
    """Paper-mode (quirks Q1/Q2) GINet towers, fused: both towers run on
    the interface edges with their own weights, so their features
    concatenate and the forward costs two collectives, one 32-wide boundary
    all-to-all and one pooled-combine all-gather, and three K1 launches
    (the local and remote sums, the pooled conv). Returns ``[G, 64]``."""
    c0, c1, g = v.num_clusters0, v.num_clusters1, v.num_graphs
    xw = torch.cat(
        [linear(v.x, model.conv1.fc.weight), linear(v.x, model.conv1_ext.fc.weight)], dim=1
    )  # [Nl, 32]
    h = torch.relu(halo_gin_aggregate(xw, v))
    hp = cross_shard_max_pool(h, v.assign0, c0, v.mem0_loc, v.group)  # [C0, 32]
    hw = torch.cat(
        [linear(hp[:, :16], model.conv2.fc.weight), linear(hp[:, 16:], model.conv2_ext.fc.weight)],
        dim=1,
    )  # [C0, 64]
    row, col = v.pe_index[0], v.pe_index[1]
    h2 = torch.relu(segment_sum(gather(hw, col), row, c0, row_ptr=v.pe_rowptr))
    hq = max_pool_x(h2, v.assign1, c1, v.mem1_idx)
    return graph_mean_pool(hq, v.pool1_graph, g)  # [G, 64] = [t1 | t2]


def ginet_apply_halo(model, v: HaloBatch, generator: Optional[torch.Generator] = None):
    """GINet's forward on a rank's view (``GINet.forward`` dispatches here):
    replicated ``[G, output_shape]`` scores. Dropout draws at ``[G, 128]``
    from ``generator``, whose state is equal on every rank."""
    if model.fuse:
        h = _ginet_towers_halo_fused(model, v)
    else:
        t1 = _ginet_tower_halo(model, model.conv1, model.conv2, v, False)
        t2 = _ginet_tower_halo(model, model.conv1_ext, model.conv2_ext, v,
                               internal=model.internal_tower)
        h = torch.cat([t1, t2], dim=1)
    h = torch.relu(linear(h, model.fc1.weight, model.fc1.bias))
    h = dropout(h, model.dropout_rate, generator, model.training)
    return linear(h, model.fc2.weight, model.fc2.bias)


def _halo_segment_mean_pair(msg_loc, lr, lptr, msg_rem, rr, rptr, n):
    """Joint segment mean over an edge family split into its local and
    remote groups (count clamped to 1: ``ops.segment.segment_mean``); the
    two sums are K1 launches."""
    total = segment_sum(msg_loc, lr, n, row_ptr=lptr) + segment_sum(msg_rem, rr, n,
                                                                    row_ptr=rptr)
    cnt = segment_count(lr, n) + segment_count(rr, n)
    return total / torch.clamp(cnt[:, None], min=1.0)


def _fout_pooled_halo(model, v: HaloBatch) -> torch.Tensor:
    """FoutNet up to the readout on a rank's view (reference
    `foutnet.py:90-126`; the neighbor mean reads the boundary exchange)."""
    c0, c1, g = v.num_clusters0, v.num_clusters1, v.num_graphs
    p = model.conv1
    alpha = v.x @ p.Wc
    beta = v.x @ p.Wn
    combined = halo_exchange(beta, v.send_idx, v.group)
    gamma = _halo_segment_mean_pair(
        gather(beta, v.loc_cols), v.loc_rows, v.loc_rowptr,
        gather(combined, v.rem_cols), v.rem_rows, v.rem_rowptr, v.nl,
    )
    h = torch.relu(alpha + gamma + p.bias)
    hp = cross_shard_max_pool(h, v.assign0, c0, v.mem0_loc, v.group)
    h2 = torch.relu(fout_layer(model.conv2, hp, v.pe_index, c0, v.pe_rowptr))
    hq = max_pool_x(h2, v.assign1, c1, v.mem1_idx)
    return graph_mean_pool(hq, v.pool1_graph, g)


def _sgat_pooled_halo(model, v: HaloBatch) -> torch.Tensor:
    """sGAT up to the readout on a rank's view (reference `sGAT.py:101-139`;
    undirected mode, the nets' only wiring, quirk Q10)."""
    c0, c1, g = v.num_clusters0, v.num_clusters1, v.num_graphs
    p = model.conv1
    in_ch = v.x.shape[1]
    xr = v.x @ p.weight[:in_ch]
    xc = v.x @ p.weight[in_ch:]
    combined = halo_exchange(xc, v.send_idx, v.group)
    a_loc = (gather(xr, torch.clamp(v.loc_rows, 0, v.nl - 1))
             + gather(xc, v.loc_cols)) * v.loc_eattr
    a_rem = (gather(xr, torch.clamp(v.rem_rows, 0, v.nl - 1))
             + gather(combined, v.rem_cols)) * v.rem_eattr
    h = _halo_segment_mean_pair(a_loc, v.loc_rows, v.loc_rowptr, a_rem, v.rem_rows,
                                v.rem_rowptr, v.nl) + p.bias
    h = torch.relu(h)
    hp = cross_shard_max_pool(h, v.assign0, c0, v.mem0_loc, v.group)
    p_cap = v.pe_index.shape[1]
    pe_attr = all_reduce(
        segment_sum(v.loc_eattr, v.loc_e2pe, p_cap) + segment_sum(v.rem_eattr, v.rem_e2pe, p_cap),
        v.group,
    )
    h2 = torch.relu(sgat_layer(model.conv2, hp, v.pe_index, pe_attr, c0, v.pe_rowptr))
    hq = max_pool_x(h2, v.assign1, c1, v.mem1_idx)
    return graph_mean_pool(hq, v.pool1_graph, g)


def single_tower_pooled_halo(model, v: HaloBatch) -> torch.Tensor:
    """FoutNet's or sGAT's ``[G, 32]`` readout on a rank's view (their
    ``forward`` dispatches here and applies the head)."""
    if isinstance(model, FoutNet):
        return _fout_pooled_halo(model, v)
    if isinstance(model, sGAT):
        return _sgat_pooled_halo(model, v)
    raise TypeError(f"{type(model).__name__} has no halo layout")


# ---------------------------------------------------------------------------
# steps


def make_halo_train_step(model, optimizer, mesh: Mesh, task: str = "reg",
                         class_weights: Optional[torch.Tensor] = None,
                         transform_sigmoid: bool = False):
    """``step(halo_batch, generator) -> (loss, pred)``: one optimizer step
    with the explicit halo exchange (``parallel.step.MeshSteps``)."""
    return MeshSteps(model, optimizer, mesh, task, class_weights, transform_sigmoid,
                     halo=True).train


def make_halo_eval_step(model, mesh: Mesh, task: str = "reg",
                        class_weights: Optional[torch.Tensor] = None,
                        transform_sigmoid: bool = False):
    """``step(halo_batch) -> (loss, pred)`` without gradients."""
    return MeshSteps(model, None, mesh, task, class_weights, transform_sigmoid,
                     halo=True).eval


__all__ = [
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

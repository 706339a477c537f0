"""Edge-to-slot aggregation, cluster max-pooling and the per-graph readout
of the dense layout.

The port's counterpart of ``deeprank_gnn_tpu/ops/dense.py``: the node
gather and the edge-to-slot sums, counts, means and softmax that the
attention conv, FoutNet and sGAT run (batched one-hot products, as XLA
compiled them for the JAX package: deterministic, no atomics); the
member-table pool (which the sparse layout uses), the pool by assignment
that the streaming dense path takes (its batches carry no member tables, so
the JAX package's ``cluster_max_pool`` dispatch always lands there), and the
masked mean readout. The paper-mode GINet's aggregation is kernel K3
(:mod:`deeprank_gnn_tpu_torch.ops.kernels.gin_conv`).

The operator path (``collate_dense(precompute_ops=True)`` and the device
store) adds the :func:`cluster_max_pool` dispatch, the tiled pool over the
striped feature-major layout (:func:`tiled_cluster_max_pool`) and the
aggregation by a stored adjacency (:func:`adj_conv`): plain torch products,
as the JAX package leaves them to XLA.

Gradients come from autograd, except for the tiled pool and ``adj_conv``,
which carry the JAX package's custom backward. A max pool splits a slot's gradient evenly
among tied maxima, as the JAX package's pools do (``_member_max_bwd``, and
``reduce_max``'s VJP for ``slot_max_pool``): ``amax`` and
``scatter_reduce(amax)`` both split ties evenly.
"""

from __future__ import annotations

import torch

from deeprank_gnn_tpu_torch.ops.segment import segment_max

# Above this virtual broadcast size (G * C * S * F fp32 bytes) the pool
# takes the member-table gathers, below it the pool by assignment: the JAX
# package's threshold (``ops/dense.py:354-367``), kept so that both packages
# take the same form for the same batch.
_MEMBER_POOL_MIN_BYTES = 64 * 1024 * 1024

# Run-padded dense layout: every level-0 cluster's contiguous run of node
# slots is padded to a multiple of this many rows (``collate_dense``).
TILE_R = 8


def gather_nodes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [G,S,F]`` gathered by ``idx [G,E]`` -> [G,E,F]; a sentinel reads
    the graph's last row (callers' aggregations drop those lanes)."""
    g, s, f = x.shape
    goff = torch.arange(g, dtype=idx.dtype, device=idx.device)[:, None] * s
    flat = (torch.clamp(idx, 0, s - 1) + goff).reshape(-1)
    return x.reshape(g * s, f).index_select(0, flat).reshape(g, idx.shape[1], f)


def _one_hot(idx: torch.Tensor, size: int, dtype: torch.dtype) -> torch.Tensor:
    """[G,E] -> [G,E,size]; a sentinel's row is all zero."""
    iota = torch.arange(size, dtype=idx.dtype, device=idx.device)
    return (idx[..., None] == iota).to(dtype)


def edge_sum_to_slots(values: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """Sum edge values ``[G,E,F]`` into slots by ``idx [G,E]`` -> [G,size,F]
    (the JAX package's one-hot einsum)."""
    return torch.einsum("ges,gef->gsf", _one_hot(idx, size, values.dtype), values)


def edge_count_to_slots(idx: torch.Tensor, size: int, dtype=torch.float32) -> torch.Tensor:
    """Number of edges per slot. [G,E] -> [G,size]."""
    return _one_hot(idx, size, dtype).sum(dim=1)


def edge_mean_to_slots(values: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """Mean of edge values per slot, 0 for an empty slot. -> [G,size,F]."""
    total = edge_sum_to_slots(values, idx, size)
    count = edge_count_to_slots(idx, size, values.dtype)
    return total / torch.clamp(count, min=1.0)[..., None]


def dense_segment_softmax(logits: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """Per-slot softmax of edge logits ``[G,E]`` grouped by ``idx [G,E]``
    (a sentinel >= ``size`` drops out, weight 0) -> [G,E]; the dense analog
    of ``ops.segment.segment_softmax`` (JAX ``ops/dense.py:370-397``), with
    its two NaN guards."""
    valid = idx < size
    member = (idx[..., None] == torch.arange(size, dtype=idx.dtype, device=idx.device)) \
        & valid[..., None]  # [G,E,C]
    neg_inf = torch.full((), float("-inf"), dtype=logits.dtype, device=logits.device)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    slot_max = torch.where(member, logits[..., None], neg_inf).amax(dim=1)  # [G,C]
    slot_max = torch.where(torch.isfinite(slot_max), slot_max, zero)
    safe = torch.clamp(idx, 0, size - 1).long()
    # sanitize BEFORE exp: where()'s backward evaluates the branch it does
    # not take too, and exp of a huge pad logit turns a zero cotangent into
    # inf * 0 = NaN
    shifted = torch.where(valid, logits - torch.gather(slot_max, 1, safe), zero)
    expv = torch.where(valid, torch.exp(shifted), zero)
    denom = edge_sum_to_slots(expv[..., None], idx, size)[..., 0]  # [G,C]
    # empty slots divide by 1, not by a tiny epsilon: the division's
    # backward squares the denominator, and eps^2 underflows to 0 -> NaN;
    # every populated slot has denom >= exp(0) = 1 thanks to the shift
    denom = torch.where(denom > 0, denom, torch.ones((), dtype=denom.dtype, device=denom.device))
    return expv / torch.gather(denom, 1, safe)


def member_max_pool(h: torch.Tensor, mem_idx: torch.Tensor) -> torch.Tensor:
    """Max-pool [G,S,F] rows into [G,C,F] via the precomputed member
    table ``mem_idx`` [G,C,M] (pad sentinel == S); empty slots give 0
    (torch-scatter zero-buffer semantics).

    One flat row gather over a [G*S + 1, F] view whose trailing row is
    -inf, so padded members never win the max; then a max over the M
    members. Touches only C*M rows and needs no scatter.
    """
    g, s, f = h.shape
    c, m = mem_idx.shape[1], mem_idx.shape[2]
    rows = torch.cat([h.reshape(g * s, f), h.new_full((1, f), float("-inf"))])
    goff = torch.arange(g, dtype=mem_idx.dtype, device=mem_idx.device)
    valid = mem_idx < s
    flat = torch.where(valid, mem_idx + goff.reshape(g, 1, 1) * s, g * s)
    vals = rows.index_select(0, flat.reshape(-1)).reshape(g, c, m, f)
    out = vals.amax(dim=2)
    empty = ~valid.any(dim=2)
    return torch.where(empty[..., None], torch.zeros((), dtype=h.dtype, device=h.device), out)


class _MemberMaxPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, mem_idx, assign):
        g, s, f = h.shape
        c, m = mem_idx.shape[1], mem_idx.shape[2]
        vals = _flat_rows(h, float("-inf")).index_select(0, _flat_idx(mem_idx, s))
        vals = vals.reshape(g, c, m, f)
        out = vals.amax(dim=2)
        # each slot's ties, counted while the member values are at hand
        counts = (vals == out[:, :, None, :]).to(h.dtype).sum(dim=2)
        ctx.save_for_backward(h, assign, out, counts)
        return out

    @staticmethod
    def backward(ctx, cot):
        # JAX ``_member_max_bwd``: each node equal to its slot's max takes
        # an even share of the slot's cotangent; padding nodes take none
        h, assign, out, counts = ctx.saved_tensors
        g, s, f = h.shape
        aidx = _flat_idx(assign, out.shape[1])
        own_max = _flat_rows(out, float("inf")).index_select(0, aidx).reshape(g, s, f)
        cnt = _flat_rows(counts, 1.0).index_select(0, aidx).reshape(g, s, f)
        cot_n = _flat_rows(cot, 0.0).index_select(0, aidx).reshape(g, s, f)
        share = cot_n / torch.clamp(cnt, min=1.0)
        dh = torch.where(h == own_max, share, torch.zeros((), dtype=h.dtype, device=h.device))
        return dh, None, None


def member_max_partial(h: torch.Tensor, mem_idx: torch.Tensor,
                       assign: torch.Tensor) -> torch.Tensor:
    """:func:`member_max_pool` without the empty-slot zero fill (JAX
    ``ops/dense.py:217-241``): an empty slot stays -inf, so the partial
    maxes of several shards combine by a max (the halo layout's
    cross-shard pooling, ``parallel/halo.py``). ``assign [G,S]`` maps each
    node to its slot (pad >= C). The backward is JAX's ``_member_max_bwd``:
    a slot's cotangent is split evenly among its nodes equal to the max."""
    return _MemberMaxPartial.apply(h, mem_idx, assign)


def slot_max_pool(h: torch.Tensor, assign: torch.Tensor, size: int) -> torch.Tensor:
    """Max-pool [G,S,F] rows into [G,size,F] by ``assign`` [G,S]; a slot
    out of ``[0, size)`` drops its row, and an empty slot gives 0.

    The flattened-segment form of the JAX function (one segment max over
    per-graph-offset ids, ``ops/dense.py:90-102``): its broadcast form
    would materialise a [G, size, S, F] tensor here."""
    g, s, f = h.shape
    gid = torch.arange(g, dtype=assign.dtype, device=assign.device)[:, None]
    flat_ids = torch.where((assign >= 0) & (assign < size), assign + gid * size, g * size)
    return segment_max(h.reshape(g * s, f), flat_ids.reshape(-1), g * size).reshape(g, size, f)


def masked_mean(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[G,S,F] mean over the valid S rows -> [G,F] (0 for a graph with
    none)."""
    m = mask.to(h.dtype)[..., None]
    return (h * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def member_counts(mem_idx: torch.Tensor, src_len: int) -> torch.Tensor:
    """Valid-member count per slot straight from the table (no scatter).
    [.., C, M] -> [.., C] float32."""
    return (mem_idx < src_len).sum(dim=-1).to(torch.float32)


def cluster_max_pool(h: torch.Tensor, assign: torch.Tensor, size: int,
                     mem_idx=None) -> torch.Tensor:
    """Cluster max-pool dispatch (JAX ``ops/dense.py:354-367``): the
    member-table gathers when the batch carries a table and the pool's
    virtual broadcast exceeds ``_MEMBER_POOL_MIN_BYTES``, else the pool by
    assignment. Both give the same numbers."""
    g, s, f = h.shape
    if mem_idx is not None and g * size * s * f * 4 > _MEMBER_POOL_MIN_BYTES:
        return member_max_pool(h, mem_idx)
    return slot_max_pool(h, assign, size)


def _flat_rows(x: torch.Tensor, pad_value: float) -> torch.Tensor:
    """[G,S,F] -> [G*S + 1, F] with a trailing sentinel row."""
    g, s, f = x.shape
    return torch.cat([x.reshape(g * s, f), x.new_full((1, f), pad_value)])


def _flat_idx(idx: torch.Tensor, bound: int) -> torch.Tensor:
    """Per-graph indices [G, ...] (pad sentinel >= ``bound``) -> flat row ids
    into the [G*bound + 1]-row view, the pad at the sentinel row."""
    g = idx.shape[0]
    goff = torch.arange(g, dtype=idx.dtype, device=idx.device).reshape((g,) + (1,) * (idx.ndim - 1))
    return torch.where(idx < bound, idx + goff * bound, g * bound).reshape(-1).long()


def _tiles_to_clusters_sum(a_t: torch.Tensor, tile_mem: torch.Tensor) -> torch.Tensor:
    """[G, F, T] tile values -> [G, C, F]: per cluster the sum over its tiles
    (the tile member table, pad sentinel == T)."""
    tl = a_t.transpose(1, 2)  # [G, T, F]
    g, t, f = tl.shape
    vals = _flat_rows(tl, 0.0).index_select(0, _flat_idx(tile_mem, t))
    return vals.reshape(g, tile_mem.shape[1], tile_mem.shape[2], f).sum(dim=2)


def _clusters_to_tiles(a_c: torch.Tensor, tile_assign: torch.Tensor, pad: float) -> torch.Tensor:
    """[G, C, F] cluster values -> [G, F, T] at each tile via ``tile_assign``
    (pad tiles read ``pad``)."""
    g, c, f = a_c.shape
    t = tile_assign.shape[1]
    rows = _flat_rows(a_c, pad).index_select(0, _flat_idx(tile_assign, c))
    return rows.reshape(g, t, f).transpose(1, 2)


class _TiledPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_fm, node_mask_fm, tile_mem, tile_assign):
        vals = torch.where(node_mask_fm[:, None], h_fm, float("-inf"))
        tiles = vals.amax(dim=2)  # [G, F, T]
        out = member_max_pool(tiles.transpose(1, 2), tile_mem)  # [G, C, F]
        ctx.save_for_backward(h_fm, node_mask_fm, tile_mem, tile_assign, out)
        return out

    @staticmethod
    def backward(ctx, cot):
        # JAX ``_tiled_pool_bwd``: every argmax node of a cluster, in any
        # of its tiles, takes an even share of the cluster's cotangent
        h_fm, node_mask_fm, tile_mem, tile_assign, hp = ctx.saved_tensors
        cmax_t = _clusters_to_tiles(hp, tile_assign, float("inf"))  # [G, F, T]
        cot_t = _clusters_to_tiles(cot, tile_assign, 0.0)
        vals = torch.where(node_mask_fm[:, None], h_fm, float("-inf"))
        is_max = vals == cmax_t[:, :, None, :]  # [G, F, R, T]
        eq_t = is_max.to(h_fm.dtype).sum(dim=2)  # [G, F, T]
        cnt_t = _clusters_to_tiles(_tiles_to_clusters_sum(eq_t, tile_mem), tile_assign, 1.0)
        share = (cot_t / torch.clamp(cnt_t, min=1.0))[:, :, None, :]
        dh = torch.where(is_max, share, torch.zeros((), dtype=h_fm.dtype, device=h_fm.device))
        return dh, None, None, None


def tiled_cluster_max_pool(h_fm: torch.Tensor, node_mask_fm: torch.Tensor,
                           tile_mem: torch.Tensor, tile_assign: torch.Tensor) -> torch.Tensor:
    """Cluster max-pool of a striped feature-major activation [G, F, R, T]
    on the run-padded layout -> [G, C, F] (JAX ``ops/dense.py:277-351``).
    ``node_mask_fm`` [G, R, T] marks member slot r of tile t (node 8t + r),
    ``tile_mem`` [G, C, MT] lists each cluster's tiles (pad == T) and
    ``tile_assign`` [G, T] each tile's cluster (pad == C).

    The forward is a max within each tile, then a member-table max over
    the tiles; an empty cluster gives 0. The backward is JAX's: each
    cluster's cotangent is split evenly over all of its argmax nodes,
    across every tile, from gathers alone. Autograd through the two maxes
    would split at each stage instead (ties 2 + 1 over two tiles: 1/4,
    1/4, 1/2 where JAX gives 1/3 each)."""
    return _TiledPool.apply(h_fm, node_mask_fm, tile_mem, tile_assign)


def _bmm_bf16(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``a @ v`` with both operands rounded to bfloat16 and an fp32 result
    accumulated in fp32: on a card one cuBLAS product with bf16 inputs and
    an fp32 output (``torch.bmm(..., out_dtype=torch.float32)``); on the CPU,
    which has no such product, the fp32 product of the rounded operands,
    whose products are exact in fp32 (8-bit significands)."""
    ab, vb = a.to(torch.bfloat16), v.to(torch.bfloat16)
    if v.device.type == "cpu":
        return torch.bmm(ab.float(), vb.float())
    return torch.bmm(ab, vb, out_dtype=torch.float32)


class _AdjConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, adj, exact):
        a = adj.to(v.dtype)
        ctx.save_for_backward(a)
        ctx.exact = exact
        return torch.bmm(a, v) if exact else _bmm_bf16(a, v)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        at = a.transpose(1, 2)
        return (torch.bmm(at, g) if ctx.exact else _bmm_bf16(at, g)), None, None


def adj_conv(v: torch.Tensor, adj: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """Aggregation by a precomputed adjacency operator, ``adj [G,S,S] @ v
    [G,S,F]``, in fp32 (TF32 off: the JAX package's "exact"); the backward
    is ``adj^T @ g`` and ``adj`` gets no gradient (JAX
    ``ops/dense.py:421-470``). ``exact=False`` is the JAX package's fast
    mode: both products take bfloat16 operands (``v``, and the cotangent in
    the backward, rounded to nearest even; ``adj``'s small integers are
    exact) with fp32 accumulation and an fp32 result. The JAX package leaves
    it to XLA, outside Pallas, so it is a library product here too."""
    return _AdjConv.apply(v, adj, exact)

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

Gradients come from autograd. A max pool splits a slot's gradient evenly
among tied maxima, as the JAX package's pools do (``_member_max_bwd``, and
``reduce_max``'s VJP for ``slot_max_pool``): ``amax`` and
``scatter_reduce(amax)`` both split ties evenly.
"""

from __future__ import annotations

import torch

from deeprank_gnn_tpu_torch.ops.segment import segment_max

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

"""Cluster max-pooling and the per-graph readout of the dense layout.

The port's counterpart of ``deeprank_gnn_tpu/ops/dense.py``: the member-table
pool (which the sparse layout uses), the pool by assignment that the
streaming dense path takes (its batches carry no member tables, so the JAX
package's ``cluster_max_pool`` dispatch always lands there), and the
masked mean readout. The dense aggregation itself is kernel K3
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

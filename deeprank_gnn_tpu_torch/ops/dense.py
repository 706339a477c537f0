"""Cluster max-pooling through member tables (forward).

The port's counterpart of ``member_max_pool`` in
``deeprank_gnn_tpu/ops/dense.py``; the rest of that module serves the
dense layout, which is not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch


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

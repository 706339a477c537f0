"""The yardstick's arithmetic: the card's peaks, the counts a graph's work
depends on, and the least time of each hand kernel, all from the traffic's
raw arrays. What a net's step needs of them is its own file's
(``nets/<net>.py``: ``work``).

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense, no
sparsity). The configurations compute in float32 with TF32 off, so the
FLOP peak is the float32 rate outside the tensor cores.

``k1_bound_ms``, ``k2_bound_ms`` and ``k3_bound_ms`` are frozen copies of
``chip_smoke.py``'s, restated on counts rather than the program's padded
batches: each input byte read once, each output byte written once, over the
HBM rate, or one add per valid edge and column over the float32 rate,
whichever is longer. K3's output is counted over a graph's real rows (the
program's batches pad them; the padding is not work the model needs).
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def k1_bound_ms(e_valid: int, n: int, f: int) -> float:
    """One sorted segment sum of ``e_valid`` rows of ``f`` columns into
    ``n`` rows: input rows, row pointers and output once."""
    moved = (e_valid * f + n * f + n + 1) * 4
    return 1e3 * max(moved / HBM_BYTES_PER_S, e_valid * f / FP32_FLOPS)


def k2_bound_ms(e_valid: int, e: int, n: int, f: int) -> float:
    """One sorted scatter-gather: input rows and row pointers once, the
    ``[n, f]`` sums and the ``[e, f]`` gathered values written once."""
    moved = (e_valid * f + n + 1 + n * f + e * f) * 4
    return 1e3 * max(moved / HBM_BYTES_PER_S, e_valid * f / FP32_FLOPS)


def k3_bound_ms(sources: int, rows: int, edges: int, f: int) -> float:
    """One K3 call ``out[r] = sum over edges (r, c) of xw[c]``: the
    ``sources`` distinct rows of ``xw`` that an edge reads, the ``rows``
    output rows, and two int32 indices per edge, each moved once."""
    moved = 4 * (sources * f + rows * f + 2 * edges)
    return 1e3 * max(moved / HBM_BYTES_PER_S, edges * f / FP32_FLOPS)


def graph_counts(g: dict) -> dict:
    """What the model's work on one graph depends on: nodes, directed edges,
    level-0 and level-1 clusters, the coalesced edges between distinct
    level-0 clusters, and the distinct endpoints of each edge set."""
    row, col = g["edge_index"]
    c0 = g["cluster0"]
    k0 = len(g["cluster1"])
    pr, pc = c0[row], c0[col]
    keep = pr != pc
    pairs = np.unique(pr[keep].astype(np.int64) * k0 + pc[keep])
    prow, pcol = pairs // k0, pairs % k0
    return {"nodes": g["x"].shape[0], "edges": row.size, "c0": k0,
            "c1": int(g["cluster1"].max()) + 1, "pooled": pairs.size,
            "edge_sources": np.unique(col).size, "edge_targets": np.unique(row).size,
            "pooled_sources": np.unique(pcol).size, "pooled_targets": np.unique(prow).size}

"""Host-side community detection: Markov Clustering (MCL) and Louvain.

The reference delegates to the `markov_clustering` and `community`
(python-louvain) packages over a networkx graph (reference
`community_pooling.py:95-158`); clusters are computed offline on
internal edges and stored in the HDF5 (`DataSet.py:45-88`). Both
algorithms are re-implemented here from their published definitions:

- MCL (van Dongen 2000): add self-loops, column-normalize, then iterate
  expansion (matrix squaring) and inflation (elementwise power +
  renormalization) with pruning until the matrix is idempotent;
  clusters are the rows of attractors (nonzero diagonal). The
  hyperparameters match the `markov_clustering.run_mcl` defaults the
  reference relies on (expansion=2, inflation=2, loop_value=1,
  pruning_threshold=1e-3).
- Louvain (Blondel et al. 2008): greedy modularity-maximizing local
  moves + graph aggregation, deterministic node order.

Cluster-id assignment follows the reference exactly: MCL cluster `ic`
writes `ic` into its member slots in enumeration order (later clusters
overwrite shared nodes, `community_pooling.py:151-153`); unassigned
nodes keep id 0.

This is the port's own copy of ``deeprank_gnn_tpu/featurize/cluster.py``
(numpy and scipy only), which ``PreCluster`` calls.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def _adjacency(edge_index: np.ndarray, num_nodes: int) -> sp.csr_matrix:
    """Symmetric unweighted adjacency from a (possibly directed,
    possibly duplicated) edge list."""
    if edge_index.size == 0:
        return sp.csr_matrix((num_nodes, num_nodes))
    src, dst = edge_index[0], edge_index[1]
    data = np.ones(src.shape[0])
    a = sp.coo_matrix((data, (src, dst)), shape=(num_nodes, num_nodes))
    a = a.maximum(a.T)  # undirected, weight 1 (nx.Graph semantics)
    a = sp.csr_matrix(a)
    a.data[:] = 1.0
    return a


# ----------------------------------------------------------------------
# MCL


def _normalize_columns(m: sp.csr_matrix) -> sp.csr_matrix:
    col_sums = np.asarray(m.sum(axis=0)).ravel()
    col_sums[col_sums == 0] = 1.0
    d = sp.diags(1.0 / col_sums)
    return sp.csr_matrix(m @ d)


def _sparse_allclose(a: sp.spmatrix, b: sp.spmatrix, rtol=1e-5, atol=1e-8) -> bool:
    diff = abs(a - b) - rtol * abs(b)
    return diff.max() <= atol if diff.nnz else True


def run_mcl(
    matrix: sp.spmatrix,
    expansion: int = 2,
    inflation: float = 2.0,
    loop_value: float = 1.0,
    iterations: int = 100,
    pruning_threshold: float = 0.001,
) -> sp.csr_matrix:
    """Markov Cluster algorithm over an adjacency matrix.

    Step order, pruning rule (threshold cut + keep-column-max, with NO
    renormalization afterwards) and the allclose convergence test match
    the published MCL procedure the reference's `markov_clustering`
    dependency implements with default parameters — verified
    cluster-for-cluster against the stored fixture output
    (`tests/test_community_pooling.py` parity tests; reference
    `community_pooling.py:142-155`).
    """
    m = sp.csr_matrix(matrix, dtype=np.float64)
    n = m.shape[0]
    if loop_value > 0:
        m = m.tolil()
        m.setdiag(loop_value)
        m = sp.csr_matrix(m)
    m = _normalize_columns(m)
    for _ in range(iterations):
        last = m.copy()
        # expansion
        for _ in range(expansion - 1):
            m = sp.csr_matrix(m @ m)
        # inflation (normalization is part of the inflation step)
        m = m.power(inflation)
        m = _normalize_columns(m)
        # pruning: drop sub-threshold entries but keep each column's max
        if pruning_threshold > 0:
            keep = m.tocsc(copy=True)
            argmax_rows = np.asarray(m.argmax(axis=0)).ravel()
            keep.data[keep.data < pruning_threshold] = 0.0
            keep.eliminate_zeros()
            keep = keep.tolil()
            col_max = np.asarray(m.max(axis=0).todense()).ravel()
            for j in range(n):
                if col_max[j] > 0:
                    keep[argmax_rows[j], j] = col_max[j]
            m = sp.csr_matrix(keep)
        if last.shape == m.shape and _sparse_allclose(m, last):
            break
    return m


def mcl_clusters(m: sp.csr_matrix):
    """Extract clusters: attractor rows' nonzero columns, deduplicated."""
    attractors = np.nonzero(m.diagonal() > 1e-12)[0]
    clusters = set()
    for i in attractors:
        members = tuple(sorted(m.getrow(i).nonzero()[1].tolist()))
        if members:
            clusters.add(members)
    return sorted(clusters)


# ----------------------------------------------------------------------
# Louvain


def louvain_partition(a: sp.csr_matrix, resolution: float = 1.0) -> np.ndarray:
    """Deterministic Louvain modularity optimization. Returns [N] labels."""
    n = a.shape[0]
    labels = np.arange(n)
    node_of = [np.array([i]) for i in range(n)]  # meta-node -> original nodes
    cur = sp.csr_matrix(a, dtype=np.float64)

    while True:
        nloc = cur.shape[0]
        comm = np.arange(nloc)
        deg = np.asarray(cur.sum(axis=1)).ravel() + cur.diagonal()
        two_m = deg.sum()
        if two_m == 0:
            break
        comm_deg = deg.copy()
        improved_any = False
        for _sweep in range(10):
            moved = False
            for v in range(nloc):
                cv = comm[v]
                row = cur.getrow(v)
                neigh, wts = row.indices, row.data
                # weights to neighboring communities (excluding self-loop)
                links = {}
                for u, w in zip(neigh, wts):
                    if u == v:
                        continue
                    links[comm[u]] = links.get(comm[u], 0.0) + w
                comm_deg[cv] -= deg[v]
                best_c, best_gain = cv, 0.0
                base = links.get(cv, 0.0) - resolution * comm_deg[cv] * deg[v] / two_m
                for c, w in links.items():
                    gain = w - resolution * comm_deg[c] * deg[v] / two_m
                    if gain - base > 1e-12 and gain > best_gain:
                        best_c, best_gain = c, gain
                comm[v] = best_c
                comm_deg[best_c] += deg[v]
                if best_c != cv:
                    moved = True
                    improved_any = True
            if not moved:
                break
        # relabel communities consecutively
        uniq, comm = np.unique(comm, return_inverse=True)
        # update original-node labels
        new_node_of = [[] for _ in range(len(uniq))]
        for v in range(nloc):
            new_node_of[comm[v]].extend(node_of[v].tolist())
        for c, members in enumerate(new_node_of):
            labels[np.array(members, dtype=int)] = c
        node_of = [np.array(m, dtype=int) for m in new_node_of]
        if not improved_any or len(uniq) == nloc:
            break
        # aggregate graph
        proj = sp.coo_matrix(
            (np.ones(nloc), (np.arange(nloc), comm)), shape=(nloc, len(uniq))
        ).tocsr()
        cur = sp.csr_matrix(proj.T @ cur @ proj)
    # consecutive ids
    _, labels = np.unique(labels, return_inverse=True)
    return labels.astype(np.int32)


# ----------------------------------------------------------------------
# public API (reference `community_pooling.py:95-158` replacement)


def community_detection(
    edge_index: np.ndarray, num_nodes: int, method: str = "mcl"
) -> np.ndarray:
    """Cluster nodes of one graph. Returns [num_nodes] int32 labels."""
    a = _adjacency(np.asarray(edge_index), num_nodes)
    if method == "louvain":
        return louvain_partition(a)
    if method == "mcl":
        m = run_mcl(a)
        clusters = mcl_clusters(m)
        index = np.zeros(num_nodes, dtype=np.int32)
        for ic, c in enumerate(clusters):
            index[list(c)] = ic
        return index
    raise ValueError(f"Clustering method {method} not supported")


def pool_graph_host(
    cluster: np.ndarray, edge_index: np.ndarray
) -> Tuple[np.ndarray, int]:
    """Coarsen a graph by a cluster assignment (host-side analog of the
    pooled-graph construction used between depth-0 and depth-1
    clustering, reference `DataSet.py:82-86`).

    Returns (pooled_edge_index [2, E'], pooled_num_nodes) with
    self-loops dropped and duplicates coalesced, consecutive ids in
    sorted-unique order (PyG `consecutive_cluster` semantics).
    """
    uniq, inv = np.unique(cluster, return_inverse=True)
    num_pooled = len(uniq)
    if edge_index.size == 0:
        return np.zeros((2, 0), dtype=np.int32), num_pooled
    mapped = inv[np.asarray(edge_index)]
    keep = mapped[0] != mapped[1]
    pairs = np.unique(mapped[:, keep].T, axis=0)
    return pairs.T.astype(np.int32), num_pooled

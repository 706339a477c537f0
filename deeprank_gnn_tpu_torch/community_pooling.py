"""Community detection and pooling on torch tensors (on-line clustering).

The port's counterpart of ``deeprank_gnn_tpu/community_pooling.py``, with
its names and signatures: `community_detection`,
`community_detection_per_batch`, `community_pooling`,
`get_preloaded_cluster`, `graclus_cluster` (the torch-cluster kernel the
reference declares at `setup.py:45` and uses in its README custom-net
example) and `plot_graph`. They take torch tensors (or arrays) and return
torch tensors on the input's device, as the reference's do.

- The clusterings (MCL, Louvain, graclus' greedy matching) are
  order-dependent host loops, as in the JAX package: their ids are
  bitwise its ids.
- `community_pooling` runs on the tensors' device: the feature max-pool
  and position mean-pool are the port's segment reductions, and the
  pooled edges are :func:`ops.coalesce.coalesce_edges`, whose attribute
  sums are K1 on a CUDA tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from deeprank_gnn_tpu_torch.featurize.cluster import (
    community_detection as _community_detection,
)
from deeprank_gnn_tpu_torch.ops.coalesce import coalesce_edges
from deeprank_gnn_tpu_torch.ops.pooling import community_pooling_pos
from deeprank_gnn_tpu_torch.ops.segment import segment_max


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _device(a) -> torch.device:
    return a.device if isinstance(a, torch.Tensor) else torch.device("cpu")


def community_detection(
    edge_index, num_nodes: int, edge_attr=None, method: str = "mcl"
) -> torch.Tensor:
    """Cluster one graph's nodes (reference `community_pooling.py:95-158`).

    edge_attr is accepted for signature parity; like the reference's
    MCL path, weights do not change the default clustering.
    """
    labels = _community_detection(_np(edge_index), num_nodes, method=method)
    return torch.as_tensor(labels.astype(np.int64), device=_device(edge_index))


def community_detection_per_batch(
    edge_index,
    batch,
    num_nodes: int,
    edge_attr=None,
    method: str = "mcl",
) -> torch.Tensor:
    """Cluster each graph of a batch independently with globally unique
    cluster ids (reference `community_pooling.py:33-92`)."""
    dev = _device(edge_index)
    edge_index = _np(edge_index)
    batch = _np(batch)
    cluster = np.zeros(num_nodes, dtype=np.int64)
    ncluster = 0
    for gid in range(int(batch.max()) + 1):
        nodes = np.nonzero(batch == gid)[0]
        remap = {int(n): i for i, n in enumerate(nodes)}
        mask = np.isin(edge_index[0], nodes) & np.isin(edge_index[1], nodes)
        sub = edge_index[:, mask]
        sub = np.array(
            [[remap[int(a)] for a in sub[0]], [remap[int(b)] for b in sub[1]]],
            dtype=np.int64,
        ).reshape(2, -1)
        c = _community_detection(sub, len(nodes), method=method)
        cluster[nodes] = c + ncluster
        ncluster = int(cluster.max()) + 1
    return torch.as_tensor(cluster, device=dev)


def get_preloaded_cluster(cluster, batch) -> torch.Tensor:
    """Offset per-graph cluster ids to be batch-global (reference
    `community_pooling.py:25-30` — without the in-place mutation)."""
    dev = _device(cluster)
    cluster = np.array(_np(cluster), copy=True)
    batch = _np(batch)
    nbatch = int(batch.max()) + 1
    for ib in range(1, nbatch):
        cluster[batch == ib] += cluster[batch == ib - 1].max() + 1
    return torch.as_tensor(cluster, device=dev)


@dataclass
class PooledGraph:
    """Result of `community_pooling` (tensors on the input's device)."""

    x: torch.Tensor
    edge_index: torch.Tensor
    edge_attr: Optional[torch.Tensor]
    pos: Optional[torch.Tensor] = None
    batch: Optional[torch.Tensor] = None
    internal_edge_index: Optional[torch.Tensor] = None
    internal_edge_attr: Optional[torch.Tensor] = None
    cluster0: Optional[torch.Tensor] = None
    cluster1: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]


def _pool_edges(inv: torch.Tensor, k: int, edge_index, edge_attr):
    """Edges mapped through ``inv``, self-loops dropped, duplicates merged
    with their attributes summed, in (src, dst) order: ``coalesce_edges``
    cut to its unique edges."""
    edge_index = torch.as_tensor(edge_index, device=inv.device)
    e = edge_index.shape[1]
    mapped = inv[edge_index.to(torch.int64)].to(torch.int32)
    if edge_attr is None:
        attr = torch.zeros((e, 0), dtype=torch.float32, device=inv.device)
    else:
        attr = torch.as_tensor(edge_attr, device=inv.device)
    mask = torch.ones(e, dtype=torch.bool, device=inv.device)
    index, pooled, valid = coalesce_edges(mapped, attr, mask, k)
    m = int(valid.sum())
    # as in the JAX package, a graph left with no edge gets a [0, F]
    # attribute array even where it has no attributes
    keep_attr = edge_attr is not None or m == 0
    return index[:, :m].to(torch.int64), pooled[:m] if keep_attr else None


def community_pooling(cluster, data) -> PooledGraph:
    """Pool a (batched) graph by a cluster assignment (reference
    `community_pooling.py:161-251`): max-pooled features (an infinite
    pooled value becomes 0, as the JAX package's ``-inf``-started buffer
    leaves it), mean-pooled positions, coalesced edges (duplicates
    attr-summed, self-loops dropped), pooled batch vector; cluster0/1 pass
    through."""
    x = torch.as_tensor(data.x)
    cluster = torch.as_tensor(cluster, device=x.device)
    _, inv = torch.unique(cluster, sorted=True, return_inverse=True)
    k = int(inv.max()) + 1 if inv.numel() else 0
    pooled_x = segment_max(x, inv, k)
    pooled_x = torch.where(torch.isinf(pooled_x), torch.zeros_like(pooled_x), pooled_x)

    edge_index, edge_attr = _pool_edges(
        inv, k, data.edge_index, getattr(data, "edge_attr", None)
    )
    iei = getattr(data, "internal_edge_index", None)
    if iei is not None:
        internal_edge_index, internal_edge_attr = _pool_edges(
            inv, k, iei, getattr(data, "internal_edge_attr", None)
        )
    else:
        internal_edge_index = internal_edge_attr = None

    pos = getattr(data, "pos", None)
    pooled_pos = None
    if pos is not None:
        pooled_pos = community_pooling_pos(torch.as_tensor(pos, device=x.device), inv, k)

    batch = getattr(data, "batch", None)
    pooled_batch = None
    if batch is not None:
        batch = torch.as_tensor(batch, device=x.device)
        pooled_batch = batch.new_zeros(k)
        pooled_batch[inv] = batch  # any member works: clusters don't span graphs

    return PooledGraph(
        x=pooled_x,
        edge_index=edge_index,
        edge_attr=edge_attr,
        pos=pooled_pos,
        batch=pooled_batch,
        internal_edge_index=internal_edge_index,
        internal_edge_attr=internal_edge_attr,
        cluster0=getattr(data, "cluster0", None),
        cluster1=getattr(data, "cluster1", None),
    )


def graclus_cluster(
    edge_index, num_nodes: int, edge_weight=None, seed: int = 0
) -> torch.Tensor:
    """Greedy heavy-edge matching coarsening (the torch-cluster
    `graclus` C++/CUDA kernel's semantics, declared by the reference at
    `setup.py:45` and used in its README custom-net example).

    Each node is matched with its heaviest unmatched neighbor;
    unmatched nodes become singletons. Deterministic node order: a host
    loop, as in the JAX package.
    """
    dev = _device(edge_index)
    edge_index = _np(edge_index)
    cluster = np.full(num_nodes, -1, dtype=np.int64)
    if edge_index.size:
        w = (
            np.ones(edge_index.shape[1])
            if edge_weight is None
            else _np(edge_weight).reshape(-1)
        )
        # adjacency lists sorted by descending weight
        order = np.argsort(-w, kind="stable")
        nbrs: Dict[int, list] = {}
        for e in order:
            a, b = int(edge_index[0, e]), int(edge_index[1, e])
            if a != b:
                nbrs.setdefault(a, []).append(b)
                nbrs.setdefault(b, []).append(a)
        nxt = 0
        for v in range(num_nodes):
            if cluster[v] >= 0:
                continue
            match = -1
            for u in nbrs.get(v, []):
                if cluster[u] < 0 and u != v:
                    match = u
                    break
            cluster[v] = nxt
            if match >= 0:
                cluster[match] = nxt
            nxt += 1
    unmatched = cluster < 0
    cluster[unmatched] = np.arange(int(cluster.max()) + 1,
                                   int(cluster.max()) + 1 + unmatched.sum())
    return torch.as_tensor(cluster, device=dev)


def plot_graph(graph, cluster, out: Optional[str] = None) -> None:
    """Spring-layout plot colored by cluster (reference
    `community_pooling.py:17-22`), saved to a file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx

    pos = nx.spring_layout(graph, iterations=200)
    nx.draw(graph, pos, node_color=list(_np(cluster)))
    plt.savefig(out or "graph_clusters.png")
    plt.close()

"""Static-shape edge coalescing (the torch-sparse `coalesce` replacement).

The port's counterpart of ``deeprank_gnn_tpu/ops/coalesce.py``. The
reference pools edges after each community-pooling stage through PyG's
`pool_edge` (reference `community_pooling.py:204-210`), which maps edge
endpoints through the cluster assignment, drops self-loops, and merges
duplicate edges by *summing* their attributes. This version keeps the
padded edge capacity E and compacts unique edges to the front:

    stable sort of edges by key (src * N + dst)  ->  flag segment
    boundaries  ->  prefix-sum boundary flags into output slots
    ->  sum attributes into slots.

Padding edges and self-loops get the maximal key, so they sort to the
back and fall into the dump slot E. Output edges come out sorted by
(src, dst) — the canonical order torch-sparse `coalesce` produces.

After the sort the slot ids are nondecreasing with the dump slot last,
so the attribute sums are K1 (``sorted_segment_sum``) over CSR pointers
``searchsorted(slot, 0..E)``: the kernel on a CUDA tensor, its plain
version on a CPU tensor. The unique keys do not go through K1, which sums
fp32 (a key past 2^24 would lose bits): each slot's boundary lane is its
one writer, so the keys are compacted by index and stay exact int32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deeprank_gnn_tpu_torch.ops.kernels.segment import sorted_segment_sum

_INT32_MAX = torch.iinfo(torch.int32).max


def coalesce_slots(
    edge_index: torch.Tensor,
    edge_mask: torch.Tensor,
    num_nodes: int,
    remove_self_loops: bool = True,
):
    """The sort behind :func:`coalesce_edges`: ``(order, sorted keys,
    boundary lanes, slots, row_ptr)``. ``order`` sorts the edges by key
    (stably), ``slot[i]`` is sorted lane ``i``'s output slot (E for padding
    and dropped self-loops) and ``row_ptr [E+1]`` (int32) its CSR pointers,
    the K1 input that sums the sorted attributes into slots."""
    if num_nodes * num_nodes >= _INT32_MAX:
        raise ValueError(
            f"num_nodes={num_nodes} too large for int32 coalesce keys"
        )
    src, dst = edge_index[0].to(torch.int32), edge_index[1].to(torch.int32)
    e = src.shape[0]
    valid = edge_mask
    if remove_self_loops:
        valid = valid & (src != dst)

    key = torch.where(valid, src * num_nodes + dst, _INT32_MAX)
    skey, order = torch.sort(key, stable=True)
    svalid = valid[order]

    prev = torch.cat([skey.new_full((1,), -1), skey[:-1]])
    boundary = (skey != prev) & svalid
    slot = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(svalid, slot, e)  # the dump slot for padding
    row_ptr = torch.searchsorted(
        slot, torch.arange(e + 1, dtype=torch.int32, device=slot.device)
    ).to(torch.int32)
    return order, skey, boundary, slot, row_ptr


def coalesce_edges(
    edge_index: torch.Tensor,
    edge_attr: torch.Tensor,
    edge_mask: torch.Tensor,
    num_nodes: int,
    *,
    remove_self_loops: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Coalesce a padded edge list.

    Args:
        edge_index: [2, E] int32 endpoints (already mapped through any
            cluster assignment by the caller).
        edge_attr: [E, F] float32 attributes; duplicate edges are summed.
        edge_mask: [E] bool validity of each padded lane.
        num_nodes: bound on node ids (keys use base num_nodes).
        remove_self_loops: drop (i, i) edges, as PyG `pool_edge` does.

    Returns:
        (new_edge_index [2, E], new_edge_attr [E, F], new_mask [E]) with
        unique edges compacted to the front in (src, dst) sorted order;
        padding lanes hold ``num_nodes`` endpoints and zero attributes.
    """
    order, skey, boundary, slot, row_ptr = coalesce_slots(
        edge_index, edge_mask, num_nodes, remove_self_loops
    )
    e = slot.shape[0]
    dev = slot.device
    new_attr = sorted_segment_sum(edge_attr[order].contiguous(), row_ptr)

    # one writer per slot (its boundary lane); the rest write the dump slot
    unique_key = torch.zeros(e + 1, dtype=torch.int32, device=dev)
    unique_key[torch.where(boundary, slot, e)] = torch.where(boundary, skey, 0)
    unique_key = unique_key[:e]
    new_mask = torch.arange(e, device=dev) < boundary.sum()
    new_src = torch.where(new_mask, unique_key // num_nodes, num_nodes)
    new_dst = torch.where(new_mask, unique_key % num_nodes, num_nodes)
    return torch.stack([new_src, new_dst]).to(torch.int32), new_attr, new_mask

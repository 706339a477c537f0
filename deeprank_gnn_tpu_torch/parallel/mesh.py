"""Meshes of ranks and the graph-parallel placement of a batch.

The port's counterpart of ``deeprank_gnn_tpu/parallel/mesh.py``. A
:class:`Mesh` is a process group (``parallel/distributed.py``) seen as a
``(dp, ep)`` grid, or as the 1-D ``("ep",)`` grid of the halo layout
(:func:`make_halo_mesh`); one process is one rank is one shard, where JAX
has one device of a ``jax.sharding.Mesh``.

Placement is graph-parallel over all ``dp * ep`` ranks, in both layouts:
each rank takes a contiguous range of the global batch's graphs and runs
the single-device model on it (``parallel/step.py``). A sparse rank
collates only its range (:func:`shard_batch`, the loader's
``graph_share``); a dense batch is cut along its graph axis. On the dense layout
that is what JAX's ``dense_batch_shardings`` asks of XLA. On the sparse
layout JAX shards nodes over ``dp`` and edges over ``ep`` and lets XLA's
partitioner derive the collectives; in torch no partitioner derives
anything, so the sparse mesh is graph-parallel too, and the port's
edge-parallel layout is ``layout="halo"`` (``parallel/halo.py``), the
explicit form of what ``ep`` asks of XLA. Both give the single-device
numbers. JAX drops the batch's member tables on a mesh; a rank's range
here is a whole batch of whole graphs, so it keeps them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from deeprank_gnn_tpu_torch.data.batch import RankBatch, collate_range
from deeprank_gnn_tpu_torch.data.dense_batch import DenseGraphBatch
from deeprank_gnn_tpu_torch.parallel.distributed import (
    is_initialized,
    process_count,
    process_index,
    rank_device,
)


@dataclass(frozen=True)
class Mesh:
    """A process group as a grid of ranks: ``shape`` over ``axis_names``
    (``("dp", "ep")`` or ``("ep",)``), this process's ``rank`` in the group
    and its ``device``. ``group`` is None for the one-rank mesh of a process
    without a process group, whose collectives are the identity."""

    group: Any
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's index along each axis (row-major, as JAX lays a
        device array out)."""
        out, r = [], self.rank
        for s in reversed(self.shape):
            out.append(r % s)
            r //= s
        return tuple(reversed(out))


def mesh_shape(n: int, dp: Optional[int] = None, ep: Optional[int] = None) -> Tuple[int, int]:
    """``(dp, ep)`` for ``n`` ranks with the JAX package's defaults and
    errors: ``ep = 2`` when ``n`` is even and above 1, else 1."""
    if dp is None and ep is None:
        ep = 2 if n % 2 == 0 and n > 1 else 1
        dp = n // ep
    elif dp is None:
        if n % ep:
            raise ValueError(f"ep={ep} does not divide {n} devices")
        dp = n // ep
    elif ep is None:
        if n % dp:
            raise ValueError(f"dp={dp} does not divide {n} devices")
        ep = n // dp
    if dp * ep != n:
        raise ValueError(f"mesh {dp}x{ep} != {n} devices")
    return dp, ep


def _group(ranks: Sequence[int]):
    """The process group over ``ranks`` (the world's when they are all of
    it); None for rank 0 alone without a process group."""
    if not is_initialized():
        if list(ranks) != [0]:
            raise ValueError(
                f"a mesh over ranks {list(ranks)} needs a process group "
                "(deeprank_gnn_tpu_torch.parallel.distributed.initialize)"
            )
        return None
    if process_index() not in ranks:
        raise ValueError(f"this process (rank {process_index()}) is not in the mesh "
                         f"ranks {list(ranks)}")
    if sorted(ranks) == list(range(process_count())):
        return dist.group.WORLD
    return dist.new_group(sorted(ranks))


def _mesh(ranks, shape, axis_names, device) -> Mesh:
    group = _group(ranks)
    rank = 0 if group is None else dist.get_rank(group)
    return Mesh(group, shape, axis_names, rank, rank_device(device))


def make_mesh(
    ranks: Optional[Sequence[int]] = None,
    dp: Optional[int] = None,
    ep: Optional[int] = None,
    *,
    device=None,
) -> Mesh:
    """A ``(dp, ep)`` mesh over ``ranks`` (default: every rank of the
    process group, or this process alone without one). Defaults as in
    JAX: ``ep = 2`` when the rank count is even and above 1, else 1.
    ``device``: this rank's device (``parallel.distributed.rank_device``).
    A mesh over a subset of the world is made with ``new_group``, which
    every rank of the world must call."""
    ranks = sorted(ranks) if ranks is not None else list(range(process_count()))
    dp, ep = mesh_shape(len(ranks), dp, ep)
    return _mesh(ranks, (dp, ep), ("dp", "ep"), device)


def make_halo_mesh(ranks: Optional[Sequence[int]] = None, *, device=None) -> Mesh:
    """The 1-D ``("ep",)`` mesh of the halo layout over ``ranks`` (default:
    every rank), JAX ``parallel/halo.py:62-66``."""
    ranks = sorted(ranks) if ranks is not None else list(range(process_count()))
    return _mesh(ranks, (len(ranks),), ("ep",), device)


def graph_range(num_graphs: int, mesh: Mesh) -> slice:
    """This rank's contiguous range of ``num_graphs`` graphs: rank ``r``
    of ``D`` takes ``num_graphs // D`` of them, one more for the first
    ``num_graphs % D`` ranks."""
    d, r = mesh.size, mesh.rank
    q, rem = divmod(num_graphs, d)
    lo = r * q + min(r, rem)
    return slice(lo, lo + q + (1 if r < rem else 0))


def _check_dense_divisible(g: int, mesh: Mesh) -> None:
    if g % mesh.size:
        raise ValueError(
            f"dense mesh layout needs batch graphs ({g}) divisible by "
            f"device count ({mesh.size}); pick batch_size accordingly"
        )


def shard_batch(graphs, mesh: Mesh, g_pad: Optional[int] = None, plans=None,
                **collate_kw) -> RankBatch:
    """This rank's :func:`graph_range` of the sparse global batch
    ``graphs`` (``g_pad`` slots, default one per graph), collated as a
    batch of its own with the global targets (``data.batch.collate_range``;
    ``collate_kw`` go to ``collate``). The engine's loader does the same
    with ``graph_share``."""
    g = g_pad or len(graphs)
    return collate_range(graphs, graph_range(g, mesh), g, plans, **collate_kw)


def shard_dense_batch(batch: DenseGraphBatch, mesh: Mesh) -> RankBatch:
    """This rank's slice of the graph axis of a dense batch (every field
    is ``[G, ...]``); the batch's graph count must divide over the ranks,
    as in JAX."""
    g = batch.num_graphs
    _check_dense_divisible(g, mesh)
    sl = graph_range(g, mesh)
    return RankBatch(batch.graph_slice(sl.start, sl.stop), sl.start, sl.stop, g)


def dense_local_slice(global_g: int, mesh: Mesh) -> slice:
    """This rank's contiguous slice of the global graph axis: the
    multi-process ingest contract (each rank loads only these graphs of
    every global batch, ``GraphLoader(host_batch_slice=...)``)."""
    _check_dense_divisible(global_g, mesh)
    return graph_range(global_g, mesh)


def shard_dense_batch_from_local(local_batch: DenseGraphBatch, mesh: Mesh,
                                 global_g: int) -> RankBatch:
    """A dense batch that holds only this rank's :func:`dense_local_slice`
    of a global batch of ``global_g`` graphs, placed as that slice."""
    sl = dense_local_slice(global_g, mesh)
    if local_batch.num_graphs != sl.stop - sl.start:
        raise ValueError(f"local batch has {local_batch.num_graphs} graphs, this rank's slice "
                         f"{sl.start}:{sl.stop} has {sl.stop - sl.start}")
    return RankBatch(local_batch, sl.start, sl.stop, global_g)

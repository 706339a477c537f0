"""Segment reductions with torch-scatter-compatible semantics.

The port's counterpart of ``deeprank_gnn_tpu/ops/segment.py``. The
reference's models aggregate per-edge messages into per-node (or
per-cluster, or per-graph) buffers with torch_scatter's `scatter_sum` /
`scatter_mean` / `scatter_max` into zero-initialized output buffers
(reference `ginet.py:69-71`, `community_pooling.py:201,214`). The contract:

- out-of-range / padding indices contribute nothing. Callers route
  padding lanes to index ``num_segments``; each such lane reduces into a
  row of its own past the real ones, sliced off (``ops/lanes.py``: no
  accumulating op sees a run of padding lanes).
- ``segment_mean`` divides by ``max(count, 1)`` — empty segments give 0.
- ``segment_max`` returns 0 for empty segments, not -inf.

``segment_sum(..., row_ptr=...)`` runs as the sorted segment sum kernel
(K1, :mod:`deeprank_gnn_tpu_torch.ops.kernels.segment`), with its gradient
``grad[rows]``, and so does ``segment_mean(..., row_ptr=...)``'s sum.
``segment_softmax(..., row_ptr=...)`` takes its denominator from the
sorted scatter-gather kernel (K2,
:mod:`deeprank_gnn_tpu_torch.ops.kernels.scatter_gather`), the one place
where the port runs a kernel where the JAX package left the composition
(a segment sum, then its gather) to XLA. Everything else is plain torch
(``index_add_``, ``index_select``, ``scatter_reduce_``), as XLA compiled it
for the JAX package; :func:`gather`'s backward, like every accumulation
here, sums no run of padding lanes.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeprank_gnn_tpu_torch.ops.kernels.scatter_gather import sorted_scatter_gather
from deeprank_gnn_tpu_torch.ops.lanes import gather_rows, index_add_rows, lane_rows
from deeprank_gnn_tpu_torch.ops.kernels.segment import (
    rows_from_row_ptr,
    sorted_segment_sum,
    sorted_segment_sum_backward,
)


class SortedSegmentSum(torch.autograd.Function):
    """K1 with its gradient. The forward is the kernel (the plain version
    on a CPU tensor); the backward gathers the output gradient at each
    edge's row, 0 at padding. When a gradient is needed, the edges' rows
    are taken from ``row_ptr`` once, in the forward, and kept for the
    backward."""

    @staticmethod
    def forward(ctx, data, row_ptr):
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(rows_from_row_ptr(row_ptr, data.shape[0]))
        return sorted_segment_sum(data, row_ptr)

    @staticmethod
    def backward(ctx, grad):
        (rows,) = ctx.saved_tensors
        return sorted_segment_sum_backward(grad, rows), None


class SortedScatterGather(torch.autograd.Function):
    """K2 with its gradient, the JAX package's ``_sg_bwd``
    (``ops/pallas/segment.py:354-364``): ``d2 = out[rows]``, so
    ``dout = g_out + segment_sum(g_d2)`` and ``ddata = dout[rows]``, 0 at
    padding. An output the caller does not use gets no cotangent (None),
    which counts as zero without a tensor being made for it. With only the
    ``d2`` cotangent (the softmax path) the gradient is
    ``segment_sum(g_d2)[rows]``, 0 at padding: exactly K2's ``d2`` on
    ``g_d2``, so it is one K2 launch. With both, the sum is one K1 launch and
    the gather plain torch, as in K1's backward."""

    @staticmethod
    def forward(ctx, data, row_ptr):
        ctx.set_materialize_grads(False)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(row_ptr)
            ctx.num_edges = data.shape[0]
        return sorted_scatter_gather(data, row_ptr)

    @staticmethod
    def backward(ctx, g_out, g_d2):
        (row_ptr,) = ctx.saved_tensors
        if g_out is None:
            if g_d2 is None:
                return None, None
            return sorted_scatter_gather(g_d2.contiguous(), row_ptr)[1], None
        dout = g_out
        if g_d2 is not None:
            dout = dout + sorted_segment_sum(g_d2.contiguous(), row_ptr)
        rows = rows_from_row_ptr(row_ptr, ctx.num_edges)
        return sorted_segment_sum_backward(dout, rows), None


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    row_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum of ``data`` rows per segment. [E, F] x [E] -> [S, F].

    Matches torch_scatter ``scatter_sum(src, index, dim=0, out=zeros)``
    (reference `ginet.py:69-71`). ``row_ptr [S+1]`` gives the CSR pointers
    of nondecreasing ids with padding at the end (``GraphBatch.edge_rowptr``
    / ``pe_rowptr``); the sum then runs as the sorted segment sum kernel,
    which reads only ``row_ptr``; its gradient is ``grad[rows]``.
    """
    if row_ptr is not None:
        if row_ptr.shape != (num_segments + 1,):
            raise ValueError(
                f"row_ptr has shape {tuple(row_ptr.shape)}, want "
                f"({num_segments + 1},)"
            )
        return SortedSegmentSum.apply(data, row_ptr)
    return index_add_rows(data, segment_ids, num_segments)


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  row_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Number of entries per segment (padding excluded), float32. [E] ->
    [S]. With CSR pointers ``row_ptr`` of sorted ids the counts are the
    runs' lengths, and nothing is accumulated."""
    if row_ptr is not None:
        return (row_ptr[1:] - row_ptr[:-1]).to(torch.float32)
    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32, device=segment_ids.device)
    return index_add_rows(ones, segment_ids, num_segments)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    nan_empty: bool = False,
    row_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean of ``data`` rows per segment.

    ``nan_empty=False`` (default) clamps the divisor to 1, so empty
    segments give 0 — torch_scatter ``scatter_mean(..., out=zeros)``
    semantics. ``nan_empty=True`` reproduces ``torch.mean`` of an empty
    selection (NaN), the behavior of the reference FoutLayer's per-node
    loop (reference `foutnet.py:69-73`). With CSR pointers ``row_ptr`` of
    sorted ids (the JAX package's ``sorted_ids``) the sum runs on K1 and
    the counts are the runs' lengths. Without them the sums and the counts
    are one accumulation: a column of ones beside the rows, each column
    summed in lane order as on its own.
    """
    if row_ptr is None:
        ones = torch.ones((data.shape[0], 1), dtype=data.dtype, device=data.device)
        both = index_add_rows(torch.cat([data.reshape(data.shape[0], -1), ones], dim=1),
                              segment_ids, num_segments)
        total = both[:, :-1].reshape((num_segments,) + tuple(data.shape[1:]))
        count = both[:, -1]
    else:
        total = segment_sum(data, segment_ids, num_segments, row_ptr=row_ptr)
        count = segment_count(segment_ids, num_segments, row_ptr).to(data.dtype)
    count = count.reshape((num_segments,) + (1,) * (data.dim() - 1))
    if nan_empty:
        return total / count
    return total / torch.clamp(count, min=1.0)


def segment_reduce_raw(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                       reduce: str, identity: float) -> torch.Tensor:
    """``scatter_reduce`` (``"amax"`` or ``"amin"``) into ``num_segments``
    rows started from ``identity``, which an empty segment keeps; each
    padding lane reduces into a row of its own, sliced off."""
    ids = lane_rows(segment_ids, num_segments)
    shape = (num_segments + data.shape[0],) + tuple(data.shape[1:])
    idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full(shape, identity)
    out.scatter_reduce_(0, idx, data, reduce=reduce, include_self=True)
    return out[:num_segments]


def _segment_reduce_with_fill(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, reduce: str,
    identity: float, row_ptr: Optional[torch.Tensor],
) -> torch.Tensor:
    """:func:`segment_reduce_raw`, with 0 for an empty segment."""
    out = segment_reduce_raw(data, segment_ids, num_segments, reduce, identity)
    count = segment_count(segment_ids, num_segments, row_ptr)
    count = count.reshape((num_segments,) + (1,) * (data.dim() - 1))
    return torch.where(count > 0, out, torch.zeros((), dtype=data.dtype, device=data.device))


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
    *, row_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment max; empty segments give 0 (the reference's
    zero-initialized scatter_max buffer, `community_pooling.py:201`).
    ``row_ptr``, CSR pointers of sorted ids, gives the counts that find the
    empty segments."""
    return _segment_reduce_with_fill(data, segment_ids, num_segments, "amax", float("-inf"),
                                     row_ptr)


def segment_min(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
    *, row_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment min; empty segments give 0."""
    return _segment_reduce_with_fill(data, segment_ids, num_segments, "amin", float("inf"),
                                     row_ptr)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    row_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Numerically stable softmax of ``logits [E]`` over entries sharing a
    segment id (the JAX package's ``segment_softmax``,
    ``ops/segment.py:148-170``): the attention weights of
    ``GINet(attention=True)``. Padding entries get a denominator of 1.

    The segment max and the shift are plain torch. With CSR pointers
    ``row_ptr`` of sorted ids the denominator, each segment's sum of
    ``exp`` gathered back onto its entries, is one K2 launch; K2 gathers 0
    at padding, where 1 is put back before the division (``exp / 1e-16``
    would overflow there). Without them it is the dump-row sum, then a
    gather.
    """
    seg_max = segment_max(logits, segment_ids, num_segments, row_ptr=row_ptr)
    shifted = logits - gather(seg_max, segment_ids, fill=0.0)
    exp = torch.exp(shifted)
    if row_ptr is not None:
        _, denom = SortedScatterGather.apply(exp[:, None], row_ptr)
        valid = (segment_ids >= 0) & (segment_ids < num_segments)
        denom = torch.where(valid, denom[:, 0], torch.ones((), dtype=exp.dtype, device=exp.device))
    else:
        denom = gather(segment_sum(exp, segment_ids, num_segments), segment_ids, fill=1.0)
    return exp / torch.clamp(denom, min=1e-16)


def gather(data: torch.Tensor, index: torch.Tensor, fill: Optional[float] = None) -> torch.Tensor:
    """Row gather ``data[index]`` with padding-safe clamping: padding
    indices (outside ``[0, data.shape[0])``) read a clamped row, or
    ``fill`` where that is given; callers mask the result. The backward
    accumulates no run of padding lanes (``ops/lanes.py``)."""
    valid = (index >= 0) & (index < data.shape[0])
    out = gather_rows(data, index, valid)
    if fill is None:
        return out
    mask = valid.reshape((-1,) + (1,) * (data.dim() - 1))
    return torch.where(mask, out, torch.full((), fill, dtype=out.dtype, device=out.device))

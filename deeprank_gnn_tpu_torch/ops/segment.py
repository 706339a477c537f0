"""Segment reductions with torch-scatter-compatible semantics.

The port's counterpart of ``deeprank_gnn_tpu/ops/segment.py``. The
reference's models aggregate per-edge messages into per-node (or
per-cluster, or per-graph) buffers with torch_scatter's `scatter_sum` /
`scatter_mean` / `scatter_max` into zero-initialized output buffers
(reference `ginet.py:69-71`, `community_pooling.py:201,214`). The contract:

- out-of-range / padding indices contribute nothing. Callers route
  padding lanes to index ``num_segments``; we reduce into
  ``num_segments + 1`` rows and slice the dump row off.
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
for the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeprank_gnn_tpu_torch.ops.kernels.scatter_gather import sorted_scatter_gather
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


def _dump_row(index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Indices outside [0, num_segments) land in the dump row
    ``num_segments``."""
    return torch.where((index >= 0) & (index < num_segments), index, num_segments)


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
    ids = _dump_row(segment_ids, num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, ids, data)
    return out[:num_segments]


def segment_count(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Number of entries per segment (padding excluded). [E] -> [S]."""
    ids = _dump_row(segment_ids, num_segments)
    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32, device=ids.device)
    out = ones.new_zeros(num_segments + 1)
    out.index_add_(0, ids, ones)
    return out[:num_segments]


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
    the counts are the runs' lengths.
    """
    total = segment_sum(data, segment_ids, num_segments, row_ptr=row_ptr)
    if row_ptr is None:
        count = segment_count(segment_ids, num_segments)
    else:
        count = (row_ptr[1:] - row_ptr[:-1]).to(data.dtype)
    count = count.reshape((num_segments,) + (1,) * (data.dim() - 1))
    if nan_empty:
        return total / count
    return total / torch.clamp(count, min=1.0)


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment max; empty segments give 0 (the reference's
    zero-initialized scatter_max buffer, `community_pooling.py:201`)."""
    ids = _dump_row(segment_ids, num_segments).to(torch.int64)
    shape = (num_segments + 1,) + tuple(data.shape[1:])
    idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full(shape, float("-inf"))
    out.scatter_reduce_(0, idx, data, reduce="amax", include_self=True)
    out = out[:num_segments]
    count = segment_count(segment_ids, num_segments)
    count = count.reshape((num_segments,) + (1,) * (data.dim() - 1))
    return torch.where(count > 0, out, torch.zeros((), dtype=data.dtype, device=data.device))


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
    seg_max = segment_max(logits, segment_ids, num_segments)
    ids = _dump_row(segment_ids, num_segments)
    shifted = logits - torch.cat([seg_max, seg_max.new_zeros(1)]).index_select(0, ids)
    exp = torch.exp(shifted)
    if row_ptr is not None:
        _, denom = SortedScatterGather.apply(exp[:, None], row_ptr)
        denom = torch.where(ids < num_segments, denom[:, 0], torch.ones((), dtype=exp.dtype, device=exp.device))
    else:
        denom = segment_sum(exp, segment_ids, num_segments)
        denom = torch.cat([denom, denom.new_ones(1)]).index_select(0, ids)
    return exp / torch.clamp(denom, min=1e-16)


def gather(data: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Row gather ``data[index]`` with padding-safe clamping: padding
    indices (== data.shape[0] or negative) read a clamped row; callers
    mask the result."""
    idx = torch.clamp(index, 0, data.shape[0] - 1)
    return data.index_select(0, idx)

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
(:mod:`deeprank_gnn_tpu_torch.ops.kernels.segment`), with its gradient
``grad[rows]``; everything else is plain torch (``index_add_``,
``index_select``, ``scatter_reduce_``), as XLA compiled it for the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import torch

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
) -> torch.Tensor:
    """Mean of ``data`` rows per segment.

    ``nan_empty=False`` (default) clamps the divisor to 1, so empty
    segments give 0 — torch_scatter ``scatter_mean(..., out=zeros)``
    semantics. ``nan_empty=True`` reproduces ``torch.mean`` of an empty
    selection (NaN), the behavior of the reference FoutLayer's per-node
    loop (reference `foutnet.py:69-73`).
    """
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_count(segment_ids, num_segments)
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


def gather(data: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Row gather ``data[index]`` with padding-safe clamping: padding
    indices (== data.shape[0] or negative) read a clamped row; callers
    mask the result."""
    idx = torch.clamp(index, 0, data.shape[0] - 1)
    return data.index_select(0, idx)

"""K3: per-graph GIN aggregation of the dense layout (CUDA kernel, plain
version, autograd Function).

Replaces ``deeprank_gnn_tpu/ops/pallas/__init__.py:fused_gin_conv``. For
``xw [G, S, F]`` and ``row``, ``col [G, E]``::

    out[g, n] = sum over edges e of graph g with row[g, e] == n of xw[g, col[g, e]]

An index outside ``[0, S)`` (the dense collate's sentinel ``S``) drops its
edge, and rows need not be sorted. Each row sums its edges in ascending edge
order, so the kernel's result is bitwise :func:`fused_gin_conv_plain`'s on
the CPU. The gradient with respect to ``xw`` is the same op with ``row`` and
``col`` swapped, as in the JAX package's VJP, so training launches the
kernel once forward and once backward per call.

The kernel (``ops/csrc/fused_gin_conv.cu``) is bound by bytes: at the
paper's width conv1 must move ~7.1 MB per call (the ``xw`` rows that valid
edges read, ``out`` whole, the indices), 2.12 us at 3.35 TB/s. A graph's
output rows are split over blocks of at most 128 rows. Each block copies the
graph's ``[S, F]`` slab into shared memory with one bulk (TMA) copy when it
fits, while it sorts its rows' edges into a CSR in shared memory (counts and
ranks from ``__match_any_sync``, a scan, stable placement, no atomics); then
a group of lanes per row sums the row's run in edge order and writes it
once. It is not a tensor-core product: that would do S / degree times the
adds and need a three-way bf16 split to stay fp32-exact.
"""

from __future__ import annotations

import ctypes

import torch

from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
from deeprank_gnn_tpu_torch.ops.kernels import build

NAME = "fused_gin_conv"


def fused_gin_conv_plain(xw: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``index_select`` of the graph-offset
    ``col`` (an edge with an index out of range reads a zero row), then
    ``index_add_`` into a buffer with a dump row over the graph-offset
    ``row``."""
    g, s, f = xw.shape
    valid = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    goff = torch.arange(g, dtype=row.dtype, device=row.device)[:, None] * s
    src = torch.where(valid, col + goff, g * s).reshape(-1)
    dst = torch.where(valid, row + goff, g * s).reshape(-1)
    rows = torch.cat([xw.reshape(g * s, f), xw.new_zeros((1, f))])
    out = xw.new_zeros((g * s + 1, f))
    out.index_add_(0, dst, rows.index_select(0, src))
    return out[: g * s].reshape(g, s, f)


def _check(xw: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> None:
    if xw.dim() != 3 or row.dim() != 2 or row.shape != col.shape or row.shape[0] != xw.shape[0]:
        raise ValueError(
            f"want xw [G, S, F] and row, col [G, E]; got {tuple(xw.shape)}, "
            f"{tuple(row.shape)} and {tuple(col.shape)}"
        )
    if not (xw.device == row.device == col.device):
        raise ValueError(f"xw on {xw.device}, row on {row.device}, col on {col.device}")


def fused_gin_conv_forward(xw: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """One application of the op, without autograd. On a CPU tensor this is
    :func:`fused_gin_conv_plain`. On a CUDA tensor it launches the kernel
    (building it at first use) or raises: ``xw`` must be contiguous float32,
    ``row`` and ``col`` contiguous int32. A tensor on any other device
    raises too, after the same checks."""
    _check(xw, row, col)
    if xw.device.type == "cpu":
        return fused_gin_conv_plain(xw, row, col)
    if xw.dtype != torch.float32 or row.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError(
            f"want float32 xw and int32 row and col; got {xw.dtype}, {row.dtype} and {col.dtype}"
        )
    if not (xw.is_contiguous() and row.is_contiguous() and col.is_contiguous()):
        raise ValueError("xw, row and col must be contiguous")
    g, s, f = xw.shape
    e = row.shape[1]
    if max(g, s, f, e) >= 2**31:
        raise ValueError("sizes must fit in int32")
    if xw.device.type != "cuda":
        raise ValueError(f"fused_gin_conv runs on cpu or cuda, not {xw.device}")
    if e == 0:  # no edges: every output row sums nothing
        return torch.zeros_like(xw)
    out = torch.empty_like(xw)
    if out.numel() == 0:
        return out
    lib = build.load(NAME)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        err = lib.fused_gin_conv_f32(
            xw.data_ptr(), row.data_ptr(), col.data_ptr(), out.data_ptr(), g, s, f, e, stream
        )
    if err != 0:
        raise RuntimeError(f"fused_gin_conv launch failed: CUDA error {err}")
    LAUNCHES[NAME] += 1
    return out


def launch_plan(device, s: int, f: int, e: int) -> dict:
    """The launch the kernel makes on ``device`` for ``S``, ``F`` and ``E``
    (all > 0): ``slab`` (whether a graph's ``[S, F]`` slab is staged in
    shared memory, else ``xw`` is read from device memory), ``rows_per_block``
    and ``blocks_per_graph`` (the split of a graph's output rows),
    ``smem_bytes`` per block and ``blocks_per_sm`` resident."""
    lib = build.load(NAME)
    plan = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = lib.fused_gin_conv_plan(s, f, e, plan)
    if err != 0:
        raise RuntimeError(f"fused_gin_conv_plan: CUDA error {err}")
    keys = ("slab", "rows_per_block", "blocks_per_graph", "smem_bytes", "blocks_per_sm")
    out = dict(zip(keys, plan))
    out["slab"] = bool(out["slab"])
    return out


class FusedGinConv(torch.autograd.Function):
    """``fused_gin_conv`` with its gradient: the same op, indices swapped
    (``d xw = fused(grad, col, row)``, the JAX package's ``_bwd``)."""

    @staticmethod
    def forward(ctx, xw, row, col):
        ctx.save_for_backward(row, col)
        return fused_gin_conv_forward(xw, row, col)

    @staticmethod
    def backward(ctx, grad):
        row, col = ctx.saved_tensors
        return fused_gin_conv_forward(grad.contiguous(), col, row), None, None


def fused_gin_conv(xw: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``segment_sum(xw[col], row)`` per graph. [G,S,F] x [G,E] -> [G,S,F],
    differentiable in ``xw``."""
    return FusedGinConv.apply(xw, row, col)

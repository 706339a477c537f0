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

``exact=False`` is the fast variant, the counterpart of the Pallas body's
non-exact branch (one bf16 MXU pass, fp32 accumulation,
``deeprank_gnn_tpu/ops/pallas/__init__.py:178-189``): the sums of ``xw``
rounded to bfloat16 (to nearest even; in the backward, of the rounded
cotangent), in fp32 in edge order, written fp32. The kernel takes the fp32
``xw``, so the path launches no cast before each call: a block stages the
graph's fp32 slab with the exact kernel's bulk copy and rounds it once, to
nearest even, into a bf16 copy in shared memory (where the slab does not fit
there, each element is rounded as it is loaded from device memory). Its sum
step is designed for bf16: each lane owns 8 columns of a row, one 16-byte
load from the copy held packed as bf16, and a block takes up to 256 rows.
Its plain version is the fp32 plain version on the rounded values, and the
kernel is bitwise that.
"""

from __future__ import annotations

import ctypes

import torch

from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
from deeprank_gnn_tpu_torch.ops.kernels import build
from deeprank_gnn_tpu_torch.ops.lanes import index_add_rows

NAME = "fused_gin_conv"
# the launch counter's name of the fast (bf16-operand) variant
NAME_BF16 = "fused_gin_conv_bf16"


def fused_gin_conv_plain(xw: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``index_select`` of the graph-offset
    ``col`` (an edge with an index out of range reads a zero row), then
    ``index_add_`` over the graph-offset ``row``, each dropped edge into a
    row of its own (``ops/lanes.py``)."""
    g, s, f = xw.shape
    valid = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    goff = torch.arange(g, dtype=row.dtype, device=row.device)[:, None] * s
    src = torch.where(valid, col + goff, g * s).reshape(-1)
    rows = torch.cat([xw.reshape(g * s, f), xw.new_zeros((1, f))])
    out = index_add_rows(rows.index_select(0, src), (row + goff).reshape(-1), g * s,
                         valid.reshape(-1))
    return out.reshape(g, s, f)


def _check(xw: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> None:
    if xw.dim() != 3 or row.dim() != 2 or row.shape != col.shape or row.shape[0] != xw.shape[0]:
        raise ValueError(
            f"want xw [G, S, F] and row, col [G, E]; got {tuple(xw.shape)}, "
            f"{tuple(row.shape)} and {tuple(col.shape)}"
        )
    if not (xw.device == row.device == col.device):
        raise ValueError(f"xw on {xw.device}, row on {row.device}, col on {col.device}")


def fused_gin_conv_forward(xw: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                           exact: bool = True) -> torch.Tensor:
    """One application of the op, without autograd, into a float32 output:
    the exact kernel, or with ``exact=False`` the fast one, which rounds
    ``xw`` to bfloat16 itself and sums in fp32. On a CPU tensor this is
    :func:`fused_gin_conv_plain` on the values the kernel would sum. On a
    CUDA tensor it launches the kernel (building it at first use) or raises:
    ``xw`` must be contiguous float32, ``row`` and ``col`` contiguous int32.
    A tensor on any other device raises too, after the same checks."""
    _check(xw, row, col)
    if xw.device.type == "cpu":
        values = xw if exact else xw.to(torch.bfloat16).float()
        return fused_gin_conv_plain(values, row, col)
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
        return torch.zeros(xw.shape, dtype=torch.float32, device=xw.device)
    out = torch.empty(xw.shape, dtype=torch.float32, device=xw.device)
    if out.numel() == 0:
        return out
    lib = build.load(NAME)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        launch = lib.fused_gin_conv_f32 if exact else lib.fused_gin_conv_fast
        err = launch(xw.data_ptr(), row.data_ptr(), col.data_ptr(), out.data_ptr(), g, s, f, e,
                     stream)
    if err != 0:
        raise RuntimeError(f"fused_gin_conv launch failed: CUDA error {err}")
    LAUNCHES[NAME if exact else NAME_BF16] += 1
    return out


def launch_plan(device, s: int, f: int, e: int, fast: bool = False) -> dict:
    """The launch the kernel (with ``fast`` the fast variant) makes on
    ``device`` for ``S``, ``F`` and ``E`` (all > 0): ``slab`` (whether a
    graph's ``[S, F]`` slab is staged in shared memory, else ``xw`` is read
    from device memory), ``rows_per_block`` and ``blocks_per_graph`` (the
    split of a graph's output rows), ``smem_bytes`` per block (the fast
    variant's with the slab's bf16 copy) and ``blocks_per_sm`` resident; the
    fast variant also ``lanes_per_row``, ``cols_per_lane`` (8: one 16-byte
    load of bf16) and ``unroll`` (source rows a lane loads before it adds
    them); both ``edge_tile`` (edges sorted in shared memory at a time) and
    ``edge_tiles`` (the tiles a block walks, carrying its rows' sums through
    ``out`` from one to the next)."""
    lib = build.load(NAME)
    keys = ["slab", "rows_per_block", "blocks_per_graph", "smem_bytes", "blocks_per_sm"]
    if fast:
        keys += ["lanes_per_row", "cols_per_lane", "unroll"]
    keys.append("edge_tile")
    plan = (ctypes.c_int * len(keys))()
    with torch.cuda.device(device):
        plan_fn = lib.fused_gin_conv_fast_plan if fast else lib.fused_gin_conv_plan
        err = plan_fn(s, f, e, plan)
    if err != 0:
        raise RuntimeError(f"fused_gin_conv plan: CUDA error {err}")
    out = dict(zip(keys, plan))
    out["slab"] = bool(out["slab"])
    out["edge_tiles"] = -(-e // out["edge_tile"])
    return out


class FusedGinConv(torch.autograd.Function):
    """``fused_gin_conv`` with its gradient: the same op, indices swapped
    (``d xw = fused(grad, col, row)``, the JAX package's ``_bwd``), on the
    bf16-rounded cotangent in the fast variant (rounded in the kernel)."""

    @staticmethod
    def forward(ctx, xw, row, col, exact):
        ctx.save_for_backward(row, col)
        ctx.exact = exact
        return fused_gin_conv_forward(xw.contiguous(), row, col, exact)

    @staticmethod
    def backward(ctx, grad):
        row, col = ctx.saved_tensors
        return fused_gin_conv_forward(grad.contiguous(), col, row, ctx.exact), None, None, None


def fused_gin_conv(xw: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                   exact: bool = True) -> torch.Tensor:
    """``segment_sum(xw[col], row)`` per graph. [G,S,F] x [G,E] -> [G,S,F],
    differentiable in ``xw``; ``exact=False`` sums the bf16-rounded ``xw``
    (the fast variant)."""
    return FusedGinConv.apply(xw, row, col, exact)

"""K1: segment sum over row-sorted edges (CUDA kernel, plain version, wrapper).

Replaces ``deeprank_gnn_tpu/ops/pallas/segment.py:sorted_segment_sum``. The
rows arrive as CSR row pointers (``GraphBatch.edge_rowptr`` / ``pe_rowptr``,
built on the host by ``collate``): ``row_ptr[n]`` is the first edge of row
``n``, ``row_ptr[N]`` the end of the valid edges; padding edges lie past it
and drop out, and an empty row gives 0.

The kernel (``ops/csrc/sorted_segment_sum.cu``) is bound by bytes: it moves
each valid input row once and each output row once, ~10.4 MB per conv1 call
of the serving path (~3.1 us at 3.35 TB/s). A group of lanes sized to F
sums each output row's contiguous run of edges, each lane a float2 or a
float4 of columns (float2 while the grid stays within 3/4 of the card's
resident threads), with 64 bytes of loads in flight; every column is summed
in ascending edge order, so the result is bitwise the plain version's on
the CPU. :func:`launch_plan` reports the launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
from deeprank_gnn_tpu_torch.ops.kernels import build
from deeprank_gnn_tpu_torch.ops.lanes import index_add_rows

NAME = "sorted_segment_sum"


def rows_from_row_ptr(row_ptr: torch.Tensor, num_edges: int) -> torch.Tensor:
    """Row id of every edge from CSR pointers; edges outside
    ``[row_ptr[0], row_ptr[N])`` get an id outside ``[0, N)``."""
    edges = torch.arange(num_edges, dtype=row_ptr.dtype, device=row_ptr.device)
    return torch.searchsorted(row_ptr, edges, right=True) - 1


def sorted_segment_sum_plain(
    data: torch.Tensor,
    row_ptr: torch.Tensor,
    rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version: the ``index_add_`` form of
    ``ops.segment.segment_sum`` (each padding edge into a row of its own,
    ``ops/lanes.py``), with the rows taken from ``rows`` when given, else
    from ``row_ptr``."""
    n = row_ptr.shape[0] - 1
    if rows is None:
        rows = rows_from_row_ptr(row_ptr, data.shape[0])
    return index_add_rows(data, rows, n)


def check_csr(data: torch.Tensor, row_ptr: torch.Tensor) -> None:
    """Shapes and devices of ``data [E, F]`` and ``row_ptr [N+1]``."""
    if data.dim() != 2 or row_ptr.dim() != 1 or row_ptr.shape[0] < 1:
        raise ValueError(
            f"want data [E, F] and row_ptr [N+1]; got {tuple(data.shape)} "
            f"and {tuple(row_ptr.shape)}"
        )
    if data.device != row_ptr.device:
        raise ValueError(
            f"data on {data.device} but row_ptr on {row_ptr.device}"
        )


def check_csr_kernel(name: str, data: torch.Tensor, row_ptr: torch.Tensor) -> None:
    """What a CSR kernel takes, checked before its launch: contiguous
    float32 ``data`` and int32 ``row_ptr``, int32 sizes, on a CUDA device."""
    if data.dtype != torch.float32 or row_ptr.dtype != torch.int32:
        raise TypeError(
            f"want float32 data and int32 row_ptr; got {data.dtype} and "
            f"{row_ptr.dtype}"
        )
    if not (data.is_contiguous() and row_ptr.is_contiguous()):
        raise ValueError("data and row_ptr must be contiguous")
    if max(*data.shape, row_ptr.shape[0] - 1) >= 2**31:
        raise ValueError("sizes must fit in int32")
    if data.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {data.device}")


def sorted_segment_sum(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """``out[n] = data[row_ptr[n]:row_ptr[n+1]].sum(0)``. [E, F] -> [N, F].

    On a CPU tensor this is :func:`sorted_segment_sum_plain`. On a CUDA
    tensor it launches the kernel (building it at first use) or raises:
    ``data`` must be contiguous float32 and ``row_ptr`` contiguous int32,
    nondecreasing, with ``row_ptr[N] <= E``. A tensor on any other device
    raises too, after the same checks.
    """
    check_csr(data, row_ptr)
    if data.device.type == "cpu":
        return sorted_segment_sum_plain(data, row_ptr)
    check_csr_kernel(NAME, data, row_ptr)
    e, f = data.shape
    n = row_ptr.shape[0] - 1
    out = torch.empty((n, f), dtype=torch.float32, device=data.device)
    if n == 0 or f == 0:
        return out
    lib = build.load(NAME)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.sorted_segment_sum_f32(
            data.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), n, f, e, stream
        )
    if err != 0:
        raise RuntimeError(f"sorted_segment_sum launch failed: CUDA error {err}")
    LAUNCHES[NAME] += 1
    return out


def launch_plan(data: torch.Tensor, row_ptr: torch.Tensor) -> dict:
    """The launch :func:`sorted_segment_sum` makes for ``data [E, F]`` and
    ``row_ptr [N+1]`` on their CUDA device: ``vec`` (columns a lane reads
    per load: 2 or 4 where F and ``data``'s alignment allow, else 1),
    ``lanes_per_row`` (the smallest power of two at or above F / ``vec``, at
    most 32), ``rows_per_block``, ``blocks``, ``loads_in_flight`` (edges a
    lane loads before it adds them) and ``blocks_per_sm`` resident."""
    lib = build.load(NAME)
    plan = (ctypes.c_int * 6)()
    ptr = data.data_ptr()
    align = 16 if ptr % 16 == 0 else 8 if ptr % 8 == 0 else 4
    with torch.cuda.device(data.device):
        err = lib.sorted_segment_sum_plan(row_ptr.shape[0] - 1, data.shape[1], align, plan)
    if err != 0:
        raise RuntimeError(f"sorted_segment_sum_plan: CUDA error {err}")
    keys = ("vec", "lanes_per_row", "rows_per_block", "blocks", "loads_in_flight",
            "blocks_per_sm")
    return dict(zip(keys, plan))


def sorted_segment_sum_backward(grad: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`sorted_segment_sum` with respect to ``data``:
    ``grad[rows]``, 0 for an edge whose row lies outside ``[0, N)``
    (padding). Plain torch on every device, as the JAX package leaves its
    ``_bwd`` (``ops/pallas/segment.py:432-436``) to XLA."""
    n = grad.shape[0]
    valid = (rows >= 0) & (rows < n)
    if n == 0:
        return grad.new_zeros((rows.shape[0], grad.shape[1]))
    g = grad.index_select(0, torch.clamp(rows, 0, n - 1))
    return torch.where(valid[:, None], g, torch.zeros((), dtype=g.dtype, device=g.device))

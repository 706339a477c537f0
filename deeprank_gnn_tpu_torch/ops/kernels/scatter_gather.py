"""K2: segment sum over row-sorted edges and its gather back onto the edges
(CUDA kernel, plain version, wrapper).

Replaces ``deeprank_gnn_tpu/ops/pallas/segment.py:sorted_scatter_gather``.
The rows arrive as CSR row pointers, as for K1
(:mod:`deeprank_gnn_tpu_torch.ops.kernels.segment`): ``row_ptr[n]`` is the
first edge of row ``n`` and ``row_ptr[N]`` the end of the valid edges. It
returns ``out [N, F]``, each row's sum, and ``d2 [E, F]``, that sum copied
onto each edge of the row, 0 for an edge outside every row's run (padding).

The JAX package's models leave this composition to XLA; in the port it
carries the denominator of the sparse attention softmax
(``ops.segment.segment_softmax(..., row_ptr=...)``) and its gradient, at
F = 1. The kernel (``ops/csrc/sorted_scatter_gather.cu``) is bound by bytes:
it reads each valid input row once and writes ``out`` and ``d2`` once, ~0.6
MB per conv1 softmax of a served batch (~0.2 us at 3.35 TB/s). At F = 1 a
block of one warp owns 32 consecutive rows, stages their contiguous span of
edges in shared-memory tiles with coalesced loads, sums each run in edge
order there and writes each row's sum over its run of ``d2``; other widths
take a group of lanes per row. :func:`launch_plan` reports the launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
from deeprank_gnn_tpu_torch.ops.kernels import build
from deeprank_gnn_tpu_torch.ops.kernels.segment import (
    check_csr,
    check_csr_kernel,
    rows_from_row_ptr,
    sorted_segment_sum_backward,
    sorted_segment_sum_plain,
)

NAME = "sorted_scatter_gather"


def sorted_scatter_gather_plain(
    data: torch.Tensor,
    row_ptr: torch.Tensor,
    rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: K1's plain version, then the sums gathered
    at each edge's row and masked at padding (an ``index_select``), with the
    rows taken from ``rows`` when given, else from ``row_ptr``."""
    if rows is None:
        rows = rows_from_row_ptr(row_ptr, data.shape[0])
    out = sorted_segment_sum_plain(data, row_ptr, rows)
    return out, sorted_segment_sum_backward(out, rows)


def sorted_scatter_gather(
    data: torch.Tensor, row_ptr: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, d2)``: ``out[n] = data[row_ptr[n]:row_ptr[n+1]].sum(0)`` and
    ``d2[e] = out[n]`` for each edge ``e`` of row ``n``, 0 outside every
    row's run. [E, F] -> ([N, F], [E, F]).

    On a CPU tensor this is :func:`sorted_scatter_gather_plain`. On a CUDA
    tensor it launches the kernel (building it at first use) or raises,
    with K1's conditions: contiguous float32 ``data``, contiguous int32
    ``row_ptr``, nondecreasing, ``row_ptr[N] <= E``.
    """
    check_csr(data, row_ptr)
    if data.device.type == "cpu":
        return sorted_scatter_gather_plain(data, row_ptr)
    check_csr_kernel(NAME, data, row_ptr)
    e, f = data.shape
    n = row_ptr.shape[0] - 1
    out = torch.empty((n, f), dtype=torch.float32, device=data.device)
    d2 = torch.empty((e, f), dtype=torch.float32, device=data.device)
    if f == 0 or n + e == 0:
        return out, d2
    lib = build.load(NAME)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.sorted_scatter_gather_f32(
            data.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), d2.data_ptr(),
            n, f, e, stream,
        )
    if err != 0:
        raise RuntimeError(f"sorted_scatter_gather launch failed: CUDA error {err}")
    LAUNCHES[NAME] += 1
    return out, d2


def launch_plan(device, n: int, f: int) -> dict:
    """The launch :func:`sorted_scatter_gather` makes on ``device`` for
    ``N`` rows of ``F`` columns: ``path`` ("tiles" at F = 1, else "lanes"),
    ``rows_per_block``, ``tile_edges`` (edges staged per shared-memory tile;
    0 on the lane path), ``blocks`` (the rows' blocks and the padding's
    zero-fill blocks), ``smem_bytes`` per block, ``blocks_per_sm`` resident
    and ``threads`` per block."""
    lib = build.load(NAME)
    plan = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = lib.sorted_scatter_gather_plan(n, f, plan)
    if err != 0:
        raise RuntimeError(f"sorted_scatter_gather_plan: CUDA error {err}")
    keys = ("path", "rows_per_block", "tile_edges", "blocks", "smem_bytes", "blocks_per_sm",
            "threads")
    out = dict(zip(keys, plan))
    out["path"] = ("tiles", "lanes")[out["path"]]
    return out

#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py [--seed N] [--graphs N]

Run from the root of a checkout; it needs one CUDA device and ``nvcc``
(``$CUDA_HOME/bin`` or PATH), and nothing beyond torch, numpy and scipy.
Phases, each of which raises on failure:

1. device: the card's name and power limit (``nvidia-smi``); fp32
   numerics with TF32 off; the cuBLAS workspace setting that
   deterministic mode needs;
2. build: every CUDA kernel of the port, from ``ops/csrc`` in this
   checkout, one ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version, and two
   launches bitwise equal. K1 (sorted segment sum) on the card at rtol 1e-5
   and atol 1e-5 (the summation order differs from ``index_add_``; its
   edge cases use values whose sums are exact in fp32, so long runs compare
   which edges were summed rather than rounding), at the sparse serving
   path's shapes and at edge cases (empty rows, a run of thousands of
   edges, trailing padding, odd widths), and its gradient against the
   plain version's. K3 (per-graph GIN aggregation) forward and backward
   bitwise equal to the plain version run on the CPU (both sum in edge
   order), on random values, at the dense path's first-batch shapes of
   both conv levels, and at edge cases: unsorted rows, duplicate edges,
   empty rows, sentinel and negative indices, F = 1, 17 and 100, more
   edges than one shared-memory tile, every valid edge of a graph on one
   row, a graph whose [S, F] slab does not fit in shared memory, and S of
   70,000, far beyond one block's rows; its launch plan (slab staged, rows
   per block, blocks resident per SM) is checked too. K2 (sorted
   scatter-gather, the attention softmax's denominator) forward and
   backward on the card at rtol 1e-5 and atol 1e-5, at the attention
   path's two softmax shapes of the first batch (F = 1), at the JAX
   package's ``bench.py`` SpMM shapes, and at edge cases (empty rows, a
   run of 8,000 edges, leading and trailing padding, F = 1, 17 and 100, no
   row at all); its ``d2`` must be bitwise ``out[rows]`` and 0 at padding,
   its ``out`` bitwise K1's sums. Each is timed at the main shapes with the
   L2 cache flushed before each call, beside its plain version, a PyTorch
   library yardstick and the least time the card could take, and also
   L2-resident and eagerly;
4. serve: a GINet at the paper's width (48 node features, the ``fold6``
   feature set, 1 edge feature, target ``fnat``, batch 128) with seeded
   random weights, written as a reference-format torch checkpoint, scores
   synthetic fixture-scale graphs (2,048 by default) through ``NeuralNet(...,
   pretrained_model=ckpt, device="cuda")`` in the sparse and the dense
   layout. The graphs are in memory (``GraphListDataSet``, which row-sorts
   their edges): the HDF5 front end is held against the JAX package by the
   CPU tests. The launch counters are cleared just before each pass and
   read just after: K1 must run twice per sparse batch, K3 twice per
   dense batch. Predictions must be finite and match the same port run
   with ``device="cpu"`` (the plain versions), and the two layouts each
   other, at rtol 2e-4 and atol 1e-5. A pass of each layout under
   ``torch.profiler`` shows where the time goes;
5. train, per layout: ``NeuralNet(graphs, GINet, ..., batch_size=128,
   percent=[0.8, 0.2], layout=...)`` with the epoch passes that ``train()``
   runs (``_run_pass`` for training, then for validation) and
   ``save_model``: ``train()`` itself also writes its epoch HDF5, and the
   card's machine has no ``h5py`` (the CPU tests run ``train()`` whole).
   With dropout off, the first 4 Adam steps' losses on the card match the
   port's ``device="cpu"`` run from the same weights at rtol 2e-4, atol
   1e-5. With dropout on, two card runs from one seed give bitwise-equal
   losses and parameters after 2 epochs. Per training batch K1 launches 2
   times (sparse) and K3 4 times (dense: 2 forward, 2 backward). Losses are
   finite. It prints graphs/s per epoch (the first one cold), a profile of
   one warm epoch, and the saved checkpoint reloads and trains on;
6. attention, the main path of the model zoo's slice:
   ``functools.partial(GINet, attention=True)``, sparse, at the paper's
   width on 2,048 graphs: served from a reference-format checkpoint as in
   4 (K1 4 and K2 4 launches per batch) and trained as in 5 (K1 8 and K2 4
   per training batch: K2's backward runs K1), with every check of both;
7. the other new paths on 768 graphs (4 or more training batches): the dense attention GINet (also
   against the sparse one), the internal-tower GINet (sparse only, K1 4
   per batch), FoutNet and sGAT in both layouts (K1 2 per sparse batch;
   their dense aggregations are plain torch), each served against its CPU
   run (one of two passes profiled) and trained 4 Adam steps against the
   CPU and one epoch.

The last two lines are a JSON object of per-kernel numbers and then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20  # read before a cold call: 5x the 50 MB L2
SPIN_CYCLES = 1_000_000  # ~0.5 ms of device spin that hides the host's launch
TOL = dict(rtol=2e-4, atol=1e-5)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)

FOLD6_FEATURES = ["type", "polarity", "bsa", "charge", "cons", "ic", "pssm"]
NODES_PER_GRAPH = 130
EDGES_PER_GRAPH = 250  # stored undirected; 500 directed after doubling
BATCH = 128
PARITY_STEPS = 4

KERNELS = {
    "sorted_segment_sum": {
        "route": "cuda",
        "source": "deeprank_gnn_tpu_torch/ops/csrc/sorted_segment_sum.cu",
        "replaces": "deeprank_gnn_tpu/ops/pallas/segment.py:408",
    },
    "fused_gin_conv": {
        "route": "cuda",
        "source": "deeprank_gnn_tpu_torch/ops/csrc/fused_gin_conv.cu",
        "replaces": "deeprank_gnn_tpu/ops/pallas/__init__.py:203",
    },
    "sorted_scatter_gather": {
        "route": "cuda",
        "source": "deeprank_gnn_tpu_torch/ops/csrc/sorted_scatter_gather.cu",
        "replaces": "deeprank_gnn_tpu/ops/pallas/segment.py:326",
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


def build_graphs(seed: int, num_graphs: int):
    """Fixture-scale residue graphs made with numpy from ``seed``:
    doubled edges with the distance transform applied, in no particular
    order (``GraphListDataSet`` row-sorts them, as ``HDF5DataSet`` does
    on load), and stored two-level clusters."""
    from deeprank_gnn_tpu_torch.data.dataset import GraphSample, default_edge_transform

    rng = np.random.default_rng(seed)
    n, e = NODES_PER_GRAPH, EDGES_PER_GRAPH
    graphs = []
    for gi in range(num_graphs):
        x = np.hstack([
            np.eye(20)[rng.integers(0, 20, n)],  # type, one-hot
            np.eye(4)[rng.integers(0, 4, n)],  # polarity, one-hot
            rng.random((n, 4)),  # bsa, charge, cons, ic
            rng.standard_normal((n, 20)),  # pssm
        ]).astype(np.float32)
        src = rng.integers(0, n, e)
        dst = (src + 1 + rng.integers(0, n - 1, e)) % n
        src[:n] = np.arange(n)
        ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
        dist = 2.0 + 6.5 * rng.random(e)
        ea = default_edge_transform(np.concatenate([dist, dist])[:, None])
        ei, ea = ei.astype(np.int32), ea.astype(np.float32)
        _, c0 = np.unique(rng.integers(0, 29, n), return_inverse=True)
        c1 = np.arange(int(c0.max()) + 1) // 3
        graphs.append(
            GraphSample(
                mol=f"model_{gi:05d}",
                x=x,
                pos=rng.standard_normal((n, 3)).astype(np.float32),
                edge_index=ei,
                edge_attr=ea,
                internal_edge_index=ei[:, :e],
                internal_edge_attr=ea[:e],
                cluster0=c0.astype(np.int32),
                cluster1=c1.astype(np.int32),
                y=float(rng.random()),
            )
        )
    return graphs


def write_checkpoint(path: str, seed: int, Net=None) -> None:
    """A reference-format torch checkpoint of a seeded random ``Net``
    (default GINet) at the paper's width."""
    import torch

    from deeprank_gnn_tpu_torch.models import GINet

    model = (Net or GINet)(48, 1, 1, device="cpu", generator=torch.Generator().manual_seed(seed))
    torch.save(
        {
            "model": model.state_dict(),
            "optimizer": {},
            "net": type(model).__name__,
            "node": FOLD6_FEATURES,
            "edge": ["dist"],
            "target": "fnat",
            "task": "reg",
            "classes": [0, 1],
            "class_weight": None,
            "batch_size": BATCH,
            "percent": [1.0, 0.0],
            "lr": 0.001,
            "index": None,
            "shuffle": True,
            "threshold": 0.3,
            "cluster_nodes": "mcl",
            "transform_sigmoid": False,
        },
        path,
    )


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one eager call, from CUDA events around ``iters``
    back-to-back calls: the host's launch cost included."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call with its inputs in HBM: before each
    call the card reads a buffer five times the L2 cache's size (a read,
    so the call finds no dirty lines to write back), then spins while the
    host queues the call between two CUDA events, so the events bracket
    the call's device work alone."""
    import torch

    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    pairs = []
    for _ in range(warmup + reps):
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs[warmup:]]))


def l2_warm_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Device time of one call with its inputs L2-resident: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times between
    CUDA events, so the host's launch cost drops out and every call after
    the first reads what the one before left in the 50 MB L2 cache."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def errors(got, want) -> dict:
    err = (got - want).abs()
    if not err.numel():
        return {"max_abs_err": 0.0, "max_rel_err": 0.0}
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float((err / want.abs().clamp_min(1e-30)).max())}


# ---------------------------------------------------------------------------
# K1: sorted segment sum


def k1_case(name, data, row_ptr, rows, timed: bool):
    """Check the sorted segment sum kernel against its plain version on
    the card; time it when ``timed``. Returns a dict of numbers."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels.segment import (
        sorted_segment_sum,
        sorted_segment_sum_plain,
    )

    a = sorted_segment_sum(data, row_ptr)
    b = sorted_segment_sum(data, row_ptr)
    want = sorted_segment_sum_plain(data, row_ptr, rows)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"K1 {name}: two launches differ")
    torch.testing.assert_close(a, want, **KERNEL_TOL, msg=f"K1 {name}")
    n, f = row_ptr.shape[0] - 1, data.shape[1]
    e_valid = int(row_ptr[-1])
    res = {"case": name, "E": int(data.shape[0]), "E_valid": e_valid, "N": n, "F": f,
           **errors(a, want)}
    if timed:
        lengths = row_ptr.diff().to(torch.int64)
        valid = data[:e_valid]
        lib = torch.segment_reduce(valid, "sum", lengths=lengths, unsafe=True)
        res.update(
            ms=cold_ms(lambda: sorted_segment_sum(data, row_ptr)),
            plain_ms=cold_ms(lambda: sorted_segment_sum_plain(data, row_ptr)),
            library_ms=cold_ms(
                lambda: torch.segment_reduce(valid, "sum", lengths=lengths, unsafe=True)
            ),
            l2_warm_ms=l2_warm_ms(lambda: sorted_segment_sum(data, row_ptr)),
            call_ms=call_ms(lambda: sorted_segment_sum(data, row_ptr)),
            library_max_abs_err=float((lib - want).abs().max()),
            bound_ms=k1_bound_ms(e_valid, n, f),
        )
    return res


def k1_bound_ms(e_valid: int, n: int, f: int) -> float:
    """Least time of one sorted segment sum: its bytes (valid input rows,
    row pointers and output, each moved once) over the HBM rate, or its
    adds over the fp32 rate, whichever is longer."""
    moved = (e_valid * f + n * f + n + 1) * 4
    return 1e3 * max(moved / HBM_BYTES_PER_S, e_valid * f / FP32_FLOPS)


def k1_backward_case(name, data, row_ptr, rows, gen) -> dict:
    """K1's gradient (``segment_sum(..., row_ptr=)`` through its autograd
    Function: the kernel forward, ``grad[rows]`` backward) against the
    gradient of the plain version (``index_add_``, whose backward is an
    ``index_select``), on the card."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels.segment import sorted_segment_sum_plain
    from deeprank_gnn_tpu_torch.ops.segment import segment_sum

    n = row_ptr.shape[0] - 1
    cot = torch.randn((n, data.shape[1]), generator=gen, device=data.device)
    x = data.clone().requires_grad_(True)
    segment_sum(x, rows, n, row_ptr=row_ptr).backward(cot)
    xp = data.clone().requires_grad_(True)
    sorted_segment_sum_plain(xp, row_ptr, rows).backward(cot)
    torch.cuda.synchronize()
    if not torch.equal(x.grad, xp.grad):
        raise AssertionError(f"K1 backward {name}: differs from the plain gradient")
    if x.grad[int(row_ptr[-1]):].any():
        raise AssertionError(f"K1 backward {name}: padding edges got a gradient")
    return {"case": name + "-backward", **errors(x.grad, xp.grad)}


def k1_phase(first_batch, seed: int):
    """K1 at the sparse serving path's two shapes (from the first collated
    batch) and at edge cases, forward and backward."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)

    def rand(e, f):
        return torch.randn((e, f), generator=gen, device=dev)

    def exact(e, f):
        # multiples of 1/64 below 8 in magnitude: every partial sum of a
        # run of thousands is exact in fp32, so the long-run cases compare
        # which edges were summed, not the rounding of the order they
        # were summed in
        return torch.randint(-512, 512, (e, f), generator=gen, device=dev).float() / 64

    def from_rows(rows_np, n):
        rows = torch.from_numpy(rows_np.astype(np.int32)).to(dev)
        ptr = torch.from_numpy(np.searchsorted(rows_np, np.arange(n + 1)).astype(np.int32)).to(dev)
        return ptr, rows

    b = first_batch.to(dev)
    main = [
        ("conv1", rand(b.edge_index.shape[1], 32), b.edge_rowptr, b.edge_index[0]),
        ("conv2", rand(b.pe_index.shape[1], 64), b.pe_rowptr, b.pe_index[0]),
    ]
    log(f"K1 event floor: {cold_ms(lambda: None)} ms between two events with no call")
    results = [k1_case(name, d, p, r, timed=True) for name, d, p, r in main]

    n = 4000
    rows = np.sort(rng.choice(np.arange(0, n, 3), 20000))  # 2 of 3 rows empty
    rows[:8000] = n // 2  # one run of 8,000 edges
    rows = np.concatenate([np.sort(rows), np.full(777, n)])  # trailing padding
    ptr, r = from_rows(rows, n)
    edge_cases = [(f"edges-F{f}", exact(len(rows), f), ptr, r) for f in (1, 17, 100)]
    ptr0, r0 = from_rows(np.full(300, 50), 50)  # every row empty, all padding
    edge_cases.append(("all-empty-F32", exact(300, 32), ptr0, r0))
    results += [k1_case(name, d, p, rr, timed=False) for name, d, p, rr in edge_cases]
    results += [k1_backward_case(name, d, p, rr, gen)
                for name, d, p, rr in main + edge_cases[:1]]
    for res in results:
        log("K1 " + json.dumps(res))
    return results


# ---------------------------------------------------------------------------
# K3: per-graph GIN aggregation


def k3_bound_ms(s: int, f: int, row, col) -> float:
    """Least time of one K3 call ``out = fused_gin_conv(xw [G,S,F], row,
    col)`` on these indices: its bytes over the HBM rate, or one add per
    valid edge and column over the fp32 rate, whichever is longer. The
    bytes are the ``xw`` rows that a valid edge reads (each distinct
    (graph, ``col``) pair once: run padding and sentinel slots are never
    read), ``out`` written whole (G*S*F) and ``row`` and ``col`` read once.
    For the backward pass ``col, row`` swapped: it reads the gradient rows
    that a valid ``row`` names."""
    import torch

    g, e = row.shape
    valid = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    goff = torch.arange(g, device=col.device)[:, None] * s
    sources = int(torch.unique((col.long() + goff)[valid]).numel())
    moved = 4 * (sources * f + g * s * f + 2 * g * e)
    return 1e3 * max(moved / HBM_BYTES_PER_S, int(valid.sum()) * f / FP32_FLOPS)


def k3_library_pair(xw, row, col):
    """The PyTorch yardstick for K3: no single call computes it, so two
    library calls on prepared flat indices, ``index_select`` of the source
    rows and ``index_add_`` into a zero-filled output (nondeterministic
    atomics; timed only, never used by the port)."""
    import torch

    g, s, f = xw.shape
    valid = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    goff = torch.arange(g, device=row.device)[:, None] * s
    src = torch.where(valid, col.long() + goff, g * s).reshape(-1)
    dst = torch.where(valid, row.long() + goff, g * s).reshape(-1)
    rows = torch.cat([xw.reshape(g * s, f), xw.new_zeros((1, f))])
    out = xw.new_zeros((g * s + 1, f))

    def run():
        out.zero_()
        out.index_add_(0, dst, rows.index_select(0, src))
        return out

    return run


def k3_case(name, xw, row, col, gen, timed: bool) -> dict:
    """K3 forward and backward (the gradient through its autograd Function)
    bitwise equal to the plain version run on the CPU on the same inputs
    (``plain(xw, row, col)``, and ``plain(cot, col, row)`` for the
    backward), which sums in edge order as the kernel does; two launches
    bitwise equal; the launch plan; timed when ``timed``."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import (
        fused_gin_conv,
        fused_gin_conv_forward,
        fused_gin_conv_plain,
        launch_plan,
    )

    g, s, f = xw.shape
    e = row.shape[1]
    cot = torch.randn(xw.shape, generator=gen, device=xw.device)
    x = xw.clone().requires_grad_(True)
    fwd = fused_gin_conv(x, row, col)
    fwd.backward(cot)
    again = fused_gin_conv_forward(xw, row, col)
    bwd_again = fused_gin_conv_forward(cot, col, row)
    torch.cuda.synchronize()
    if not (torch.equal(fwd, again) and torch.equal(x.grad, bwd_again)):
        raise AssertionError(f"K3 {name}: two launches differ")
    xc, rc, cc, gc = xw.cpu(), row.cpu(), col.cpu(), cot.cpu()
    want, want_grad = fused_gin_conv_plain(xc, rc, cc), fused_gin_conv_plain(gc, cc, rc)
    got, got_grad = fwd.detach().cpu(), x.grad.cpu()
    fe, be = errors(got, want), errors(got_grad, want_grad)
    if not (torch.equal(got, want) and torch.equal(got_grad, want_grad)):
        raise AssertionError(f"K3 {name}: not bitwise the plain version on the cpu: "
                             f"forward {fe}, backward {be}")
    valid = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    res = {"case": name, "G": g, "S": s, "F": f, "E": e, "E_valid": int(valid.sum()),
           **launch_plan(xw.device, s, f, e),
           "max_abs_err": max(fe["max_abs_err"], be["max_abs_err"]),
           "max_rel_err": max(fe["max_rel_err"], be["max_rel_err"])}
    if timed:
        lib_fwd, lib_bwd = k3_library_pair(xw, row, col), k3_library_pair(cot, col, row)
        res.update(
            ms_fwd=cold_ms(lambda: fused_gin_conv_forward(xw, row, col)),
            ms_bwd=cold_ms(lambda: fused_gin_conv_forward(cot, col, row)),
            plain_ms_fwd=cold_ms(lambda: fused_gin_conv_plain(xw, row, col)),
            plain_ms_bwd=cold_ms(lambda: fused_gin_conv_plain(cot, col, row)),
            library_ms_fwd=cold_ms(lib_fwd),
            library_ms_bwd=cold_ms(lib_bwd),
            l2_warm_ms_fwd=l2_warm_ms(lambda: fused_gin_conv_forward(xw, row, col)),
            l2_warm_ms_bwd=l2_warm_ms(lambda: fused_gin_conv_forward(cot, col, row)),
            call_ms_fwd=call_ms(lambda: fused_gin_conv_forward(xw, row, col)),
            library_max_abs_err=float(
                (lib_fwd()[: g * s].reshape(g, s, f).cpu() - want).abs().max()),
            bound_ms_fwd=k3_bound_ms(s, f, row, col),
            bound_ms_bwd=k3_bound_ms(s, f, col, row),
        )
    return res


def k3_phase(first_dense_batch, seed: int):
    """K3 at the dense path's first-batch shapes of both conv levels and at
    edge cases, all with random values: summation order shows in the bits."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rng = np.random.default_rng(seed + 1)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def indices(g, s, e, one_row=False):
        """Unsorted rows with a long run of duplicates on one row (with
        ``one_row``, every valid edge on one row), sentinel (== S) and
        negative indices, and rows without edges."""
        row = rng.integers(0, s, (g, e))
        col = rng.integers(0, s, (g, e))
        row[:, : e // 4] = s // 3  # duplicates of one row
        if one_row:
            row[:] = s // 3
        row[:, ::7] = s
        col[:, 3::11] = s
        row[:, 5::13] = -1
        row[row == s // 2] = s // 2 + 1  # slot s//2 receives nothing
        rng.shuffle(row, axis=1)
        return (torch.from_numpy(row.astype(np.int32)).to(dev),
                torch.from_numpy(col.astype(np.int32)).to(dev))

    b = first_dense_batch.to(dev)
    g, ng = b.x.shape[0], b.x.shape[1]
    c0g = b.pool0_mask.shape[1]
    main = [
        ("conv1", rand((g, ng, 32)), b.row, b.col),
        ("conv2", rand((g, c0g, 64)), b.pe_row, b.pe_col),
    ]
    results = [k3_case(name, x, r, c, gen, timed=True) for name, x, r, c in main]
    edge = []
    for f in (1, 17, 100):
        edge.append((f"edges-F{f}", rand((6, 50, f)), *indices(6, 50, 400)))
    edge.append(("tiles-F32", rand((4, 300, 32)), *indices(4, 300, 10000)))
    edge.append(("one-row-F32", rand((3, 300, 32)), *indices(3, 300, 5000, one_row=True)))
    edge.append(("no-slab-F64", rand((2, 4000, 64)), *indices(2, 4000, 9000)))
    edge.append(("wide-S-F8", rand((2, 70000, 8)), *indices(2, 70000, 9000)))
    results += [k3_case(name, x, r, c, gen, timed=False) for name, x, r, c in edge]
    for res in results:
        log("K3 " + json.dumps(res))
    by_case = {r["case"]: r for r in results}
    for name in ("conv1", "conv2"):
        # the main shapes: slab staged, rows split at most 128 to a block, at
        # least two blocks resident per SM
        r = by_case[name]
        if not (r["slab"] and r["rows_per_block"] <= 128 and r["blocks_per_sm"] >= 2):
            raise AssertionError(f"K3 {name}: launch plan {r}")
    if by_case["conv1"]["blocks_per_graph"] < 2:
        raise AssertionError("K3: conv1's rows should be split over several blocks")
    for name in ("no-slab-F64", "wide-S-F8"):
        if by_case[name]["slab"]:
            raise AssertionError(f"K3 {name}: the slab should not fit in shared memory")
    if by_case["wide-S-F8"]["blocks_per_graph"] != -(-70000 // 128):
        raise AssertionError(f"K3 wide-S-F8: launch plan {by_case['wide-S-F8']}")
    return results


# ---------------------------------------------------------------------------
# K2: sorted scatter-gather


def k2_bound_ms(e_valid: int, e: int, n: int, f: int) -> float:
    """Least time of one sorted scatter-gather: its bytes (valid input rows
    and row pointers read once, ``out [N,F]`` and ``d2 [E,F]`` written
    whole once) over the HBM rate, or its adds over the fp32 rate,
    whichever is longer."""
    moved = (e_valid * f + n + 1 + n * f + e * f) * 4
    return 1e3 * max(moved / HBM_BYTES_PER_S, e_valid * f / FP32_FLOPS)


def k2_library(data, row_ptr, rows):
    """The PyTorch yardstick for K2: no one call computes it, so
    ``torch.segment_reduce`` over the valid rows, then ``index_select`` of
    the sums at the valid edges' rows (indices prepared beforehand; the
    padding of ``d2`` is not written). Timed only, never used by the
    port."""
    import torch

    lengths = row_ptr.diff().to(torch.int64)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    valid, idx = data[lo:hi], rows[lo:hi].long()

    def run():
        out = torch.segment_reduce(valid, "sum", lengths=lengths, unsafe=True)
        return out, out.index_select(0, idx)

    return run


def k2_case(name, data, row_ptr, rows, gen, timed: bool) -> dict:
    """K2 against its plain version on the card: ``out`` and ``d2`` within
    ``KERNEL_TOL``, ``d2`` bitwise ``out[rows]`` and 0 outside every run,
    ``out`` bitwise K1's sums, two launches bitwise equal, and the gradient
    through its autograd Function (with both cotangents, and with the
    ``out`` one absent as on the softmax path) against the gradient through
    the plain version. Timed when ``timed``."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels.scatter_gather import (
        sorted_scatter_gather,
        sorted_scatter_gather_plain,
    )
    from deeprank_gnn_tpu_torch.ops.kernels.segment import sorted_segment_sum
    from deeprank_gnn_tpu_torch.ops.segment import SortedScatterGather

    n, (e, f) = row_ptr.shape[0] - 1, data.shape
    out, d2 = sorted_scatter_gather(data, row_ptr)
    out_b, d2_b = sorted_scatter_gather(data, row_ptr)
    want_out, want_d2 = sorted_scatter_gather_plain(data, row_ptr, rows)
    k1 = sorted_segment_sum(data, row_ptr)
    torch.cuda.synchronize()
    if not (torch.equal(out, out_b) and torch.equal(d2, d2_b)):
        raise AssertionError(f"K2 {name}: two launches differ")
    torch.testing.assert_close(out, want_out, **KERNEL_TOL, msg=f"K2 {name} out")
    torch.testing.assert_close(d2, want_d2, **KERNEL_TOL, msg=f"K2 {name} d2")
    valid = (rows >= 0) & (rows < n)
    if not (torch.equal(d2[valid], out[rows[valid].long()]) and not d2[~valid].any()):
        raise AssertionError(f"K2 {name}: d2 is not bitwise out[rows], 0 at padding")
    if not torch.equal(out, k1):
        raise AssertionError(f"K2 {name}: out differs from K1's sums")
    errs = [errors(out, want_out), errors(d2, want_d2)]
    cot_out = torch.randn((n, f), generator=gen, device=data.device)
    cot_d2 = torch.randn((e, f), generator=gen, device=data.device)
    if name not in ("conv1", "conv2", "bench"):
        cot_out, cot_d2 = torch.round(cot_out * 64) / 64, torch.round(cot_d2 * 64) / 64
    for use_out in (True, False):
        x = data.clone().requires_grad_(True)
        o, g = SortedScatterGather.apply(x, row_ptr)
        ((g * cot_d2).sum() + ((o * cot_out).sum() if use_out else 0)).backward()
        xp = data.clone().requires_grad_(True)
        o, g = sorted_scatter_gather_plain(xp, row_ptr, rows)
        ((g * cot_d2).sum() + ((o * cot_out).sum() if use_out else 0)).backward()
        torch.cuda.synchronize()
        torch.testing.assert_close(x.grad, xp.grad, **KERNEL_TOL, msg=f"K2 {name} backward")
        if x.grad[~valid].any():
            raise AssertionError(f"K2 {name}: padding edges got a gradient")
        errs.append(errors(x.grad, xp.grad))
    e_valid = int(valid.sum())
    res = {"case": name, "E": e, "E_valid": e_valid, "N": n, "F": f,
           "max_abs_err": max(r["max_abs_err"] for r in errs),
           "max_rel_err": max(r["max_rel_err"] for r in errs)}
    if timed:
        lib = k2_library(data, row_ptr, rows)
        lib_out, lib_d2 = lib()
        res.update(
            ms=cold_ms(lambda: sorted_scatter_gather(data, row_ptr)),
            plain_ms=cold_ms(lambda: sorted_scatter_gather_plain(data, row_ptr)),
            library_ms=cold_ms(lib),
            l2_warm_ms=l2_warm_ms(lambda: sorted_scatter_gather(data, row_ptr)),
            call_ms=call_ms(lambda: sorted_scatter_gather(data, row_ptr)),
            library_max_abs_err=max(float((lib_out - want_out).abs().max()),
                                    float((lib_d2 - want_d2[valid]).abs().max())),
            bound_ms=k2_bound_ms(e_valid, e, n, f),
        )
    return res


def k2_phase(first_batch, seed: int):
    """K2 at the attention softmax's two shapes of the first served batch
    (F = 1, positive values as ``exp`` gives), at the JAX package's
    ``bench.py`` SpMM shapes, and at edge cases (exactly summable values)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    rng = np.random.default_rng(seed + 2)

    def exact(e, f):
        return torch.randint(-512, 512, (e, f), generator=gen, device=dev).float() / 64

    def from_rows(rows_np, n):
        rows = torch.from_numpy(rows_np.astype(np.int32)).to(dev)
        ptr = np.searchsorted(rows_np, np.arange(n + 1)).astype(np.int32)
        return torch.from_numpy(ptr).to(dev), rows

    b = first_batch.to(dev)
    cases = [
        ("conv1", torch.rand((b.edge_index.shape[1], 1), generator=gen, device=dev) * 3,
         b.edge_rowptr, b.edge_index[0]),
        ("conv2", torch.rand((b.pe_index.shape[1], 1), generator=gen, device=dev) * 3,
         b.pe_rowptr, b.pe_index[0]),
    ]
    # bench.py's bench_spmm_kernel: N 81,920, E 983,040, F 16, no padding
    n_b, e_b = 81920, 983040
    ptr_b, rows_b = from_rows(np.sort(rng.integers(0, n_b, e_b)), n_b)
    cases.append(("bench", torch.randn((e_b, 16), generator=gen, device=dev), ptr_b, rows_b))
    results = [k2_case(name, d, p, r, gen, timed=True) for name, d, p, r in cases]

    n = 4000
    rows = np.sort(rng.choice(np.arange(0, n, 3), 20000))  # 2 of 3 rows empty
    rows[:8000] = n // 2 - 2  # one run of 8,000 edges
    # leading padding (edges before row_ptr[0]) and trailing padding
    rows = np.concatenate([np.full(300, -1), np.sort(rows), np.full(777, n)])
    ptr, r = from_rows(rows, n)
    edge = [(f"edges-F{f}", exact(len(rows), f), ptr, r) for f in (1, 17, 100)]
    ptr0, r0 = from_rows(np.full(300, 50), 50)  # every row empty, all padding
    edge.append(("all-empty-F32", exact(300, 32), ptr0, r0))
    results += [k2_case(name, d, p, rr, gen, timed=False) for name, d, p, rr in edge]
    for res in results:
        log("K2 " + json.dumps(res))
    if int(ptr[0]) != 300:
        raise AssertionError("K2: the edge cases should carry leading padding")
    return results


# ---------------------------------------------------------------------------
# the engine's passes


def serve(dataset, ckpt: str, device: str, outdir: str, passes: int, layout: str, Net):
    """Score every graph ``passes`` times through the port's engine on
    ``device``; returns the engine, the last pass's outputs and loss, and
    per-pass wall times and launch counts."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    nn = NeuralNet(dataset, Net, pretrained_model=ckpt, device=device, outdir=outdir,
                   layout=layout)
    walls, launches = [], []
    for _ in range(passes):
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out, _out_m, _ys, loss, _data = nn.eval(nn.test_loader)
        if device == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(dict(LAUNCHES))
    return nn, np.asarray(out, dtype=np.float64), loss, walls, launches


def per_pass(per_batch: dict, batches: int) -> dict:
    """The launch counts a pass of ``batches`` batches must show."""
    return {k: v * batches for k, v in per_batch.items() if v}


def profile_pass(run, loader, kernel_bounds) -> dict:
    """Where one warm pass spends its time: the host's collation alone
    (``loader`` iterated without the model), then ``run()`` under
    ``torch.profiler``: wall time, the device's busy time (every kernel and
    copy it ran; the profiler's annotation ranges, such as
    ``Optimizer.step``, span kernels already counted and are left out),
    its idle share, the kernels that took most, and each named kernel's
    device time per batch beside ``kernel_bounds[name]``, its bound per
    batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    batches = sum(1 for _ in loader)
    collate_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    annotations = [e for e in on_card if e.is_user_annotation]
    on_card = [e for e in on_card if not e.is_user_annotation]
    busy_ms = sum(e.device_time for e in on_card) / 1e3
    by_name: dict = {}
    for e in on_card:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.device_time / 1e3
    res = {
        "batches": batches,
        "host_collate_ms": collate_ms,
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops": len(on_card),
        "annotation_ms_not_counted": sum(e.device_time for e in annotations) / 1e3,
        "top_device_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
    }
    for name, bound in kernel_bounds.items():
        ms = sum(v for k, v in by_name.items() if name in k)
        res[f"{name}_device_ms"] = ms
        res[f"{name}_ms_per_batch"] = ms / batches
        res[f"{name}_share_of_busy"] = ms / busy_ms
        res[f"{name}_bound_ms_per_batch"] = bound
    return res


def sparse_bound_per_batch(loader) -> float:
    """K1's bound per batch of ``loader``, averaged over its batches
    (conv1 at 32 columns over the interface edges, conv2 at 64 over the
    pooled edges)."""
    bounds = [k1_bound_ms(int(b.edge_rowptr[-1]), b.num_nodes, 32)
              + k1_bound_ms(int(b.pe_rowptr[-1]), b.num_clusters0, 64) for b, _ in loader]
    return float(np.mean(bounds))


def attention_bounds_per_batch(loader, training: bool) -> dict:
    """K1's and K2's bounds per batch of ``loader`` on the attention path,
    averaged over its batches: per tower K1 sums the weighted messages
    (conv1 at 16 columns, conv2 at 32) and K2 the softmax denominators
    (F = 1); training adds K2's backward, one K1 call at F = 1 each."""
    k1, k2 = [], []
    for b, _ in loader:
        levels = ((int(b.edge_rowptr[-1]), b.edge_index.shape[1], b.num_nodes, 16),
                  (int(b.pe_rowptr[-1]), b.pe_index.shape[1], b.num_clusters0, 32))
        k1.append(2 * sum(k1_bound_ms(ev, n, f) + (k1_bound_ms(ev, n, 1) if training else 0.0)
                          for ev, _e, n, f in levels))
        k2.append(2 * sum(k2_bound_ms(ev, e, n, 1) for ev, e, n, _f in levels))
    return {"sorted_segment_sum": float(np.mean(k1)), "sorted_scatter_gather": float(np.mean(k2))}


def dense_bound_per_batch(loader, backward: bool) -> float:
    """K3's bound per batch of ``loader``: conv1 at 32 columns, conv2 at 64,
    forward, and backward too when ``backward``."""
    bounds = []
    for b, _ in loader:
        total = 0.0
        for s, f, row, col in ((b.x.shape[1], 32, b.row, b.col),
                               (b.pool0_mask.shape[1], 64, b.pe_row, b.pe_col)):
            total += k3_bound_ms(s, f, row, col)
            if backward:
                total += k3_bound_ms(s, f, col, row)
        bounds.append(total)
    return float(np.mean(bounds))


def serve_check(label: str, Net, dataset, ckpt: str, tmp: str, layout: str, per_batch: dict,
                bounds=None, passes: int = 2) -> dict:
    """Score ``dataset`` with ``Net`` from ``ckpt`` on the card (``passes``
    passes, launch counts cleared before each and read after: ``per_batch``
    launches per batch, nothing else) and once on the CPU: finite
    predictions that match the CPU's at ``TOL``. With ``bounds`` (a function
    of the test loader giving each kernel's bound per batch) one more pass
    runs under ``torch.profiler``."""
    nn, pred, loss, walls, launches = serve(
        dataset, ckpt, "cuda", os.path.join(tmp, f"serve_{label}"), passes, layout, Net)
    batches = len(nn.test_loader)
    where = None
    if bounds is not None:
        where = profile_pass(lambda: nn.eval(nn.test_loader), nn.test_loader,
                             bounds(nn.test_loader))
    _, pred_cpu, loss_cpu, walls_cpu, launches_cpu = serve(
        dataset, ckpt, "cpu", os.path.join(tmp, f"serve_{label}_cpu"), 1, layout, Net)
    log(f"serve {label}: {len(pred)} models in {batches} batches; pass walls (s) {walls} "
        f"-> models/s {[len(pred) / w for w in walls]}; loss {loss}")
    log(f"serve {label}: launches per pass {launches}; cpu pass {walls_cpu[0]} s, "
        f"launches {launches_cpu[0]}")
    if where is not None:
        log(f"serve {label} breakdown " + json.dumps(where))
    want = per_pass(per_batch, batches)
    for i, count in enumerate(launches):
        if count != want:
            raise AssertionError(f"serve {label} pass {i}: launched {count}, want {want}")
    if launches_cpu[0]:
        raise AssertionError(f"the cpu pass launched kernels: {launches_cpu[0]}")
    if pred.shape != (len(dataset),) or not np.isfinite(pred).all():
        raise AssertionError(f"predictions: shape {pred.shape}, finite {np.isfinite(pred).all()}")
    diff = np.abs(pred - pred_cpu)
    log(f"serve {label}: card vs cpu max abs {diff.max()}, max rel "
        f"{(diff / np.maximum(np.abs(pred_cpu), 1e-30)).max()}, loss {loss} vs {loss_cpu}; "
        f"prediction std {pred.std()}")
    np.testing.assert_allclose(pred, pred_cpu, **TOL)
    np.testing.assert_allclose(loss, loss_cpu, **TOL)
    return {"pred": pred, "launches": launches[0], "where": where, "walls": walls,
            "cpu_max_abs": float(diff.max())}


def serve_phase(dataset, tmp: str, seed: int):
    """Paper-mode GINet: score through both layouts on the card and on the
    CPU, profiled, and the layouts against each other."""
    from deeprank_gnn_tpu_torch.models import GINet

    ckpt = os.path.join(tmp, "ginet_fold6_fnat.pth.tar")
    write_checkpoint(ckpt, seed)
    out = {
        "sparse": serve_check("sparse", GINet, dataset, ckpt, tmp, "sparse",
                              {"sorted_segment_sum": 2},
                              lambda ld: {"sorted_segment_sum": sparse_bound_per_batch(ld)}),
        "dense": serve_check("dense", GINet, dataset, ckpt, tmp, "dense", {"fused_gin_conv": 2},
                             lambda ld: {"fused_gin_conv": dense_bound_per_batch(ld, False)}),
    }
    diff = np.abs(out["dense"]["pred"] - out["sparse"]["pred"])
    log(f"serve: dense vs sparse on the card, max abs {diff.max()}")
    np.testing.assert_allclose(out["dense"]["pred"], out["sparse"]["pred"], **TOL)
    return out


def first_steps(nn, steps: int):
    """The losses of the first ``steps`` Adam steps of ``nn``'s training
    loader, as ``_run_pass(training=True)`` takes them."""
    from deeprank_gnn_tpu_torch.device import deterministic

    losses = []
    nn.model.train()
    with deterministic():
        for i, (batch, _mols) in enumerate(nn.train_loader):
            if i == steps:
                break
            loss, _pred = nn._train_step(nn._map_targets_host(batch).to(nn.device))
            losses.append(float(loss))
    nn.model.eval()
    return losses


def train_phase(label: str, Net, dataset, layout: str, seed: int, tmp: str, per_batch: dict,
                bounds=None) -> dict:
    """Train ``Net`` at the paper's width, batch 128, percent [0.8, 0.2]:
    the first 4 Adam steps (dropout off) against the CPU's at ``TOL``; the
    epoch passes of ``train()`` with ``per_batch`` launches per training
    batch (counts cleared before each epoch and read after) and finite
    losses. With ``bounds`` (a function of the training loader giving each
    kernel's bound per batch) the whole check: two epochs, a second run
    from the same seed bitwise equal, a profiled warm epoch, and save,
    reload and resume."""
    import torch

    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    kw = dict(node_feature=FOLD6_FEATURES, edge_feature=["dist"], target="fnat",
              batch_size=BATCH, percent=[0.8, 0.2], layout=layout, seed=seed)
    full = bounds is not None

    def engine(device, name, **extra):
        return NeuralNet(dataset, Net, device=device,
                         outdir=os.path.join(tmp, f"{label}_{name}"), **kw, **extra)

    # parity with the CPU from the same weights, dropout off (FoutNet and
    # sGAT have none)
    rate = GINet.dropout_rate
    GINet.dropout_rate = 0.0
    try:
        card = first_steps(engine("cuda", "parity_cuda"), PARITY_STEPS)
        cpu = first_steps(engine("cpu", "parity_cpu"), PARITY_STEPS)
    finally:
        GINet.dropout_rate = rate
    diff = np.abs(np.asarray(card) - np.asarray(cpu))
    log(f"train {label}: first {PARITY_STEPS} losses card {card} cpu {cpu}; max abs {diff.max()}, "
        f"max rel {(diff / np.abs(cpu)).max()}")
    np.testing.assert_allclose(card, cpu, **TOL)

    # the main path: the epoch passes of train(), dropout on
    def epochs(nn, count):
        walls, launches, losses, valid = [], [], [], []
        for _ in range(count):
            LAUNCHES.clear()
            t0 = time.perf_counter()
            _o, _om, _y, loss, _d = nn._run_pass(nn.train_loader, training=True)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append(dict(LAUNCHES))
            losses.append(loss)
            valid.append(nn._run_pass(nn.valid_loader, training=False)[3])
        return walls, launches, losses, valid

    a = engine("cuda", "a")
    walls, launches, losses, valid = epochs(a, 2 if full else 1)
    batches = len(a.train_loader)
    graphs = len(a.train_loader.dataset)
    log(f"train {label}: {graphs} graphs in {batches} batches per epoch; epoch walls (s) {walls} "
        f"-> graphs/s {[graphs / w for w in walls]} (the first cold); losses {losses}, "
        f"valid {valid}; launches {launches}")
    want = per_pass(per_batch, batches)
    for i, count in enumerate(launches):
        if count != want:
            raise AssertionError(f"train {label} epoch {i}: launched {count}, want {want}")
    if not np.isfinite(losses + valid).all():
        raise AssertionError(f"train {label}: losses {losses}, valid {valid}")
    res = {"walls": walls, "launches": launches[0], "where": None, "graphs": graphs,
           "parity_max_abs": float(diff.max())}
    if not full:
        return res

    # determinism: a second run from the same seed
    params = {k: v.clone() for k, v in a.model.state_dict().items()}
    b = engine("cuda", "b")
    _w, _l, losses_b, valid_b = epochs(b, 2)
    same = all(torch.equal(v, b.model.state_dict()[k]) for k, v in params.items())
    log(f"train {label}: second run losses {losses_b} valid {valid_b}; parameters equal {same}")
    if losses_b != losses or valid_b != valid or not same:
        raise AssertionError(f"train {label}: two runs from one seed differ")

    # a profiled warm epoch
    res["where"] = profile_pass(lambda: a._run_pass(a.train_loader, training=True),
                                a.train_loader, bounds(a.train_loader))
    log(f"train {label} breakdown " + json.dumps(res["where"]))

    # save, reload, resume
    path = os.path.join(tmp, f"{label}_a", "resume.pth.tar")
    a.save_model(path)
    r = NeuralNet(dataset, Net, pretrained_model=path, layout=layout, device="cuda",
                  outdir=os.path.join(tmp, f"{label}_r"))
    if not all(torch.equal(v, r.model.state_dict()[k]) for k, v in a.model.state_dict().items()):
        raise AssertionError(f"train {label}: the reloaded weights differ")
    state = r.optimizer.state_dict()["state"]
    steps = {float(s["step"]) for s in state.values()}
    if len(state) != len(list(r.model.parameters())) or steps != {3.0 * batches}:
        raise AssertionError(f"train {label}: reloaded Adam steps {steps}")
    resumed = r._run_pass(r.train_loader, training=True)[3]
    log(f"train {label}: reloaded {path}, Adam step {steps}; resumed epoch loss {resumed}")
    if not np.isfinite(resumed):
        raise AssertionError(f"train {label}: resumed loss {resumed}")
    return res


def attention_phase(dataset, tmp: str, seed: int) -> dict:
    """``functools.partial(GINet, attention=True)``, sparse, at full width:
    served from a reference-format checkpoint (4 K1 and 4 K2 launches per
    batch) and trained (8 K1 and 4 K2 per batch: K2's backward launches K1),
    both profiled, with every check of the training phase."""
    from deeprank_gnn_tpu_torch.models import GINet

    net = functools.partial(GINet, attention=True)
    ckpt = os.path.join(tmp, "ginet_attention_fold6_fnat.pth.tar")
    write_checkpoint(ckpt, seed, net)
    t0 = time.perf_counter()
    served = serve_check("attention", net, dataset, ckpt, tmp, "sparse",
                         {"sorted_segment_sum": 4, "sorted_scatter_gather": 4},
                         lambda ld: attention_bounds_per_batch(ld, False))
    log(f"phase serve attention: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trained = train_phase("attention", net, dataset, "sparse", seed, tmp,
                          {"sorted_segment_sum": 8, "sorted_scatter_gather": 4},
                          lambda ld: attention_bounds_per_batch(ld, True))
    log(f"phase train attention: {time.perf_counter() - t0:.1f} s")
    return {"serve": served, "train": trained}


def zoo_phase(dataset, tmp: str, seed: int) -> dict:
    """The other new paths at a smaller count: each served against its CPU
    run (two passes, then one profiled) and trained 4 Adam steps against
    the CPU and one epoch, with its launches per batch; the dense attention
    GINet also against the sparse one. The dense edge-to-slot paths run no
    hand kernel."""
    from deeprank_gnn_tpu_torch.models import FoutNet, GINet, sGAT

    attention = functools.partial(GINet, attention=True)
    paths = [
        ("attention_dense", attention, "dense", {}, {}),
        ("attention_sparse_small", attention, "sparse",
         {"sorted_segment_sum": 4, "sorted_scatter_gather": 4},
         {"sorted_segment_sum": 8, "sorted_scatter_gather": 4}),
        ("internal_tower", functools.partial(GINet, internal_tower=True), "sparse",
         {"sorted_segment_sum": 4}, {"sorted_segment_sum": 4}),
        ("foutnet_sparse", FoutNet, "sparse", {"sorted_segment_sum": 2},
         {"sorted_segment_sum": 2}),
        ("foutnet_dense", FoutNet, "dense", {}, {}),
        ("sgat_sparse", sGAT, "sparse", {"sorted_segment_sum": 2}, {"sorted_segment_sum": 2}),
        ("sgat_dense", sGAT, "dense", {}, {}),
    ]
    out = {}
    for label, net, layout, serve_per_batch, train_per_batch in paths:
        t0 = time.perf_counter()
        ckpt = os.path.join(tmp, f"{label}.pth.tar")
        write_checkpoint(ckpt, seed, net)
        served = serve_check(label, net, dataset, ckpt, tmp, layout, serve_per_batch,
                             lambda ld: {})
        trained = train_phase(label, net, dataset, layout, seed, tmp, train_per_batch)
        out[label] = {"serve": served, "train": trained}
        log(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    diff = np.abs(out["attention_dense"]["serve"]["pred"]
                  - out["attention_sparse_small"]["serve"]["pred"])
    log(f"serve attention: dense vs sparse on the card, max abs {diff.max()}")
    np.testing.assert_allclose(out["attention_dense"]["serve"]["pred"],
                               out["attention_sparse_small"]["serve"]["pred"], **TOL)
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--graphs", type=int, default=2048,
                    help="graphs of the paper-mode and attention GINet phases")
    ap.add_argument("--zoo-graphs", type=int, default=768,
                    help="graphs of the other new paths (at least 5 batches of 128 "
                         "give 4 training steps)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import deeprank_gnn_tpu_torch

    here = Path(__file__).resolve().parent
    if Path(deeprank_gnn_tpu_torch.__file__).resolve().parent.parent != here:
        raise RuntimeError(
            "deeprank_gnn_tpu_torch must come from this checkout "
            f"({here}), not {deeprank_gnn_tpu_torch.__file__}"
        )
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet
    from deeprank_gnn_tpu_torch.device import set_fp32_numerics
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.ops.kernels import build

    t_start = time.perf_counter()
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    set_fp32_numerics()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability {torch.cuda.get_device_capability(0)}")

    # 2. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        texts = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    for name, text in texts.items():
        build.load(name)
        log(f"build: {build.library_path(name).name} with {' '.join(build.NVCC_FLAGS)}")
        for line in text.strip().splitlines():
            log(f"  nvcc {name}: {line.strip()}")
    log(f"build: {len(KERNELS)} sources in {time.perf_counter() - t0:.2f} s")

    # 3. kernels, at the shapes of the paths' first batches
    graphs = build_graphs(args.seed, max(args.graphs, args.zoo_graphs))
    dataset = GraphListDataSet(graphs[: args.graphs])
    zoo = GraphListDataSet(graphs[: args.zoo_graphs])
    first_batch, _ = next(iter(GraphLoader(dataset, batch_size=BATCH)))
    first_dense, _ = next(iter(GraphLoader(dataset, batch_size=BATCH, layout="dense")))
    t0 = time.perf_counter()
    k1 = k1_phase(first_batch, args.seed)
    k3 = k3_phase(first_dense, args.seed)
    k2 = k2_phase(first_batch, args.seed)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 4. serve paper-mode GINet, both layouts
        t0 = time.perf_counter()
        served = serve_phase(dataset, tmp, args.seed)
        log(f"phase serve paper: {time.perf_counter() - t0:.1f} s")
        # 5. train paper-mode GINet, both layouts
        trained = {}
        for layout, per_batch, bounds in (
            ("sparse", {"sorted_segment_sum": 2},
             lambda ld: {"sorted_segment_sum": sparse_bound_per_batch(ld)}),
            ("dense", {"fused_gin_conv": 4},
             lambda ld: {"fused_gin_conv": dense_bound_per_batch(ld, True)}),
        ):
            t0 = time.perf_counter()
            trained[layout] = train_phase(layout, GINet, dataset, layout, args.seed, tmp,
                                          per_batch, bounds)
            log(f"phase train {layout}: {time.perf_counter() - t0:.1f} s")
        # 6. attention GINet, sparse, full width: serve and train
        att = attention_phase(dataset, tmp, args.seed)
        # 7. the other new paths
        zoo_out = zoo_phase(zoo, tmp, args.seed)

    k1_main = [r for r in k1 if "ms" in r]
    k3_main = [r for r in k3 if "ms_fwd" in r]
    k2_path = [r for r in k2 if r["case"] in ("conv1", "conv2")]
    k2_bench = next(r for r in k2 if r["case"] == "bench")
    s_where, d_where = served["sparse"]["where"], served["dense"]["where"]
    t_sparse, t_dense = trained["sparse"]["where"], trained["dense"]["where"]
    a_serve, a_train = att["serve"]["where"], att["train"]["where"]
    line = {"kernels": [
        {
            "name": "sorted_segment_sum",
            **KERNELS["sorted_segment_sum"],
            # the paper-mode sparse serving pass (slice 1's main path)
            "launches": served["sparse"]["launches"]["sorted_segment_sum"],
            "max_abs_err": max(r["max_abs_err"] for r in k1),
            # one call at each conv level's shape of the first served batch,
            # L2 flushed before each call
            "ms": sum(r["ms"] for r in k1_main),
            "plain_ms": sum(r["plain_ms"] for r in k1_main),
            "bound_ms": sum(r["bound_ms"] for r in k1_main),
            "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in k1_main),
            # the profiled passes: device time per batch and its bound
            "served_ms_per_batch": s_where["sorted_segment_sum_ms_per_batch"],
            "served_bound_ms_per_batch": s_where["sorted_segment_sum_bound_ms_per_batch"],
            "train_launches": trained["sparse"]["launches"]["sorted_segment_sum"],
            "train_ms_per_batch": t_sparse["sorted_segment_sum_ms_per_batch"],
            "train_bound_ms_per_batch": t_sparse["sorted_segment_sum_bound_ms_per_batch"],
            # the attention path: 4 launches per served batch, 8 per trained
            "attention_serve_launches": att["serve"]["launches"]["sorted_segment_sum"],
            "attention_served_ms_per_batch": a_serve["sorted_segment_sum_ms_per_batch"],
            "attention_served_bound_ms_per_batch":
                a_serve["sorted_segment_sum_bound_ms_per_batch"],
            "attention_train_launches": att["train"]["launches"]["sorted_segment_sum"],
            "attention_train_ms_per_batch": a_train["sorted_segment_sum_ms_per_batch"],
            "attention_train_bound_ms_per_batch":
                a_train["sorted_segment_sum_bound_ms_per_batch"],
            # the same two calls with their inputs L2-resident (graph replay)
            "l2_warm_ms": sum(r["l2_warm_ms"] for r in k1_main),
            # eager per-call time, the host's launch cost included
            "call_ms": sum(r["call_ms"] for r in k1_main),
            "shapes": [{k: r[k] for k in ("case", "E", "E_valid", "N", "F", "ms", "plain_ms",
                                          "library_ms", "bound_ms", "l2_warm_ms", "call_ms")}
                       for r in k1_main],
        },
        {
            "name": "fused_gin_conv",
            **KERNELS["fused_gin_conv"],
            # the dense training epoch (slice 2's main path): 2 forward
            # and 2 backward launches per batch
            "launches": trained["dense"]["launches"]["fused_gin_conv"],
            "max_abs_err": max(r["max_abs_err"] for r in k3),
            # the 4 calls of one training batch at the first dense batch's
            # shapes (conv1 and conv2, forward and backward), L2 flushed
            # before each call
            "ms": sum(r["ms_fwd"] + r["ms_bwd"] for r in k3_main),
            "plain_ms": sum(r["plain_ms_fwd"] + r["plain_ms_bwd"] for r in k3_main),
            "bound_ms": sum(r["bound_ms_fwd"] + r["bound_ms_bwd"] for r in k3_main),
            "bound_by": "bytes",
            # no one PyTorch call computes K3: index_select + index_add_
            # on prepared flat indices, into a zero-filled output
            "library_ms": sum(r["library_ms_fwd"] + r["library_ms_bwd"] for r in k3_main),
            "library_call": "index_select + index_add_ (two calls, zero-filled output)",
            "train_ms_per_batch": t_dense["fused_gin_conv_ms_per_batch"],
            "train_bound_ms_per_batch": t_dense["fused_gin_conv_bound_ms_per_batch"],
            "serve_launches": served["dense"]["launches"]["fused_gin_conv"],
            "served_ms_per_batch": d_where["fused_gin_conv_ms_per_batch"],
            "served_bound_ms_per_batch": d_where["fused_gin_conv_bound_ms_per_batch"],
            "shapes": [{k: r[k] for k in ("case", "G", "S", "F", "E", "E_valid", "ms_fwd",
                                          "ms_bwd", "plain_ms_fwd", "plain_ms_bwd",
                                          "library_ms_fwd", "library_ms_bwd", "bound_ms_fwd",
                                          "bound_ms_bwd", "l2_warm_ms_fwd", "l2_warm_ms_bwd",
                                          "call_ms_fwd", "rows_per_block", "blocks_per_graph",
                                          "smem_bytes", "blocks_per_sm")}
                       for r in k3_main],
        },
        {
            "name": "sorted_scatter_gather",
            **KERNELS["sorted_scatter_gather"],
            # the attention GINet's sparse serving pass (this slice's main
            # path): one launch per conv and tower, 4 per batch
            "launches": att["serve"]["launches"]["sorted_scatter_gather"],
            "max_abs_err": max(r["max_abs_err"] for r in k2),
            # one call at each softmax shape of the first served batch
            # (conv1 over the interface edges, conv2 over the pooled ones,
            # F = 1), L2 flushed before each call
            "ms": sum(r["ms"] for r in k2_path),
            "plain_ms": sum(r["plain_ms"] for r in k2_path),
            "bound_ms": sum(r["bound_ms"] for r in k2_path),
            "bound_by": "bytes",
            # no one PyTorch call computes K2: torch.segment_reduce, then
            # index_select of the sums at the valid edges' rows
            "library_ms": sum(r["library_ms"] for r in k2_path),
            "library_call": "torch.segment_reduce + index_select (two calls, prepared indices)",
            "served_ms_per_batch": a_serve["sorted_scatter_gather_ms_per_batch"],
            "served_bound_ms_per_batch": a_serve["sorted_scatter_gather_bound_ms_per_batch"],
            "train_launches": att["train"]["launches"]["sorted_scatter_gather"],
            "train_ms_per_batch": a_train["sorted_scatter_gather_ms_per_batch"],
            "train_bound_ms_per_batch": a_train["sorted_scatter_gather_bound_ms_per_batch"],
            "l2_warm_ms": sum(r["l2_warm_ms"] for r in k2_path),
            "call_ms": sum(r["call_ms"] for r in k2_path),
            # bench.py's bench_spmm_kernel shapes (N 81,920, E 983,040, F 16)
            "bench_shapes": {k: k2_bench[k] for k in ("E", "N", "F", "ms", "plain_ms",
                                                       "library_ms", "bound_ms", "l2_warm_ms",
                                                       "call_ms")},
            "shapes": [{k: r[k] for k in ("case", "E", "E_valid", "N", "F", "ms", "plain_ms",
                                          "library_ms", "bound_ms", "l2_warm_ms", "call_ms")}
                       for r in k2_path],
        },
    ]}
    passes = {f"serve_{k}": v for k, v in served.items()}
    passes.update({f"train_{k}": v for k, v in trained.items()})
    passes.update(serve_attention=att["serve"], train_attention=att["train"])
    for label, v in zoo_out.items():
        passes.update({f"serve_{label}": v["serve"], f"train_{label}": v["train"]})
    summary = {}
    for label, v in passes.items():
        count = len(v["pred"]) if label.startswith("serve") else v["graphs"]
        summary[label] = {"graphs_per_s": [count / w for w in v["walls"]],
                          "launches": v["launches"]}
        if v["where"] is not None:
            summary[label]["device_idle_share"] = v["where"]["device_idle_share"]
    log("summary " + json.dumps(summary))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

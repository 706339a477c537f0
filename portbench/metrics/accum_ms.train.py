"""Device milliseconds a training step in PyTorch's index accumulation: the
profiled passes' operations among the trace's ten that took most
(``breakdown.device_ops``) whose names hold ``indexing_backward_kernel``
(``indexing_backward_kernel_stride_1``, ``_small_stride``: the sum over each
run of equal indices that ``index_add_`` and ``index_put_(accumulate=True)``
launch under deterministic algorithms, as ``ops/lanes.py``
``index_add_rows`` and the ``scatter_add_`` of a max pool's backward do) or
``DeviceRadixSort`` (cub's ``DeviceRadixSortOnesweepKernel`` and its
histogram and scan kernels: the sort of the indices that it waits on). On
the CPU, where the harness's own tests run, the host's ``aten::index_add_``
and ``aten::index_put_`` entries stand in. 0.0 where none is among the
ten."""

MOVES = "train_graphs_per_s"
NAMES = ("indexing_backward_kernel", "DeviceRadixSort", "aten::index_add", "aten::index_put")


def read(ctx):
    if ctx.mode != "train":
        return None
    p = ctx.rec["profile"]
    seconds = sum(s for name, s in p["device_ops"] if any(n in name for n in NAMES))
    return 1e3 * seconds / p["steps"]

"""The port's padding rule: no accumulating op sees a run of padding lanes.

Under ``torch.use_deterministic_algorithms(True)`` an accumulating op on the
card (``index_add``, ``index_put_`` with ``accumulate=True``, ``scatter_add``,
``scatter_reduce``, and ``index_select``'s backward, which is an
``index_add``) sorts its indices and sums each run of equal ones serially.
A padded batch's padding lanes all carry one sentinel index, so an op that
takes them as they are sums a run as long as the batch's padding.

- ``test_no_padding_run``: one training step (forward, loss, backward) of
  each path at a small width, on the CPU, under a ``TorchDispatchMode`` that
  records the indices every accumulating op receives: the longest run of
  equal indices is at most the batch's largest real group (a degree, a
  cluster's size, a graph's clusters), never its padding;
- ``test_step_bitwise_old_forms``: the same step with the ops' old plain
  forms (written out in ``chip_smoke.py``, which holds them against the new
  ops on the card too, as they stood before the rule) swapped in gives the
  same loss and gradients, ``torch.equal`` (which holds across the sign of
  a zero): the repaired ops only stop adding zeros;
- ``test_repaired_op_bitwise_old_form``: each repaired op against its old
  form on its own, forward and gradient, with ties and empty slots;
- ``test_forward_only_bitwise_training_forward``: each op with a gradient
  run without one (as serving runs it) bitwise its training forward.

``member_max_pool``'s backward against the JAX package's VJP is in
``tests/test_torch_dense.py``.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from chip_smoke import (
    PADDING_PATHS,
    old_dense_segment_softmax,
    old_forms,
    old_gather,
    old_gather_nodes,
    old_k1_plain,
    old_k3_plain,
    old_member_max_pool,
    old_segment_count,
    old_segment_max,
    old_segment_mean,
    old_segment_softmax,
    old_segment_sum,
    training_step,
)
from test_torch_data import datasets, write_graphs_hdf5

NUM_GRAPHS = 6


# ---------------------------------------------------------------------------
# the runs each accumulating op receives


def _longest_run(keys: torch.Tensor) -> int:
    """Most lanes sharing one key; ``keys [L, K]`` int64."""
    if keys.shape[0] == 0:
        return 0
    return int(torch.unique(keys, dim=0, return_counts=True)[1].max())


def _scatter_keys(index: torch.Tensor, dim: int) -> torch.Tensor:
    """(index, position off ``dim``) of every lane of a scatter's index."""
    idx = index.movedim(dim, 0).reshape(index.shape[dim], -1).long()
    other = torch.arange(idx.shape[1]).expand_as(idx)
    return torch.stack([idx.reshape(-1), other.reshape(-1)], dim=1)


class AccumulationRuns(TorchDispatchMode):
    """Records ``(op, longest run of equal indices)`` for every accumulating
    op issued under it."""

    def __init__(self):
        super().__init__()
        self.runs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in ("index_add", "index_add_"):
            self.runs.append((name, _longest_run(args[2].long()[:, None])))
        elif name in ("index_put", "index_put_", "_index_put_impl", "_index_put_impl_"):
            accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
            if accumulate:
                parts = [i.long().reshape(-1) for i in torch.broadcast_tensors(
                    *[i for i in args[1] if i is not None])]
                self.runs.append((name, _longest_run(torch.stack(parts, dim=1))))
        elif name in ("scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_"):
            self.runs.append((name, _longest_run(_scatter_keys(args[2], args[1]))))
        return func(*args, **kwargs)


def _counts_max(values: torch.Tensor, valid: torch.Tensor) -> int:
    v = values[valid].long()
    return int(torch.bincount(v - v.min()).max()) if v.numel() else 0


def largest_real_group(b) -> int:
    """The batch's largest real group: a degree (either end of any edge
    family, real edges only), edges merged into a pooled edge, a cluster's
    members, a graph's level-1 clusters (the readout's mean)."""
    from deeprank_gnn_tpu_torch.data.dense_batch import DenseGraphBatch

    if isinstance(b, DenseGraphBatch):
        g = b.x.shape[0]

        def per_graph(idx, mask):
            keyed = idx.long() + torch.arange(g)[:, None] * (int(idx.max()) + 1)
            return _counts_max(keyed.reshape(-1), mask.reshape(-1))

        groups = [per_graph(b.row, b.edge_mask), per_graph(b.col, b.edge_mask),
                  per_graph(b.pe_row, b.pe_mask), per_graph(b.pe_col, b.pe_mask),
                  per_graph(b.edge_to_pe, b.edge_mask & (b.edge_to_pe < b.pe_row.shape[1])),
                  per_graph(b.assign0, b.node_mask), per_graph(b.assign1, b.pool0_mask)]
        return max(groups)
    groups = [
        _counts_max(b.edge_index[0], b.edge_mask), _counts_max(b.edge_index[1], b.edge_mask),
        _counts_max(b.iedge_index[0], b.iedge_mask), _counts_max(b.iedge_index[1], b.iedge_mask),
        _counts_max(b.pe_index[0], b.pe_mask), _counts_max(b.pe_index[1], b.pe_mask),
        _counts_max(b.pie_index[0], b.pie_mask), _counts_max(b.pie_index[1], b.pie_mask),
        _counts_max(b.edge_to_pe, b.edge_mask & (b.edge_to_pe < b.pe_index.shape[1])),
        _counts_max(b.iedge_to_pie, b.iedge_mask & (b.iedge_to_pie < b.pie_index.shape[1])),
        _counts_max(b.assign0, b.node_mask), _counts_max(b.assign1, b.pool0_mask),
        _counts_max(b.pool1_graph, b.pool1_mask),
    ]
    return max(groups)


def largest_padding(b) -> int:
    """The batch's largest padding of one axis (lanes sharing a sentinel
    under the old forms): what a run of padding would be."""
    from deeprank_gnn_tpu_torch.data.dense_batch import DenseGraphBatch

    if isinstance(b, DenseGraphBatch):
        return int(max((~b.edge_mask).sum(1).max(), (~b.pe_mask).sum(1).max()))
    return int(max((~b.edge_mask).sum(), (~b.pe_mask).sum(), (~b.node_mask).sum()))


# ---------------------------------------------------------------------------
# the paths


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    from deeprank_gnn_tpu_torch.data.batch import collate
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense

    path = write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_padding") / "g.hdf5"), num_graphs=NUM_GRAPHS,
        seed=21)
    _, tds = datasets(path)
    tg = [tds.get(i) for i in range(len(tds))]
    return {"sparse": collate(tg, g_pad=8)[0], "dense": collate_dense(tg, g_pad=8)[0],
            "store": collate_dense(tg, g_pad=8, precompute_ops=True)[0]}


def step(batch, name, kw):
    return training_step(batch, name, kw, 0, "cpu")


@pytest.mark.parametrize("path", PADDING_PATHS, ids=[p[0] for p in PADDING_PATHS])
def test_no_padding_run(batches, path):
    label, name, kw, layout = path
    b = batches[layout]
    bound = largest_real_group(b)
    # the batch must have more padding than real group size, or the test
    # could not tell the two apart
    assert largest_padding(b) > bound, (largest_padding(b), bound)
    with AccumulationRuns() as mode:
        loss, grads = step(b, name, kw)
    assert torch.isfinite(loss) and grads
    worst = max(mode.runs, key=lambda r: r[1], default=("none", 0))
    assert worst[1] <= bound, (label, worst, bound, mode.runs)


@pytest.mark.parametrize("path", PADDING_PATHS, ids=[p[0] for p in PADDING_PATHS])
def test_step_bitwise_old_forms(batches, path):
    label, name, kw, layout = path
    loss, grads = step(batches[layout], name, kw)
    with old_forms():
        old_loss, old_grads = step(batches[layout], name, kw)
    assert torch.equal(loss, old_loss), label
    assert grads.keys() == old_grads.keys()
    for k in grads:
        assert torch.equal(grads[k], old_grads[k]), (label, k)


def _grad(fn, x, cot):
    x = x.clone().requires_grad_(True)
    out = fn(x)
    out.backward(cot)
    return out.detach(), x.grad


def _pool_case(rng, g=3, s=24, f=4, c=6, m=7):
    """Small integers (ties), a cluster left empty, padding nodes."""
    h = torch.from_numpy(rng.integers(-2, 3, (g, s, f)).astype(np.float32))
    assign = np.full((g, s), c, dtype=np.int32)
    mem = np.full((g, c, m), s, dtype=np.int32)
    for gi in range(g):
        nodes = rng.permutation(s)[: s - 4]
        clusters = rng.integers(0, c - 1, nodes.shape[0])  # cluster c - 1 stays empty
        for ci in range(c):
            members = np.sort(nodes[clusters == ci])[:m]
            mem[gi, ci, : len(members)] = members
            assign[gi, members] = ci
    return h, torch.from_numpy(assign), torch.from_numpy(mem)


OPS = ["gather", "gather_fill", "gather_nodes", "segment_sum", "segment_count",
       "segment_max", "segment_softmax", "segment_softmax_csr", "slot_max_pool",
       "member_max_pool", "dense_segment_softmax", "k1_plain", "k3_plain", "segment_mean"]
# the ops with a gradient, which skip what only their backward needs when
# no gradient is recorded
GRAD_OPS = [op for op in OPS if op not in ("segment_count", "k1_plain", "k3_plain")]


def _op_case(op):
    """``(new, old, (x, cotangent))`` of a repaired op with a gradient, its
    old form and its inputs; for one without, its check is made here and
    the result is None."""
    from deeprank_gnn_tpu_torch.ops import dense as D
    from deeprank_gnn_tpu_torch.ops import segment as S
    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import fused_gin_conv_plain
    from deeprank_gnn_tpu_torch.ops.kernels.segment import sorted_segment_sum_plain

    rng = np.random.default_rng(OPS.index(op))
    n, e, f = 12, 40, 3
    # sorted ids with padding at the end and rows without entries
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    ids[ids == 5] = 6
    ids[-12:] = n
    ids_t = torch.from_numpy(ids)
    row_ptr = torch.from_numpy(np.searchsorted(ids, np.arange(n + 1)).astype(np.int32))
    valid = ids_t < n
    x = torch.from_numpy(rng.integers(-2, 3, (e, f)).astype(np.float32))
    nodes = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    col = torch.from_numpy(np.where(ids < n, rng.integers(0, n, e), n).astype(np.int32))
    edge_cot = torch.from_numpy(rng.standard_normal((e, f)).astype(np.float32))
    edge_cot = edge_cot * valid[:, None]  # the callers' masks: 0 at padding
    h, assign, mem = _pool_case(rng)
    if op == "gather":
        new, old = (lambda t: S.gather(t, col)), (lambda t: old_gather(t, col))
        args = (nodes, edge_cot)
    elif op == "gather_fill":
        new = lambda t: S.gather(t, ids_t, fill=0.0)  # noqa: E731
        old = lambda t: old_gather(t, ids_t, fill=0.0)  # noqa: E731
        args = (nodes[:, 0], torch.from_numpy(rng.standard_normal(e).astype(np.float32)))
    elif op == "gather_nodes":
        idx = torch.from_numpy(rng.integers(0, 30, (3, 40)).astype(np.int32))  # >= 24: padding
        cot = torch.from_numpy(rng.standard_normal((3, 40, 4)).astype(np.float32))
        new, old = (lambda t: D.gather_nodes(t, idx)), (lambda t: old_gather_nodes(t, idx))
        args = (h, cot * (idx < 24)[..., None])
    elif op == "segment_sum":
        new, old = (lambda t: S.segment_sum(t, ids_t, n)), (lambda t: old_segment_sum(t, ids_t, n))
        args = (x, torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)))
    elif op == "segment_count":
        assert torch.equal(S.segment_count(ids_t, n), old_segment_count(ids_t, n))
        assert torch.equal(S.segment_count(ids_t, n, row_ptr), old_segment_count(ids_t, n))
        return None
    elif op == "segment_max":
        new = lambda t: S.segment_max(t, ids_t, n)  # noqa: E731
        old = lambda t: old_segment_max(t, ids_t, n)  # noqa: E731
        args = (x, torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)))
        assert torch.equal(S.segment_max(x, ids_t, n, row_ptr=row_ptr), old(x))
    elif op in ("segment_softmax", "segment_softmax_csr"):
        ptr = row_ptr if op.endswith("csr") else None
        new = lambda t: S.segment_softmax(t, ids_t, n, row_ptr=ptr)  # noqa: E731
        old = lambda t: old_segment_softmax(t, ids_t, n, row_ptr=ptr)  # noqa: E731
        args = (x[:, 0], edge_cot[:, 0])
    elif op == "slot_max_pool":
        cot = torch.from_numpy(rng.standard_normal((3, 6, 4)).astype(np.float32))
        new = lambda t: D.slot_max_pool(t, assign, 6)  # noqa: E731

        def old(t):
            g, s, ff = t.shape
            gid = torch.arange(g, dtype=assign.dtype)[:, None]
            flat = torch.where((assign >= 0) & (assign < 6), assign + gid * 6, g * 6)
            return old_segment_max(t.reshape(g * s, ff), flat.reshape(-1), g * 6).reshape(g, 6, ff)

        args = (h, cot)
    elif op == "member_max_pool":
        cot = torch.from_numpy(rng.standard_normal((3, 6, 4)).astype(np.float32))
        new = lambda t: D.member_max_pool(t, mem, assign)  # noqa: E731
        old = lambda t: old_member_max_pool(t, mem)  # noqa: E731
        args = (h, cot)
    elif op == "dense_segment_softmax":
        idx = torch.from_numpy(rng.integers(0, 9, (3, 40)).astype(np.int32))  # >= 7: padding
        logits = torch.from_numpy(rng.integers(-2, 3, (3, 40)).astype(np.float32))
        cot = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32)) * (idx < 7)
        new = lambda t: D.dense_segment_softmax(t, idx, 7)  # noqa: E731
        old = lambda t: old_dense_segment_softmax(t, idx, 7)  # noqa: E731
        args = (logits, cot)
    elif op == "k1_plain":
        assert torch.equal(sorted_segment_sum_plain(x, row_ptr), old_k1_plain(x, row_ptr))
        return None
    elif op == "segment_mean":
        new = lambda t: S.segment_mean(t, ids_t, n)  # noqa: E731
        old = lambda t: old_segment_mean(t, ids_t, n)  # noqa: E731
        args = (x, torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)))
    else:
        row = torch.from_numpy(rng.integers(-1, 26, (3, 60)).astype(np.int32))
        kcol = torch.from_numpy(rng.integers(0, 26, (3, 60)).astype(np.int32))
        assert torch.equal(fused_gin_conv_plain(h, row, kcol), old_k3_plain(h, row, kcol))
        return None
    return new, old, args


@pytest.mark.parametrize("op", OPS)
def test_repaired_op_bitwise_old_form(op):
    case = _op_case(op)
    if case is None:  # checked in _op_case
        return
    new, old, args = case
    got, got_grad = _grad(new, *args)
    want, want_grad = _grad(old, *args)
    assert torch.equal(got, want)
    assert torch.equal(got_grad, want_grad)


@pytest.mark.parametrize("op", GRAD_OPS)
def test_forward_only_bitwise_training_forward(op):
    """Without a gradient (serving, under ``inference_mode``) an op skips
    what only its backward needs (a member pool's tie counts, a gather's
    valid lanes): its result is bitwise the training forward's."""
    new, _old, (x, _cot) = _op_case(op)
    want = new(x.clone().requires_grad_(True)).detach()
    with torch.inference_mode():
        got = new(x)
    assert torch.equal(got, want)

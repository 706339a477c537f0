"""K4, the dense attention conv (``ops/kernels/attention_conv.py``).

On the CPU:

- the conv's plain version, through ``models.ginet.ginet_conv_dense`` (the
  scalars ``p``, ``q``, ``b`` in torch, then the plain version), against the
  composition it replaced (two ``gather_nodes``, the logits' ``cat`` and
  linear, ``dense_segment_softmax``, ``edge_sum_to_slots``) in float64 to
  1e-12: the output and the gradients of ``x``, ``fc``, ``fc_attention`` and
  ``fc_edge_attr``, on graphs with padding lanes, a node without in-edges,
  tied logits and a padded graph slot;
- ``attention_csr``'s plain version against ``torch.sort(stable=True)`` and
  against each row's lanes listed in ascending order;
- the conv's plain version counts nothing in ``ACCUMULATED``; the wrappers
  raise on a device they do not take, and the plain version reads no CSR
  (the same numbers without them).

On a card (``cuda`` marker; skipped here): the kernels at the atomic cell's
shapes (conv1 ``[64, 5,216, 16]`` over ~30,080 unsorted lanes a graph,
conv2 ``[64, 640, 32]`` over sorted pooled-edge rows) against the plain
version, two runs bitwise equal, a CUDA-graph replay equal to the eager
calls, and the launches a training step and a scoring batch make.
``python -m pytest --noconftest -m cuda tests/test_torch_attention_conv.py``
on the card's machine (its ``conftest.py`` imports JAX, which that machine
lacks).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from deeprank_gnn_tpu_torch.ops.kernels import attention_conv as K

S, E = 10, 40
NO_IN_EDGES, TIED_ROW, TIED_COL = 5, 7, 2


def _lanes(seed: int):
    """row, col [3, E] int32 and edge attributes [3, E, 1]: graph 0 with 30
    real lanes, node 5 no lane's row, node 7 two lanes from node 2 with one
    attribute (tied logits), slot 9 no node's; graph 1 with 36; graph 2 a
    padded graph slot (every lane padding, row = col = S)."""
    rng = np.random.default_rng(seed)
    row = np.full((3, E), S, dtype=np.int32)
    col = np.full((3, E), S, dtype=np.int32)
    attr = rng.random((3, E, 1))
    for g, n in ((0, 30), (1, 36)):
        r = rng.choice([k for k in range(S - 1) if k != NO_IN_EDGES], n)
        c = rng.integers(0, S - 1, n)
        r[:2], c[:2] = TIED_ROW, TIED_COL
        attr[g, 1] = attr[g, 0]
        row[g, :n], col[g, :n] = r, c
    return torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(attr)


def _old_conv(conv, x, row, col, edge_attr, size):
    """The dense attention conv as the port ran it before K4."""
    from deeprank_gnn_tpu_torch.models.common import linear
    from deeprank_gnn_tpu_torch.ops.dense import (
        dense_segment_softmax,
        edge_sum_to_slots,
        gather_nodes,
    )

    xw = linear(x, conv.fc.weight)
    msg = gather_nodes(xw, col)
    xrow = gather_nodes(xw, row)
    ed = linear(edge_attr, conv.fc_edge_attr.weight)
    logits = linear(torch.cat([xrow, msg, ed], dim=-1), conv.fc_attention.weight)
    alpha = dense_segment_softmax(F.leaky_relu(logits[..., 0]), row, size)
    return edge_sum_to_slots(msg * alpha[..., None], row, size)


def _conv_grads(fn, conv, x, cot):
    x = x.clone().requires_grad_(True)
    for prm in conv.parameters():
        prm.grad = None
    out = fn(x)
    (out * cot).sum().backward()
    grads = {"x": x.grad, **{k: v.grad.clone() for k, v in conv.named_parameters()}}
    return out.detach(), grads


def _close(got, want, rtol):
    """Within ``rtol`` of each element, or of the tensor's largest where an
    element cancels to ~0."""
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * float(want.abs().max()))


@pytest.mark.parametrize("widths", [(48, 16), (16, 32), (7, 5)], ids=["conv1", "conv2", "odd"])
def test_plain_matches_the_old_composition(widths):
    from deeprank_gnn_tpu_torch.models.ginet import GINetConvLayer, ginet_conv_dense

    f_in, f_out = widths
    conv = GINetConvLayer(f_in, f_out, 1, torch.Generator().manual_seed(3)).double()
    row, col, attr = _lanes(11)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((3, S, f_in)))
    cot = torch.from_numpy(np.random.default_rng(6).standard_normal((3, S, f_out)))
    by_row, by_col = K.attention_csr(row, col, S), K.attention_csr(col, row, S)
    got, got_g = _conv_grads(
        lambda v: ginet_conv_dense(conv, v, row, col, attr, by_row, by_col), conv, x, cot)
    want, want_g = _conv_grads(lambda v: _old_conv(conv, v, row, col, attr, S), conv, x, cot)
    _close(got, want, 1e-12)
    assert set(got_g) == {"x", "fc.weight", "fc_edge_attr.weight", "fc_attention.weight"}
    for k in want_g:
        _close(got_g[k], want_g[k], 1e-12)
    # the node without in-edges gives 0; the padded graph slot gives 0
    assert not got[0, NO_IN_EDGES].any() and not got[2].any()
    # the tied lanes take the same weight
    _, alpha = K.fused_attention_conv_plain(*_scalars(conv, x, attr), row, col)
    assert alpha[0, 0] == alpha[0, 1] and alpha[0, 0] > 0
    assert not alpha[2].any() and not alpha[0, 30:].any()


def _scalars(conv, x, attr):
    from deeprank_gnn_tpu_torch.models.common import linear

    xw = linear(x, conv.fc.weight)
    f = xw.shape[-1]
    a = conv.fc_attention.weight[0]
    return (xw, xw @ a[:f], xw @ a[f:2 * f],
            linear(attr, conv.fc_edge_attr.weight) @ a[2 * f:])


def test_csr_plain_is_a_stable_sort():
    rng = np.random.default_rng(7)
    g, e, s = 4, 300, 23
    key = rng.integers(-1, s + 2, (g, e)).astype(np.int32)  # ties, and lanes out of range
    other = rng.integers(0, s + 1, (g, e)).astype(np.int32)  # some out of range: dropped
    key[3] = s  # a padded graph slot
    csr = K.attention_csr(torch.from_numpy(key), torch.from_numpy(other), s)
    assert csr.ptr.dtype == csr.perm.dtype == torch.int32
    assert csr.ptr.shape == (g, s + 1) and csr.perm.shape == (g, e)
    kept = (key >= 0) & (key < s) & (other >= 0) & (other < s)
    bucket = torch.from_numpy(np.where(kept, key, s).astype(np.int64))
    assert torch.equal(csr.perm.long(), torch.sort(bucket, dim=1, stable=True).indices)
    for gi in range(g):
        ptr, perm = csr.ptr[gi].numpy(), csr.perm[gi].numpy()
        for k in range(s):
            assert perm[ptr[k]:ptr[k + 1]].tolist() == np.flatnonzero(
                kept[gi] & (key[gi] == k)).tolist()
        assert perm[ptr[s]:].tolist() == np.flatnonzero(~kept[gi]).tolist()
    assert csr.ptr[3].tolist() == [0] * (s + 1)


def test_plain_counts_no_accumulation():
    from deeprank_gnn_tpu_torch.ops.lanes import ACCUMULATED

    row, col, attr = _lanes(12)
    rng = np.random.default_rng(8)
    xw = torch.from_numpy(rng.standard_normal((3, S, 4))).requires_grad_(True)
    p = torch.from_numpy(rng.standard_normal((3, S))).requires_grad_(True)
    q = torch.from_numpy(rng.standard_normal((3, S))).requires_grad_(True)
    b = attr[..., 0].clone().requires_grad_(True)
    before = Counter(ACCUMULATED)
    out = K.fused_attention_conv(xw, p, q, b, row, col, K.attention_csr(row, col, S),
                                 K.attention_csr(col, row, S))
    out.sum().backward()
    assert Counter(ACCUMULATED) == before
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (xw, p, q, b))
    # the dropped lanes and the padded graph take no gradient
    assert not b.grad[0, 30:].any() and not b.grad[2].any()


def test_wrappers_raise_on_what_they_do_not_take():
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES

    launches = dict(LAUNCHES)
    idx = torch.zeros((2, 7), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        K.attention_csr(idx, idx, 4)
    csr = K.AttentionCSR(torch.zeros((2, 5), dtype=torch.int32, device="meta"), idx)
    xw = torch.empty((2, 4, 3), device="meta")
    pq, b = torch.empty((2, 4), device="meta"), torch.empty((2, 7), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        K.fused_attention_conv_forward(xw, pq, pq, b, idx, idx, csr)
    with pytest.raises(ValueError, match=r"b: want \(2, 7\)"):
        K.fused_attention_conv_forward(xw, pq, pq, b[:, :3], idx, idx, csr)
    with pytest.raises(ValueError, match="key, other"):
        K.attention_csr(idx, idx[:, :3], 4)
    row, col, attr = _lanes(13)
    rng = np.random.default_rng(9)
    pq = torch.from_numpy(rng.standard_normal((3, S)))
    values = torch.from_numpy(rng.standard_normal((3, S, 4)))
    runs = []
    for csrs in ((), (K.attention_csr(row, col, S), K.attention_csr(col, row, S))):
        xw = values.clone().requires_grad_(True)
        out = K.fused_attention_conv(xw, pq, pq, attr[..., 0], row, col, *csrs)
        (out * torch.arange(4.0, dtype=torch.float64)).sum().backward()
        runs.append((out.detach(), xw.grad))
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    assert dict(LAUNCHES) == launches


# ---------------------------------------------------------------------------
# on the card

# conv1: 64 graphs of 2,560 nodes in 5,216 run-padded slots, 30,000 real
# lanes of 30,080, unsorted; conv2: 640 cluster slots, ~28,300 pooled edges
# of 28,416, sorted by row (the atomic cell's store batches)
CELL_CASES = {"conv1": (64, 5216, 16, 30080, 30000, 2560, False),
              "conv2": (64, 640, 32, 28416, 28300, 640, True)}


def cell_inputs(case: str, seed: int, device):
    """xw, p, q, b, row, col at a case of :data:`CELL_CASES`: the real
    lanes' rows and cols drawn among ``real`` slots (a random subset of the
    ``S``), a few lanes repeated (tied logits), the rest padding (``S``)."""
    g, s, f, e, e_real, real, sort_rows = CELL_CASES[case]
    rng = np.random.default_rng(seed)
    row = np.full((g, e), s, dtype=np.int32)
    col = np.full((g, e), s, dtype=np.int32)
    for gi in range(g):
        slots = np.sort(rng.choice(s, real, replace=False))
        r, c = slots[rng.integers(0, real, e_real)], slots[rng.integers(0, real, e_real)]
        r[1::97], c[1::97] = r[::97][:len(r[1::97])], c[::97][:len(c[1::97])]
        if sort_rows:
            order = np.lexsort((c, r))
            r, c = r[order], c[order]
        row[gi, :e_real], col[gi, :e_real] = r, c
    xw = rng.standard_normal((g, s, f)).astype(np.float32)
    p = (0.3 * rng.standard_normal((g, s))).astype(np.float32)
    q = (0.3 * rng.standard_normal((g, s))).astype(np.float32)
    b = (0.05 * rng.standard_normal((g, e))).astype(np.float32)
    b[:, 1::97] = b[:, ::97][:, :b[:, 1::97].shape[1]]
    dout = rng.standard_normal((g, s, f)).astype(np.float32)
    return [torch.from_numpy(v).to(device) for v in (xw, p, q, b, row, col, dout)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 runs only on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CELL_CASES))
def test_k4_cuda_matches_plain(case):
    """The CSRs bitwise the plain version on the CPU; two runs bitwise
    equal. Against the plain version run on the card: ``out`` and ``alpha``
    bitwise at every row of fewer than 32 lanes and its lanes (the same fp32
    operations in the same order, ``expf`` on both sides); at a row of 32
    lanes or more the card's ``index_add_`` (its kernel for one column, the
    softmax's denominator) adds each 32 lanes' share of the run by a warp's
    tree where the kernel, as the CPU, adds in lane order, so there and in
    what reads those weights (``dxw``) the two are held within 1e-6 of the
    tensor's largest element. ``db``, ``dp`` and ``dq`` within 1e-5 of it:
    ``dA_e``'s dot product of F products adds in column order in the kernel
    and in torch's reduction order on the other side, a few ulp apart, and
    ``alpha (dA - s)`` can cancel."""
    _need_card()
    from deeprank_gnn_tpu_torch.device import deterministic

    xw, p, q, b, row, col, dout = cell_inputs(case, 17, "cuda")
    s = xw.shape[1]
    by_row, by_col = K.attention_csr(row, col, s), K.attention_csr(col, row, s)
    for got, want in ((by_row, K.attention_csr_plain(row.cpu(), col.cpu(), s)),
                      (by_col, K.attention_csr_plain(col.cpu(), row.cpu(), s))):
        assert torch.equal(got.ptr.cpu(), want.ptr) and torch.equal(got.perm.cpu(), want.perm)
    out, alpha = K.fused_attention_conv_forward(xw, p, q, b, row, col, by_row)
    grads = K.fused_attention_conv_backward(dout, xw, p, q, b, row, col, alpha, by_row, by_col)
    out2, alpha2 = K.fused_attention_conv_forward(xw, p, q, b, row, col, by_row)
    grads2 = K.fused_attention_conv_backward(dout, xw, p, q, b, row, col, alpha2, by_row, by_col)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(alpha, alpha2)
    assert all(torch.equal(a, c) for a, c in zip(grads, grads2))
    with deterministic():
        want_out, want_alpha = K.fused_attention_conv_plain(xw, p, q, b, row, col)
        want = K.fused_attention_conv_plain_bwd(dout, xw, p, q, b, row, col, want_alpha)
    lanes = by_row.ptr[:, 1:] - by_row.ptr[:, :-1]  # [G, S]
    short = torch.cat([lanes < 32, torch.ones_like(lanes[:, :1], dtype=torch.bool)], dim=1)
    kept = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    short_lanes = short.gather(1, torch.where(kept, row.long(), s))
    assert short[:, :s].any() and short_lanes.any()
    with pytest.raises(RuntimeError, match="row CSR"):
        K.fused_attention_conv_forward(xw, p, q, b, row, col)
    with pytest.raises(RuntimeError, match="col CSR"):
        K.fused_attention_conv_backward(dout, xw, p, q, b, row, col, alpha, by_row)
    assert torch.equal(out[short[:, :s]], want_out[short[:, :s]])
    assert torch.equal(alpha[short_lanes], want_alpha[short_lanes])
    for got, exp in ((out, want_out), (alpha, want_alpha), (grads[0], want[0])):
        _close(got, exp, 1e-6)
    for got, exp in zip(grads[1:], want[1:]):
        _close(got, exp, 1e-5)


@pytest.mark.cuda
def test_k4_cuda_graph_replay_matches_eager():
    """The CSR builds, the forward and the backward captured into one CUDA
    graph: a replay gives the eager calls' numbers bitwise."""
    _need_card()
    xw, p, q, b, row, col, dout = cell_inputs("conv1", 19, "cuda")
    s = xw.shape[1]

    def calls():
        by_row, by_col = K.attention_csr(row, col, s), K.attention_csr(col, row, s)
        out, alpha = K.fused_attention_conv_forward(xw, p, q, b, row, col, by_row)
        return (out, alpha, *K.fused_attention_conv_backward(dout, xw, p, q, b, row, col,
                                                              alpha, by_row, by_col))

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(eager, captured))


@pytest.mark.cuda
def test_k4_launches_a_step():
    """A training step of attention GINet on a dense batch: 4 CSR builds,
    4 forward calls, 2 backward passes for each of the 4 convs; a scoring
    batch (no autograd): the 2 row CSRs and 4 forward calls."""
    _need_card()
    from deeprank_gnn_tpu_torch import GINet, GraphListDataSet
    from deeprank_gnn_tpu_torch.data.dataset import GraphSample
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.train.losses import mse_loss
    from portbench import graphs

    samples = GraphListDataSet([GraphSample(
        mol=g["mol"], x=g["x"], pos=g["pos"], edge_index=g["edge_index"],
        edge_attr=g["edge_attr"], internal_edge_index=g["internal_edge_index"],
        internal_edge_attr=g["internal_edge_attr"], cluster0=g["cluster0"],
        cluster1=g["cluster1"], y=g["y"]) for g in graphs.atomic(2**31 + 24, 4, 64, 150, 48)])
    batch = collate_dense(samples.graphs, g_pad=4, precompute_ops=False)[0]
    model = GINet(48, 1, 1, attention=True, device="cuda").train()
    before = Counter(LAUNCHES)
    mse_loss(model(batch)[:, 0], batch.y.cuda(), batch.y_mask.cuda()).backward()
    torch.cuda.synchronize()
    step = Counter(LAUNCHES)
    step.subtract(before)
    assert +step == Counter({K.NAME_CSR: 4, K.NAME: 4, K.NAME_BWD: 8})
    before = Counter(LAUNCHES)
    with torch.no_grad():
        model.eval()(batch)
    served = Counter(LAUNCHES)
    served.subtract(before)
    assert +served == Counter({K.NAME_CSR: 2, K.NAME: 4})

"""PyTorch port vs JAX package: the dense layout and the gradients of slice 2.

- ``collate_dense`` and the dense ``GraphLoader``: integer fields bitwise
  equal, ``x`` equal;
- K3 (``fused_gin_conv``): the port's plain version against the JAX
  package's ``fused_gin_conv`` on the CPU (its einsum path), forward and
  VJP, at rtol = atol = 1e-5 (the summation order differs), and bitwise
  against a loop that sums each row's edges in ascending edge order, the
  order the CUDA kernel keeps;
- the dense pools and readout, K1's gradient and ``member_max_pool``'s
  gradient against the JAX functions, with ties;
- dense GINet, fused and unfused, against JAX dense and against the port's
  sparse GINet, forward at rtol 2e-4, atol 1e-5 and gradients at rtol 5e-4,
  atol 1e-5 (``tests/test_dense_layout.py:52-54``).

The CUDA kernel is checked on the card by ``chip_smoke.py``;
``test_k3_cuda_matches_plain`` runs it where a card is present and holds it
bitwise to the plain version on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_data import datasets, write_graphs_hdf5

TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
DENSE_FIELDS = (
    "x", "node_mask", "row", "col", "edge_attr", "edge_mask", "assign0",
    "pool0_mask", "edge_to_pe", "pe_row", "pe_col", "pe_mask", "assign1",
    "pool1_mask", "y", "y_mask",
)
DEAD = ("fc_edge_attr", "fc_attention")


@pytest.fixture(scope="module")
def h5_path(tmp_path_factory):
    return write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_dense") / "g.hdf5"), num_graphs=9, seed=8
    )


def _assert_dense_equal(jb, tb):
    assert [f.name for f in dataclasses.fields(tb)] == list(DENSE_FIELDS)
    for name in DENSE_FIELDS:
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("g_pad", [None, 12], ids=["exact", "padded"])
def test_collate_dense_bitwise(h5_path, g_pad):
    from deeprank_gnn_tpu.data.dense_batch import collate_dense as jax_collate_dense
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense

    jds, tds = datasets(h5_path)
    jb, jmols = jax_collate_dense([jds.get(i) for i in range(len(jds))], g_pad=g_pad)
    tb, tmols = collate_dense([tds.get(i) for i in range(len(tds))], g_pad=g_pad)
    assert jmols == tmols
    _assert_dense_equal(jb, tb)
    assert tb.num_graphs == (g_pad or len(tds))
    # run padding: every level-0 cluster owns a contiguous run of slots
    # padded to a multiple of 8, so the node capacity exceeds the largest
    # graph, and the graphs' clusters are uneven
    assert tb.nodes_per_graph % 8 == 0
    assert tb.nodes_per_graph > max(tds.get(i).num_nodes for i in range(len(tds)))
    for gi in range(len(tds)):
        a = tb.assign0[gi].numpy()[tb.node_mask[gi].numpy()]
        assert (np.diff(a) >= 0).all()
        sizes = np.bincount(a)
        assert sizes.min() < sizes.max()
    # edges keep their file order: the rows of a graph are not sorted
    assert any((np.diff(tb.row[gi].numpy()[tb.edge_mask[gi].numpy()]) < 0).any()
               for gi in range(len(tds)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        collate_dense([tds.get(0)], precompute_ops=True)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True)])
def test_dense_loader_matches_jax(h5_path, shuffle, drop_last):
    from deeprank_gnn_tpu.data.batch import GraphLoader as JaxLoader
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader

    jds, tds = datasets(h5_path)
    kw = dict(batch_size=4, shuffle=shuffle, seed=5, drop_last=drop_last, layout="dense")
    jl, tl = JaxLoader(jds, **kw), GraphLoader(tds, **kw)
    assert len(jl) == len(tl)
    for _epoch in range(2):  # the shuffle stream advances identically
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) > 0
        for (jb, jm), (tb, tm) in zip(jbs, tbs):
            assert jm == tm
            _assert_dense_equal(jb, tb)
            assert tb.num_graphs == 4


def test_graph_sizes_match_jax(h5_path):
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet

    jds, tds = datasets(h5_path)
    mem = GraphListDataSet([tds.get(i) for i in range(len(tds))])
    for i in range(len(tds)):
        want = jds.graph_sizes(i)
        assert {"np8", "mt0"} <= set(want)
        assert tds.graph_sizes(i) == want
        assert mem.graph_sizes(i) == want


def k3_inputs(rng, g, s, f, e, one_row=False):
    """Unsorted rows and cols with sentinels (== S and negative),
    duplicate edges, and rows without edges; with ``one_row``, every valid
    edge of a graph on one row (the longest run)."""
    row = rng.integers(0, s, (g, e))
    col = rng.integers(0, s, (g, e))
    if one_row:
        row[:] = s // 3
    row[:, ::7] = s  # sentinel rows
    col[:, 3::11] = s  # sentinel cols
    row[:, 5::13] = -1
    row[:, 1:9] = row[:, :1]  # a run of duplicate edges on one row
    col[:, 1:9] = col[:, :1]
    row[row == s // 2] = s // 2 + 1  # slot s//2 receives nothing
    xw = rng.standard_normal((g, s, f)).astype(np.float32)
    return xw, row.astype(np.int32), col.astype(np.int32)


# (G, S, F, E, one_row): small graphs at three widths, a run of ~4,000 edges
# on one row, more edges than one of the kernel's 2,048-edge tiles (and than
# 4,096), and conv1's shape at the paper's width
K3_SHAPES = {
    "1": (3, 40, 1, 150, False),
    "17": (3, 40, 17, 150, False),
    "32": (3, 40, 32, 150, False),
    "one-row": (2, 40, 8, 5000, True),
    "E6000": (2, 300, 16, 6000, False),
    "conv1": (8, 272, 32, 512, False),
}


def edge_order_sum(xw, row, col):
    """``fused_gin_conv`` as a loop over the edges in ascending order, one
    float32 add per edge and column."""
    g, s, _ = xw.shape
    out = np.zeros_like(xw)
    for gi in range(g):
        for r, c in zip(row[gi], col[gi]):
            if 0 <= r < s and 0 <= c < s:
                out[gi, r] += xw[gi, c]
    return out


@pytest.mark.parametrize("shape", list(K3_SHAPES))
def test_k3_plain_sums_in_edge_order(shape):
    """The plain version on the CPU sums each row's edges in ascending edge
    order: bitwise the loop, forward and with the indices swapped (the
    backward). The kernel sums in the same order, so the card's check
    holds it to this bitwise."""
    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import fused_gin_conv_plain

    g, s, f, e, one_row = K3_SHAPES[shape]
    xw, row, col = k3_inputs(np.random.default_rng(11), g, s, f, e, one_row)
    for r, c in ((row, col), (col, row)):
        got = fused_gin_conv_plain(torch.from_numpy(xw), torch.from_numpy(r),
                                   torch.from_numpy(c)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), edge_order_sum(xw, r, c).view(np.int32))


@pytest.mark.parametrize("shape", list(K3_SHAPES))
def test_k3_plain_matches_jax(shape):
    import jax
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.pallas import fused_gin_conv as jax_fused
    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import fused_gin_conv

    g, s, f, e, one_row = K3_SHAPES[shape]
    rng = np.random.default_rng(f)
    xw, row, col = k3_inputs(rng, g, s, f, e, one_row)
    cot = rng.standard_normal((g, s, f)).astype(np.float32)
    if one_row:
        # multiples of 1/64 below 8: every partial sum of the ~4,000-edge run
        # is exact in fp32, so the two summation orders agree
        xw, cot = (np.clip(np.round(a * 64), -511, 511) / 64 for a in (xw, cot))
    want, vjp = jax.vjp(lambda v: jax_fused(v, jnp.asarray(row), jnp.asarray(col)),
                        jnp.asarray(xw))
    (want_grad,) = vjp(jnp.asarray(cot))

    x = torch.from_numpy(xw).requires_grad_(True)
    got = fused_gin_conv(x, torch.from_numpy(row), torch.from_numpy(col))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **KERNEL_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **KERNEL_TOL)
    assert (got.detach().numpy()[:, s // 2] == 0).all()  # an empty row gives 0


def test_k3_wrapper_never_falls_back():
    """Only a CPU tensor takes the plain version. Off the CPU the kernel
    path's own checks run (on meta tensors, which need no card) and a
    device other than CUDA raises."""
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import fused_gin_conv_forward

    xw = torch.empty((2, 5, 4), device="meta")
    idx = torch.empty((2, 7), dtype=torch.int32, device="meta")
    launches = dict(LAUNCHES)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_gin_conv_forward(xw, idx, idx)
    with pytest.raises(TypeError, match="float32"):
        fused_gin_conv_forward(xw.double(), idx, idx)
    with pytest.raises(TypeError, match="int32"):
        fused_gin_conv_forward(xw, idx.long(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        fused_gin_conv_forward(torch.empty((2, 4, 5), device="meta").transpose(1, 2), idx, idx)
    with pytest.raises(ValueError, match=r"\[G, S, F\]"):
        fused_gin_conv_forward(xw, idx[:1], idx[:1])
    with pytest.raises(ValueError, match="row on cpu"):
        fused_gin_conv_forward(xw, torch.zeros((2, 7), dtype=torch.int32), idx)
    assert dict(LAUNCHES) == launches


@pytest.mark.cuda
def test_k3_cuda_matches_plain():
    """The kernel, forward and backward, bitwise the plain version on the
    CPU, two launches bitwise equal, and its launch plan: the slab staged
    when it fits in shared memory, at most 128 rows to a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import (
        fused_gin_conv,
        fused_gin_conv_plain,
        launch_plan,
    )

    rng = np.random.default_rng(0)
    cases = ((4, 40, 17, 300, False), (2, 4000, 64, 6000, False), (8, 32, 100, 5000, False),
             (3, 300, 32, 5000, True), (2, 70000, 8, 9000, False))
    for g, s, f, e, one_row in cases:
        xw, row, col = k3_inputs(rng, g, s, f, e, one_row)
        cot = torch.from_numpy(rng.standard_normal((g, s, f)).astype(np.float32))
        x = torch.from_numpy(xw).cuda().requires_grad_(True)
        r, c = torch.from_numpy(row).cuda(), torch.from_numpy(col).cuda()
        before = LAUNCHES["fused_gin_conv"]
        a = fused_gin_conv(x, r, c)
        b = fused_gin_conv(x, r, c)
        (a * cot.cuda()).sum().backward()
        torch.cuda.synchronize()
        assert LAUNCHES["fused_gin_conv"] == before + 3
        assert torch.equal(a, b)
        rc, cc = torch.from_numpy(row), torch.from_numpy(col)
        assert torch.equal(a.detach().cpu(), fused_gin_conv_plain(torch.from_numpy(xw), rc, cc))
        assert torch.equal(x.grad.cpu(), fused_gin_conv_plain(cot, cc, rc))
        plan = launch_plan(x.device, s, f, e)
        assert plan["slab"] == (s * f * 4 < 200_000)
        assert plan["rows_per_block"] <= 128
        assert plan["blocks_per_graph"] == -(-s // plan["rows_per_block"])


def pool_inputs(rng, g=3, s=40, f=6, c=9):
    """Relu-like values with many exact ties, two empty slots, padding
    nodes (assign == c) and a matching member table."""
    h = rng.standard_normal((g, s, f)).astype(np.float32)
    h[h < 0.3] = 0.0
    h[:, ::5] = np.round(h[:, ::5])
    assign = rng.integers(0, c - 2, (g, s)).astype(np.int32)
    assign[:, -4:] = c
    mem = np.full((g, c, 16), s, dtype=np.int32)
    for gi in range(g):
        for ci in range(c):
            members = np.flatnonzero(assign[gi] == ci)
            mem[gi, ci, : len(members)] = members
    cot = rng.standard_normal((g, c, f)).astype(np.float32)
    return h, assign, mem, cot


def _torch_grad(fn, h, cot):
    x = torch.from_numpy(h).requires_grad_(True)
    out = fn(x)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def _jax_grad(fn, h, cot):
    import jax
    import jax.numpy as jnp

    out, vjp = jax.vjp(fn, jnp.asarray(h))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def test_dense_pools_match_jax_with_ties():
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops import dense as J
    from deeprank_gnn_tpu_torch.ops import dense as T

    rng = np.random.default_rng(3)
    h, assign, mem, cot = pool_inputs(rng)
    c = cot.shape[1]
    ja = jnp.asarray(assign)
    ta, tm = torch.from_numpy(assign), torch.from_numpy(mem)
    want, want_grad = _jax_grad(lambda x: J.slot_max_pool(x, ja, c), h, cot)
    # the port's pool by assignment against JAX's broadcast pool, JAX's
    # cluster_max_pool without a member table (the streaming dense path's
    # branch), and the port's member-table pool on the same clusters
    refs = {"jax_slot": (want, want_grad),
            "jax_cluster": _jax_grad(lambda x: J.cluster_max_pool(x, ja, c), h, cot),
            "members": _torch_grad(lambda x: T.member_max_pool(x, tm), h, cot)}
    got, got_grad = _torch_grad(lambda x: T.slot_max_pool(x, ta, c), h, cot)
    for name, (ref, ref_grad) in refs.items():
        np.testing.assert_array_equal(got, ref, err_msg=name)
        np.testing.assert_allclose(got_grad, ref_grad, rtol=1e-6, atol=1e-6, err_msg=name)
    assert (want[:, c - 2:] == 0).all()  # empty slots give 0
    # ties split: a slot's gradient is shared among its tied maxima
    tied = (want_grad != 0) & (np.abs(want_grad) < np.abs(cot).max())
    assert tied.any()

    jmask = jnp.asarray(assign < c)
    got, got_grad = _torch_grad(lambda x: T.masked_mean(x, torch.from_numpy(assign < c)),
                                h, cot[:, 0])
    want, want_grad = _jax_grad(lambda x: J.masked_mean(x, jmask), h, cot[:, 0])
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    np.testing.assert_allclose(got_grad, want_grad, **KERNEL_TOL)


def test_member_max_pool_grad_matches_jax():
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.dense import member_max_pool as jax_pool
    from deeprank_gnn_tpu_torch.ops.dense import member_max_pool

    rng = np.random.default_rng(4)
    h, assign, mem, cot = pool_inputs(rng, g=2, s=30, f=5, c=7)
    h = np.round(h)  # more ties
    ja, jm = jnp.asarray(assign), jnp.asarray(mem)
    want, want_grad = _jax_grad(lambda x: jax_pool(x, jm, ja), h, cot)
    got, got_grad = _torch_grad(lambda x: member_max_pool(x, torch.from_numpy(mem)), h, cot)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-6, atol=1e-6)


def test_k1_grad_matches_jax():
    """K1 through its autograd Function (``segment_sum(..., row_ptr=)``)
    against the JAX package's ``segment_sum`` VJP and the Pallas kernel's
    VJP (interpret mode): padding edges and edges of empty rows."""
    import jax
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.pallas.segment import required_window
    from deeprank_gnn_tpu.ops.pallas.segment import sorted_segment_sum as pallas_sss
    from deeprank_gnn_tpu.ops.segment import segment_sum as jax_segment_sum
    from deeprank_gnn_tpu_torch.ops.segment import segment_sum

    rng = np.random.default_rng(6)
    n, e_valid, e_pad, f = 60, 200, 230, 8
    rows = np.sort(rng.choice(np.arange(0, n, 3), e_valid))  # 2 of 3 rows empty
    rows = np.concatenate([rows, np.full(e_pad - e_valid, n)]).astype(np.int32)
    ptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int32)
    data = rng.standard_normal((e_pad, f)).astype(np.float32)
    cot = rng.standard_normal((n, f)).astype(np.float32)
    jr = jnp.asarray(rows)
    want, want_grad = _jax_grad(lambda d: jax_segment_sum(d, jr, n), data, cot)
    window = required_window(rows, n)
    _, pallas_grad = _jax_grad(lambda d: pallas_sss(d, jr, n, True, window), data, cot)
    got, got_grad = _torch_grad(
        lambda d: segment_sum(d, torch.from_numpy(rows), n, row_ptr=torch.from_numpy(ptr)),
        data, cot)
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    np.testing.assert_array_equal(got_grad, want_grad)
    np.testing.assert_array_equal(got_grad, pallas_grad)
    assert (got_grad[e_valid:] == 0).all()


@pytest.fixture(scope="module")
def batches(h5_path):
    from deeprank_gnn_tpu.data.batch import collate as jax_collate
    from deeprank_gnn_tpu.data.dense_batch import collate_dense as jax_collate_dense
    from deeprank_gnn_tpu_torch.data.batch import collate
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense

    jds, tds = datasets(h5_path)
    jg = [jds.get(i) for i in range(len(jds))]
    tg = [tds.get(i) for i in range(len(tds))]
    return {
        "jax_dense": jax_collate_dense(jg, g_pad=10)[0],
        "dense": collate_dense(tg, g_pad=10)[0],
        "sparse": collate(tg, g_pad=10)[0],
        "num_graphs": len(tg),
    }


def _port_grads(model, batch, num_graphs):
    model.zero_grad(set_to_none=True)
    out = model(batch)
    (out[:num_graphs] ** 2).sum().backward()
    return out.detach().numpy(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("output_shape", [1, 2], ids=["reg", "class"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_dense_ginet_matches_jax_and_sparse(batches, output_shape, fuse):
    import jax

    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    ng = batches["num_graphs"]
    jb, tb, sb = batches["jax_dense"], batches["dense"], batches["sparse"]
    jm = JaxGINet(tb.x.shape[2], output_shape, 1)
    params = jm.init(jax.random.PRNGKey(2))
    tm = GINet(tb.x.shape[2], output_shape, 1, fuse=fuse, device="cpu")
    tm.load_state_dict(state_dict_from_jax_params("GINet", params))
    tm.eval()

    def loss(p):
        return (jm.apply(p, jb)[:ng] ** 2).sum()

    want = np.asarray(jm.apply(params, jb))
    want_grads = state_dict_from_jax_params("GINet", jax.grad(loss)(params))
    dense_out, dense_grads = _port_grads(tm, tb, ng)
    sparse_out, sparse_grads = _port_grads(tm, sb, ng)
    assert dense_out.shape == (10, output_shape)
    np.testing.assert_allclose(dense_out, want, **TOL)
    np.testing.assert_allclose(dense_out[:ng], sparse_out[:ng], **TOL)
    for name, want_grad in want_grads.items():
        if name.split(".")[1] in DEAD:
            # Q1: autograd leaves the dead parameters without a gradient;
            # the engine's step gives them an exact zero one
            assert dense_grads[name] is None and sparse_grads[name] is None
            assert not want_grad.any()
            continue
        np.testing.assert_allclose(dense_grads[name].numpy(), want_grad.numpy(),
                                   err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(dense_grads[name].numpy(), sparse_grads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_dense_ginet_routes_through_k3(batches, monkeypatch):
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.models import ginet as ginet_module

    tb = batches["dense"]
    calls = []
    real = ginet_module.fused_gin_conv
    monkeypatch.setattr(ginet_module, "fused_gin_conv",
                        lambda xw, r, c: calls.append(xw.shape[2]) or real(xw, r, c))
    with torch.inference_mode():
        GINet(tb.x.shape[2], 1, 1, device="cpu")(tb)
        assert calls == [32, 64]  # one K3 call per conv level, fused
        GINet(tb.x.shape[2], 1, 1, fuse=False, device="cpu")(tb)
    assert calls[2:] == [16, 32, 16, 32]

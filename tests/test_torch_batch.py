"""PyTorch port vs JAX package: collation, CSR row pointers, the loader and
the prefetcher."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from test_torch_data import datasets, write_graphs_hdf5

INT_FIELDS = (
    "node_graph", "node_mask", "edge_index", "edge_mask", "iedge_index",
    "iedge_mask", "assign0", "pool0_graph", "pool0_mask", "edge_to_pe",
    "pe_index", "pe_mask", "iedge_to_pie", "pie_index", "pie_mask", "assign1",
    "pool1_graph", "pool1_mask", "y_mask", "mem0_idx", "mem1_idx",
)
FLOAT_FIELDS = ("x", "pos", "edge_attr", "iedge_attr", "y")


@pytest.fixture(scope="module")
def h5_path(tmp_path_factory):
    return write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_batch") / "g.hdf5"), num_graphs=10, seed=1
    )


def _assert_batches_equal(jb, tb):
    for name in INT_FIELDS + FLOAT_FIELDS:
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the JAX package takes its sorted kernel on the same batches
    assert jb.edges_sorted


def test_collate_fields_bitwise(h5_path):
    from deeprank_gnn_tpu.data.batch import collate as jax_collate
    from deeprank_gnn_tpu_torch.data.batch import collate

    jds, tds = datasets(h5_path)
    jb, jmols = jax_collate([jds.get(i) for i in range(len(jds))])
    tb, tmols = collate([tds.get(i) for i in range(len(tds))])
    assert jmols == tmols
    _assert_batches_equal(jb, tb)
    assert (np.diff(tb.edge_index[0].numpy()) >= 0).all()
    assert (np.diff(tb.pe_index[0].numpy()) >= 0).all()


def test_unsorted_edges_are_sorted_or_refused(h5_path):
    """``collate`` refuses edges that are not row-sorted (the row pointers
    would be wrong for them); ``GraphListDataSet`` sorts them as the HDF5
    loader does, leaving the caller's graphs as they were."""
    from deeprank_gnn_tpu_torch.data.batch import collate
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet

    _, tds = datasets(h5_path)
    graphs = [tds.get(i) for i in range(3)]
    flipped = [
        dataclasses.replace(g, edge_index=g.edge_index[:, ::-1].copy(),
                            edge_attr=g.edge_attr[::-1].copy())
        for g in graphs
    ]
    with pytest.raises(ValueError, match="interface edges are not row-sorted"):
        collate(flipped)
    flipped_internal = [
        dataclasses.replace(g, internal_edge_index=g.internal_edge_index[:, ::-1].copy(),
                            internal_edge_attr=g.internal_edge_attr[::-1].copy())
        for g in graphs
    ]
    with pytest.raises(ValueError, match="internal edges are not row-sorted"):
        collate(flipped_internal)
    got, _ = collate([GraphListDataSet(flipped_internal).get(i) for i in range(3)])
    assert torch.equal(got.iedge_rowptr, collate(graphs)[0].iedge_rowptr)
    mem = GraphListDataSet(flipped)
    assert (np.diff(flipped[0].edge_index[0]) < 0).any()
    want, _ = collate(graphs)
    got, _ = collate([mem.get(i) for i in range(len(mem))])
    assert torch.equal(got.edge_rowptr, want.edge_rowptr)
    assert torch.equal(got.pe_rowptr, want.pe_rowptr)
    for b in (want, got):
        assert (np.diff(b.edge_index[0].numpy()) >= 0).all()

    def edges(b):
        keys = np.c_[b.edge_index.numpy().T, b.edge_attr.numpy()]
        return keys[np.lexsort(keys.T[::-1])]

    np.testing.assert_array_equal(edges(got), edges(want))


def test_row_pointers_are_csr_of_sorted_rows(h5_path):
    from deeprank_gnn_tpu_torch.data.batch import collate

    _, tds = datasets(h5_path)
    b, _ = collate([tds.get(i) for i in range(len(tds))])
    n, c0 = b.num_nodes, b.num_clusters0
    for ptr, index, size, mask in (
        (b.edge_rowptr, b.edge_index, n, b.edge_mask),
        (b.pe_rowptr, b.pe_index, c0, b.pe_mask),
        (b.iedge_rowptr, b.iedge_index, n, b.iedge_mask),
        (b.pie_rowptr, b.pie_index, c0, b.pie_mask),
    ):
        r = index[0].numpy()
        assert ptr.dtype == torch.int32 and ptr.shape == (size + 1,)
        np.testing.assert_array_equal(ptr.numpy(), np.searchsorted(r, np.arange(size + 1)))
        # padding rows sort last and lie past ptr[N]
        assert int(ptr[-1]) == int(mask.sum())
        assert (r[int(ptr[-1]):] == size).all()


@pytest.mark.parametrize(
    "shuffle,num_buckets,drop_last",
    [(False, 1, False), (True, 1, True), (True, 2, False)],
)
def test_loader_batches_match(h5_path, shuffle, num_buckets, drop_last):
    from deeprank_gnn_tpu.data.batch import GraphLoader as JaxLoader
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader

    jds, tds = datasets(h5_path)
    kw = dict(batch_size=4, shuffle=shuffle, seed=3, num_buckets=num_buckets,
              drop_last=drop_last)
    jl, tl = JaxLoader(jds, **kw), GraphLoader(tds, **kw)
    assert len(jl) == len(tl)
    for _epoch in range(2):  # the shuffle stream advances identically
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) > 0
        for (jb, jm), (tb, tm) in zip(jbs, tbs):
            assert jm == tm
            _assert_batches_equal(jb, tb)
    assert jl.padding_stats == tl.padding_stats


def test_loader_rejects_unported_options(h5_path):
    """The dense layout, the device store and the precomputed operators are
    ported (tests/test_torch_store.py), and so are multi-host slices
    (tests/test_torch_parallel.py) and a mesh rank's store: the slices and
    the store options need the dense layout, as in the JAX package, and a
    mesh's loader (``store_sharding``) leaves the member tables out."""
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.dense_batch import DenseGraphBatch

    _, tds = datasets(h5_path)
    with pytest.raises(ValueError, match="host_batch_slice requires layout='dense'"):
        GraphLoader(tds, host_batch_slice=slice(0, 2))
    sharded, _ = next(iter(GraphLoader(tds, batch_size=4, store_sharding=torch.device("cpu"))))
    plain, _ = next(iter(GraphLoader(tds, batch_size=4)))
    assert sharded.mem0_idx is None and sharded.mem1_idx is None
    assert plain.mem0_idx is not None and torch.equal(sharded.x, plain.x)
    for kw in ({"device_cache": True, "device": "cpu"}, {"precompute_ops": True}):
        with pytest.raises(ValueError, match="requires layout='dense'"):
            GraphLoader(tds, **kw)
    with pytest.raises(ValueError, match="unknown layout"):
        GraphLoader(tds, layout="halo")
    batch, mols = next(iter(GraphLoader(tds, batch_size=4, layout="dense")))
    assert isinstance(batch, DenseGraphBatch) and batch.num_graphs == 4 and len(mols) == 4
    assert batch.agg_x is None


def test_batch_to_keeps_static_fields(h5_path):
    from deeprank_gnn_tpu_torch.data.batch import collate

    _, tds = datasets(h5_path)
    b, _ = collate([tds.get(i) for i in range(3)])
    moved = b.to("cpu", non_blocking=True)
    assert moved.device.type == "cpu"
    assert moved.num_nodes == b.num_nodes and moved.num_clusters0 == b.num_clusters0
    for f in dataclasses.fields(b):
        v = getattr(b, f.name)
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(moved, f.name))


def test_prefetch_yields_in_order_and_cleans_up(h5_path):
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.prefetch import prefetch

    _, tds = datasets(h5_path)
    loader = GraphLoader(tds, batch_size=3)
    direct = [(b, m) for b, m in loader]
    got = list(prefetch(loader, "cpu", size=1))
    assert [m for _, m in got] == [m for _, m in direct]
    for (a, _), (b, _) in zip(direct, got):
        assert torch.equal(a.x, b.x) and torch.equal(a.edge_rowptr, b.edge_rowptr)

    # a consumer that stops early leaves no worker behind
    before = threading.active_count()
    it = iter(prefetch(loader, "cpu", size=1))
    next(it)
    it.close()
    assert threading.active_count() == before

    # a failure in the worker reaches the consumer
    def broken():
        yield direct[0]
        raise OSError("unreadable graph")

    with pytest.raises(OSError, match="unreadable graph"):
        list(prefetch(broken(), "cpu"))

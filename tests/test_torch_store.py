"""PyTorch port vs JAX package: the device store and the operator path.

- ``collate_dense(precompute_ops=True)``: every field bitwise JAX's
  (``adj1``'s 0/1 values, which JAX holds as bfloat16), with ``g_pad`` and
  with a graph of one cluster;
- ``static_field_kinds`` and ``estimate_store_bytes`` equal JAX's for both
  packs, with and without the operators, and past the 16-bit capacities;
- store batches: lossless ones bitwise the streamed batches and bitwise the
  JAX store's ``gather_packed`` batches; bf16 ones round the payload
  fields as ``x.to(torch.bfloat16)`` does, and equal JAX's bitwise;
- the loader: the budget fallback prints JAX's line and streams, with the
  operators off unless asked for; shuffled ``True`` and ``"chunked"``
  epochs give JAX's molecule order and padding statistics over two
  epochs; a chunked epoch serves every graph once;
- ``tiled_cluster_max_pool`` forward and gradient against JAX's, with a
  2 + 1 tie across two tiles and a dead-relu cluster, where autograd
  through the two maxes would split differently; ``adj_conv`` exact
  against JAX's; ``cluster_max_pool`` on both sides of its threshold;
- GINet (paper mode, its ``agg_x`` branch, dense attention), FoutNet and
  sGAT on operator batches against JAX at rtol 2e-4, atol 1e-5 (gradients
  5e-4), and against the port's own path without the operators;
- the engine: ``device_cache=True`` losses against JAX's engine from one
  checkpoint, chunked epochs against JAX's, chunked serving bitwise the
  resident store's, and bf16 packing training close to lossless.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_data import datasets, write_graphs_hdf5
from test_torch_train import jax_engine, port_engine

TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
NUM_GRAPHS = 10
OPS = ("agg_x", "deg0", "adj1", "wagg_x", "ea_rowsum0", "wadj1", "ea_rowsum1", "mem0_idx",
       "mem1_idx", "agg_x_fm", "node_mask_fm", "tile_mem0", "tile_assign0")
PAYLOADS = ("x", "edge_attr", "agg_x", "agg_x_fm", "wagg_x", "wadj1", "ea_rowsum0",
            "ea_rowsum1")


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_store") / "g.hdf5"), num_graphs=NUM_GRAPHS, seed=21
    )


@pytest.fixture()
def no_dropout(monkeypatch):
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch.models import GINet

    monkeypatch.setattr(JaxGINet, "dropout_rate", 0.0)
    monkeypatch.setattr(GINet, "dropout_rate", 0.0)


def assert_fields_equal(jb, tb, skip=()):
    """Every field of the JAX batch ``jb`` bitwise the port's ``tb`` (the
    same None pattern; ``adj1``'s values whatever its float type)."""
    for f in dataclasses.fields(tb):
        a, b = getattr(jb, f.name), getattr(tb, f.name)
        assert (a is None) == (b is None), f.name
        if a is None or f.name in skip:
            continue
        a, b = np.asarray(a), b.cpu().numpy()
        if f.name == "adj1":
            a = a.astype(np.float32)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def one_cluster(g):
    """``g`` with all its nodes in one level-0 cluster."""
    return dataclasses.replace(g, cluster0=np.zeros(g.num_nodes, g.cluster0.dtype),
                               cluster1=np.zeros(1, g.cluster1.dtype))


@pytest.mark.parametrize("case", ["exact", "padded", "one-cluster"])
def test_precompute_collate_bitwise(db, case):
    from deeprank_gnn_tpu.data.dense_batch import collate_dense as jax_collate_dense
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense

    jds, tds = datasets(db)
    jg = [jds.get(i) for i in range(len(jds))]
    tg = [tds.get(i) for i in range(len(tds))]
    if case == "one-cluster":
        jg[3], tg[3] = one_cluster(jg[3]), one_cluster(tg[3])
    g_pad = 12 if case == "padded" else None
    jb, jm = jax_collate_dense(jg, g_pad=g_pad, precompute_ops=True)
    tb, tm = collate_dense(tg, g_pad=g_pad, precompute_ops=True)
    assert jm == tm
    assert_fields_equal(jb, tb)
    assert all(getattr(tb, name) is not None for name in OPS)
    assert set(np.unique(tb.adj1.numpy())) == {0.0, 1.0}
    # the stored action is the sum aggregation of the raw features
    agg = torch.zeros_like(tb.x)
    for gi in range(len(tg)):
        m = tb.edge_mask[gi]
        agg[gi].index_add_(0, tb.row[gi][m].long(), tb.x[gi][tb.col[gi][m].long()])
    torch.testing.assert_close(tb.agg_x, agg, **TOL)


CAPS = {
    "fixture": dict(ng=272, eg=512, pg=512, c0g=32, c1g=16),
    "wide": dict(ng=70000, eg=70016, pg=512, c0g=32, c1g=16),
}


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("precompute_ops", [True, False], ids=["ops", "no-ops"])
@pytest.mark.parametrize("pack", ["lossless", "bf16"])
def test_store_sizing_matches_jax(caps, precompute_ops, pack):
    from deeprank_gnn_tpu.data import device_store as J
    from deeprank_gnn_tpu_torch.data import device_store as T

    c = CAPS[caps]
    assert T.static_field_kinds(pack=pack, **c) == J.static_field_kinds(pack=pack, **c)
    for fe in (1, 2):
        kw = dict(num_features=13, num_edge_features=fe, precompute_ops=precompute_ops,
                  pack=pack, m0g=16, m1g=8, mt0g=3, **c)
        assert T.estimate_store_bytes(37, **kw) == J.estimate_store_bytes(37, **kw)


def store_loaders(db, **kw):
    from deeprank_gnn_tpu.data.batch import GraphLoader as JaxLoader
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader

    jds, tds = datasets(db)
    kw = dict(batch_size=4, layout="dense", **kw)
    return JaxLoader(jds, **kw), GraphLoader(tds, device="cpu", **kw)


@pytest.mark.parametrize("pack", ["lossless", "bf16"])
@pytest.mark.parametrize("precompute_ops", [True, False], ids=["ops", "no-ops"])
def test_store_batches_match_streaming_and_jax(db, precompute_ops, pack):
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader

    jl, tl = store_loaders(db, device_cache=True, precompute_ops=precompute_ops,
                           store_pack=pack)
    streamed = list(GraphLoader(tl.dataset, batch_size=4, layout="dense",
                                precompute_ops=precompute_ops))
    stored, jax_stored = list(tl), list(jl)
    assert tl._store is not None and jl._store is not None
    assert len(stored) == len(streamed) == 3
    for (sb, sm), (tb, tm), (jb, jm) in zip(streamed, stored, jax_stored):
        assert sm == tm == jm
        # the JAX store's gather, field by field
        assert_fields_equal(jb, tb)
        for f in dataclasses.fields(sb):
            want, got = getattr(sb, f.name), getattr(tb, f.name)
            assert (want is None) == (got is None), f.name
            if want is None:
                continue
            assert want.dtype == got.dtype and want.shape == got.shape, f.name
            if pack == "bf16" and f.name in PAYLOADS:
                want = want.to(torch.bfloat16).to(torch.float32)
            assert torch.equal(want, got), f.name
    assert tl.padding_stats == jl.padding_stats


@pytest.mark.parametrize("requested", [None, True], ids=["default", "requested"])
def test_budget_fallback_streams(db, capsys, requested):
    jl, tl = store_loaders(db, device_cache=True, device_cache_bytes=1,
                           precompute_ops=requested)
    jb = list(jl)
    jax_out = capsys.readouterr().out
    tb = list(tl)
    assert capsys.readouterr().out == jax_out
    assert "exceeds budget" in jax_out and "streaming" in jax_out
    assert tl._store is None and tl.device_cache is False
    assert tl.precompute_ops is bool(requested) is jl.precompute_ops
    for (a, am), (b, bm) in zip(jb, tb):
        assert am == bm
        assert_fields_equal(a, b)
        assert (b.agg_x is not None) is bool(requested)


@pytest.mark.parametrize("device_cache", [True, "chunked"], ids=["resident", "chunked"])
def test_shuffled_store_epochs_match_jax(db, device_cache):
    """Two shuffled epochs: JAX's molecule order (the store draws the
    streamed epoch's shuffle; the chunked one chunk order, then each
    chunk's order) and padding statistics, every graph once per epoch."""
    jl, tl = store_loaders(db, device_cache=device_cache, shuffle=True, seed=7,
                           device_cache_bytes=1 if device_cache == "chunked" else 2 ** 31)
    orders = []
    for _epoch in range(2):
        jb, tb = list(jl), list(tl)
        assert [m for _, m in tb] == [m for _, m in jb]
        for (a, _), (b, _) in zip(jb, tb):
            assert_fields_equal(a, b)
        mols = [m for _, ms in tb for m in ms]
        assert sorted(mols) == sorted(tl.dataset.get(i).mol for i in range(NUM_GRAPHS))
        assert tl.padding_stats == jl.padding_stats
        orders.append(mols)
    assert orders[0] != orders[1]
    if device_cache == "chunked":
        assert tl._chunk_store.num_chunks == jl._chunk_store.num_chunks == 3


@pytest.mark.parametrize("device_cache", [True, "chunked"], ids=["resident", "chunked"])
def test_store_counts_match_jax(db, device_cache):
    """``num_graphs`` of both stores and ``num_slots`` of their packed
    matrices (the resident store, a chunk, the fixed chunk buffers of a
    scanned epoch) are JAX's."""
    jl, tl = store_loaders(db, device_cache=device_cache,
                           device_cache_bytes=1 if device_cache == "chunked" else 2 ** 31)
    list(jl), list(tl)
    if device_cache is True:
        js, ts = jl._store, tl._store
        assert ts.num_graphs == js.num_graphs == NUM_GRAPHS
        assert ts.store.num_slots == js.store.num_slots == NUM_GRAPHS + 1
        return
    js, ts = jl._chunk_store, tl._chunk_store
    assert ts.num_graphs == js.num_graphs == NUM_GRAPHS
    for ci in range(ts.num_chunks):
        assert ts.upload(ci).num_slots == js.upload(ci).num_slots == ts.chunk_ranges[ci][1] + 1
    assert ts.empty_chunk().num_slots == max(n for _, n in ts.chunk_ranges) + 1


def tiled_case(rng, g=3, c=7, f=8):
    """Striped feature-major activations on the run-padded layout (cluster
    sizes 1..12, a pad tile), with planted ties: in graph 0, cluster 0 has
    12 nodes over two tiles and its feature 0 peaks twice in the first tile
    and once in the second; cluster 1 is a dead relu (all 0)."""
    r = 8
    lens = rng.integers(1, 13, size=(g, c))
    lens[0, 0], lens[0, 1] = 12, 5
    t = int((-(-lens // r) * r).sum(axis=1).max()) // r + 1
    h = np.zeros((g, f, r, t), np.float32)
    mask = np.zeros((g, r, t), bool)
    tile_mem = np.full((g, c, 2), t, np.int32)
    tile_assign = np.full((g, t), c, np.int32)
    assign = np.full((g, t * r), c, np.int32)
    node_major = np.zeros((g, t * r, f), np.float32)
    for gi in range(g):
        off = 0
        for ci in range(c):
            n = lens[gi, ci]
            t0, t1 = off // r, (off + -(-n // r) * r) // r
            tile_mem[gi, ci, : t1 - t0] = np.arange(t0, t1)
            tile_assign[gi, t0:t1] = ci
            vals = np.maximum(np.round(rng.standard_normal((n, f)) * 2) / 2, 0.0)
            if gi == 0 and ci == 0:
                vals[:, 0] = 0.5
                vals[[1, 5, 9], 0] = 3.0  # 2 + 1 over tiles t0 and t0 + 1
            if gi == 0 and ci == 1:
                vals[:] = 0.0
            for j in range(n):
                s = off + j
                h[gi, :, s % r, s // r] = vals[j]
                mask[gi, s % r, s // r] = True
                assign[gi, s] = ci
                node_major[gi, s] = vals[j]
            off += (t1 - t0) * r
    cot = rng.standard_normal((g, c, f)).astype(np.float32)
    return h, mask, tile_mem, tile_assign, assign, node_major, cot


def test_tiled_pool_splits_ties_as_jax():
    import jax
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops import dense as J
    from deeprank_gnn_tpu_torch.ops import dense as T

    h, mask, tile_mem, tile_assign, assign, node_major, cot = tiled_case(np.random.default_rng(5))
    c = cot.shape[1]
    jargs = [jnp.asarray(a) for a in (mask, tile_mem, tile_assign)]
    targs = [torch.from_numpy(a) for a in (mask, tile_mem, tile_assign)]
    want, vjp = jax.vjp(lambda x: J.tiled_cluster_max_pool(x, *jargs), jnp.asarray(h))
    want_grad = np.asarray(vjp(jnp.asarray(cot))[0])
    x = torch.from_numpy(h).requires_grad_(True)
    got = T.tiled_cluster_max_pool(x, *targs)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.detach().numpy(),
        T.slot_max_pool(torch.from_numpy(node_major), torch.from_numpy(assign), c).numpy())
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-6, atol=1e-7)
    # the planted 2 + 1 tie: a third of the cotangent to each argmax node
    share = x.grad.numpy()[0, 0][[1, 5, 1], [0, 0, 1]]
    np.testing.assert_allclose(share, np.full(3, cot[0, 0, 0] / 3), rtol=1e-6)
    # the dead cluster: every one of its 5 nodes ties at 0
    np.testing.assert_allclose(x.grad.numpy()[0, :, :5, 2], np.repeat(cot[0, 1][:, None] / 5, 5, 1),
                               rtol=1e-6)

    # autograd through the two maxes splits per stage: 1/4, 1/4, 1/2
    y = torch.from_numpy(h).requires_grad_(True)
    tiles = torch.where(targs[0][:, None], y, float("-inf")).amax(dim=2)
    naive = T.member_max_pool(tiles.transpose(1, 2), targs[1], targs[2])
    (naive * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.grad.numpy()[0, 0][[1, 5, 1], [0, 0, 1]],
                               cot[0, 0, 0] * np.array([0.25, 0.25, 0.5]), rtol=1e-6)
    assert not np.allclose(y.grad.numpy(), want_grad)


def test_adj_conv_matches_jax():
    import jax
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops import dense as J
    from deeprank_gnn_tpu_torch.ops import dense as T

    rng = np.random.default_rng(6)
    adj = (rng.random((3, 12, 12)) < 0.3).astype(np.float32)
    v = rng.standard_normal((3, 12, 5)).astype(np.float32)
    cot = rng.standard_normal((3, 12, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: J.adj_conv(x, jnp.asarray(adj, jnp.bfloat16), True),
                        jnp.asarray(v))
    x = torch.from_numpy(v).requires_grad_(True)
    a = torch.from_numpy(adj).requires_grad_(False)
    got = T.adj_conv(x, a)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-6, atol=1e-6)
    assert a.grad is None


@pytest.mark.parametrize("form", ["member", "slot"])
def test_cluster_max_pool_both_forms_match_jax(monkeypatch, form):
    import jax
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops import dense as J
    from deeprank_gnn_tpu_torch.ops import dense as T
    from test_torch_dense import pool_inputs

    threshold = 0 if form == "member" else 1 << 40
    monkeypatch.setattr(J, "_MEMBER_POOL_MIN_BYTES", threshold)
    monkeypatch.setattr(T, "_MEMBER_POOL_MIN_BYTES", threshold)
    calls = []
    for name in ("member_max_pool", "slot_max_pool"):
        real = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, real=real, name=name: calls.append(name)
                            or real(*a))
    h, assign, mem, cot = pool_inputs(np.random.default_rng(9))
    c = cot.shape[1]
    want, vjp = jax.vjp(lambda x: J.cluster_max_pool(x, jnp.asarray(assign), c,
                                                      jnp.asarray(mem)), jnp.asarray(h))
    x = torch.from_numpy(h).requires_grad_(True)
    got = T.cluster_max_pool(x, torch.from_numpy(assign), c, torch.from_numpy(mem))
    (got * torch.from_numpy(cot)).sum().backward()
    assert calls == [f"{form}_max_pool"]
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(T.member_counts(torch.from_numpy(mem), h.shape[1]).numpy(),
                                  np.asarray(J.member_counts(jnp.asarray(mem), h.shape[1])))


@pytest.fixture(scope="module")
def op_batches(db):
    from deeprank_gnn_tpu.data.dense_batch import collate_dense as jax_collate_dense
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense

    jds, tds = datasets(db)
    jg = [jds.get(i) for i in range(len(jds))]
    tg = [tds.get(i) for i in range(len(tds))]
    return (jax_collate_dense(jg, g_pad=12, precompute_ops=True)[0],
            collate_dense(tg, g_pad=12, precompute_ops=True)[0])


# (net name, constructor keywords, operator fields dropped from the batch)
OP_CASES = [
    ("GINet", {}, ()),
    ("GINet", {}, ("agg_x_fm",)),
    ("GINet", {"attention": True}, ()),
    ("FoutNet", {}, ()),
    ("sGAT", {}, ()),
]


def port_grads(model, batch):
    model.zero_grad(set_to_none=True)
    out = model(batch)
    (out[:NUM_GRAPHS] ** 2).sum().backward()
    return out.detach().numpy(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("case", OP_CASES, ids=["GINet", "GINet-aggx", "GINet-attention",
                                                "FoutNet", "sGAT"])
def test_operator_path_matches_jax_and_streaming(op_batches, case):
    import jax

    from test_torch_zoo import models
    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    name, kw, dropped = case
    jb, tb = op_batches
    jb = dataclasses.replace(jb, **{k: None for k in dropped})
    tb = dataclasses.replace(tb, **{k: None for k in dropped})
    plain = dataclasses.replace(tb, **{k: None for k in OPS})
    jm, params, tm = models(name, kw, tb.x.shape[-1], seed=3)

    def loss(p):
        return (jm.apply(p, jb)[:NUM_GRAPHS] ** 2).sum()

    want = np.asarray(jm.apply(params, jb))
    want_grads = state_dict_from_jax_params(name, jax.grad(loss)(params))
    got, grads = port_grads(tm, tb)
    ref, ref_grads = port_grads(tm, plain)
    assert np.isfinite(got).all() and got[:NUM_GRAPHS].std() > 1e-4
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[:NUM_GRAPHS], ref[:NUM_GRAPHS], **TOL)
    for pname, grad in grads.items():
        if grad is None:  # Q1's dead parameters in paper mode
            assert ref_grads[pname] is None and not want_grads[pname].any(), pname
            continue
        np.testing.assert_allclose(grad.numpy(), want_grads[pname].numpy(), err_msg=pname,
                                   **GRAD_TOL)
        np.testing.assert_allclose(grad.numpy(), ref_grads[pname].numpy(), err_msg=pname,
                                   **GRAD_TOL)


def test_operator_path_runs_no_hand_kernel(op_batches, monkeypatch):
    """Paper-mode GINet on operator batches never calls K3's wrapper."""
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.models import ginet as ginet_module

    calls = []
    monkeypatch.setattr(ginet_module, "fused_gin_conv", lambda *a: calls.append(a))
    model = GINet(op_batches[1].x.shape[-1], 1, 1, device="cpu")
    model(op_batches[1]).sum().backward()
    assert calls == []


def test_store_engine_losses_match_jax(db, tmp_path, no_dropout):
    """``NeuralNet(layout="dense", device_cache=True)``: 4 Adam steps (one
    batch an epoch) from one JAX checkpoint, against JAX's engine."""
    start = str(tmp_path / "start.pth.tar")
    jax_engine(db, str(tmp_path / "j0"), target="fnat", batch_size=16, lr=0.005, seed=2,
               layout="dense").save_model(start)
    kw = dict(pretrained_model=start, layout="dense", device_cache=True)
    j = jax_engine(db, str(tmp_path / "j"), **kw)
    t = port_engine(db, str(tmp_path / "t"), **kw)
    j.train(nepoch=4)
    t.train(nepoch=4)
    assert t.train_loader._store is not None and t.train_loader.precompute_ops
    np.testing.assert_allclose(t.train_loss, j.train_loss, **TOL)
    assert len(set(np.round(t.train_loss, 6))) == 4
    np.testing.assert_allclose(t.train_out, j.train_out, **TOL)


def test_chunked_engine_matches_jax_and_resident(db, tmp_path, no_dropout):
    """``device_cache="chunked"`` (3 chunks of 4): shuffled training epochs
    against JAX's chunked engine, and serving bitwise the resident store's."""
    start = str(tmp_path / "start.pth.tar")
    jax_engine(db, str(tmp_path / "j0"), target="fnat", batch_size=4, lr=0.005, seed=2,
               layout="dense").save_model(start)
    kw = dict(pretrained_model=start, layout="dense", device_cache="chunked",
              device_cache_bytes=1)
    j = jax_engine(db, str(tmp_path / "j"), **kw)
    t = port_engine(db, str(tmp_path / "t"), **kw)
    j.train(nepoch=2)
    t.train(nepoch=2)
    assert t.train_loader._chunk_store.num_chunks == 3
    np.testing.assert_allclose(t.train_loss, j.train_loss, **TOL)
    assert t.data["train"]["mol"] == j.data["train"]["mol"]
    resident = port_engine(db, str(tmp_path / "r"), pretrained_model=start, layout="dense",
                           device_cache=True)
    chunked = port_engine(db, str(tmp_path / "c"), **kw)
    resident.test()
    chunked.test()
    assert chunked.test_out == resident.test_out and chunked.test_loss == resident.test_loss
    assert chunked.data["test"]["mol"] == resident.data["test"]["mol"]


def test_bf16_pack_trains_close(db, tmp_path):
    """bf16 packing tracks the lossless run: the only difference is the
    rounding of the raw payloads (JAX's
    ``test_neuralnet_bf16_pack_trains_close``, at its rtol 5e-2)."""
    kw = dict(target="fnat", batch_size=4, percent=(0.8, 0.2), layout="dense", seed=0,
              device_cache=True)
    a = port_engine(db, str(tmp_path / "a"), **kw)
    a.train(nepoch=2, validate=True)
    b = port_engine(db, str(tmp_path / "b"), store_pack="bf16", **kw)
    b.train(nepoch=2, validate=True)
    assert b.train_loader._store.store.segments["x:bf16"].dtype == torch.bfloat16
    assert np.isfinite(b.train_loss).all()
    np.testing.assert_allclose(b.train_loss, a.train_loss, rtol=5e-2)
    np.testing.assert_allclose(b.valid_loss, a.valid_loss, rtol=5e-2)
    assert b.train_loss != a.train_loss

"""PyTorch port vs JAX package at atomic-graph shapes, on the CPU.

The JAX package measures itself at atomic-interface scale: ``bench.py``'s
``build_big_graphs`` (2,560 nodes and 30,000 directed edges a graph, level-0
clusters drawn from ``n // 4`` labels, about 4 nodes each). Here the same
generator, value for value (``chip_smoke.build_atomic_graphs``, which
``chip_smoke.py`` runs at full size on the card), makes 3 graphs of 512 nodes
and 3,000 undirected edges: 6,000 directed edges a graph, more than one of
K3's 2,048-edge tiles, and ~128 clusters of four, so the run-padded node axis
is about twice the node count. Both packages get the same numpy arrays, and
the weights go from JAX to the port through ``state_dict_from_jax_params``.

- ``collate`` and ``collate_dense`` (with and without the precomputed
  operators): integer fields bitwise, float fields at rtol 2e-4, atol 1e-5;
  the port's CSR row pointers against the rows they index;
- GINet forward in the sparse, dense and operator layouts at rtol 2e-4, atol
  1e-5, gradients at rtol 5e-4; the fast mode: K3's fast variant at both
  conv levels' shapes against JAX's ``fused_gin_conv`` on the bf16-rounded
  input (as ``tests/test_torch_fast.py``), and fast GINet on the K3 and
  operator paths within rtol 2e-2, atol 1e-4 of JAX's GINet (JAX on the CPU
  ignores ``exact``; the tolerance of the port's own fast-against-exact
  test);
- 4 Adam steps with dropout off in the sparse and the dense layout, through
  both engines from one JAX checkpoint, on an HDF5 file of the atomic
  graphs;
- ``AtomGraph`` on a seeded synthetic complex (``write_docking_models``):
  the JAX package writes the graphs to HDF5 and clusters them there
  (``PreCluster``), the port converts them in memory (``Graph.to_sample``,
  ``cluster_sample``); the samples bitwise, their collated batches' integer
  fields bitwise, and the scores of both engines served from one
  checkpoint at rtol 2e-4, atol 1e-5;
- the rest of the model zoo (``tests/test_torch_zoo.py``'s eight cases:
  attention GINet in both layouts, the internal tower with and without
  attention, FoutNet and sGAT in both layouts) on the atomic batch: forward
  at rtol 2e-4, atol 1e-5 and every gradient at rtol 5e-4, atol 1e-5; the
  dense ones run the flattened-slot edge ops
  (``tests/test_torch_dense_ops.py`` holds those at ``bench.py``'s own
  per-graph shapes);
- the halo layout at ``d = 1`` (``bench.py``'s ``atomic_halo_step``:
  ``make_halo_mesh``, ``partition_batch``, ``make_halo_train_step`` on one
  device, here a one-rank mesh without a process group): the first 4 Adam
  steps' losses, dropout off, against JAX's halo train step at rtol 2e-4,
  atol 1e-5.
"""

import dataclasses

import h5py
import ml_dtypes
import numpy as np
import pytest
import torch

from chip_smoke import build_atomic_graphs, write_docking_models
from test_torch_zoo import CASES, case_id
from test_torch_zoo import models as zoo_models

TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
FAST_TOL = dict(rtol=2e-2, atol=1e-4)
NODES, EDGES, GRAPHS = 512, 3000, 3
FEATURES = [f"f{i}" for i in range(48)]  # bench.py's write_bench_hdf5 names
ATOM_FEATURES = ["type", "polarity", "atomtype", "bsa", "charge", "pssm"]  # bench.py:490-491
DEAD = ("fc_edge_attr", "fc_attention")


@pytest.fixture(scope="module")
def samples():
    """(JAX samples, port samples) of the same arrays."""
    from deeprank_gnn_tpu.data.dataset import GraphSample as JaxSample

    port = build_atomic_graphs(7, GRAPHS, NODES, EDGES)
    jax = [JaxSample(**{f.name: getattr(s, f.name) for f in dataclasses.fields(s)})
           for s in port]
    return jax, port


@pytest.fixture(scope="module")
def batches(samples):
    from deeprank_gnn_tpu.data.batch import collate as jax_collate
    from deeprank_gnn_tpu.data.dense_batch import collate_dense as jax_collate_dense
    from deeprank_gnn_tpu_torch.data.batch import collate
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense

    jg, tg = samples
    return {
        "sparse": (jax_collate(jg)[0], collate(tg)[0]),
        "dense": (jax_collate_dense(jg)[0], collate_dense(tg)[0]),
        "operators": (jax_collate_dense(jg, precompute_ops=True)[0],
                      collate_dense(tg, precompute_ops=True)[0]),
    }


def assert_fields_match(jb, tb):
    """Every field of both batches: integer and bool ones bitwise, float
    ones at ``TOL``; None in both or in neither. The JAX sparse batch's
    ``edges_sorted`` flag must be set (its sorted kernel takes the batch,
    as K1 does the port's)."""
    if hasattr(jb, "edges_sorted"):
        assert jb.edges_sorted
    for f in dataclasses.fields(jb):
        if f.name == "edges_sorted":
            continue
        a, b = getattr(jb, f.name), getattr(tb, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, f.name
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(b, a.astype(b.dtype), err_msg=f.name, **TOL)
        else:
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_atomic_graphs_have_atomic_shapes(samples, batches):
    """The generator's shapes: doubled edges, clusters of ~4 nodes, more
    than one K3 edge tile a graph, a run-padded node axis ~2x the nodes."""
    _, tg = samples
    for s in tg:
        assert s.x.shape == (NODES, 48) and s.edge_index.shape == (2, 2 * EDGES)
        assert 100 < int(s.cluster0.max()) + 1 <= NODES // 4
    db = batches["dense"][1]
    assert db.row.shape[1] > 2048
    assert 1.5 * NODES < db.x.shape[1] < 2.5 * NODES


@pytest.mark.parametrize("layout", ["sparse", "dense", "operators"])
def test_collate_matches_jax(batches, layout):
    jb, tb = batches[layout]
    assert_fields_match(jb, tb)
    if layout == "sparse":
        # the port's CSR row pointers: each row's run of the valid edges
        for ptr, index, mask in ((tb.edge_rowptr, tb.edge_index, tb.edge_mask),
                                 (tb.pe_rowptr, tb.pe_index, tb.pe_mask),
                                 (tb.iedge_rowptr, tb.iedge_index, tb.iedge_mask),
                                 (tb.pie_rowptr, tb.pie_index, tb.pie_mask)):
            rows = index[0][mask].numpy()
            want = np.searchsorted(rows, np.arange(ptr.shape[0]))
            np.testing.assert_array_equal(ptr.numpy(), want)


def models(seed, dense_fast=False):
    import jax

    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    jm = JaxGINet(48, 1, 1)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = GINet(48, 1, 1, dense_fast=dense_fast, device="cpu")
    tm.load_state_dict(state_dict_from_jax_params("GINet", params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("layout", ["sparse", "dense", "operators"])
def test_ginet_forward_and_gradients_match_jax(batches, layout):
    import jax

    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    jb, tb = batches[layout]
    jm, params, tm = models(3)

    def loss(p):
        return (jm.apply(p, jb)[:GRAPHS] ** 2).sum()

    want = np.asarray(jm.apply(params, jb))
    want_grads = state_dict_from_jax_params("GINet", jax.grad(loss)(params))
    tm.zero_grad(set_to_none=True)
    out = tm(tb)
    (out[:GRAPHS] ** 2).sum().backward()
    got = out.detach().numpy()
    assert np.isfinite(got).all() and got.std() > 1e-4
    np.testing.assert_allclose(got, want, **TOL)
    for name, p in tm.named_parameters():
        if name.split(".")[1] in DEAD:
            assert p.grad is None and not want_grads[name].any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_zoo_forward_and_gradients_match_jax(batches, case):
    import jax

    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    name, kw, layout = case
    jb, tb = batches[layout]
    jm, params, tm = zoo_models(name, kw, 48, seed=len(case_id(case)))

    def loss(p):
        return (jm.apply(p, jb)[:GRAPHS] ** 2).sum()

    want = np.asarray(jm.apply(params, jb))
    want_grads = state_dict_from_jax_params(name, jax.grad(loss)(params))
    out = tm(tb)
    (out[:GRAPHS] ** 2).sum().backward()
    got = out.detach().numpy()
    assert np.isfinite(got).all() and got[:GRAPHS].std() > 1e-4
    np.testing.assert_allclose(got[:GRAPHS], want[:GRAPHS], **TOL)
    for pname, p in tm.named_parameters():
        want_grad = want_grads[pname].numpy()
        if p.grad is None:  # paper mode's dead attention parameters (Q1)
            assert not kw.get("attention") and pname.split(".")[1] in DEAD, pname
            assert not want_grad.any(), pname
            continue
        assert np.isfinite(p.grad.numpy()).all(), pname
        np.testing.assert_allclose(p.grad.numpy(), want_grad, err_msg=pname, **GRAD_TOL)


def bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.mark.parametrize("level", ["conv1", "conv2"])
def test_fast_k3_matches_jax_at_atomic_shapes(batches, level):
    """K3's fast variant at the atomic batch's conv shapes (conv1: a graph's
    ~6,000 edges over three tiles) against JAX's ``fused_gin_conv`` on the
    rounded input, forward and gradient."""
    import jax
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.pallas import fused_gin_conv as jax_fused
    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import fused_gin_conv

    tb = batches["dense"][1]
    row, col, s, f = ((tb.row, tb.col, tb.x.shape[1], 32) if level == "conv1"
                      else (tb.pe_row, tb.pe_col, tb.pool0_mask.shape[1], 64))
    rng = np.random.default_rng(f)
    xw = rng.standard_normal((GRAPHS, s, f)).astype(np.float32)
    cot = rng.standard_normal((GRAPHS, s, f)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jax_fused(v, jnp.asarray(row.numpy()),
                                            jnp.asarray(col.numpy()), False),
                        jnp.asarray(bf16(xw)))
    (want_grad,) = vjp(jnp.asarray(bf16(cot)))
    x = torch.from_numpy(xw).requires_grad_(True)
    got = fused_gin_conv(x, row, col, exact=False)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **GRAD_TOL)


@pytest.mark.parametrize("layout", ["dense", "operators"])
def test_fast_ginet_within_tolerance_of_jax(batches, layout):
    jb, tb = batches[layout]
    jm, params, exact = models(5)
    _, _, fast = models(5, dense_fast=True)
    want = np.asarray(jm.apply(params, jb))
    with torch.inference_mode():
        got, ref = fast(tb).numpy(), exact(tb).numpy()
    assert not np.array_equal(got, ref)
    np.testing.assert_allclose(got, want, **FAST_TOL)


def write_atomic_hdf5(graphs, path):
    """The graphs in the reference schema, as ``bench.py``'s
    ``write_bench_hdf5`` writes them (the first half of the doubled,
    row-sorted edges stored; the loader doubles them again)."""
    with h5py.File(path, "w") as f5:
        for s in graphs:
            grp = f5.create_group(s.mol)
            nd = grp.create_group("node_data")
            for i, name in enumerate(FEATURES):
                nd.create_dataset(name, data=s.x[:, i])
            nd.create_dataset("pos", data=s.pos)
            e = s.edge_index.shape[1] // 2
            grp.create_dataset("edge_index", data=s.edge_index[:, :e].T.astype(np.int64))
            grp.create_group("edge_data").create_dataset("dist", data=s.edge_attr[:e, 0])
            grp.create_dataset("internal_edge_index",
                               data=s.internal_edge_index.T.astype(np.int64))
            grp.create_group("internal_edge_data").create_dataset(
                "dist", data=s.internal_edge_attr[:, 0])
            grp.create_group("score").create_dataset("irmsd", data=s.y)
            cl = grp.create_group("clustering/mcl")
            cl.create_dataset("depth_0", data=s.cluster0.astype(np.int64))
            cl.create_dataset("depth_1", data=s.cluster1.astype(np.int64))
    return path


@pytest.fixture()
def no_dropout(monkeypatch):
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch.models import GINet

    monkeypatch.setattr(JaxGINet, "dropout_rate", 0.0)
    monkeypatch.setattr(GINet, "dropout_rate", 0.0)


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_adam_steps_match_jax(samples, tmp_path, no_dropout, layout):
    """4 Adam steps (one batch an epoch) from one JAX checkpoint through
    both engines on the same HDF5 file of the atomic graphs."""
    from deeprank_gnn_tpu import NeuralNet as JaxNeuralNet
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch import GINet, NeuralNet

    db = write_atomic_hdf5(samples[1], str(tmp_path / "atomic.hdf5"))
    start = str(tmp_path / "start.pth.tar")
    JaxNeuralNet(db, JaxGINet, node_feature=FEATURES, edge_feature=["dist"], target="irmsd",
                 batch_size=GRAPHS, lr=0.005, seed=2, layout=layout,
                 outdir=str(tmp_path / "j0")).save_model(start)
    j = JaxNeuralNet(db, JaxGINet, pretrained_model=start, layout=layout,
                     outdir=str(tmp_path / "j"))
    t = NeuralNet(db, GINet, pretrained_model=start, layout=layout, device="cpu",
                  outdir=str(tmp_path / "t"))
    j.train(nepoch=4)
    t.train(nepoch=4)
    assert len(t.train_loss) == 4 and np.isfinite(t.train_loss).all()
    assert len(set(np.round(t.train_loss, 4))) == 4  # every step moved the weights
    np.testing.assert_allclose(t.train_loss, j.train_loss, **TOL)
    np.testing.assert_allclose(t.train_out, j.train_out, **TOL)


def test_atom_graphs_served_like_jax(tmp_path):
    """``AtomGraph`` graphs of a seeded complex: written, clustered and
    loaded by the JAX package; converted and clustered in memory by the
    port; the same samples and batches, and the same scores from one
    checkpoint."""
    from deeprank_gnn_tpu import NeuralNet as JaxNeuralNet
    from deeprank_gnn_tpu.data.batch import collate as jax_collate
    from deeprank_gnn_tpu.data.dataset import HDF5DataSet as JaxDataSet
    from deeprank_gnn_tpu.data.dataset import PreCluster as JaxPreCluster
    from deeprank_gnn_tpu.featurize.atom_graph import AtomGraph as JaxAtomGraph
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch import GINet, NeuralNet
    from deeprank_gnn_tpu_torch.data.batch import collate
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet, cluster_sample
    from deeprank_gnn_tpu_torch.featurize.atom_graph import AtomGraph

    cx = write_docking_models(str(tmp_path / "docking"), seed=11, n_models=3, res_a=45,
                              res_b=40)
    path = str(tmp_path / "atomic.hdf5")
    port = []
    with h5py.File(path, "w") as f5:
        for pdb in cx["pdbs"]:
            jg = JaxAtomGraph(pdb=pdb, pssm=cx["pssm_files"])
            jg.get_score(cx["ref_file"])
            jg.nx2h5(f5)
            tg = AtomGraph(pdb=pdb, pssm=cx["pssm_files"], device="cpu")
            tg.get_score(cx["ref_file"])
            port.append(cluster_sample(tg.to_sample(ATOM_FEATURES, ["dist"], target="irmsd"),
                                       "mcl"))
    kw = dict(database=path, node_feature=ATOM_FEATURES, edge_feature=["dist"],
              target="irmsd")
    JaxPreCluster(JaxDataSet(**kw), "mcl")
    jds = JaxDataSet(**kw, clustering_method="mcl")
    assert len(jds) == len(port) == 3
    for i, s in enumerate(port):
        want = jds.get(i)
        assert s.mol == want.mol and s.x.shape[1] == 51
        for f in dataclasses.fields(s):
            if f.name == "mol":
                continue
            a, b = getattr(want, f.name), getattr(s, f.name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
            assert np.array_equal(a, b), f.name
    jb, _ = jax_collate([jds.get(i) for i in range(len(jds))])
    tb, _ = collate(GraphListDataSet(port).graphs)
    assert_fields_match(jb, tb)

    start = str(tmp_path / "start.pth.tar")
    JaxNeuralNet(path, JaxGINet, node_feature=ATOM_FEATURES, edge_feature=["dist"],
                 target="irmsd", batch_size=2, seed=4, outdir=str(tmp_path / "j0")
                 ).save_model(start)
    j = JaxNeuralNet(path, JaxGINet, pretrained_model=start, outdir=str(tmp_path / "j"))
    t = NeuralNet(GraphListDataSet(port), GINet, pretrained_model=start, device="cpu",
                  outdir=str(tmp_path / "t"))
    j.test(threshold=0.3)
    t.test(threshold=0.3)
    assert np.isfinite(t.test_out).all() and np.std(t.test_out) > 1e-6
    np.testing.assert_allclose(t.test_out, j.test_out, **TOL)


def test_halo_d1_train_matches_jax(batches, no_dropout):
    """``bench.py``'s ``atomic_halo_step`` (``bench.py:655-660``) at the atomic
    batch: JAX's halo train step on one device against the port's on a
    one-rank mesh, 4 Adam steps from the same weights."""
    import jax
    import optax

    from deeprank_gnn_tpu.parallel import halo as JH
    from deeprank_gnn_tpu_torch.parallel import halo as TH
    from deeprank_gnn_tpu_torch.parallel.mesh import make_halo_mesh

    jb, tb = batches["sparse"]
    jm, params, tm = models(9)
    opt = optax.adam(1e-3)
    jmesh = JH.make_halo_mesh(jax.devices()[:1])
    jstep = JH.make_halo_train_step(jm, opt, jmesh)
    hb = JH.shard_halo_batch(JH.partition_batch(jb, 1), jmesh)
    p, o, rng, want = params, opt.init(params), jax.random.PRNGKey(1), []
    for _ in range(4):
        p, o, loss, _pred, rng = jstep(p, o, hb, rng)
        want.append(float(loss))

    mesh = make_halo_mesh(device="cpu")
    tm.train()
    step = TH.make_halo_train_step(tm, torch.optim.Adam(tm.parameters(), lr=1e-3), mesh)
    thb = TH.shard_halo_batch(TH.partition_batch(tb, 1), mesh)
    got = [float(step(thb)[0]) for _ in range(4)]
    assert len(set(np.round(got, 5))) == 4  # every step moved the weights
    np.testing.assert_allclose(got, want, **TOL)

"""PyTorch port vs JAX package: multi-device training on
``torch.distributed`` (``deeprank_gnn_tpu_torch/parallel``), on the CPU.

The torch ranks are gloo processes (``tests/torch_mesh_worker.py``) over a
``file://`` store in ``tmp_path``; the JAX side runs in this process.

- the graph-parallel dense mesh (``make_mesh(dp=2, ep=1)``) and sparse mesh
  (``make_mesh()``, dp=1 x ep=2 by JAX's default): 3 Adam steps with
  dropout off against JAX's single-device trajectory (losses at rtol 1e-5,
  atol 1e-7, parameters at rtol 1e-4, atol 1e-6, ``tests/test_halo.py``'s
  tolerances), both ranks' parameters bitwise equal;
- ``NeuralNet(mesh=...)`` on 2 ranks (halo, sparse and dense layouts, dropout
  on) trains, validates and tests like the single-process port;
- ``GraphLoader(host_batch_slice=...)`` loads only its slice and matches
  the full batch's content (``tests/test_host_shard_loader.py``'s analog);
- ``initialize()`` from the ``DEEPRANK_*`` variables in 2 processes
  (``tests/test_multihost.py``'s analog);
- ``make_mesh``'s defaults and errors, and ``member_max_partial`` forward
  and tie-splitting backward, against JAX's; the one-rank mesh with the
  device store, in this process.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_data import FEATURE_NAMES, datasets, write_graphs_hdf5

WORKER = os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py")
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
ENGINE_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
STEPS = 3


def run_ranks(tmp_path, world, tasks, env=None, timeout=240):
    """Run ``tasks`` on ``world`` gloo ranks (one worker process each);
    returns each rank's results and printed output."""
    spec = {"store": str(tmp_path / "store"), "world": world, "tasks": tasks,
            "out": str(tmp_path / "rank{rank}.npz"), "env": env is not None}
    spec_path = str(tmp_path / "spec.pt")
    torch.save(spec, spec_path)
    procs = []
    for rank in range(world):
        penv = dict(os.environ)
        penv.update({k: v.format(rank=rank) for k, v in (env or {}).items()})
        procs.append(subprocess.Popen([sys.executable, WORKER, spec_path, str(rank)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, env=penv))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, "\n".join(
        f"rank {rank} exited {code}:\n{text[-4000:]}"
        for rank, (code, text) in enumerate(zip(codes, outputs)))
    results = [dict(np.load(str(tmp_path / f"rank{rank}.npz"))) for rank in range(world)]
    return results, outputs


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return write_graphs_hdf5(str(tmp_path_factory.mktemp("torch_parallel") / "g.hdf5"),
                             num_graphs=8, seed=21)


@pytest.fixture(scope="module")
def start(db):
    """JAX paper-mode GINet parameters and the port's state dict of them."""
    from test_torch_zoo import models

    jm, params, tm = models("GINet", {}, 13, seed=6)
    return jm, params, tm.state_dict()


def jax_trajectory(jm, params, batch):
    """3 single-device Adam steps of the JAX net (dropout off):
    ``tests/test_halo.py``'s ``single_step``."""
    import jax
    import optax

    from deeprank_gnn_tpu.train.losses import mse_loss

    opt = optax.adam(LR)

    def single_step(p, s, b, rng):
        rng, key = jax.random.split(rng)

        def loss_fn(q):
            pred = jm.apply(q, b, training=True, rng=key).reshape(-1)
            return mse_loss(pred, b.y, b.y_mask), pred

        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, rng

    step = jax.jit(single_step)
    p, s, rng, losses = params, opt.init(params), jax.random.PRNGKey(0), []
    for _ in range(STEPS):
        p, s, loss, rng = step(p, s, batch, rng)
        losses.append(float(loss))
    return np.array(losses), p


def assert_params_match(jax_params, got: dict, prefix: str):
    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    want = state_dict_from_jax_params("GINet", jax_params)
    for name, value in want.items():
        np.testing.assert_allclose(got[f"{prefix}param:{name}"], value.numpy(), err_msg=name,
                                   **PARAM_TOL)


@pytest.fixture(scope="module")
def mesh_ranks(db, start, tmp_path_factory):
    """One 2-rank run of every mesh check of this file."""
    common = dict(db=db, g_pad=8, state=start[2], lr=LR, steps=STEPS)
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    tasks = [
        dict(kind="mesh_train", layout="sparse", **common),
        dict(kind="mesh_train", layout="dense", dp=2, ep=1, **common),
        *(dict(kind="engine", label=layout, layout=layout, db=db, outdir=str(tmp))
          for layout in ("halo", "sparse", "dense")),
        dict(kind="engine", label="store", layout="dense", device_cache=True, db=db,
             outdir=str(tmp)),
    ]
    return run_ranks(tmp, 2, tasks)[0]


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_mesh_trajectory_matches_jax(db, start, mesh_ranks, layout, monkeypatch):
    """The graph-parallel mesh's 3 Adam steps follow JAX's single-device
    trajectory; both ranks hold bitwise-equal parameters and the whole
    batch's predictions."""
    from deeprank_gnn_tpu.data.batch import collate as jax_collate
    from deeprank_gnn_tpu.data.dense_batch import collate_dense as jax_collate_dense
    from deeprank_gnn_tpu.models import GINet as JaxGINet

    monkeypatch.setattr(JaxGINet, "dropout_rate", 0.0)
    jds, _ = datasets(db, node_feature=FEATURE_NAMES)
    graphs = [jds.get(i) for i in range(len(jds))]
    jb = (jax_collate_dense if layout == "dense" else jax_collate)(graphs, g_pad=8)[0]
    losses, params = jax_trajectory(start[0], start[1], jb)
    for rank, got in enumerate(mesh_ranks):
        # the mesh's shape and this rank's (dp, ep) coordinates
        want = [2, 1, rank, 0] if layout == "dense" else [1, 2, 0, rank]
        assert got[f"{layout}_mesh"].tolist() == want
        np.testing.assert_allclose(got[f"{layout}_losses"], losses, **LOSS_TOL)
        assert_params_match(params, got, f"{layout}_")
        assert got[f"{layout}_pred"].shape == (8,)
    for key in mesh_ranks[0]:
        if key.startswith(f"{layout}_") and key != f"{layout}_mesh":
            np.testing.assert_array_equal(mesh_ranks[1][key], mesh_ranks[0][key], err_msg=key)


@pytest.mark.parametrize("layout", ["halo", "sparse", "dense", "store"])
def test_neuralnet_on_a_mesh_matches_single_process(db, mesh_ranks, tmp_path, layout):
    """``NeuralNet(mesh=...)`` trains 2 epochs with validation (dropout on)
    and tests on 2 ranks as the single-process port does: the same losses,
    bitwise-equal parameters on both ranks, and the same predictions (a
    streaming dense rank's cover its slice of each batch; with the store,
    ``"store"``, each rank holds the whole store and sees every graph)."""
    from deeprank_gnn_tpu_torch import GINet, NeuralNet

    ref_layout = {"halo": "sparse", "store": "dense"}.get(layout, layout)
    nn = NeuralNet(db, GINet, node_feature=FEATURE_NAMES, edge_feature=["dist"],
                   target="fnat", batch_size=4, percent=[0.5, 0.5], seed=5,
                   layout=ref_layout, device_cache=layout == "store", device="cpu",
                   outdir=str(tmp_path))
    nn.train(nepoch=2, validate=True)
    nn.test(db)
    for rank, got in enumerate(mesh_ranks):
        np.testing.assert_allclose(got[f"{layout}:train_loss"], nn.train_loss, **ENGINE_TOL)
        np.testing.assert_allclose(got[f"{layout}:valid_loss"], nn.valid_loss, **ENGINE_TOL)
        np.testing.assert_allclose(got[f"{layout}:test_loss"], nn.test_loss, **ENGINE_TOL)
        want = np.array(nn.test_out)
        if layout == "dense":
            # positions 2r:2r+2 of each test batch of 4, in dataset order
            want = want.reshape(-1, 4)[:, 2 * rank: 2 * rank + 2].reshape(-1)
        np.testing.assert_allclose(got[f"{layout}:test_out"], want, **ENGINE_TOL)
        for name, p in nn.model.named_parameters():
            np.testing.assert_allclose(got[f"{layout}:param:{name}"], p.detach().numpy(),
                                       err_msg=name, **PARAM_TOL)
    for key in mesh_ranks[0]:
        if key.startswith(f"{layout}:param:"):
            np.testing.assert_array_equal(mesh_ranks[1][key], mesh_ranks[0][key], err_msg=key)


def test_initialize_from_env(db, start, tmp_path):
    """Two processes form the group from the ``DEEPRANK_*`` variables and
    compute the same global loss (``tests/test_multihost.py``'s analog)."""
    env = {"DEEPRANK_COORDINATOR": f"file://{tmp_path / 'env_store'}",
           "DEEPRANK_NUM_PROCESSES": "2", "DEEPRANK_PROCESS_ID": "{rank}"}
    results, outputs = run_ranks(tmp_path, 2, [dict(kind="env_step", db=db, g_pad=8,
                                                    state=start[2])], env=env)
    lines = [next(ln for ln in out.splitlines() if ln.startswith("RANK_LOSS"))
             for out in outputs]
    assert "rank=0 world=2 mesh=(1, 2)" in lines[0] and "rank=1 world=2" in lines[1], lines
    assert lines[0].split("loss=")[1] == lines[1].split("loss=")[1]
    assert np.isfinite(results[0]["loss"])


def _loader_dataset(db):
    _, tds = datasets(db, node_feature=FEATURE_NAMES)
    return tds


def test_host_batch_slice_loads_only_its_slice(db):
    """With ``host_batch_slice`` a rank reads only the payloads in its
    slice of each global batch (``tests/test_host_shard_loader.py``)."""
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader

    ds = _loader_dataset(db)
    loaded = []
    orig_get = ds.get

    def spy_get(i):
        loaded.append(i)
        return orig_get(i)

    ds.get = spy_get
    batches = list(GraphLoader(ds, batch_size=3, layout="dense", host_batch_slice=slice(1, 3)))
    assert len(batches) == 3  # 8 graphs in global batches of 3
    for batch, mols in batches:
        assert batch.num_graphs == 2 and len(mols) <= 2
    expected = [i for start in range(0, 8, 3) for i in range(8)[start: start + 3][1:3]]
    assert sorted(loaded) == expected and len(loaded) < len(ds)
    with pytest.raises(ValueError, match="host_batch_slice requires layout='dense'"):
        GraphLoader(ds, host_batch_slice=slice(0, 1))
    with pytest.raises(ValueError, match="exclusive"):
        GraphLoader(ds, layout="dense", device_cache=True, host_batch_slice=slice(0, 1),
                    device="cpu")


def test_collate_range_matches_full_batch(db, start):
    """A sparse mesh rank collates only its range of a global batch
    (``data.batch.collate_range``): paper-mode GINet on each range gives
    the full batch's predictions of those graphs, an empty range (3 graphs
    in 4 slots over 4 ranks) gives an all-padding batch, and every range
    carries the global targets."""
    from deeprank_gnn_tpu_torch.data.batch import collate, collate_range
    from deeprank_gnn_tpu_torch.data.dataset import HDF5DataSet
    from deeprank_gnn_tpu_torch.models import GINet

    ds = HDF5DataSet(database=db, node_feature=FEATURE_NAMES, edge_feature=["dist"],
                     target="fnat", tqdm=False)
    graphs = [ds.get(i) for i in range(3)]
    model = GINet(13, 1, 1, device="cpu")
    model.load_state_dict(start[2])
    model.eval()
    full, _ = collate(graphs, g_pad=4)
    with torch.no_grad():
        want = model(full).reshape(-1)[:3]
        for lo in range(4):
            rb = collate_range(graphs, slice(lo, lo + 1), 4)
            assert rb.batch.num_graphs == 1 and (rb.lo, rb.hi, rb.num_graphs) == (lo, lo + 1, 4)
            assert torch.equal(rb.y, full.y) and torch.equal(rb.y_mask, full.y_mask)
            got = model(rb.batch).reshape(-1)
            if lo < 3:
                np.testing.assert_allclose(got.numpy(), want[lo:lo + 1].numpy(), rtol=1e-5,
                                           atol=1e-6)
            else:
                assert not rb.batch.node_mask.any() and not rb.batch.y_mask.any()
                assert torch.isfinite(got).all()


def test_host_batch_slice_matches_full_batch(db):
    """The ranks' slices, put side by side, are the full batch: the same
    graphs and every field bitwise, shuffled or not; a slice past the last
    batch's graphs is an all-padding batch."""
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader

    ds = _loader_dataset(db)
    for shuffle in (False, True):
        kw = dict(batch_size=4, layout="dense", shuffle=shuffle, seed=3)
        full = list(GraphLoader(ds, **kw))
        lo = list(GraphLoader(ds, host_batch_slice=slice(0, 2), **kw))
        hi = list(GraphLoader(ds, host_batch_slice=slice(2, 4), **kw))
        assert len(full) == len(lo) == len(hi) == 2
        for (fb, fm), (lb, lm), (hb, hm) in zip(full, lo, hi):
            assert lm + hm == fm
            for name in ("x", "row", "col", "edge_attr", "assign0", "pe_row", "assign1", "y",
                         "y_mask", "node_mask"):
                torch.testing.assert_close(torch.cat([getattr(lb, name), getattr(hb, name)]),
                                           getattr(fb, name), rtol=0, atol=0, msg=name)
    tail = list(GraphLoader(ds, batch_size=3, layout="dense", host_batch_slice=slice(2, 3)))
    assert len(tail) == 3 and tail[-1][1] == [] and not tail[-1][0].y_mask.any()


def test_make_mesh_matches_jax():
    """``make_mesh``'s default shapes and error messages are JAX's."""
    import jax

    from deeprank_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from deeprank_gnn_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    for n in range(1, 9):
        want = jax_make_mesh(jax.devices()[:n]).devices.shape
        assert mesh_shape(n) == want, n
    for n, kw in ((6, dict(ep=4)), (6, dict(dp=4)), (4, dict(dp=3, ep=2)), (8, dict(dp=2, ep=2))):
        with pytest.raises(ValueError) as want:
            jax_make_mesh(jax.devices()[:n], **kw)
        with pytest.raises(ValueError) as got:
            make_mesh(list(range(n)), **kw)
        assert str(got.value) == str(want.value)
    # one process without a process group: the one-rank mesh
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.axis_names, mesh.rank, mesh.coords, mesh.group) == (
        (1, 1), ("dp", "ep"), 0, (0, 0), None)
    with pytest.raises(ValueError, match="needs a process group"):
        make_mesh([0, 1], device="cpu")


def test_member_max_partial_matches_jax():
    """``member_max_partial``: -inf empty slots, and the tie-splitting
    backward of JAX's ``_member_max_bwd``."""
    import jax
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.dense import member_max_partial as jax_partial
    from deeprank_gnn_tpu_torch.ops.dense import member_max_partial

    rng = np.random.default_rng(0)
    g, s, f, c = 2, 9, 3, 4
    # small integers: many ties within a slot
    h = rng.integers(0, 3, (g, s, f)).astype(np.float32)
    assign = rng.integers(0, c, (g, s)).astype(np.int32)
    assign[:, -2:] = c  # padding nodes
    assign[0][assign[0] == 3] = 0  # slot 3 of graph 0 is empty
    m = 8
    mem = np.full((g, c, m), s, np.int32)
    for gi in range(g):
        for ci in range(c):
            members = np.flatnonzero(assign[gi] == ci)
            mem[gi, ci, : len(members)] = members
    cot = rng.standard_normal((g, c, f)).astype(np.float32)

    want, vjp = jax.vjp(lambda x: jax_partial(x, jnp.asarray(mem), jnp.asarray(assign)),
                        jnp.asarray(h))
    (want_grad,) = vjp(jnp.asarray(cot))
    ht = torch.tensor(h, requires_grad=True)
    got = member_max_partial(ht, torch.from_numpy(mem), torch.from_numpy(assign))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert np.isneginf(got[0, 3].detach().numpy()).all()
    got.backward(torch.from_numpy(np.where(np.isfinite(np.asarray(want)), cot, 0.0)))
    (want_grad,) = vjp(jnp.asarray(np.where(np.isfinite(np.asarray(want)), cot, 0.0)))
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-7)
    assert (ht.grad.numpy() != 0).sum() > g * c  # ties shared the cotangent


def test_one_rank_mesh_with_the_store(db, tmp_path):
    """A mesh of one rank in one process (no process group; the collectives
    are the identity) with the dense store on its device: the same
    training as without the mesh, and scanned epochs and the chunked store
    on a mesh raise, naming their ROADMAP item."""
    from deeprank_gnn_tpu_torch import GINet, NeuralNet
    from deeprank_gnn_tpu_torch.parallel import make_mesh

    kw = dict(node_feature=FEATURE_NAMES, edge_feature=["dist"], target="fnat",
              batch_size=4, percent=[0.75, 0.25], seed=2, layout="dense",
              device_cache=True, device="cpu")
    single = NeuralNet(db, GINet, outdir=str(tmp_path / "single"), **kw)
    meshed = NeuralNet(db, GINet, outdir=str(tmp_path / "mesh"), mesh=make_mesh(device="cpu"),
                       **kw)
    assert meshed.train_loader.store_sharding == torch.device("cpu")
    for nn in (single, meshed):
        nn.train(nepoch=2, validate=True)
    np.testing.assert_allclose(meshed.train_loss, single.train_loss, **ENGINE_TOL)
    np.testing.assert_allclose(meshed.valid_loss, single.valid_loss, **ENGINE_TOL)
    for extra in (dict(device_cache="chunked"), dict(scan_epochs=True)):
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP.md, queue 1 \(scanned multi-device epochs\)"):
            NeuralNet(db, GINet, outdir=str(tmp_path / "x"), mesh=make_mesh(device="cpu"),
                      **{**kw, **extra})

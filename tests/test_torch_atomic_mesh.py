"""PyTorch port vs JAX package at atomic-graph shapes on several ranks, and
FoutNet and sGAT from the store's operators there, on the CPU.

The graphs are ``tests/test_torch_atomic.py``'s: ``chip_smoke.build_atomic_graphs``
(``bench.py``'s ``build_big_graphs`` value for value) at 512 nodes and 3,000
undirected edges a graph. The torch ranks are gloo processes
(``tests/torch_mesh_worker.py``, one module-scoped run of 4 ranks) that build
the same graphs in memory; JAX runs in this process on conftest's virtual
CPU devices.

- ``partition_batch`` over 4 shards bitwise JAX's on 3 graphs: the shard
  boundaries at nodes 384, 768 and 1,152 fall inside graphs, so every shard
  has remote edges (at ``chip_smoke.py``'s atomic scale a global batch of
  254 graphs does the same);
- the halo layout on 4 ranks: paper-mode GINet's predictions against JAX's
  ``make_halo_eval_step`` on ``jax.devices()[:4]`` at rtol 2e-4, atol 1e-5;
  4 Adam steps (dropout off), each step's loss (rtol 2e-4, atol 1e-5) and
  gradients summed over the ranks (rtol 5e-4, atol 1e-5) against JAX's halo
  train step there at the parameters the port's step started from; the
  4 losses and the parameters after them against the port's halo step on a
  one-rank mesh in this process at rtol 2e-4, atol 1e-5 (which
  ``tests/test_torch_atomic.py`` holds against JAX); every rank's
  parameters and gradients bitwise equal; one step's collective bytes
  equal the plan;
- the dense (``make_mesh(dp=4, ep=1)``) and sparse (``make_mesh()``)
  graph-parallel meshes on 4 ranks at 4 graphs (one a rank): each of 4 Adam
  steps' loss and gradients against JAX's sharded train step on a mesh of
  4 devices of the same shape, at the tolerances above, from the port's
  parameters; the 4 steps against the same step in one process (a one-rank
  mesh), losses at rtol 1e-5, atol 1e-7 and parameters at rtol 1e-4, atol
  1e-6; every rank's parameters and gradients bitwise equal;
- FoutNet and sGAT in the ``"operators"`` layout (``agg_x``, ``deg0``,
  ``adj1``; ``wagg_x``, ``ea_rowsum0``, ``wadj1``, ``ea_rowsum1``): forward
  at rtol 2e-4, atol 1e-5 and every gradient at rtol 5e-4, atol 1e-5
  against JAX's operator forms, and against the port's streamed dense form;
- the device store's batches with the operators (the weighted ones among
  them) bitwise the collated batches.

Each step is held against JAX from the port's own parameters, not along
JAX's trajectory: Adam moves a parameter whose gradient is below ~1e-7 by up
to the learning rate either way, so two sums of the same gradient in
different orders part there. From the weights of
``tests/test_torch_atomic.py``'s seed 11 the fourth of 4 Adam losses along
JAX's own trajectory differed from JAX's by 3.7e-4 relative (its plain
single-device sparse path did too), while each step's gradients agreed;
these checks pass from seed 9 (the weights used) and from seed 11. A
gradient scaled by a constant (the halo's objective over ``D + 1`` instead of
``D``, or a mesh's normalizer times 1.01) fails the checks against JAX,
though Adam's update does not see it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_atomic import EDGES, GRAD_TOL, NODES, TOL, batches, samples  # noqa: F401
from test_torch_atomic import models as ginet_models
from test_torch_parallel import LOSS_TOL, PARAM_TOL, run_ranks

from chip_smoke import build_atomic_graphs

RANKS = 4
SEED = 7  # test_torch_atomic's samples
STEPS = 4
LR = 1e-3


def atomic_db(count: int) -> tuple:
    """The worker's in-memory source of ``count`` atomic graphs."""
    return ("atomic", SEED, count, NODES, EDGES)


@pytest.fixture(scope="module")
def start():
    """A JAX paper-mode GINet at the atomic width and the port's state dict
    of it: the weights of ``tests/test_torch_atomic.py``'s halo test at
    ``d = 1``."""
    jm, params, tm = ginet_models(9)
    return jm, params, tm.state_dict()


@pytest.fixture(scope="module")
def ranks(start, tmp_path_factory):
    """One run of 4 gloo ranks: the halo's eval and train steps on 3 graphs,
    the two graph-parallel meshes' steps on 4."""
    state = start[2]
    tasks = [
        dict(kind="halo_eval", db=atomic_db(3), g_pad=3, nets=[("paper", "GINet", {}, state)]),
        dict(kind="halo_train", db=atomic_db(3), g_pad=3, state=state, lr=LR, steps=STEPS,
             record=True),
        dict(kind="mesh_train", layout="sparse", db=atomic_db(4), g_pad=4, state=state, lr=LR,
             steps=STEPS, record=True),
        dict(kind="mesh_train", layout="dense", dp=RANKS, ep=1, db=atomic_db(4), g_pad=4,
             state=state, lr=LR, steps=STEPS, record=True),
    ]
    results, _ = run_ranks(tmp_path_factory.mktemp("atomic_mesh"), RANKS, tasks)
    return results


@pytest.fixture(scope="module")
def mesh_graphs():
    """(JAX samples, port samples) of the meshes' 4 graphs, row-sorted as
    the ranks' dataset holds them."""
    from deeprank_gnn_tpu.data.dataset import GraphSample as JaxSample
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet

    port = GraphListDataSet(build_atomic_graphs(SEED, 4, NODES, EDGES)).graphs
    jax = [JaxSample(**{f.name: getattr(s, f.name) for f in dataclasses.fields(s)})
           for s in port]
    return jax, port


@pytest.fixture()
def no_dropout(monkeypatch):
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch.models import GINet

    monkeypatch.setattr(JaxGINet, "dropout_rate", 0.0)
    monkeypatch.setattr(GINet, "dropout_rate", 0.0)


def assert_ranks_equal(results, prefix: str, skip=()):
    for key in results[0]:
        if key.startswith(prefix) and key not in skip:
            for other in results[1:]:
                np.testing.assert_array_equal(other[key], results[0][key], err_msg=key)


def adam(model):
    return torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)


def probe():
    """An optax transformation that leaves the parameters where they are and
    keeps the gradients as its state: a JAX train step with it gives the
    loss and the gradients at the parameters it is given."""
    import jax
    import jax.numpy as jnp
    import optax

    def zeros(tree):
        return jax.tree.map(jnp.zeros_like, tree)

    return optax.GradientTransformation(zeros, lambda g, _state, _params=None: (zeros(g), g))


def grads_at(step, batch):
    """``params -> (grads, loss)`` through a JAX train step made with
    :func:`probe`."""
    import jax

    def run(params):
        _p, grads, loss, _pred, _rng = step(params, probe().init(params), batch,
                                            jax.random.PRNGKey(0))
        return grads, loss

    return run


def assert_steps_match_jax(ranks, prefix: str, jm, loss_and_grads):
    """Every recorded step of the ranks (bitwise equal on each) against JAX
    at the parameters it started from (``loss_and_grads``: see
    :func:`grads_at`); the loss at ``TOL``, every gradient at ``GRAD_TOL``. Each step
    is held from the port's own parameters, so that the steps' small
    differences in summation order do not compound through Adam."""
    from deeprank_gnn_tpu.train.checkpoint import torch_state_dict_to_params
    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    got = ranks[0]
    assert_ranks_equal(ranks, prefix, skip=(f"{prefix}mesh",))
    for i in range(STEPS):
        head = f"{prefix}{i}_param:"
        params = torch_state_dict_to_params(
            jm, {k[len(head):]: v for k, v in got.items() if k.startswith(head)})
        grads, loss = loss_and_grads(params)
        np.testing.assert_allclose(got[f"{prefix}losses"][i], float(loss),
                                   err_msg=f"step {i}", **TOL)
        for name, want in state_dict_from_jax_params("GINet", grads).items():
            np.testing.assert_allclose(got[f"{prefix}{i}_grad:{name}"], want.numpy(),
                                       err_msg=f"step {i} {name}", **GRAD_TOL)


def jax_halo(batches):
    """JAX's halo mesh of 4 virtual devices and the atomic batch placed on it."""
    import jax

    from deeprank_gnn_tpu.parallel import halo as JH

    mesh = JH.make_halo_mesh(jax.devices()[:RANKS])
    return JH, mesh, JH.shard_halo_batch(JH.partition_batch(batches["sparse"][0], RANKS), mesh)


def test_partition_batch_d4_bitwise_jax(batches):
    from deeprank_gnn_tpu.parallel import halo as JH
    from deeprank_gnn_tpu_torch.parallel import halo as TH

    jb, tb = batches["sparse"]
    want, got = JH.partition_batch(jb, RANKS), TH.partition_batch(tb, RANKS)
    assert (got.num_shards, got.nl) == (RANKS, 384) and want.nl == got.nl
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        if f.name == "group" or w is None or not hasattr(got, f.name):
            continue
        w, g = np.asarray(w), getattr(got, f.name)
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)
    # the boundaries fall inside graphs: every shard reads remote rows
    remote = [int(p[-1]) for p in got.rem_rowptr]
    assert min(remote) > 0, remote
    assert got.send_idx.shape[-1] >= 8


def test_halo_eval_matches_jax(ranks, batches, start):
    jm, params, _ = start
    JH, mesh, hb = jax_halo(batches)
    _, want = JH.make_halo_eval_step(jm, mesh)(params, hb)
    want = np.asarray(want)
    for rank, got in enumerate(ranks):
        pred = got["paper:pred"]
        assert pred.shape == (3,) and np.isfinite(pred).all() and pred.std() > 1e-4, rank
        np.testing.assert_allclose(pred, want, err_msg=str(rank), **TOL)


def test_halo_steps_match_jax(ranks, batches, start, no_dropout):
    """Each of the 4 Adam steps of the halo layout on 4 ranks against JAX's
    halo train step on 4 devices from the parameters that step started at."""
    JH, mesh, hb = jax_halo(batches)
    step = JH.make_halo_train_step(start[0], probe(), mesh)
    assert_steps_match_jax(ranks, "halo_", start[0], grads_at(step, hb))


def test_halo_train_matches_one_process(ranks, batches, start, no_dropout):
    """The 4 Adam steps of the halo layout on 4 ranks against the port's
    halo train step on a one-rank mesh in this process
    (``tests/test_torch_atomic.py`` holds that run against JAX's), from the
    same weights: losses and parameters at rtol 2e-4, atol 1e-5."""
    from deeprank_gnn_tpu_torch.parallel import halo as TH
    from deeprank_gnn_tpu_torch.parallel.mesh import make_halo_mesh

    model = ginet_models(9)[2].train()
    mesh = make_halo_mesh(device="cpu")
    step = TH.make_halo_train_step(model, adam(model), mesh)
    hb = TH.shard_halo_batch(TH.partition_batch(batches["sparse"][1], 1), mesh)
    losses = [float(step(hb)[0]) for _ in range(STEPS)]
    assert len(set(np.round(losses, 5))) == STEPS  # every step moved the weights
    for got in ranks:
        np.testing.assert_allclose(got["halo_losses"], losses, **TOL)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(got[f"halo_param:{name}"], p.detach().numpy(),
                                       err_msg=name, **TOL)
    assert_ranks_equal(ranks, "halo_")


def test_halo_bytes_equal_plan(ranks):
    """One halo training step's collective bytes on 4 ranks at the atomic
    shapes: the boundary exchange ``D * H * 32 * 4`` each way, the pooled
    combine's all-gather ``C0 * 33 * 4`` and its backward ``D`` times that,
    one all-reduce of the gradients. (At these small graphs a peer needs
    almost every row of a neighbouring shard, ``H`` near ``Nl``; at
    ``chip_smoke.py``'s atomic scale the exchange is far below an all-gather
    of the node array, and the check there says so.)"""
    for got in ranks:
        d, h, nl, c0 = got["plan"].tolist()
        assert (d, nl) == (RANKS, 384)
        counted = {k[len("bytes:"):]: int(v) for k, v in got.items() if k.startswith("bytes:")}
        n_params = sum(got[k].size for k in got if k.startswith("halo_param:"))
        assert counted == {
            "all_to_all/forward": d * h * 32 * 4,
            "all_to_all/backward": d * h * 32 * 4,
            "all_gather/forward": c0 * 33 * 4,
            "all_gather/backward": d * c0 * 33 * 4,
            "all_reduce/gradients": n_params * 4,
        }, counted
        assert 0 < h <= nl


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_mesh_steps_match_jax(ranks, mesh_graphs, start, no_dropout, layout):
    """Each of the 4 Adam steps of the graph-parallel mesh on 4 ranks, one
    atomic graph a rank, against JAX's sharded train step on a mesh of 4
    devices (dp=4 x ep=1 dense, the default dp=2 x ep=2 sparse) from the
    parameters that step started at."""
    import jax

    from deeprank_gnn_tpu.data.batch import collate as jax_collate
    from deeprank_gnn_tpu.data.dense_batch import collate_dense as jax_collate_dense
    from deeprank_gnn_tpu.parallel import make_mesh
    from deeprank_gnn_tpu.parallel import mesh as JM
    from deeprank_gnn_tpu.parallel.step import make_sharded_train_step

    jg = mesh_graphs[0]
    if layout == "dense":
        mesh = make_mesh(jax.devices()[:RANKS], dp=RANKS, ep=1)
        batch = JM.shard_dense_batch(jax_collate_dense(jg, g_pad=4)[0], mesh)
    else:
        mesh = make_mesh(jax.devices()[:RANKS])
        batch = JM.shard_batch(jax_collate(jg, g_pad=4)[0], mesh)
    step = make_sharded_train_step(start[0], probe(), mesh)
    assert_steps_match_jax(ranks, f"{layout}_", start[0], grads_at(step, batch))


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_mesh_matches_one_process(ranks, mesh_graphs, start, no_dropout, layout):
    """The graph-parallel mesh on 4 ranks, one atomic graph a rank, against
    the same 4 Adam steps in one process (a one-rank mesh)."""
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.parallel import mesh as M
    from deeprank_gnn_tpu_torch.parallel.step import make_sharded_train_step

    graphs = mesh_graphs[1]
    mesh = M.make_mesh(device="cpu")
    if layout == "dense":
        rb = M.shard_dense_batch(collate_dense(graphs, g_pad=4)[0], mesh)
    else:
        rb = M.shard_batch(graphs, mesh, g_pad=4)
    model = GINet(48, 1, 1, device="cpu")
    model.load_state_dict(start[2])
    step = make_sharded_train_step(model, adam(model), mesh)
    losses = [float(step(rb)[0]) for _ in range(STEPS)]
    assert len(set(np.round(losses, 5))) == STEPS
    dp, ep = (RANKS, 1) if layout == "dense" else (2, 2)
    for rank, got in enumerate(ranks):
        assert got[f"{layout}_mesh"].tolist() == [dp, ep, rank // ep, rank % ep]
        np.testing.assert_allclose(got[f"{layout}_losses"], losses, **LOSS_TOL)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(got[f"{layout}_param:{name}"], p.detach().numpy(),
                                       err_msg=name, **PARAM_TOL)
    assert_ranks_equal(ranks, f"{layout}_", skip=(f"{layout}_mesh",))


@pytest.mark.parametrize("name", ["FoutNet", "sGAT"])
def test_operator_forms_match_jax(batches, name):
    """FoutNet and sGAT on the precomputed operators at the atomic batch:
    forward and every gradient against JAX's operator forms, and against
    the port's streamed dense form of the same batch."""
    import jax

    from test_torch_store import OPS
    from test_torch_zoo import models
    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    jb, tb = batches["operators"]
    plain = dataclasses.replace(tb, **{k: None for k in OPS})
    jm, params, tm = models(name, {}, 48, seed=len(name))

    def loss(p):
        return (jm.apply(p, jb)[:3] ** 2).sum()

    def port(batch):
        tm.zero_grad(set_to_none=True)
        out = tm(batch)
        (out[:3] ** 2).sum().backward()
        return out.detach().numpy(), {k: p.grad for k, p in tm.named_parameters()}

    want = np.asarray(jm.apply(params, jb))
    want_grads = state_dict_from_jax_params(name, jax.grad(loss)(params))
    got, grads = port(tb)
    ref, ref_grads = port(plain)
    assert np.isfinite(got).all() and got[:3].std() > 1e-4
    np.testing.assert_allclose(got[:3], want[:3], **TOL)
    np.testing.assert_allclose(got[:3], ref[:3], **TOL)
    for pname, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want_grads[pname].numpy(), err_msg=pname,
                                   **GRAD_TOL)
        np.testing.assert_allclose(grad.numpy(), ref_grads[pname].numpy(), err_msg=pname,
                                   **GRAD_TOL)


def test_store_weighted_operators_bitwise_collated(samples):  # noqa: F811
    """The device store's unshuffled batches with the operators (two of 2
    graphs, the last padded) bitwise the collated ones, field by field, the
    weighted operators among them."""
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet
    from deeprank_gnn_tpu_torch.data.dense_batch import WEIGHTED_OPERATORS

    ds = GraphListDataSet(samples[1])
    kw = dict(batch_size=2, layout="dense", precompute_ops=True)
    streamed = list(GraphLoader(ds, **kw))
    stored = list(GraphLoader(ds, device_cache=True, device="cpu", **kw))
    assert len(streamed) == len(stored) == 2
    for (a, am), (b, bm) in zip(streamed, stored):
        assert am == bm
        assert all(getattr(a, f) is not None for f in WEIGHTED_OPERATORS)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None) == (y is None), f.name
            if x is not None:
                assert x.dtype == y.dtype and x.shape == y.shape, f.name
                assert torch.equal(x, y), f.name

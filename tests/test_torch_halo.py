"""PyTorch port vs JAX package: the halo layout
(``deeprank_gnn_tpu_torch/parallel/halo.py``) on 2 and 4 gloo ranks, on
the CPU.

- ``partition_batch``'s integer fields (and its chunked features and edge
  attributes) bitwise the JAX package's, for 1, 2 and 4 shards;
- the eval predictions of paper-mode, attention and internal-tower GINet,
  FoutNet and sGAT against JAX's ``make_halo_eval_step`` on as many of
  conftest's virtual CPU devices, at JAX's own rtol 2e-5, atol 1e-6
  (``tests/test_halo.py``), on every rank;
- 3 Adam steps of paper-mode GINet with dropout off against JAX's
  single-device trajectory (losses at rtol 1e-5, atol 1e-7; parameters at
  rtol 1e-4, atol 1e-6), every rank's parameters bitwise equal;
- the collective byte counter of one training step equals the plan:
  ``D * H * F * 4`` bytes per boundary exchange each way (F = 32, both
  towers in one exchange), the pooled combine's all-gather of
  ``C0 * (F + 1) * 4`` bytes and its backward reduce-scatter of ``D`` times
  that, one all-reduce of the gradients; and the exchange moves far fewer
  bytes than an all-gather of the node array would.
"""

import numpy as np
import pytest
import torch

from test_torch_data import FEATURE_NAMES, datasets, write_graphs_hdf5
from test_torch_parallel import LOSS_TOL, LR, STEPS, assert_params_match, jax_trajectory, run_ranks

EVAL_TOL = dict(rtol=2e-5, atol=1e-6)
NUM_GRAPHS = 7
NETS = [
    ("paper", "GINet", {}),
    ("attention", "GINet", {"attention": True}),
    ("internal", "GINet", {"internal_tower": True}),
    ("foutnet", "FoutNet", {}),
    ("sgat", "sGAT", {}),
]
INT_FIELDS = (
    "assign0", "send_idx", "loc_rows", "loc_cols", "loc_e2pe", "rem_rows", "rem_cols",
    "rem_e2pe", "isend_idx", "iloc_rows", "iloc_cols", "iloc_e2pie", "irem_rows", "irem_cols",
    "irem_e2pie", "mem0_loc", "pe_index", "pie_index", "assign1", "pool1_graph", "mem1_idx",
)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return write_graphs_hdf5(str(tmp_path_factory.mktemp("torch_halo") / "g.hdf5"),
                             num_graphs=NUM_GRAPHS, seed=12)


@pytest.fixture(scope="module")
def batches(db):
    from deeprank_gnn_tpu.data.batch import collate as jax_collate
    from deeprank_gnn_tpu_torch.data.batch import collate

    jds, tds = datasets(db, node_feature=FEATURE_NAMES)
    jb = jax_collate([jds.get(i) for i in range(len(jds))], g_pad=8)[0]
    tb = collate([tds.get(i) for i in range(len(tds))], g_pad=8)[0]
    return jb, tb


@pytest.fixture(scope="module")
def nets(batches):
    """label -> (JAX net, its parameters, the port's state dict of them)."""
    from test_torch_zoo import models

    num_features = batches[1].x.shape[1]
    out = {}
    for seed, (label, name, kw) in enumerate(NETS):
        jm, params, tm = models(name, kw, num_features, seed=seed + 1)
        out[label] = (jm, params, tm.state_dict())
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda d: f"d{d}")
def ranks(request, db, nets, tmp_path_factory):
    """One run of every check of this file on ``d`` ranks."""
    d = request.param
    tasks = [
        dict(kind="halo_eval", db=db, g_pad=8,
             nets=[(label, name, kw, nets[label][2]) for label, name, kw in NETS]),
        dict(kind="halo_train", db=db, g_pad=8, state=nets["paper"][2], lr=LR, steps=STEPS),
    ]
    results, _ = run_ranks(tmp_path_factory.mktemp(f"halo_d{d}"), d, tasks)
    return d, results


@pytest.mark.parametrize("d", [1, 2, 4])
def test_partition_batch_bitwise_jax(batches, d):
    from deeprank_gnn_tpu.parallel import halo as JH
    from deeprank_gnn_tpu_torch.parallel import halo as TH

    jb, tb = batches
    want, got = JH.partition_batch(jb, d), TH.partition_batch(tb, d)
    assert got.num_shards == d and got.nl == want.nl
    for name in INT_FIELDS + ("x", "loc_eattr", "rem_eattr", "iloc_eattr", "irem_eattr", "y",
                              "y_mask"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # each shard's K1 row pointers cover its nondecreasing rows
    for rows, ptr in ((got.loc_rows, got.loc_rowptr), (got.rem_rows, got.rem_rowptr),
                      (got.iloc_rows, got.iloc_rowptr), (got.irem_rows, got.irem_rowptr)):
        for r, p in zip(rows, ptr):
            assert p[-1] == (r < got.nl).sum() and (np.diff(p) >= 0).all()
            np.testing.assert_array_equal(np.repeat(np.arange(got.nl), np.diff(p)),
                                          r[: p[-1]])


@pytest.mark.parametrize("label", [n[0] for n in NETS])
def test_halo_eval_matches_jax(ranks, batches, nets, label):
    import jax

    from deeprank_gnn_tpu.parallel import halo as JH

    d, results = ranks
    jm, params, _ = nets[label]
    mesh = JH.make_halo_mesh(jax.devices()[:d])
    hb = JH.shard_halo_batch(JH.partition_batch(batches[0], d), mesh)
    _, want = JH.make_halo_eval_step(jm, mesh)(params, hb)
    want = np.asarray(want)
    for rank, got in enumerate(results):
        pred = got[f"{label}:pred"]
        assert pred.shape == (8,) and np.isfinite(pred).all(), rank
        np.testing.assert_allclose(pred[:NUM_GRAPHS], want[:NUM_GRAPHS], err_msg=str(rank),
                                   **EVAL_TOL)


def test_halo_train_matches_jax_single_device(ranks, batches, nets, monkeypatch):
    from deeprank_gnn_tpu.models import GINet as JaxGINet

    monkeypatch.setattr(JaxGINet, "dropout_rate", 0.0)
    d, results = ranks
    jm, params, _ = nets["paper"]
    losses, final = jax_trajectory(jm, params, batches[0])
    for got in results:
        np.testing.assert_allclose(got["halo_losses"], losses, **LOSS_TOL)
        assert_params_match(final, got, "halo_")
    for key in results[0]:
        if key.startswith("halo_"):
            for other in results[1:]:
                np.testing.assert_array_equal(other[key], results[0][key], err_msg=key)


def test_halo_collective_bytes_equal_plan(ranks, batches):
    d, results = ranks
    f = 32  # both paper-mode towers, 16 wide each, in one exchange
    for got in results:
        dd, h, nl, c0 = got["plan"].tolist()
        assert dd == d
        counted = {k[len("bytes:"):]: int(v) for k, v in got.items() if k.startswith("bytes:")}
        n_params = sum(got[k].size for k in got if k.startswith("halo_param:"))
        assert counted == {
            "all_to_all/forward": d * h * f * 4,
            "all_to_all/backward": d * h * f * 4,
            "all_gather/forward": c0 * (f + 1) * 4,
            "all_gather/backward": d * c0 * (f + 1) * 4,
            "all_reduce/gradients": n_params * 4,
        }, counted
        # an all-gather of the [Nl, F] node array, forward and backward
        node_gather = nl * f * 4 + d * nl * f * 4
        assert counted["all_to_all/forward"] + counted["all_to_all/backward"] < node_gather

"""PyTorch port vs JAX package: scanned epochs, on the CPU.

- epoch plans: ``device_epoch_plan`` and ``chunk_epoch_plan`` give JAX's
  slot matrices (bitwise, int32), molecules and padding statistics over two
  shuffled epochs, and the next iterated epoch's order is JAX's; an empty
  chunk plan restores the loader's RNG as JAX's does;
- ``scan_epochs=True``: losses, predictions, epoch data, parameters, Adam
  state and the dropout generator's state bitwise the port's looped store
  epochs, with dropout off and on, for the regression and class tasks;
  within rtol 2e-4, atol 1e-5 of JAX's scanned run with dropout off;
- ``scan_epochs="full"``: bitwise the per-epoch scan; with
  ``save_model="best"`` one checkpoint, for the epoch JAX picks, holding
  that epoch's parameters (which JAX's engine loads); ``save_epoch="all"``
  exports every epoch as the per-epoch scan does;
- ``scan_unroll=3`` over 13 batches (a remainder of one) bitwise the
  rolled scan; the chunked scan bitwise the looped chunked epochs;
  ``test()`` scanned bitwise the looped ``test()``;
- the argument checks raise JAX's errors (``scan_epochs`` without a store,
  a bad flag, ``"full"`` on the chunked store, ``scan_unroll=0``; on a mesh
  the chunked store without scanned epochs, the layout and the batch size's
  divisibility). ``tests/test_torch_scan_mesh.py`` runs scanned epochs on
  a mesh.

On the card the steps are CUDA-graph replays (``chip_smoke.py`` holds them
bitwise to the looped path there); here they run eagerly, grouped as the
card replays them.
"""

import copy
import os

import h5py
import numpy as np
import pytest
import torch

from test_torch_data import datasets, write_graphs_hdf5
from test_torch_train import TOL, jax_engine, port_engine

NUM_GRAPHS = 10


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_scan") / "g.hdf5"), num_graphs=NUM_GRAPHS, seed=31
    )


@pytest.fixture()
def no_dropout(monkeypatch):
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch.models import GINet

    monkeypatch.setattr(JaxGINet, "dropout_rate", 0.0)
    monkeypatch.setattr(GINet, "dropout_rate", 0.0)


def loaders(jds, tds, **kw):
    from deeprank_gnn_tpu.data.batch import GraphLoader as JaxLoader
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader

    kw = dict(batch_size=4, layout="dense", shuffle=True, seed=7, **kw)
    return JaxLoader(jds, **kw), GraphLoader(tds, device="cpu", **kw)


def plan_of(loader, device_cache):
    return loader.device_epoch_plan() if device_cache is True else loader.chunk_epoch_plan()


def assert_plans_equal(jp, tp, device_cache):
    if device_cache is True:
        jp, tp = [(0, *jp)], [(0, *tp)]
    assert len(jp) == len(tp)
    for (jci, js, jm), (tci, ts, tm) in zip(jp, tp):
        assert jci == tci and tm == jm
        assert ts.dtype == np.int32 == np.asarray(js).dtype
        np.testing.assert_array_equal(ts, np.asarray(js))


@pytest.mark.parametrize("device_cache", [True, "chunked"], ids=["resident", "chunked"])
def test_epoch_plans_match_jax(db, device_cache):
    jl, tl = loaders(*datasets(db), device_cache=device_cache,
                     device_cache_bytes=1 if device_cache == "chunked" else 2 ** 31)
    for _epoch in range(2):
        jp, tp = plan_of(jl, device_cache), plan_of(tl, device_cache)
        assert_plans_equal(jp, tp, device_cache)
        assert tl.padding_stats == jl.padding_stats
    if device_cache == "chunked":
        assert tl._chunk_store.num_chunks == 3
        pad = {int(s[-1, -1]) for _, s, _ in tp}
        assert pad <= {clen for _, clen in tl._chunk_store.chunk_ranges}
    else:
        assert tp[0][-1, -1] == tl._store.pad_slot
    # the next iterated epoch draws on from the same RNG state
    assert [m for _, m in tl] == [m for _, m in jl]


def test_empty_chunk_plan_restores_rng(db):
    """Every chunk shorter than a batch with ``drop_last``: no plan, and the
    RNG as before it, so the looped epoch draws what a looped run would."""
    jds, tds = datasets(db)
    jds, tds = copy.copy(jds), copy.copy(tds)
    jds.index_complexes = jds.index_complexes[:3]
    tds.index_complexes = tds.index_complexes[:3]
    jl, tl = loaders(jds, tds, device_cache="chunked", device_cache_bytes=1, drop_last=True)
    before = tl._rng.get_state()[1].copy()
    assert jl.chunk_epoch_plan() is None and tl.chunk_epoch_plan() is None
    np.testing.assert_array_equal(tl._rng.get_state()[1], before)
    np.testing.assert_array_equal(tl._rng.get_state()[1], jl._rng.get_state()[1])
    assert list(tl) == [] and list(jl) == []
    np.testing.assert_array_equal(tl._rng.get_state()[1], jl._rng.get_state()[1])


def engines(db, tmp_path, scans, **kw):
    """Fresh port engines from one seed, one per ``scan_epochs`` value."""
    kw = dict(dict(target="fnat", batch_size=4, percent=[0.8, 0.2], layout="dense", seed=0,
                   device_cache=True), **kw)
    return [port_engine(db, str(tmp_path / f"e{i}"), scan_epochs=s, **kw)
            for i, s in enumerate(scans)]


def assert_same_run(a, b, passes=("train", "eval")):
    """Two port engines trained alike: bitwise the same losses, epoch data,
    parameters, Adam state and dropout generator state."""
    assert a.train_loss == b.train_loss and a.valid_loss == b.valid_loss
    for p in passes:
        assert a.data[p] == b.data[p], p
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][name], sb[k][name]), name
    assert torch.equal(a._dropout_generator.get_state(), b._dropout_generator.get_state())


@pytest.mark.parametrize("dropout", [False, True], ids=["no-dropout", "dropout"])
@pytest.mark.parametrize("target", ["fnat", "bin_class"], ids=["reg", "class"])
def test_scan_matches_looped_store_epochs(db, tmp_path, monkeypatch, target, dropout):
    from deeprank_gnn_tpu_torch.models import GINet

    if not dropout:
        monkeypatch.setattr(GINet, "dropout_rate", 0.0)
    looped, scanned = engines(db, tmp_path, [False, True], target=target,
                              class_weights=target == "bin_class")
    for nn in (looped, scanned):
        nn.train(nepoch=2, validate=True)
    assert_same_run(looped, scanned)
    assert scanned.train_loader.padding_stats == looped.train_loader.padding_stats
    assert len(set(np.round(scanned.train_loss, 6))) == 2
    if target == "bin_class":
        assert set(scanned.data["train"]["outputs"]) <= {0, 1}


@pytest.mark.parametrize("target", ["fnat", "bin_class"], ids=["reg", "class"])
def test_scan_matches_jax(db, tmp_path, no_dropout, target):
    """Both packages' ``scan_epochs=True`` from one JAX checkpoint: three
    shuffled epochs of 3 batches."""
    start = str(tmp_path / "start.pth.tar")
    jax_engine(db, str(tmp_path / "j0"), target=target, batch_size=4, lr=0.005, seed=2,
               layout="dense", class_weights=target == "bin_class").save_model(start)
    kw = dict(pretrained_model=start, layout="dense", device_cache=True, scan_epochs=True)
    j = jax_engine(db, str(tmp_path / "j"), **kw)
    t = port_engine(db, str(tmp_path / "t"), **kw)
    j.train(nepoch=3)
    t.train(nepoch=3)
    np.testing.assert_allclose(t.train_loss, j.train_loss, **TOL)
    assert len(set(np.round(t.train_loss, 6))) == 3
    assert t.data["train"]["mol"] == j.data["train"]["mol"]
    np.testing.assert_allclose(np.asarray(t.data["train"]["raw_outputs"], np.float32),
                               np.asarray(j.data["train"]["raw_outputs"], np.float32), **TOL)


def test_full_scan_matches_per_epoch_scan(db, tmp_path):
    per_epoch, full = engines(db, tmp_path, [True, "full"])
    for nn in (per_epoch, full):
        nn.train(nepoch=3, validate=True)
    assert_same_run(per_epoch, full)


def test_full_scan_best_checkpoint_matches_jax(db, tmp_path, no_dropout):
    """``save_model="best"``: JAX's and the port's full scans from the same
    weights pick the same epoch and each writes one file for it; the port's
    holds the parameters the per-epoch scan had after that epoch, and JAX's
    engine loads it."""
    from deeprank_gnn_tpu_torch.train import checkpoint as ckpt

    kw = dict(target="fnat", batch_size=4, percent=[0.8, 0.2], layout="dense", seed=0,
              device_cache=True, lr=0.05)
    j = jax_engine(db, str(tmp_path / "j"), scan_epochs="full", **kw)
    start = str(tmp_path / "start.pth.tar")
    j.save_model(start)
    weights = ckpt.state_dict_from_checkpoint("GINet", ckpt.load_state(start))
    ts = [port_engine(db, str(tmp_path / name), scan_epochs=scan, **kw)
          for name, scan in (("full", "full"), ("epochs", True))]
    for t in ts:
        t.model.load_state_dict(weights)
    j.train(nepoch=3, validate=True, save_model="best")
    params_after = []
    for t in ts:
        t.train(nepoch=1 if t.scan_epochs is True else 3, validate=True, save_model="best")
    per_epoch = ts[1]
    params_after.append({k: v.clone() for k, v in per_epoch.model.state_dict().items()})
    for _ in range(2):
        per_epoch.train(nepoch=1, validate=True, save_model="best")
        params_after.append({k: v.clone() for k, v in per_epoch.model.state_dict().items()})
    full = ts[0]
    np.testing.assert_allclose(full.valid_loss, j.valid_loss, **TOL)
    assert full.valid_loss == per_epoch.valid_loss
    best = int(np.argmin(j.valid_loss)) + 1
    assert best == int(np.argmin(full.valid_loss)) + 1
    name = full._ckpt_name(3, best)
    assert [f for f in os.listdir(tmp_path / "full") if f.endswith(".pth.tar")] == [name]
    assert os.path.exists(tmp_path / "j" / name)
    saved = ckpt.load_state(str(tmp_path / "full" / name))
    for k, v in params_after[best - 1].items():
        assert torch.equal(saved["model"][k], v), k
    jr = jax_engine(db, str(tmp_path / "jr"), pretrained_model=str(tmp_path / "full" / name))
    jw = ckpt.state_dict_from_jax_params("GINet", jr.params)
    for k, v in params_after[best - 1].items():
        np.testing.assert_allclose(np.asarray(jw[k]), v.numpy(), rtol=1e-6, atol=1e-7)


def test_full_scan_save_epoch_all_exports(db, tmp_path):
    per_epoch, full = engines(db, tmp_path, [True, "full"], percent=[1.0, 0.0])
    files = []
    for nn in (per_epoch, full):
        nn.train(nepoch=3, save_epoch="all")
        files.append(os.path.join(nn.outdir, "train_data.hdf5"))
    with h5py.File(files[0], "r") as a, h5py.File(files[1], "r") as b:
        assert sorted(a) == sorted(b) == ["epoch_0001", "epoch_0002", "epoch_0003"]
        for ep in a:
            for name in a[ep]["train"]:
                np.testing.assert_array_equal(a[ep]["train"][name][()], b[ep]["train"][name][()])


def test_scan_unroll_matches_rolled(tmp_path_factory, tmp_path):
    """13 batches of one graph, three steps a graph: the first epoch's
    warm-up step, then 4 groups of 3; the second epoch 4 groups of 3 and a
    remainder of 1."""
    db13 = write_graphs_hdf5(str(tmp_path_factory.mktemp("scan13") / "g.hdf5"),
                             num_graphs=13, seed=5)
    rolled, unrolled = [
        port_engine(db13, str(tmp_path / f"u{u}"), target="fnat", batch_size=1,
                    percent=[1.0, 0.0], layout="dense", seed=0, device_cache=True,
                    scan_epochs=True, scan_unroll=u)
        for u in (1, 3)]
    groups = []
    for _ in range(2):
        rolled.train(nepoch=1)
        unrolled.train(nepoch=1)
        groups.append(unrolled._scan.last_groups)
    assert groups == [[1, 3, 3, 3, 3], [3, 3, 3, 3, 1]]
    assert_same_run(rolled, unrolled, passes=("train",))


def test_chunked_scan_matches_looped(db, tmp_path):
    looped, scanned = engines(db, tmp_path, [False, True], device_cache="chunked",
                              device_cache_bytes=1)
    for nn in (looped, scanned):
        nn.train(nepoch=2, validate=True)
    assert scanned.train_loader._chunk_store.num_chunks == 2
    assert_same_run(looped, scanned)
    assert sorted(scanned.data["train"]["mol"]) == sorted(looped.data["train"]["mol"])


@pytest.mark.parametrize("device_cache", [True, "chunked"], ids=["resident", "chunked"])
def test_scanned_test_matches_looped(db, tmp_path, device_cache):
    start = str(tmp_path / "start.pth.tar")
    port_engine(db, str(tmp_path / "s"), target="fnat", batch_size=4, layout="dense",
                seed=3).save_model(start)
    kw = dict(pretrained_model=start, layout="dense", device_cache=device_cache,
              device_cache_bytes=1 if device_cache == "chunked" else None)
    looped = port_engine(db, str(tmp_path / "l"), **kw)
    scanned = port_engine(db, str(tmp_path / "c"), scan_epochs=True, **kw)
    looped.test(threshold=0.3)
    scanned.test(threshold=0.3)
    assert scanned.test_out == looped.test_out and scanned.test_loss == looped.test_loss
    assert scanned.data["test"] == looped.data["test"]
    assert len(scanned.test_out) == NUM_GRAPHS


@pytest.mark.parametrize("kw", [
    dict(layout="dense", scan_epochs=True),
    dict(layout="dense", device_cache=True, scan_epochs="banana"),
    dict(layout="dense", device_cache="chunked", scan_epochs="full"),
    dict(layout="dense", device_cache=True, scan_epochs=True, scan_unroll=0),
], ids=["requires-device-cache", "bad-flag", "full-chunked", "unroll-0"])
def test_scan_argument_errors_match_jax(db, tmp_path, kw):
    """JAX's ``test_scan_epochs_requires_device_cache`` and
    ``test_full_scan_rejects_bad_flag``, the chunked full scan and
    ``scan_unroll=0``: the same error type and message."""
    with pytest.raises(ValueError) as want:
        jax_engine(db, str(tmp_path / "j"), target="fnat", **kw)
    with pytest.raises(ValueError) as got:
        port_engine(db, str(tmp_path / "t"), target="fnat", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(layout="dense", device_cache="chunked"),
    dict(layout="sparse", device_cache=True, scan_epochs=True),
    dict(layout="dense", device_cache=True, scan_epochs=True, batch_size=3),
], ids=["chunked-needs-scan", "scan-needs-dense", "batch-divisible"])
def test_mesh_scan_argument_errors_match_jax(db, tmp_path, kw):
    """JAX's checks of the store and scan options on a mesh of two
    devices (JAX ``train/neuralnet.py:140-145, 185-191``): the same error
    type and message. On the sparse layout both raise the store's layout
    error, which comes first in both engines."""
    import jax
    import torch

    from deeprank_gnn_tpu.parallel import make_mesh
    from deeprank_gnn_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError) as want:
        jax_engine(db, str(tmp_path / "j"), target="fnat",
                   mesh=make_mesh(jax.devices()[:2], dp=2, ep=1), **kw)
    # a two-rank mesh's description: the checks come before any collective
    two = Mesh(group=None, shape=(2, 1), axis_names=("dp", "ep"), rank=0,
               device=torch.device("cpu"))
    with pytest.raises(ValueError) as got:
        port_engine(db, str(tmp_path / "t"), target="fnat", mesh=two, **kw)
    assert str(got.value) == str(want.value)


def test_scan_without_store_runs_the_loop(db, tmp_path, capsys):
    """Over the byte budget the store is not built and a scanned engine
    runs the per-batch loop, as JAX's falls back."""
    looped, scanned = engines(db, tmp_path, [False, True], device_cache_bytes=1024)
    for nn in (looped, scanned):
        nn.train(nepoch=1, validate=True)
    assert "exceeds budget" in capsys.readouterr().out
    assert scanned.train_loader._store is None and scanned._scan.last_groups == []
    assert_same_run(looped, scanned)

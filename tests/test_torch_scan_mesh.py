"""PyTorch port: scanned epochs and the chunked store on a dense mesh, on
the CPU.

Two and four gloo ranks (``tests/torch_mesh_worker.py``'s ``scan_engine``,
spawned once for each rank count) train ``NeuralNet(layout="dense",
mesh=make_mesh(dp=D, ep=1), device_cache=...)`` with dropout on:

- ``scan_epochs=True``, ``"full"`` with ``save_model="best"``, and the
  chunked store split into more than one chunk, each bitwise the looped
  mesh run from the same seed: losses, epoch data, parameters, Adam state
  and the dropout generator's state, on every rank; a pass's collective
  bytes equal the looped pass's;
- the same runs against the single-process scanned run at the north star's
  tolerance (rtol 2e-4, atol 1e-5), and ``"full"``'s one "best" checkpoint
  named as the single-process run's;
- with dropout off, from one JAX checkpoint, against JAX's scanned mesh run
  on as many of conftest's virtual CPU devices (``make_mesh(jax.devices()[:D],
  dp=D, ep=1)``), at that tolerance.

JAX's argument checks of these options are in ``tests/test_torch_scan.py``.
"""

import os

import numpy as np
import pytest

from test_torch_data import write_graphs_hdf5
from test_torch_parallel import run_ranks
from test_torch_train import TOL, jax_engine, port_engine

COMMON = dict(target="fnat", batch_size=4, percent=[0.8, 0.2], seed=3)
RUNS = {
    # label: (scan_epochs, engine keywords, train keywords)
    "looped": (False, dict(device_cache=True), dict(nepoch=2, validate=True)),
    "scan": (True, dict(device_cache=True), dict(nepoch=2, validate=True)),
    "looped_best": (False, dict(device_cache=True),
                    dict(nepoch=3, validate=True, save_model="best")),
    "full_best": ("full", dict(device_cache=True),
                  dict(nepoch=3, validate=True, save_model="best")),
    "looped_chunked": (False, dict(device_cache="chunked", device_cache_bytes=1),
                       dict(nepoch=2, validate=True)),
    "chunked": (True, dict(device_cache="chunked", device_cache_bytes=1),
                dict(nepoch=2, validate=True)),
}
PAIRS = [("scan", "looped"), ("full_best", "looped_best"), ("chunked", "looped_chunked")]


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return write_graphs_hdf5(str(tmp_path_factory.mktemp("torch_scan_mesh") / "g.hdf5"),
                             num_graphs=10, seed=41)


@pytest.fixture(scope="module")
def start(db, tmp_path_factory):
    """A JAX checkpoint: the starting weights of the runs held against JAX."""
    path = str(tmp_path_factory.mktemp("scan_mesh_start") / "start.pth.tar")
    jax_engine(db, str(tmp_path_factory.mktemp("scan_mesh_j0")), target="fnat", batch_size=4,
               lr=0.005, seed=2, layout="dense").save_model(path)
    return path


@pytest.fixture(scope="module", params=[2, 4], ids=lambda d: f"d{d}")
def ranks(request, db, start, tmp_path_factory):
    """One run of every scanned mesh run of this file on ``d`` ranks."""
    d = request.param
    tmp = tmp_path_factory.mktemp(f"scan_mesh_ranks_d{d}")
    tasks = [dict(kind="scan_engine", label=label, scan=scan, kw={**COMMON, **kw}, train=train,
                  db=db, outdir=str(tmp))
             for label, (scan, kw, train) in RUNS.items()]
    tasks.append(dict(kind="scan_engine", label="jax_start", scan=True, no_dropout=True,
                      kw=dict(pretrained_model=start, device_cache=True),
                      train=dict(nepoch=3), db=db, outdir=str(tmp)))
    return d, run_ranks(tmp, d, tasks)[0]


def _keys(ranks, label):
    return [k for k in ranks[0] if k.startswith(f"{label}:")
            and not k.startswith((f"{label}:checkpoints", f"{label}:meta:"))]


@pytest.mark.parametrize("scanned,looped", PAIRS, ids=[p[0] for p in PAIRS])
def test_scanned_mesh_is_the_looped_mesh(ranks, scanned, looped):
    """Bitwise, dropout on: every loss, epoch datum, parameter, Adam state
    and generator state, on every rank, which agree with each other; and
    the collective bytes of one more training pass."""
    _d, ranks = ranks
    keys = _keys(ranks, scanned)
    assert any(":bytes:all_reduce/gradients" in k for k in keys)
    # the scanned run stepped through EpochSteps, the looped one did not
    assert ranks[0][f"{scanned}:meta:groups"].sum() > 0
    assert ranks[0][f"{looped}:meta:groups"].size == 0
    if scanned == "chunked":
        assert ranks[0]["chunked:meta:chunks"] > 1
    assert len(set(np.round(ranks[0][f"{scanned}:train_loss"], 6))) > 1
    for got in ranks:
        for k in keys:
            want = got[k.replace(f"{scanned}:", f"{looped}:", 1)]
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    for other in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)


def test_scanned_mesh_bytes_match_the_plan(ranks):
    """A scanned training pass over ``B`` batches issues what the looped
    pass does: ``B`` loss normalizers and ``B`` numerators (8 B bytes), each
    batch's ``4 / D`` predictions of this rank gathered, and one all-reduce
    of every gradient per step."""
    d, ranks = ranks
    for got in ranks:
        b, n = int(got["scan:batches"]), int(got["scan:params"])
        assert {k.split(":bytes:")[1]: int(v) for k, v in got.items()
                if k.startswith("scan:bytes:")} == {
            "all_gather/loss": 8 * b, "all_gather/outputs": b * (4 // d) * 4,
            "all_reduce/gradients": b * n * 4}


@pytest.mark.parametrize("label", ["scan", "full_best", "chunked"])
def test_scanned_mesh_matches_single_process(db, ranks, tmp_path, label):
    """The single-process port's scanned run from the same seed, within
    the north star's tolerance; ``"full"`` writes one "best" checkpoint,
    under the single-process run's name."""
    _d, ranks = ranks
    scan, kw, train = RUNS[label]
    nn = port_engine(db, str(tmp_path), layout="dense", scan_epochs=scan, **COMMON, **kw)
    nn.train(**train)
    for got in ranks:
        np.testing.assert_allclose(got[f"{label}:train_loss"], nn.train_loss, **TOL)
        np.testing.assert_allclose(got[f"{label}:valid_loss"], nn.valid_loss, **TOL)
        for split in ("train", "eval"):
            assert got[f"{label}:data:{split}:mol"].tolist() == nn.data[split]["mol"]
            np.testing.assert_allclose(got[f"{label}:data:{split}:raw_outputs"],
                                       np.asarray(nn.data[split]["raw_outputs"], np.float32),
                                       **TOL)
        for name, p in nn.model.named_parameters():
            np.testing.assert_allclose(got[f"{label}:param:{name}"], p.detach().numpy(),
                                       err_msg=name, **TOL)
        files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".pth.tar"))
        assert got[f"{label}:checkpoints"].tolist() == files
    if label == "full_best":
        assert len(files) == 1 and files[0].startswith(nn._ckpt_name(3)[: -len(".pth.tar")])


def test_scanned_mesh_matches_jax_mesh(db, start, ranks, tmp_path, monkeypatch):
    """Dropout off, from one JAX checkpoint: three scanned epochs on ``D``
    ranks against JAX's scanned run on a mesh of ``D`` virtual devices."""
    import jax

    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu.parallel import make_mesh

    monkeypatch.setattr(JaxGINet, "dropout_rate", 0.0)
    d, ranks = ranks
    j = jax_engine(db, str(tmp_path / "j"), pretrained_model=start, layout="dense",
                   device_cache=True, scan_epochs=True,
                   mesh=make_mesh(jax.devices()[:d], dp=d, ep=1))
    j.train(nepoch=3)
    assert len(set(np.round(j.train_loss, 6))) == 3
    for got in ranks:
        np.testing.assert_allclose(got["jax_start:train_loss"], j.train_loss, **TOL)
        assert got["jax_start:data:train:mol"].tolist() == j.data["train"]["mol"]
        np.testing.assert_allclose(got["jax_start:data:train:raw_outputs"],
                                   np.asarray(j.data["train"]["raw_outputs"], np.float32),
                                   **TOL)

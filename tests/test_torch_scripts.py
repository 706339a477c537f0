"""PyTorch port vs JAX package: the example and paper scripts, on the CPU.

Each JAX script runs unedited (``runpy.run_path(..., run_name="__main__")``)
in a working directory laid out as its relative paths expect, and its
``_torch`` counterpart's ``main(device="cpu")`` runs in a copy of it. The
docking models and their PSSMs are written from a seed
(``chip_smoke.write_docking_models``: four models of one complex of 45 and
40 residues, the first the reference); the pretrained checkpoints the paper
scripts load are seeded GINets in the reference's state-dict names
(``chip_smoke.write_checkpoint``), since the published ones are not in the
repository.

- ``create_graph`` and ``create_atomic_graph``: the HDF5 files' groups and
  datasets in order, node and edge lists bitwise, features within 1e-9;
- ``nn`` (its 250 epochs capped at 3, dropout off, the port's engine
  started from the JAX engine's initial weights) and ``custom_model`` (the
  port's net from JAX's ``init_params``): losses and predictions at the
  north star's tolerance (rtol 2e-4, atol 1e-5);
- ``score_docking_models``: the scored models and their predictions;
  ``bio_vs_crystal``: the predictions and the metrics it prints.
"""

import os
import runpy
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import write_checkpoint, write_docking_models
from test_torch_featurize import FEAT_TOL, walk
from test_torch_train import TOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NN_EPOCHS = 3


def script(path):
    return os.path.join(ROOT, path)


def port_main(path):
    """The port script's ``main`` (the script loaded without running it)."""
    return runpy.run_path(script(path))["main"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return write_docking_models(str(tmp_path_factory.mktemp("script_models")), seed=9,
                                n_models=4, res_a=45, res_b=40, name="1ATN")


def layout(base, models, pdb: str, pssm: str, ref=None) -> str:
    """A working directory ``base/work`` with the models' PDBs, PSSMs (and
    reference) copied to the relative paths ``pdb``, ``pssm`` (``ref``)."""
    work = os.path.join(base, "work")
    os.makedirs(work)
    for src, rel in ((models["pdb"], pdb), (models["pssm"], pssm), (models["ref"], ref)):
        if rel is not None:
            shutil.copytree(src, os.path.normpath(os.path.join(work, rel)))
    return work


def run_jax(path, cwd, monkeypatch) -> dict:
    monkeypatch.chdir(cwd)
    return runpy.run_path(script(path), run_name="__main__")


def assert_hdf5_equal(got: str, want: str) -> None:
    """Groups and datasets in order; integers and strings bitwise, floats
    within 1e-9."""
    a_items, b_items = walk(want), walk(got)
    assert [n for n, _ in b_items] == [n for n, _ in a_items] and len(a_items) > 20
    for (name, a), (_, b) in zip(a_items, b_items):
        assert b.dtype == a.dtype and np.shape(b) == np.shape(a), name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, err_msg=name, **FEAT_TOL)
        else:
            assert np.array_equal(b, a), name


@pytest.fixture(scope="module")
def residue_hdf5(models, tmp_path_factory):
    """The training scripts' database: the JAX featurizer's residue graphs
    of the models with depth and half-sphere exposure (``biopython=True``),
    which ``nn.py``'s features need, as the reference's 1ATN fixture has
    them."""
    from deeprank_gnn_tpu.featurize.graphgen import GraphHDF5

    out = str(tmp_path_factory.mktemp("residue_hdf5") / "1ATN_residue.hdf5")
    GraphHDF5(pdb_path=models["pdb"], ref_path=models["ref"], pssm_path=models["pssm"],
              biopython=True, outfile=out)
    return out


@pytest.mark.parametrize("name,outfile", [("create_graph", "1ATN_residue.hdf5"),
                                          ("create_atomic_graph", "1ATN_atomic.hdf5")])
def test_create_graph_scripts(models, tmp_path, monkeypatch, name, outfile):
    dirs = ("data/pdb/1ATN", "data/pssm/1ATN", "data/ref/1ATN")
    jax_work = layout(str(tmp_path / "jax"), models, *dirs)
    port_work = layout(str(tmp_path / "port"), models, *dirs)
    run_jax(f"example/{name}.py", jax_work, monkeypatch)
    monkeypatch.chdir(port_work)
    port_main(f"example/{name}_torch.py")(device="cpu")
    assert_hdf5_equal(os.path.join(port_work, outfile), os.path.join(jax_work, outfile))


def copy_db(src: str, dst_dir: str) -> str:
    os.makedirs(dst_dir)
    return shutil.copy(src, os.path.join(dst_dir, os.path.basename(src)))


def test_nn_script(residue_hdf5, tmp_path, monkeypatch):
    """``nn.py``'s training (capped at 3 epochs, dropout off) and the
    port's from the same initial weights: the same losses and
    predictions; both draw their scatter plot."""
    from deeprank_gnn_tpu import NeuralNet as JaxNeuralNet
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch import GINet, NeuralNet
    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    monkeypatch.setattr(JaxGINet, "dropout_rate", 0.0)
    monkeypatch.setattr(GINet, "dropout_rate", 0.0)
    start = {}
    jax_train, port_train = JaxNeuralNet.train, NeuralNet.train

    def jax_capped(self, nepoch=1, **kw):
        start["state"] = state_dict_from_jax_params("GINet", self.params)
        return jax_train(self, nepoch=NN_EPOCHS, **kw)

    def port_from_jax_start(self, nepoch=1, **kw):
        self.model.load_state_dict(start["state"])
        return port_train(self, nepoch=nepoch, **kw)

    monkeypatch.setattr(JaxNeuralNet, "train", jax_capped)
    monkeypatch.setattr(NeuralNet, "train", port_from_jax_start)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    copy_db(residue_hdf5, jax_dir)
    copy_db(residue_hdf5, port_dir)
    j = run_jax("example/nn.py", jax_dir, monkeypatch)["nn"]
    monkeypatch.chdir(port_dir)
    t = port_main("example/nn_torch.py")(nepoch=NN_EPOCHS, device="cpu")
    assert len(t.train_loss) == NN_EPOCHS and len(set(np.round(t.train_loss, 6))) == NN_EPOCHS
    np.testing.assert_allclose(t.train_loss, j.train_loss, **TOL)
    np.testing.assert_allclose(t.train_out, j.train_out, **TOL)
    for d in (jax_dir, port_dir):
        assert os.path.exists(os.path.join(d, "scatter.png"))


def test_custom_model_script(residue_hdf5, tmp_path, monkeypatch, capsys):
    """``custom_model.py``'s 19 epochs, and the port's ``CustomNet`` from
    JAX's ``init_params`` trained by the port's ``train``: the last
    epoch's batch losses and the final parameters; the port's ``main``
    prints one line an epoch."""
    import jax

    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    copy_db(residue_hdf5, jax_dir)
    db = copy_db(residue_hdf5, port_dir)
    j = run_jax("example/custom_model.py", jax_dir, monkeypatch)
    capsys.readouterr()
    monkeypatch.chdir(port_dir)
    _model, history = port_main("example/custom_model_torch.py")(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines if ln.startswith("Epoch")] == [
        f"{e:02d}" for e in range(1, 20)]
    assert len(history) == 19 and np.isfinite(history).all()

    port = runpy.run_path(script("example/custom_model_torch.py"))
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.dataset import HDF5DataSet

    dataset = HDF5DataSet(database=db, node_feature=["type", "polarity", "bsa"],
                          edge_feature=["dist"], target="irmsd", tqdm=False)
    model = port["CustomNet"](dataset.get(0).num_features)
    init = j["init_params"](jax.random.PRNGKey(0), dataset.get(0).num_features)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in init.items()})
    loader = GraphLoader(dataset, batch_size=4, shuffle=True)
    history = port["train"](model, loader, 19, device="cpu")
    np.testing.assert_allclose(history[-1], j["losses"], **TOL)
    for k, v in j["params"].items():
        np.testing.assert_allclose(getattr(model, k).detach().numpy(), np.asarray(v),
                                   err_msg=k, **TOL)


def test_score_docking_models_script(models, tmp_path, monkeypatch):
    """The fold6 scorer (a seeded stand-in in the reference's names) over
    the featurized models: the same models scored, the same predictions."""
    dirs = ("../tests/data/pdb/1ATN", "../tests/data/pssm/1ATN")
    jax_work = layout(str(tmp_path / "jax"), models, *dirs)
    port_work = layout(str(tmp_path / "port"), models, *dirs)
    for work in (jax_work, port_work):
        write_checkpoint(os.path.join(work, "fold6_treg_yfnat_b128_e20_lr0.001_4.pt"), seed=4)
    j = run_jax("paper/score_docking_models.py", jax_work, monkeypatch)["model"]
    monkeypatch.chdir(port_work)
    t = port_main("paper/score_docking_models_torch.py")(device="cpu")
    assert t.data["test"]["mol"] == j.data["test"]["mol"] and len(t.test_out) == 4
    np.testing.assert_allclose(t.test_out, j.test_out, **TOL)


def test_bio_vs_crystal_script(models, tmp_path, monkeypatch):
    """The interface classifier (a seeded stand-in) over the featurized
    models, labelled from ``bio_interfaces.txt``: the same class
    probabilities and the same printed metrics."""
    dirs = ("../DC/pdb", "../DC/pssm")
    jax_work = layout(str(tmp_path / "jax"), models, *dirs)
    port_work = layout(str(tmp_path / "port"), models, *dirs)
    for work in (jax_work, port_work):
        write_checkpoint(os.path.join(work, "tclass_ybio_interface_b128_e50_lr0.001_26.pth.tar"),
                         seed=8, task="class", target="bio_interface")
        with open(os.path.join(work, "bio_interfaces.txt"), "w") as f:
            f.writelines(f"1ATN_{k} {k % 2}\n" for k in range(4))
    jg = run_jax("paper/bio_vs_crystal.py", jax_work, monkeypatch)
    monkeypatch.chdir(port_work)
    t, m = port_main("paper/bio_vs_crystal_torch.py")(device="cpu")
    j, jm = jg["model"], jg["m"]
    assert t.data["test"]["mol"] == j.data["test"]["mol"] and len(t.test_out) == 4
    np.testing.assert_allclose(np.asarray(t.data["test"]["raw_outputs"]),
                               np.asarray(j.data["test"]["raw_outputs"]), **TOL)
    for name in ("accuracy", "specificity", "sensitivity", "precision", "FPR", "FNR"):
        assert getattr(m, name) == getattr(jm, name), name

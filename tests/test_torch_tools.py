"""PyTorch port vs JAX package: the tools, the h5x plot callbacks and the
host subcommands of the CLI.

- ``add_target``, ``hdf5_to_csv`` and ``pssm_3dcons_to_deeprank`` on HDF5
  and text files written here: the same files as the JAX package's;
  ``manifold_embedding`` and the h5x callbacks: the same values and HTML;
- end to end through ``python -m deeprank_gnn_tpu_torch``-style ``main``
  calls with ``--device cpu``: ``graphgen`` on seeded docking models writes
  the JAX package's file (within 1e-9 for floats), ``add-target`` the same
  targets, ``train`` fits a GINet on the port's own graph file and saves a
  checkpoint, ``test`` scores every graph with it, and ``hdf5-to-csv``
  converts the epoch file as the JAX package does.
"""

import glob
import os
import shutil

import h5py
import numpy as np
import pytest

from chip_smoke import write_docking_models
from test_torch_data import write_graphs_hdf5
from test_torch_featurize import walk

FEAT_TOL = dict(rtol=1e-9, atol=1e-9)


def assert_same_hdf5(got, want, exact=False):
    a, b = walk(got), walk(want)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype, name
        if np.asarray(y).dtype.kind == "f" and not exact:
            np.testing.assert_allclose(x, y, err_msg=name, **FEAT_TOL)
        else:
            assert np.array_equal(x, y), name


def test_add_target_matches_jax(tmp_path):
    from deeprank_gnn_tpu.tools import add_target as jax_add_target
    from deeprank_gnn_tpu_torch.tools import add_target

    write_graphs_hdf5(str(tmp_path / "g.hdf5"), num_graphs=5, seed=2)
    for name in ("port", "jax"):
        os.makedirs(tmp_path / name)
        shutil.copy(tmp_path / "g.hdf5", tmp_path / name / "g.hdf5")
    targets = tmp_path / "targets.lst"
    targets.write_text("".join(f"mol_{i:03d} {0.25 * i}\n" for i in range(5)) + "bad line x\n")
    add_target(str(tmp_path / "port"), "my_target", str(targets))
    jax_add_target(str(tmp_path / "jax" / "g.hdf5"), "my_target", str(targets))
    assert_same_hdf5(str(tmp_path / "port" / "g.hdf5"), str(tmp_path / "jax" / "g.hdf5"),
                     exact=True)
    with h5py.File(tmp_path / "port" / "g.hdf5", "r") as f5:
        assert f5["mol_003/score/my_target"][()] == 0.75
    with pytest.raises(ValueError, match="neither an hdf5 file nor a directory"):
        add_target(str(targets), "t", str(targets))


def test_pssm_3dcons_matches_jax(tmp_path):
    from deeprank_gnn_tpu.tools import pssm_3dcons_to_deeprank as jax_convert
    from deeprank_gnn_tpu_torch.tools import pssm_3dcons_to_deeprank

    rng = np.random.default_rng(0)
    lines = ["# 3dcons profile\n", "Last position-specific scoring matrix\n"]
    for i, res in enumerate("ARNDCQEGHILKMFPSTWYV", start=1):
        scores = "".join(f"{v:4d}" for v in rng.integers(-6, 9, 20))
        freqs = " ".join(f"{v:3d}" for v in rng.integers(0, 100, 20))
        lines.append(f"{i:5d} {res}   {scores} {freqs} {rng.random():.2f} 0.00\n")
    for name in ("port", "jax"):
        (tmp_path / f"{name}.pssm").write_text("".join(lines))
    out = pssm_3dcons_to_deeprank(str(tmp_path / "port.pssm"))
    want = jax_convert(str(tmp_path / "jax.pssm"))
    assert out == str(tmp_path / "port.deeprank.pssm")
    got_lines = open(out).read().splitlines()
    assert got_lines == open(want).read().splitlines() and len(got_lines) == 21


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's CLI end to end on six seeded docking models, beside the
    JAX package's ``graphgen``, ``add-target`` and ``hdf5-to-csv``."""
    from deeprank_gnn_tpu.cli import main as jax_main
    from deeprank_gnn_tpu_torch.cli import main

    tmp = tmp_path_factory.mktemp("tools_cli")
    cx = write_docking_models(str(tmp / "models"), seed=9, n_models=6, res_a=40, res_b=35)
    args = ["graphgen", "--pdb", cx["pdb"], "--ref", cx["ref"], "--pssm", cx["pssm"]]
    main(args + ["--out", str(tmp / "port.hdf5"), "--device", "cpu", "--nproc", "2"])
    jax_main(args + ["--out", str(tmp / "jax.hdf5")])
    shutil.copy(tmp / "port.hdf5", tmp / "graphs.hdf5")
    targets = tmp / "targets.lst"
    targets.write_text("".join(f"1SYN_{k} {k / 10}\n" for k in range(6)))
    for name, run in (("port", main), ("jax", jax_main)):
        run(["add-target", str(tmp / f"{name}.hdf5"), "rank", str(targets)])
    out = tmp / "train"
    main(["train", "--database", str(tmp / "graphs.hdf5"), "--target", "fnat",
          "--epochs", "2", "--batch-size", "2", "--val-fraction", "0.34", "--outdir", str(out),
          "--save-model", "last", "--device", "cpu"])
    (ckpt,) = glob.glob(str(out / "*.pth.tar"))
    return {"tmp": tmp, "main": main, "jax_main": jax_main, "ckpt": ckpt, "out": out}


def test_cli_graphgen_and_add_target(cli_run):
    tmp = cli_run["tmp"]
    assert_same_hdf5(str(tmp / "port.hdf5"), str(tmp / "jax.hdf5"))
    with h5py.File(tmp / "port.hdf5", "r") as f5:
        assert sorted(f5) == [f"1SYN_{k}" for k in range(6)]
        assert f5["1SYN_4/score/rank"][()] == 0.4 and "fnat" in f5["1SYN_4/score"]


def test_cli_trains_and_scores_port_graphs(cli_run, capsys):
    """A graph file written by the port's ``graphgen`` trains (above) and
    scores through the port's engine: a prediction for every graph."""
    tmp = cli_run["tmp"]
    capsys.readouterr()
    cli_run["main"](["test", "--database", str(tmp / "graphs.hdf5"), "--checkpoint",
                     cli_run["ckpt"], "--outdir", str(tmp / "scored"), "--device", "cpu"])
    lines = [line.split() for line in capsys.readouterr().out.splitlines()
             if line.startswith("1SYN_")]
    assert sorted(m for m, _ in lines) == [f"1SYN_{k}" for k in range(6)]
    assert np.isfinite([float(v) for _, v in lines]).all()
    with h5py.File(tmp / "graphs.hdf5", "r") as f5:
        assert "clustering/mcl/depth_1" in f5["1SYN_0"]  # the engine's PreCluster


def test_cli_hdf5_to_csv_matches_jax(cli_run, capsys):
    from deeprank_gnn_tpu.tools import hdf5_to_csv as jax_hdf5_to_csv

    (epochs,) = glob.glob(str(cli_run["out"] / "train_data*.hdf5"))
    jax_copy = str(cli_run["tmp"] / "jax_epochs.hdf5")
    shutil.copy(epochs, jax_copy)
    capsys.readouterr()
    cli_run["main"](["hdf5-to-csv", epochs])
    csv = capsys.readouterr().out.strip()
    assert csv == epochs.rsplit(".", 1)[0] + ".csv"
    got = open(csv).read()
    assert got == open(jax_hdf5_to_csv(jax_copy)).read()
    assert got.startswith("epoch,set,model,targets,prediction") and "1SYN_" in got


def test_embedding_and_h5x_match_jax(cli_run, tmp_path):
    """``manifold_embedding`` (tSNE, spectral, MDS) and the h5x callbacks
    (``graph3d``'s HTML and positions, ``tsne_graph``'s 2D positions and
    clusters) on the graph file the port's ``graphgen`` wrote."""
    from deeprank_gnn_tpu.h5x import baseimport as jax_h5x
    from deeprank_gnn_tpu.tools import manifold_embedding as jax_embed
    from deeprank_gnn_tpu_torch.h5x import baseimport
    from deeprank_gnn_tpu_torch.tools import manifold_embedding

    pos = np.random.default_rng(1).standard_normal((40, 3))
    for method in ("tsne", "spectral", "mds"):
        np.testing.assert_allclose(manifold_embedding(pos, method), jax_embed(pos, method),
                                   rtol=1e-6, atol=1e-6)
    path = str(cli_run["tmp"] / "port.hdf5")
    got = baseimport.graph3d(path, "1SYN_1", out=str(tmp_path / "port"))
    want = jax_h5x.graph3d(path, "1SYN_1", out=str(tmp_path / "jax"))
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "port_3d.html").read_text() == (tmp_path / "jax_3d.html").read_text()
    assert os.path.getsize(tmp_path / "port_3d.png") > 0
    pos2d, cluster = baseimport.tsne_graph(path, "1SYN_2", method="mcl",
                                           out=str(tmp_path / "p2"))
    want2d, want_cluster = jax_h5x.tsne_graph(path, "1SYN_2", method="mcl",
                                              out=str(tmp_path / "j2"))
    np.testing.assert_allclose(pos2d, want2d, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(cluster, want_cluster)

"""PyTorch port vs JAX package: the CLI, the plots and ``train(profile=)``.

These run on the CPU only: the card's machine has neither ``h5py`` (the CLI
reads HDF5 and ``train()`` writes its epoch file) nor ``matplotlib``.

- ``main(["train", ...])`` gives the losses of the same API call bitwise,
  and its checkpoint loads in the JAX engine with the same predictions;
  ``main(["test", ...])`` on a JAX checkpoint prints JAX's predictions
  within tolerance; an unknown model exits with JAX's message;
  ``--scan-epochs`` trains; the parsers take JAX's arguments and defaults
  (plus ``--device`` and ``train``'s ``--dense-fast``); ``python -m
  deeprank_gnn_tpu_torch`` runs (``graphgen``, ``add-target`` and
  ``hdf5-to-csv`` run in ``test_torch_tools.py``);
- the four plots write JAX's file names, ``plot_hit_rate`` plots JAX's
  values, and after ``plot_scatter`` the next epoch's order is JAX's;
- ``train(profile=dir)`` writes one trace that parses as JSON, and its
  losses are bitwise those of an unprofiled run.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_data import FEATURE_NAMES, write_graphs_hdf5
from test_torch_neuralnet import jax_checkpoint
from test_torch_train import jax_engine, port_engine

TOL = dict(rtol=2e-4, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_cli") / "g.hdf5"), num_graphs=10, seed=31
    )


@pytest.fixture()
def no_dropout(monkeypatch):
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch.models import GINet

    monkeypatch.setattr(JaxGINet, "dropout_rate", 0.0)
    monkeypatch.setattr(GINet, "dropout_rate", 0.0)


def printed_predictions(out):
    """``{mol: prediction}`` and the test loss from ``test``'s stdout."""
    preds, loss = {}, None
    for line in out.splitlines():
        if line.startswith("mol_"):
            mol, value = line.split()
            preds[mol] = float(value)
        elif line.startswith("test loss:"):
            loss = float(line.split(":")[1])
    return preds, loss


@pytest.mark.parametrize("extra", [[], ["--layout", "dense", "--device-cache"]],
                         ids=["sparse", "dense-store"])
def test_cli_train_matches_api_and_loads_in_jax(db, tmp_path, monkeypatch, capsys, extra):
    from deeprank_gnn_tpu import NeuralNet as JaxNeuralNet
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch import GINet, NeuralNet, cli

    engines = []
    real = cli._common_nn
    monkeypatch.setattr(cli, "_common_nn", lambda args: engines.append(real(args)) or engines[-1])
    cli.main(["train", "--database", db, "--node-feature", ",".join(FEATURE_NAMES),
              "--target", "fnat", "--epochs", "2", "--batch-size", "4",
              "--outdir", str(tmp_path / "cli"), "--device", "cpu", *extra])
    (c,) = engines
    assert f"final train loss: {c.train_loss[-1]}" in capsys.readouterr().out
    layout = "dense" if extra else "sparse"
    api = NeuralNet(db, GINet, node_feature=FEATURE_NAMES, edge_feature=["dist"], target="fnat",
                    lr=0.001, batch_size=4, percent=[0.8, 0.2], cluster_nodes="mcl",
                    outdir=str(tmp_path / "api"), layout=layout, device_cache=bool(extra),
                    device="cpu")
    api.train(nepoch=2, validate=True, save_model="best")
    assert c.train_loss == api.train_loss and c.valid_loss == api.valid_loss
    assert (c.layout, c.device_cache, c.device.type) == (layout, bool(extra), "cpu")
    ckpt = sorted(glob.glob(str(tmp_path / "cli" / "treg_yfnat_b4_e2_lr0.001_*.pth.tar")))[-1]
    j = JaxNeuralNet(db, JaxGINet, pretrained_model=ckpt, outdir=str(tmp_path / "j"))
    t = NeuralNet(db, GINet, pretrained_model=ckpt, outdir=str(tmp_path / "t"), device="cpu")
    j.test(threshold=0.3)
    t.test(threshold=0.3)
    np.testing.assert_allclose(t.test_out, j.test_out, **TOL)


def test_cli_test_matches_jax(db, tmp_path, capsys):
    from deeprank_gnn_tpu.cli import main as jax_main
    from deeprank_gnn_tpu_torch.cli import main

    ckpt = jax_checkpoint(db, str(tmp_path / "ckpt" / "model.pth.tar"), "fnat")
    capsys.readouterr()
    jax_main(["test", "--database", db, "--checkpoint", ckpt, "--outdir", str(tmp_path / "j")])
    want, want_loss = printed_predictions(capsys.readouterr().out)
    main(["test", "--database", db, "--checkpoint", ckpt, "--outdir", str(tmp_path / "t"),
          "--device", "cpu"])
    got, got_loss = printed_predictions(capsys.readouterr().out)
    assert list(got) == list(want) and len(got) == 10
    np.testing.assert_allclose(list(got.values()), list(want.values()), **TOL)
    np.testing.assert_allclose(got_loss, want_loss, **TOL)


def test_cli_unknown_model_exits_as_jax(db):
    from deeprank_gnn_tpu.cli import main as jax_main
    from deeprank_gnn_tpu_torch.cli import main

    argv = ["train", "--database", db, "--model", "NotAModel", "--epochs", "1"]
    with pytest.raises(SystemExit) as want:
        jax_main(argv)
    with pytest.raises(SystemExit) as got:
        main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) and "NotAModel" in str(got.value)


@pytest.mark.parametrize("argv", [
    ["train", "--layout", "dense", "--device-cache", "--scan-epochs"],
], ids=["scan-epochs"])
def test_cli_unported_raise(db, tmp_path, argv, capsys):
    """``--scan-epochs`` is ported and trains with scanned epochs (the host
    subcommands that raised here are ported too: ``test_torch_tools.py``
    runs them)."""
    from deeprank_gnn_tpu_torch.cli import main

    argv = argv + ["--database", db, "--outdir", str(tmp_path), "--device", "cpu",
                   "--node-feature", ",".join(FEATURE_NAMES), "--target", "fnat",
                   "--epochs", "2", "--batch-size", "4"]
    main(argv)
    assert "final train loss:" in capsys.readouterr().out


def parser_spec(parser, skip=("device",)):
    """``{subcommand: [(flags, dest, default, choices, required, type)]}``."""
    (sub,) = [a for a in parser._actions if a.dest == "cmd"]
    return {
        name: [(tuple(a.option_strings), a.dest, a.default, a.choices, a.required, a.type)
               for a in p._actions if a.dest not in ("help", *skip)]
        for name, p in sub.choices.items()
    }


def test_cli_parsers_match_jax():
    from deeprank_gnn_tpu.cli import build_parser as jax_parser
    from deeprank_gnn_tpu_torch.cli import build_parser

    assert (parser_spec(build_parser(), skip=("device", "dense_fast"))
            == parser_spec(jax_parser()))
    spec = parser_spec(build_parser(), skip=())
    for cmd in ("graphgen", "train", "test"):
        assert (("--device",), "device", "cuda", ("cuda", "cpu"), False, None) in spec[cmd]
    assert (("--dense-fast",), "dense_fast", False, None, False, None) in spec["train"]


def test_python_m_trains(db, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "deeprank_gnn_tpu_torch", "train", "--database", db,
         "--node-feature", ",".join(FEATURE_NAMES), "--target", "fnat", "--epochs", "1",
         "--batch-size", "4", "--outdir", str(tmp_path), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "final train loss:" in out.stdout
    assert glob.glob(str(tmp_path / "*.pth.tar"))


def test_plots_match_jax(db, tmp_path, monkeypatch, no_dropout):
    """From one JAX checkpoint: both engines train, score and plot; the
    same PNG files, the hit rate's values, and after ``plot_scatter`` (which
    draws from the loaders' shuffle) the same next epoch order."""
    import matplotlib.pyplot as plt

    plotted = []
    real_plot = plt.plot
    monkeypatch.setattr(plt, "plot", lambda x, y, **kw: plotted.append(np.asarray(y))
                        or real_plot(x, y, **kw))
    ckpt = jax_checkpoint(db, str(tmp_path / "ckpt" / "model.pth.tar"), "fnat")
    engines = {}
    for name, make in (("jax", jax_engine), ("port", port_engine)):
        nn = make(db, str(tmp_path / name), pretrained_model=ckpt)
        nn.train(nepoch=2)
        nn.test(threshold=0.3)
        nn.plot_loss()
        nn.plot_acc()
        plotted.clear()
        nn.plot_hit_rate(data="test", threshold=0.3)
        nn.hits = plotted[-1]
        nn.plot_scatter()
        nn.train(nepoch=1)
        engines[name] = nn
    j, t = engines["jax"], engines["port"]
    pngs = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "jax" / "*.png")))
    assert pngs == ["acc_epoch.png", "hitrate.png", "loss_epoch.png", "scatter.png"]
    assert sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "port" / "*.png"))) == pngs
    np.testing.assert_allclose(t.test_out, j.test_out, **TOL)
    np.testing.assert_array_equal(t.hits, j.hits)
    assert t.hits[-1] > 0
    assert t.data["train"]["mol"] == j.data["train"]["mol"]
    np.testing.assert_allclose(t.train_loss, j.train_loss, **TOL)


def test_profile_writes_a_trace_and_changes_nothing(db, tmp_path):
    kw = dict(target="fnat", batch_size=4, percent=[0.8, 0.2], seed=3)
    profiled = port_engine(db, str(tmp_path / "p"), **kw)
    profiled.train(nepoch=2, validate=True, profile=str(tmp_path / "trace"))
    plain = port_engine(db, str(tmp_path / "q"), **kw)
    plain.train(nepoch=2, validate=True)
    (trace,) = glob.glob(str(tmp_path / "trace" / "*"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert profiled.train_loss == plain.train_loss and profiled.valid_loss == plain.valid_loss

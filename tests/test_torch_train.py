"""PyTorch port vs JAX package: training end to end, on the CPU.

- loss trajectories: both packages load one checkpoint saved by the JAX
  engine (``pretrained_model``) and train 4 single-batch epochs, one Adam
  step each, with dropout off, in both layouts and for ``reg`` and
  ``class``: the losses agree at rtol 2e-4, atol 1e-5;
- ``train(nepoch=2, validate=True)`` from scratch in both layouts, with its
  checkpoints and epoch export;
- cross-loading: a port checkpoint loads in the JAX engine with the same
  predictions and Adam moments, and a JAX checkpoint with its optimizer
  resumes in the port with the same losses;
- the options that are not ported raise, and the scan options and the
  executable cache, ported since, take the JAX engine's checks.
"""

import os

import h5py
import numpy as np
import pytest
import torch

from test_torch_data import FEATURE_NAMES, write_graphs_hdf5

TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_train") / "g.hdf5"), num_graphs=10, seed=9
    )


@pytest.fixture()
def no_dropout(monkeypatch):
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch.models import GINet

    monkeypatch.setattr(JaxGINet, "dropout_rate", 0.0)
    monkeypatch.setattr(GINet, "dropout_rate", 0.0)


def jax_engine(db, outdir, **kw):
    from deeprank_gnn_tpu import NeuralNet as JaxNeuralNet
    from deeprank_gnn_tpu.models import GINet as JaxGINet

    if "pretrained_model" in kw:
        return JaxNeuralNet(db, JaxGINet, outdir=outdir, **kw)
    return JaxNeuralNet(db, JaxGINet, node_feature=FEATURE_NAMES, edge_feature=["dist"],
                        outdir=outdir, **kw)


def port_engine(db, outdir, **kw):
    from deeprank_gnn_tpu_torch import GINet, NeuralNet

    if "pretrained_model" in kw:
        return NeuralNet(db, GINet, outdir=outdir, device="cpu", **kw)
    return NeuralNet(db, GINet, node_feature=FEATURE_NAMES, edge_feature=["dist"],
                     outdir=outdir, device="cpu", **kw)


def flat_moments(nn):
    """The port's Adam moments raveled in parameter order."""
    state = nn.optimizer.state_dict()["state"]
    return (np.concatenate([state[i]["exp_avg"].numpy().ravel() for i in sorted(state)]),
            np.concatenate([state[i]["exp_avg_sq"].numpy().ravel() for i in sorted(state)]))


@pytest.mark.parametrize("target", ["fnat", "bin_class"], ids=["reg", "class"])
@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_loss_trajectory_matches_jax(db, tmp_path, no_dropout, layout, target):
    start = str(tmp_path / "start.pth.tar")
    jax_engine(db, str(tmp_path / "j0"), target=target, batch_size=16, lr=0.005,
               seed=2, layout=layout, class_weights=target == "bin_class").save_model(start)
    j = jax_engine(db, str(tmp_path / "j"), pretrained_model=start, layout=layout)
    t = port_engine(db, str(tmp_path / "t"), pretrained_model=start, layout=layout)
    j.train(nepoch=4)
    t.train(nepoch=4)
    assert len(t.train_loss) == 4 and np.isfinite(t.train_loss).all()
    np.testing.assert_allclose(t.train_loss, j.train_loss, **TOL)
    assert len(set(np.round(t.train_loss, 6))) == 4  # every step moved the weights
    np.testing.assert_allclose(t.train_out, j.train_out, **TOL)
    # every parameter has Adam state, Q1's dead ones at exactly zero
    state = t.optimizer.state_dict()["state"]
    assert len(state) == 16
    for i, (name, p) in enumerate(t.model.named_parameters()):
        if name.split(".")[1] in ("fc_edge_attr", "fc_attention"):
            assert not state[i]["exp_avg"].any() and not p.grad.any(), name


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_train_from_scratch(db, tmp_path, layout):
    out = str(tmp_path / layout)
    t = port_engine(db, out, target="fnat", batch_size=4, percent=[0.8, 0.2],
                    layout=layout, seed=3)
    assert len(t.train_loader.dataset) == 8 and len(t.valid_loader.dataset) == 2
    t.train(nepoch=2, validate=True, save_model="best", save_epoch="all")
    t.train(nepoch=1, validate=True, save_model="last", hdf5="again.hdf5")
    assert len(t.train_loss) == len(t.valid_loss) == 3
    assert np.isfinite(t.train_loss + t.valid_loss).all()
    files = sorted(os.listdir(out))
    assert "treg_yfnat_b4_e2_lr0.01_1.pth.tar" in files
    assert "treg_yfnat_b4_e1_lr0.01.pth.tar" in files
    with h5py.File(os.path.join(out, "train_data.hdf5"), "r") as f5:
        assert sorted(f5) == ["epoch_0001", "epoch_0002"]
        assert sorted(f5["epoch_0002"]) == ["eval", "train"]
        assert len(f5["epoch_0002/train/mol"]) == 8
    # the same seed gives the same run, dropout included
    again = port_engine(db, str(tmp_path / "again"), target="fnat", batch_size=4,
                        percent=[0.8, 0.2], layout=layout, seed=3)
    again.train(nepoch=2, validate=True, save_model="best", save_epoch="all")
    assert again.train_loss == t.train_loss[:2] and again.valid_loss == t.valid_loss[:2]


def test_split_and_class_weights_match_jax(db, tmp_path):
    j = jax_engine(db, str(tmp_path / "j"), target="bin_class", batch_size=4,
                   percent=[0.7, 0.3], class_weights=True, seed=4)
    t = port_engine(db, str(tmp_path / "t"), target="bin_class", batch_size=4,
                    percent=[0.7, 0.3], class_weights=True, seed=4)
    for jl, tl in ((j.train_loader, t.train_loader), (j.valid_loader, t.valid_loader)):
        assert tl.dataset.index_complexes == jl.dataset.index_complexes
        assert [m for _, m in tl] == [m for _, m in jl]  # same shuffled batches
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights), **TOL)
    assert (t.task, t.threshold) == (j.task, j.threshold) == ("class", 1)


def test_port_checkpoint_loads_in_jax(db, tmp_path):
    from deeprank_gnn_tpu.train.checkpoint import adam_state_from_torch, load_state

    t = port_engine(db, str(tmp_path / "t"), target="fnat", batch_size=4, lr=0.002, seed=5)
    t.train(nepoch=2, save_model="last")
    path = str(tmp_path / "t" / "treg_yfnat_b4_e2_lr0.002.pth.tar")
    payload = torch.load(path, weights_only=False)
    assert "rng" not in payload and payload["net"] == "GINet"
    assert all(v.device.type == "cpu" for v in payload["model"].values())

    j = jax_engine(db, str(tmp_path / "j"), pretrained_model=path)
    assert adam_state_from_torch(load_state(path)["optimizer"], j.params, flat=True) is not None
    mu, nu = flat_moments(t)
    np.testing.assert_array_equal(np.asarray(j.opt_state[0].mu), mu)
    np.testing.assert_array_equal(np.asarray(j.opt_state[0].nu), nu)
    assert int(j.opt_state[0].count) == 2 * len(t.train_loader)
    assert j.train_loss == t.train_loss
    j.test(threshold=0.3)
    t.test(database_test=db, threshold=0.3)
    np.testing.assert_allclose(t.test_out, j.test_out, **TOL)
    np.testing.assert_allclose(t.test_loss, j.test_loss, **TOL)


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_jax_checkpoint_resumes_in_port(db, tmp_path, no_dropout, layout):
    j0 = jax_engine(db, str(tmp_path / "j0"), target="fnat", batch_size=16, lr=0.004,
                    seed=6, layout=layout)
    j0.train(nepoch=2, save_model="last")
    path = str(tmp_path / "j0" / "treg_yfnat_b16_e2_lr0.004.pth.tar")
    j = jax_engine(db, str(tmp_path / "j"), pretrained_model=path, layout=layout)
    t = port_engine(db, str(tmp_path / "t"), pretrained_model=path, layout=layout)
    mu, nu = flat_moments(t)
    np.testing.assert_array_equal(mu, np.asarray(j.opt_state[0].mu))
    np.testing.assert_array_equal(nu, np.asarray(j.opt_state[0].nu))
    assert all(float(s["step"]) == 2 for s in t.optimizer.state_dict()["state"].values())
    j.train(nepoch=2)
    t.train(nepoch=2)
    # the second loss follows an update that used the restored moments
    assert len(t.train_loss) == 4
    np.testing.assert_allclose(t.train_loss, j.train_loss, **TOL)


def first_dropout_mask(nn):
    """The mask of the engine's next dropout draw (GINet's rate, 256 units),
    drawn from a copy of its generator."""
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.models.common import dropout

    gen = torch.Generator(device=nn.device)
    gen.set_state(nn._dropout_generator.get_state())
    return dropout(torch.ones(256), GINet.dropout_rate, gen, True) != 0


def test_port_checkpoint_resumes_in_port(db, tmp_path, capsys):
    """Weights, Adam moments and the dropout generator's state come back
    from a port checkpoint: the reloaded engine goes on with the saved
    dropout stream (bitwise the state at save time), not the seed's. A
    checkpoint without that state (a JAX one), or with one saved on another
    device type, resumes seeded from ``seed`` and says so."""
    from deeprank_gnn_tpu_torch.train.neuralnet import DROPOUT_KEY

    t = port_engine(db, str(tmp_path / "t"), target="fnat", batch_size=4, seed=7,
                    layout="dense")
    fresh_mask = first_dropout_mask(t)
    t.train(nepoch=1)
    saved_state = t._dropout_generator.get_state()  # train() saved the model last
    path = str(tmp_path / "t" / "treg_yfnat_b4_e1_lr0.01.pth.tar")
    r = port_engine(db, str(tmp_path / "r"), pretrained_model=path, layout="dense", seed=7)
    for (name, a), b in zip(t.model.state_dict().items(), r.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = t.optimizer.state_dict()["state"], r.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert all(torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k]))
                   for k in ("step", "exp_avg", "exp_avg_sq"))
    assert torch.equal(r._dropout_generator.get_state(), saved_state)
    assert not torch.equal(first_dropout_mask(r), fresh_mask)
    assert "dropout seeded" not in capsys.readouterr().out
    r.train(nepoch=1)
    assert len(r.train_loss) == 2 and np.isfinite(r.train_loss).all()

    # a state saved on another device type is not restored
    payload = torch.load(path, weights_only=False)
    assert payload[DROPOUT_KEY]["device"] == "cpu"
    payload[DROPOUT_KEY]["device"] = "cuda"
    other = str(tmp_path / "other.pth.tar")
    torch.save(payload, other)
    o = port_engine(db, str(tmp_path / "o"), pretrained_model=other, layout="dense", seed=7)
    assert "state is for cuda, not cpu; dropout seeded from seed 7" in capsys.readouterr().out
    assert torch.equal(first_dropout_mask(o), fresh_mask)

    # a JAX-package checkpoint holds no such state and still resumes
    jpath = str(tmp_path / "jax.pth.tar")
    jax_engine(db, str(tmp_path / "j"), target="fnat", batch_size=4, seed=7,
               layout="dense").save_model(jpath)
    capsys.readouterr()
    j = port_engine(db, str(tmp_path / "jr"), pretrained_model=jpath, layout="dense", seed=7)
    assert ("the checkpoint holds no dropout generator state; dropout seeded from seed 7"
            in capsys.readouterr().out)
    assert torch.equal(first_dropout_mask(j), fresh_mask)
    j.train(nepoch=1)
    assert np.isfinite(j.train_loss).all()


UNPORTED = [
    dict(mesh=object()), dict(layout="halo"), dict(scan_epochs=True),
    dict(scan_unroll=2), dict(executable_cache_dir="cache"),
]


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: next(iter(kw)) + "=" + str(
    next(iter(kw.values())))[:12])
def test_unported_engine_options_raise(db, tmp_path, kw, monkeypatch):
    """``mesh`` and ``layout="halo"`` are not ported and raise. The scan
    options and ``executable_cache_dir`` are ported: ``scan_epochs``
    without ``device_cache`` raises the JAX engine's error, and the other
    two construct as in JAX (``executable_cache_dir`` sets the kernels'
    build directory)."""
    from deeprank_gnn_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "_build_dir", build.build_dir())
    if "mesh" in kw or "layout" in kw:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_engine(db, str(tmp_path), target="fnat", **kw)
    elif "scan_epochs" in kw:
        with pytest.raises(ValueError) as want:
            jax_engine(db, str(tmp_path / "j"), target="fnat", **kw)
        with pytest.raises(ValueError) as got:
            port_engine(db, str(tmp_path), target="fnat", **kw)
        assert str(got.value) == str(want.value) and "device_cache" in str(got.value)
    else:
        t = port_engine(db, str(tmp_path), target="fnat", **kw)
        assert t.scan_unroll == kw.get("scan_unroll", 1)
        if "executable_cache_dir" in kw:
            assert str(build.build_dir()) == os.path.abspath("cache")


def test_unported_methods_raise(db, tmp_path):
    """The engine's methods that raised before (the plots and ``profile=``)
    are ported: each runs on the CPU and writes its file. The fast mode,
    the last of the device store's ROADMAP item, is ported too:
    ``adj_conv(exact=False)`` multiplies the bf16-rounded operands."""
    from deeprank_gnn_tpu_torch.ops.dense import adj_conv

    t = port_engine(db, str(tmp_path), target="fnat", batch_size=4, percent=[0.8, 0.2])
    t.train(nepoch=2, validate=True, profile=str(tmp_path / "trace"))
    assert len(os.listdir(tmp_path / "trace")) == 1
    for name in ("plot_loss", "plot_acc", "plot_hit_rate", "plot_scatter"):
        getattr(t, name)()
    assert {"loss_epoch.png", "acc_epoch.png", "scatter.png"} <= set(os.listdir(tmp_path))
    v = torch.full((1, 2, 3), 1.0 + 2.0 ** -10)
    adj = torch.ones(1, 2, 2)
    torch.testing.assert_close(adj_conv(v, adj, exact=False), torch.full((1, 2, 3), 2.0),
                               rtol=0, atol=0)
    assert not torch.equal(adj_conv(v, adj), torch.full((1, 2, 3), 2.0))


def zoo_nets(name):
    """The JAX package's and the port's net for a zoo name, as a user picks
    them: ``functools.partial`` for GINet's options."""
    import functools

    import deeprank_gnn_tpu.models as J
    import deeprank_gnn_tpu_torch.models as T

    if name.startswith("GINet-"):
        kw = {"attention": True} if name == "GINet-attention" else {"internal_tower": True}
        return functools.partial(J.GINet, **kw), functools.partial(T.GINet, **kw)
    return getattr(J, name), getattr(T, name)


ZOO = [("GINet-attention", "sparse", "fnat"), ("GINet-attention", "dense", "fnat"),
       ("GINet-internal", "sparse", "fnat"), ("FoutNet", "sparse", "fnat"),
       ("FoutNet", "dense", "fnat"), ("sGAT", "sparse", "fnat"), ("sGAT", "dense", "fnat"),
       ("FoutNet", "sparse", "bin_class"), ("sGAT", "dense", "bin_class")]


@pytest.mark.parametrize("name,layout,target", ZOO,
                         ids=[f"{n}-{lay}-{'class' if t == 'bin_class' else 'reg'}"
                              for n, lay, t in ZOO])
def test_zoo_loss_trajectory_matches_jax(db, tmp_path, no_dropout, name, layout, target):
    """4 Adam steps of the rest of the zoo, from one checkpoint saved by the
    JAX engine, in both packages, for regression and (FoutNet and sGAT,
    whose two-class head the engine sizes) classification. With attention
    the attention parameters get real gradients, and the engine's zero fill
    (for Q1's dead ones) leaves them alone."""
    from deeprank_gnn_tpu import NeuralNet as JaxNeuralNet
    from deeprank_gnn_tpu_torch import NeuralNet

    jnet, tnet = zoo_nets(name)
    start = str(tmp_path / "start.pth.tar")
    JaxNeuralNet(db, jnet, node_feature=FEATURE_NAMES, edge_feature=["dist"], target=target,
                 batch_size=16, lr=0.005, seed=2, layout=layout,
                 class_weights=target == "bin_class",
                 outdir=str(tmp_path / "j0")).save_model(start)
    j = JaxNeuralNet(db, jnet, pretrained_model=start, layout=layout, outdir=str(tmp_path / "j"))
    t = NeuralNet(db, tnet, pretrained_model=start, layout=layout, device="cpu",
                  outdir=str(tmp_path / "t"))
    assert t.model.fc2.weight.shape[0] == (2 if target == "bin_class" else 1)
    j.train(nepoch=4)
    t.train(nepoch=4)
    assert np.isfinite(t.train_loss).all()
    np.testing.assert_allclose(t.train_loss, j.train_loss, **TOL)
    assert len(set(np.round(t.train_loss, 6))) == 4  # every step moved the weights
    np.testing.assert_allclose(t.train_out, j.train_out, **TOL)
    state = t.optimizer.state_dict()["state"]
    assert len(state) == len(list(t.model.parameters()))
    for i, (pname, p) in enumerate(t.model.named_parameters()):
        dead = name != "GINet-attention" and pname.split(".")[-2] in (
            "fc_edge_attr", "fc_attention")
        assert bool(state[i]["exp_avg"].any()) != dead, pname
        assert bool(p.grad.any()) != dead, pname


@pytest.mark.parametrize("name", ["FoutNet", "sGAT"])
def test_zoo_checkpoints_cross_load(db, tmp_path, no_dropout, name):
    """A port checkpoint of FoutNet or sGAT loads in the JAX engine with the
    same Adam moments and predictions; a JAX checkpoint with its optimizer
    resumes in the port with the same losses."""
    from deeprank_gnn_tpu import NeuralNet as JaxNeuralNet
    from deeprank_gnn_tpu_torch import NeuralNet

    jnet, tnet = zoo_nets(name)
    kw = dict(node_feature=FEATURE_NAMES, edge_feature=["dist"], target="fnat", batch_size=4,
              lr=0.003, seed=8)
    t = NeuralNet(db, tnet, device="cpu", outdir=str(tmp_path / "t"), **kw)
    t.train(nepoch=1, save_model="last")
    path = str(tmp_path / "t" / "treg_yfnat_b4_e1_lr0.003.pth.tar")
    assert torch.load(path, weights_only=False)["net"] == name
    j = JaxNeuralNet(db, jnet, pretrained_model=path, outdir=str(tmp_path / "j"))
    mu, nu = flat_moments(t)
    np.testing.assert_array_equal(np.asarray(j.opt_state[0].mu), mu)
    np.testing.assert_array_equal(np.asarray(j.opt_state[0].nu), nu)
    j.test(threshold=0.3)
    t.test(database_test=db, threshold=0.3)
    np.testing.assert_allclose(t.test_out, j.test_out, **TOL)

    j0 = JaxNeuralNet(db, jnet, outdir=str(tmp_path / "j0"), **{**kw, "batch_size": 16})
    j0.train(nepoch=2, save_model="last")
    path = str(tmp_path / "j0" / "treg_yfnat_b16_e2_lr0.003.pth.tar")
    j = JaxNeuralNet(db, jnet, pretrained_model=path, outdir=str(tmp_path / "j1"))
    r = NeuralNet(db, tnet, pretrained_model=path, device="cpu", outdir=str(tmp_path / "r"))
    np.testing.assert_array_equal(flat_moments(r)[0], np.asarray(j.opt_state[0].mu))
    j.train(nepoch=2)
    r.train(nepoch=2)
    np.testing.assert_allclose(r.train_loss, j.train_loss, **TOL)

"""PyTorch port vs JAX package: pretrained scoring end to end.

``NeuralNet(db, GINet, pretrained_model=ckpt, device="cpu").test()`` in
the port against the JAX package's ``NeuralNet(db, GINet,
pretrained_model=ckpt).test()`` on the same HDF5 file, for both
checkpoint flavours (a pickle saved by the JAX package and a torch file
written with ``torch.save``): outputs, loss, metrics and the exported
``test_data.hdf5`` at rtol 2e-4, atol 1e-5. Also the guards: no JAX in
the port's imports, no silent CPU fallback, unported options raise.
"""

import os
import pickle
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from test_torch_data import FEATURE_NAMES, write_graphs_hdf5

TOL = dict(rtol=2e-4, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_FIELDS = (
    "sensitivity", "specificity", "precision", "NPV", "FPR", "FNR", "FDR",
    "accuracy", "explained_variance", "max_error", "mean_absolute_error",
    "mean_squared_error", "root_mean_squared_error", "mean_squared_log_error",
    "median_squared_log_error", "r2_score",
)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_nn") / "g.hdf5"), num_graphs=10, seed=6
    )


def jax_checkpoint(db, path, target, task=None, class_weights=None):
    """A checkpoint saved by the JAX package's engine (fresh weights)."""
    from deeprank_gnn_tpu import NeuralNet as JaxNeuralNet
    from deeprank_gnn_tpu.models import GINet as JaxGINet

    nn = JaxNeuralNet(
        db, JaxGINet, node_feature=FEATURE_NAMES, edge_feature=["dist"],
        target=target, task=task, batch_size=4, class_weights=class_weights,
        outdir=os.path.dirname(path), seed=1,
    )
    nn.save_model(path)
    return path


def torch_checkpoint(path, target, task, output_shape, threshold, sigmoid=False):
    """A reference-format torch checkpoint written with ``torch.save``."""
    from deeprank_gnn_tpu_torch.models import GINet

    num_features = 5 + 3 + 1 + 4
    model = GINet(num_features, output_shape, 1, device="cpu",
                  generator=torch.Generator().manual_seed(11))
    torch.save(
        {
            "model": model.state_dict(), "optimizer": {}, "node": FEATURE_NAMES,
            "edge": ["dist"], "target": target, "task": task, "classes": [0, 1],
            "class_weight": None, "batch_size": 4, "percent": [1.0, 0.0],
            "lr": 0.001, "index": None, "shuffle": True, "threshold": threshold,
            "cluster_nodes": "mcl", "transform_sigmoid": sigmoid,
        },
        path,
    )
    return path


def serve_both(db, ckpt, outdir, threshold):
    from deeprank_gnn_tpu import NeuralNet as JaxNeuralNet
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch import GINet, NeuralNet

    j = JaxNeuralNet(db, JaxGINet, pretrained_model=ckpt, outdir=os.path.join(outdir, "jax"))
    j.test(threshold=threshold)
    t = NeuralNet(db, GINet, pretrained_model=ckpt, outdir=os.path.join(outdir, "torch"),
                  device="cpu")
    t.test(threshold=threshold)
    return j, t


def assert_served_alike(j, t, threshold, outdir):
    assert (t.target, t.task, t.node_feature) == (j.target, j.task, j.node_feature)
    assert len(t.test_out) == len(j.test_out) == 10
    assert np.isfinite(t.test_out).all()
    np.testing.assert_allclose(t.test_out, j.test_out, **TOL)
    np.testing.assert_allclose(t.test_loss, j.test_loss, **TOL)
    np.testing.assert_array_equal(t.test_y, j.test_y)
    mj, mt = j.get_metrics("test", threshold), t.get_metrics("test", threshold)
    for name in METRIC_FIELDS:
        a, b = getattr(mj, name), getattr(mt, name)
        if a is None:
            assert b is None, name
        else:
            np.testing.assert_allclose(b, a, equal_nan=True, err_msg=name, **TOL)
    np.testing.assert_array_equal(mt.hitrate(), mj.hitrate())
    with h5py.File(os.path.join(outdir, "jax", "test_data.hdf5"), "r") as fj, \
            h5py.File(os.path.join(outdir, "torch", "test_data.hdf5"), "r") as ft:
        gj, gt = fj["epoch_0000"], ft["epoch_0000"]
        assert dict(gj.attrs) == dict(gt.attrs)
        assert sorted(gj["test"]) == sorted(gt["test"]) == [
            "mol", "outputs", "raw_outputs", "targets"]
        np.testing.assert_array_equal(gt["test/mol"][()], gj["test/mol"][()])
        np.testing.assert_array_equal(gt["test/targets"][()], gj["test/targets"][()])
        for name in ("outputs", "raw_outputs"):
            np.testing.assert_allclose(gt[f"test/{name}"][()], gj[f"test/{name}"][()], **TOL)


@pytest.mark.parametrize("flavour", ["jax_pickle", "torch_file"])
def test_pretrained_regression_matches_jax(db, tmp_path, flavour):
    if flavour == "jax_pickle":
        ckpt = jax_checkpoint(db, str(tmp_path / "model.pth.tar"), "fnat")
    else:
        ckpt = torch_checkpoint(str(tmp_path / "model.pt"), "fnat", "reg", 1, 0.3, sigmoid=True)
    j, t = serve_both(db, ckpt, str(tmp_path), threshold=0.3)
    assert t.task == "reg" and t.transform_sigmoid == (flavour == "torch_file")
    assert_served_alike(j, t, 0.3, str(tmp_path))
    assert not torch.are_deterministic_algorithms_enabled()  # restored after the pass


def test_pretrained_classifier_matches_jax(db, tmp_path):
    ckpt = jax_checkpoint(db, str(tmp_path / "cls.pth.tar"), "bin_class", class_weights=True)
    j, t = serve_both(db, ckpt, str(tmp_path), threshold=1)
    assert t.task == "class" and t.weights is not None
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights), **TOL)
    assert set(t.test_out) <= {0, 1}
    raw = np.asarray(t.data["test"]["raw_outputs"])
    np.testing.assert_allclose(raw.sum(axis=1), 1.0, atol=1e-5)
    assert_served_alike(j, t, 1, str(tmp_path))


@pytest.mark.parametrize("where", ["pretrained", "database_test"])
def test_test_loader_keeps_dataset_order_with_buckets(db, tmp_path, where):
    """With ``num_buckets=2`` the JAX package still scores the test set with
    one bucket, in the file's order, both for the loader a pretrained load
    builds and for ``test(database_test=)``; the port does the same: the
    same ``test_out`` order and values (rtol 2e-4, atol 1e-5) and the same
    exported ``mol`` order, over 10 graphs at batch size 4 (two buckets of
    graphs by node count)."""
    from deeprank_gnn_tpu import NeuralNet as JaxNeuralNet
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch import GINet, NeuralNet

    ckpt = jax_checkpoint(db, str(tmp_path / "model.pth.tar"), "fnat")
    j = JaxNeuralNet(db, JaxGINet, pretrained_model=ckpt, num_buckets=2,
                     outdir=str(tmp_path / "jax"))
    t = NeuralNet(db, GINet, pretrained_model=ckpt, num_buckets=2,
                  outdir=str(tmp_path / "torch"), device="cpu")
    assert t.batch_size == 4 and len(t.test_loader.dataset) == 10
    kw = {"database_test": db} if where == "database_test" else {}
    j.test(threshold=0.3, **kw)
    t.test(threshold=0.3, **kw)
    assert t.data["test"]["mol"] == j.data["test"]["mol"] == sorted(t.data["test"]["mol"])
    np.testing.assert_allclose(t.test_out, j.test_out, **TOL)
    np.testing.assert_allclose(t.test_loss, j.test_loss, **TOL)


def test_in_memory_graphs_score_like_the_file(db, tmp_path):
    from deeprank_gnn_tpu_torch import GINet, GraphListDataSet, NeuralNet
    from test_torch_data import graphs

    ckpt = torch_checkpoint(str(tmp_path / "model.pt"), "fnat", "reg", 1, 0.3)
    from_file = NeuralNet(db, GINet, pretrained_model=ckpt, outdir=str(tmp_path / "a"),
                          device="cpu")
    from_file.test(threshold=0.3)
    mem = GraphListDataSet(graphs(db))
    in_mem = NeuralNet(mem, GINet, pretrained_model=ckpt, outdir=str(tmp_path / "b"),
                       device="cpu")
    out, _, ys, loss, data = in_mem.eval(in_mem.test_loader)
    assert out == from_file.test_out and loss == from_file.test_loss
    assert ys == from_file.test_y and data["mol"] == from_file.data["test"]["mol"]
    # test() on another database (here the same file again) scores it with
    # the loaded model and exports next to the first export
    in_mem.test(database_test=db, threshold=0.3)
    assert in_mem.test_out == from_file.test_out
    assert os.path.exists(tmp_path / "b" / "test_data.hdf5")


def test_no_silent_cpu_fallback_and_no_training(db, tmp_path):
    """Training is ported: the constructor without a checkpoint prepares
    it, and a pretrained engine trains on. What is not ported yet (scanned
    epochs on a mesh) still raises, ``scan_epochs`` without a device store
    is refused as in JAX, and ``cuda`` without a card is refused."""
    from deeprank_gnn_tpu_torch import GINet, NeuralNet
    from deeprank_gnn_tpu_torch.parallel import make_mesh

    ckpt = torch_checkpoint(str(tmp_path / "model.pt"), "fnat", "reg", 1, 0.3)
    fresh = NeuralNet(db, GINet, node_feature=FEATURE_NAMES, target="fnat", batch_size=4,
                      outdir=str(tmp_path / "fresh"), device="cpu")
    assert fresh.task == "reg" and len(fresh.train_loader.dataset) == 10
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NeuralNet(db, GINet, target="fnat", layout="dense", device_cache=True,
                  scan_epochs=True, mesh=make_mesh(device="cpu"), device="cpu")
    nn = NeuralNet(db, GINet, pretrained_model=ckpt, outdir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="scan_epochs requires device_cache"):
        NeuralNet(db, GINet, pretrained_model=ckpt, scan_epochs=True, device="cpu")
    nn.train(nepoch=1, save_model=None)
    assert len(nn.train_loss) == 1 and np.isfinite(nn.train_loss).all()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NeuralNet(db, GINet, pretrained_model=ckpt, outdir=str(tmp_path))


def test_losses_match_jax():
    import jax.numpy as jnp

    from deeprank_gnn_tpu.train import losses as J
    from deeprank_gnn_tpu_torch.train import losses as T

    rng = np.random.default_rng(2)
    pred = rng.standard_normal(9).astype(np.float32)
    logits = rng.standard_normal((9, 3)).astype(np.float32)
    y = rng.random(9).astype(np.float32)
    y_idx = rng.integers(0, 3, 9).astype(np.int32)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], dtype=bool)
    w = np.array([0.2, 0.5, 0.3], dtype=np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        T.mse_loss(t(pred), t(y), t(mask)).item(),
        float(J.mse_loss(jnp.asarray(pred), jnp.asarray(y), jnp.asarray(mask))), **TOL)
    for weights in (None, w):
        want = J.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(y_idx), jnp.asarray(mask),
                                    None if weights is None else jnp.asarray(weights))
        got = T.cross_entropy_loss(t(logits), t(y_idx), t(mask),
                                   None if weights is None else t(weights))
        np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_jax_checkpoint_loads_without_jax(db, tmp_path):
    """In a process where jax, optax and deeprank_gnn_tpu cannot be
    imported, the port imports, chip_smoke imports without running, and
    a checkpoint saved by the JAX package loads with its weights."""
    from deeprank_gnn_tpu.train.checkpoint import load_state as jax_load_state

    ckpt = jax_checkpoint(db, str(tmp_path / "model.pth.tar"), "fnat")
    out = str(tmp_path / "state_dict.pt")
    code = f"""
import sys
for name in ("jax", "jaxlib", "optax", "deeprank_gnn_tpu"):
    sys.modules[name] = None
try:
    import jax
    raise SystemExit("jax was importable")
except ImportError:
    pass
import torch
import deeprank_gnn_tpu_torch
from deeprank_gnn_tpu_torch import GINet, HDF5DataSet, NeuralNet
import chip_smoke
from deeprank_gnn_tpu_torch.train.checkpoint import load_state, state_dict_from_checkpoint
payload = load_state({ckpt!r})
assert payload["net"] == "GINet" and payload["target"] == "fnat"
assert payload["optimizer"][0].mu.ndim == 1
model = GINet(len(payload["model"].conv1.fc_w[0]), 1, 1, device="cpu")
model.load_state_dict(state_dict_from_checkpoint("GINet", payload))
torch.save(model.state_dict(), {out!r})
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in ("jax", "optax", "deeprank_gnn_tpu")]
assert not loaded, loaded
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    sd = torch.load(out)
    params = jax_load_state(ckpt)["model"]
    np.testing.assert_array_equal(sd["conv1.fc.weight"].numpy(), np.asarray(params.conv1.fc_w))
    np.testing.assert_array_equal(sd["conv2_ext.fc_attention.weight"].numpy(),
                                  np.asarray(params.conv2_ext.fc_att_w))
    np.testing.assert_array_equal(sd["fc2.bias"].numpy(), np.asarray(params.fc2_b))


def test_checkpoint_unpickler_refuses_other_globals(tmp_path):
    from deeprank_gnn_tpu_torch.train.checkpoint import MAGIC, load_state

    path = str(tmp_path / "evil.pth.tar")
    with open(path, "wb") as f:
        pickle.dump({"__format__": MAGIC, "model": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="getcwd"):
        load_state(path)


def zoo_nets(name):
    """The JAX package's and the port's net for a zoo name."""
    import functools

    import deeprank_gnn_tpu.models as J
    import deeprank_gnn_tpu_torch.models as T

    if name == "GINet-attention":
        return (functools.partial(J.GINet, attention=True),
                functools.partial(T.GINet, attention=True))
    return getattr(J, name), getattr(T, name)


@pytest.mark.parametrize("name", ["GINet-attention", "FoutNet", "sGAT"])
def test_zoo_pretrained_matches_jax(db, tmp_path, name):
    """Scoring with the rest of the zoo from a checkpoint the JAX engine
    saved, in both packages: outputs, loss, metrics and the export."""
    from deeprank_gnn_tpu import NeuralNet as JaxNeuralNet
    from deeprank_gnn_tpu_torch import NeuralNet

    jnet, tnet = zoo_nets(name)
    ckpt = str(tmp_path / "zoo.pth.tar")
    JaxNeuralNet(db, jnet, node_feature=FEATURE_NAMES, edge_feature=["dist"], target="fnat",
                 batch_size=4, outdir=str(tmp_path), seed=3).save_model(ckpt)
    j = JaxNeuralNet(db, jnet, pretrained_model=ckpt, outdir=str(tmp_path / "jax"))
    j.test(threshold=0.3)
    t = NeuralNet(db, tnet, pretrained_model=ckpt, outdir=str(tmp_path / "torch"), device="cpu")
    t.test(threshold=0.3)
    assert type(t.model).__name__ == name.split("-")[0]
    assert np.std(t.test_out) > 1e-4
    assert_served_alike(j, t, 0.3, str(tmp_path))


@pytest.mark.parametrize("name", ["FoutNet", "sGAT"])
def test_zoo_jax_checkpoint_loads_without_jax(db, tmp_path, name):
    """A FoutNet or sGAT checkpoint saved by the JAX package loads, with its
    weights and Adam moments, in a process where jax, optax and
    deeprank_gnn_tpu cannot be imported."""
    from deeprank_gnn_tpu import NeuralNet as JaxNeuralNet
    from deeprank_gnn_tpu.train.checkpoint import load_state as jax_load_state

    jnet, _ = zoo_nets(name)
    ckpt = str(tmp_path / "zoo.pth.tar")
    j = JaxNeuralNet(db, jnet, node_feature=FEATURE_NAMES, edge_feature=["dist"],
                     target="fnat", batch_size=4, outdir=str(tmp_path), seed=2)
    j.train(nepoch=1, save_model=None)
    j.save_model(ckpt)
    out = str(tmp_path / "state.pt")
    code = f"""
import sys
for name in ("jax", "jaxlib", "optax", "deeprank_gnn_tpu"):
    sys.modules[name] = None
import torch
from deeprank_gnn_tpu_torch import {name}
from deeprank_gnn_tpu_torch.train.checkpoint import (
    adam_state_from_checkpoint, load_state, state_dict_from_checkpoint)
payload = load_state({ckpt!r})
assert payload["net"] == {name!r}
model = {name}(13, 1, 1, device="cpu")
model.load_state_dict(state_dict_from_checkpoint({name!r}, payload))
moments = adam_state_from_checkpoint(payload, list(model.parameters()))
assert moments is not None and len(moments) == len(list(model.parameters()))
torch.save({{"model": model.state_dict(), "moments": moments}}, {out!r})
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in ("jax", "optax", "deeprank_gnn_tpu")]
assert not loaded, loaded
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = torch.load(out)
    params = jax_load_state(ckpt)["model"]
    np.testing.assert_array_equal(got["model"]["conv1.bias"].numpy(),
                                  np.asarray(params.conv1.bias))
    np.testing.assert_array_equal(got["model"]["fc2.weight"].numpy(), np.asarray(params.fc2_w))
    mu = np.concatenate([got["moments"][i]["exp_avg"].numpy().ravel()
                         for i in sorted(got["moments"])])
    np.testing.assert_array_equal(mu, np.asarray(j.opt_state[0].mu))

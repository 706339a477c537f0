"""PyTorch port vs JAX package: HDF5 front end (datasets, PreCluster).

Also holds the synthetic-data helpers the other ``test_torch_*`` files
import: small residue graphs made from a seed with numpy and written in the
reference HDF5 schema (reference `Graph.py:61-139`), with or without
precomputed clusters.
"""

import os
import shutil

import h5py
import numpy as np
import pytest

NODE_FEATURES = {"type": 5, "polarity": 3, "bsa": 1, "pssm": 4}  # name -> width
FEATURE_NAMES = list(NODE_FEATURES)


def write_graphs_hdf5(path, num_graphs=12, seed=0, clusters=True, n_range=(20, 60)):
    """Write ``num_graphs`` random interface graphs in the reference
    schema: one-hot and scalar node features, undirected interface and
    internal edges with a ``dist`` feature, ``fnat`` and ``bin_class``
    scores and (optionally) ``clustering/mcl/depth_{0,1}``."""
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f5:
        for gi in range(num_graphs):
            n = int(rng.integers(*n_range))
            grp = f5.create_group(f"mol_{gi:03d}")
            nd = grp.create_group("node_data")
            for name, width in NODE_FEATURES.items():
                if width == 1:
                    nd.create_dataset(name, data=rng.random(n).astype(np.float32))
                else:
                    onehot = np.eye(width, dtype=np.float32)[rng.integers(0, width, n)]
                    vals = onehot if name != "pssm" else rng.standard_normal((n, width))
                    nd.create_dataset(name, data=vals.astype(np.float32))
            nd.create_dataset("pos", data=rng.standard_normal((n, 3)).astype(np.float32))
            for key, count in (("edge", 2 * n), ("internal_edge", n)):
                src = rng.integers(0, n, count)
                dst = (src + 1 + rng.integers(0, n - 1, count)) % n
                pairs = np.unique(np.sort(np.stack([src, dst], 1), axis=1), axis=0)
                grp.create_dataset(f"{key}_index", data=pairs.astype(np.int64))
                grp.create_group(f"{key}_data").create_dataset(
                    "dist", data=(2.0 + 8.0 * rng.random(len(pairs))).astype(np.float32)
                )
            sc = grp.create_group("score")
            sc.create_dataset("fnat", data=float(rng.random()))
            sc.create_dataset("bin_class", data=float(rng.integers(0, 2)))
            if clusters:
                c0 = rng.integers(0, max(2, n // 4), n)
                k0 = len(np.unique(c0))
                c1 = np.arange(k0) // 3
                cl = grp.create_group("clustering/mcl")
                cl.create_dataset("depth_0", data=c0.astype(np.int64))
                cl.create_dataset("depth_1", data=c1.astype(np.int64))
    return path


def datasets(path, target="fnat", node_feature=None, clustering_method="mcl"):
    """The same file opened by both packages: (jax_dataset, torch_dataset)."""
    from deeprank_gnn_tpu.data.dataset import HDF5DataSet as JaxDataSet
    from deeprank_gnn_tpu_torch.data.dataset import HDF5DataSet as TorchDataSet

    kw = dict(
        database=path,
        node_feature=node_feature or FEATURE_NAMES,
        edge_feature=["dist"],
        target=target,
        clustering_method=clustering_method,
        tqdm=False,
    )
    return JaxDataSet(**kw), TorchDataSet(**kw)


def graphs(path, **kw):
    """All graphs of ``path`` as port GraphSamples."""
    _, ds = datasets(path, **kw)
    return [ds.get(i) for i in range(len(ds))]


@pytest.fixture(scope="module")
def h5_path(tmp_path_factory):
    return write_graphs_hdf5(str(tmp_path_factory.mktemp("torch_data") / "g.hdf5"))


SAMPLE_ARRAYS = (
    "x", "pos", "edge_index", "edge_attr", "internal_edge_index",
    "internal_edge_attr", "cluster0", "cluster1",
)


def test_graph_samples_bitwise(h5_path):
    jds, tds = datasets(h5_path)
    assert len(jds) == len(tds) == 12
    for i in range(len(jds)):
        a, b = jds.get(i), tds.get(i)
        assert a.mol == b.mol and a.y == b.y
        for name in SAMPLE_ARRAYS:
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        # the loader's contract: row-sorted doubled edges
        assert (np.diff(b.edge_index[0]) >= 0).all()


def test_divide_dataset_same_split(h5_path):
    from deeprank_gnn_tpu.data.dataset import DivideDataSet as JaxDivide
    from deeprank_gnn_tpu_torch.data.dataset import DivideDataSet

    jds, tds = datasets(h5_path)
    ja, jb = JaxDivide(jds, percent=(0.75, 0.25), seed=7)
    ta, tb = DivideDataSet(tds, percent=(0.75, 0.25), seed=7)
    assert ja.index_complexes == ta.index_complexes
    assert jb.index_complexes == tb.index_complexes
    assert len(ta) == 9 and len(tb) == 3


@pytest.mark.parametrize("method", ["mcl", "louvain"])
def test_precluster_bitwise(tmp_path, method):
    from deeprank_gnn_tpu.data.dataset import PreCluster as JaxPreCluster
    from deeprank_gnn_tpu_torch.data.dataset import PreCluster

    src = write_graphs_hdf5(str(tmp_path / "raw.hdf5"), num_graphs=4, seed=3, clusters=False)
    pj, pt = str(tmp_path / "jax.hdf5"), str(tmp_path / "torch.hdf5")
    shutil.copy(src, pj)
    shutil.copy(src, pt)
    jds, _ = datasets(pj, clustering_method=method)
    _, tds = datasets(pt, clustering_method=method)
    JaxPreCluster(jds, method)
    PreCluster(tds, method)
    with h5py.File(pj, "r") as fj, h5py.File(pt, "r") as ft:
        assert list(fj) == list(ft)
        for mol in fj:
            for depth in ("depth_0", "depth_1"):
                a = fj[f"{mol}/clustering/{method}/{depth}"][()]
                b = ft[f"{mol}/clustering/{method}/{depth}"][()]
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    # the written clusters load back into the samples
    _, tds = datasets(pt, clustering_method=method)
    assert all(tds.get(i).cluster0 is not None for i in range(len(tds)))


def test_graph_list_dataset_matches_hdf5(h5_path):
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet

    _, tds = datasets(h5_path)
    mem = GraphListDataSet([tds.get(i) for i in range(len(tds))])
    assert len(mem) == len(tds)
    for i in range(len(tds)):
        assert mem.graph_sizes(i) == tds.graph_sizes(i)
        assert mem.get_target(i) == tds.get_target(i)
        assert mem.get(i).mol == tds.get(i).mol


def test_dataset_imports_without_h5py_loaded():
    """The module defers h5py to the functions that open files."""
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['h5py'] = None; sys.modules['sklearn'] = None\n"
        "import deeprank_gnn_tpu_torch.train.neuralnet\n"
        "import deeprank_gnn_tpu_torch.data.dataset as d\n"
        "print(d.GraphListDataSet([]).__len__())\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "0"

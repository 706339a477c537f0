"""The yardstick at small shapes: generators, FLOP counts, byte bounds, TF32.

CPU only: ``python -m pytest portbench/tests`` from the root of the repo.
"""

from __future__ import annotations

import ast
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import graphs, reference, roofline, spec  # noqa: E402

GINET = spec.load_net("GINet")


def _constants(path: Path) -> dict:
    """Module-level integer constants and each function's integer keyword
    defaults of a file, read without importing it."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value.value
        if isinstance(node, ast.FunctionDef):
            args = node.args.args[-len(node.args.defaults):] if node.args.defaults else []
            for a, d in zip(args, node.args.defaults):
                if isinstance(d, ast.Constant):
                    out[f"{node.name}.{a.arg}"] = d.value
    return out


def test_generators_match_bench_shapes():
    """The atomic graphs have bench.py's ``build_big_graphs`` shapes, the
    residue graphs its fixture scale."""
    c = _constants(ROOT / "bench.py")
    g = graphs.atomic(7, 2, c["build_big_graphs.n"], c["build_big_graphs.e_und"],
                      c["NODE_FEATS"])
    for x in g:
        assert x["x"].shape == (2560, 48) and x["x"].dtype == np.float32
        assert x["edge_index"].shape == (2, 30000) and x["edge_index"].dtype == np.int32
        assert np.all(np.diff(x["edge_index"][0]) >= 0)
        assert set(np.unique(x["edge_index"][0])) == set(range(2560))
        assert x["edge_attr"].shape == (30000, 1)
        assert x["cluster0"].max() + 1 == len(x["cluster1"])
        assert np.array_equal(x["cluster1"], np.arange(len(x["cluster1"])) // 3)
        assert 0 <= x["y"] < 10
    r = graphs.residue(7, 3, c["NODES_PER_GRAPH"], c["EDGES_PER_GRAPH"], c["NODE_FEATS"])
    for x in r:
        assert x["x"].shape == (130, 48) and x["edge_index"].shape == (2, 500)
        assert np.all(x["x"][:, :20].sum(1) == 1) and np.all(x["x"][:, 20:24].sum(1) == 1)
        assert np.all((x["edge_attr"] > 0) & (x["edge_attr"] <= 2))
        assert x["cluster0"].max() < 29


def _digest(gs) -> str:
    h = hashlib.sha256()
    for g in gs:
        for k in ("x", "edge_index", "edge_attr", "cluster0", "cluster1"):
            h.update(np.ascontiguousarray(g[k]).tobytes())
        h.update(repr(g["y"]).encode())
    return h.hexdigest()


def test_generators_are_the_frozen_copies():
    """Value for value the generators of ``chip_smoke.py`` they were copied
    from (read in a separate process: the benchmark never imports it)."""
    code = f"""
import sys, hashlib, numpy as np
sys.path.insert(0, {str(ROOT)!r})
import chip_smoke as cs
def digest(gs):
    h = hashlib.sha256()
    for g in gs:
        for k in ("x", "edge_index", "edge_attr", "cluster0", "cluster1"):
            h.update(np.ascontiguousarray(getattr(g, k)).tobytes())
        h.update(repr(g.y).encode())
    return h.hexdigest()
print(digest(cs.build_atomic_graphs(11, 2, 512, 3000)))
print(digest(cs.build_graphs(11, 4)))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    atomic, residue = res.stdout.split()
    assert _digest(graphs.atomic(11, 2, 512, 3000, 48)) == atomic
    assert _digest(graphs.residue(11, 4, 130, 250, 48)) == residue


def test_seed_gives_same_inputs_and_large_seeds_work():
    a = graphs.atomic(2**31 + 17, 2, 64, 200, 48)
    b = graphs.atomic(2**31 + 17, 2, 64, 200, 48)
    assert _digest(a) == _digest(b)
    assert _digest(a) != _digest(graphs.atomic(2**31 + 18, 2, 64, 200, 48))
    w1 = reference.draw_weights(GINET.param_table(_model()), 2**40 + 3, "cpu")
    w2 = reference.draw_weights(GINET.param_table(_model()), 2**40 + 3, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)


def _model():
    return {"node_features": 48, "edge_features": 1, "conv1_out": 16, "conv2_out": 32,
            "fc1_out": 128, "fc2_out": 1, "dropout": 0.4, "lr": 0.01}


def _toy_graph():
    """4 nodes, clusters {0, 1} and {2, 3}, one level-1 cluster; edges
    0->1, 1->0, 1->2, 2->1, 2->3, 3->2, 3->0 (directed)."""
    row = np.array([0, 1, 1, 2, 2, 3, 3], np.int32)
    col = np.array([1, 0, 2, 1, 3, 2, 0], np.int32)
    return {"x": np.ones((4, 48), np.float32), "edge_index": np.stack([row, col]),
            "cluster0": np.array([0, 0, 1, 1], np.int32), "cluster1": np.array([0, 0], np.int32)}


def test_counts_and_flops_by_hand():
    c = roofline.graph_counts(_toy_graph())
    # between clusters: 1->2 maps to (0, 1), 2->1 and 3->0 to (1, 0)
    assert c == {"nodes": 4, "edges": 7, "c0": 2, "c1": 1, "pooled": 2, "edge_sources": 4,
                 "edge_targets": 4, "pooled_sources": 2, "pooled_targets": 2}
    m = _model()
    conv1 = 2 * 4 * 48 * 32  # both towers' node products
    agg1 = 7 * 32
    conv2 = 2 * 2 * 16 * 32 * 2
    agg2 = 2 * 64
    head = 2 * 64 * 128 + 2 * 128 * 1
    fwd = conv1 + agg1 + conv2 + agg2 + head
    assert GINET.flops(c, m, training=False) == fwd
    assert GINET.flops(c, m, training=True) == fwd + conv1 + agg1 + 2 * conv2 + agg2 + 2 * head
    assert GINET.work(c, m, True)["flops"] == GINET.flops(c, m, True)


def test_byte_bounds_by_hand():
    # K3, conv1 forward of the toy graph at 32 columns: 4 source rows, 4
    # output rows of 32 floats, 7 edges of two int32 indices
    want = 4 * (4 * 32 + 4 * 32 + 2 * 7) / 3.35e12 * 1e3
    assert roofline.k3_bound_ms(4, 4, 7, 32) == pytest.approx(want)
    assert roofline.k1_bound_ms(100, 10, 8) == pytest.approx(
        (100 * 8 + 10 * 8 + 11) * 4 / 3.35e12 * 1e3)
    assert roofline.k2_bound_ms(90, 100, 10, 1) == pytest.approx(
        (90 + 11 + 10 + 100) * 4 / 3.35e12 * 1e3)
    # an add reads 4 bytes, and the card moves 0.05 bytes a FLOP: bytes bound
    assert roofline.k1_bound_ms(10**6, 1, 64) > 10**6 * 64 / 67e12 * 1e3
    c = roofline.graph_counts(_toy_graph())
    train = GINET.k3_bound_ms(c, _model(), True)
    assert train == pytest.approx(2 * roofline.k3_bound_ms(4, 4, 7, 32)
                                  + 2 * roofline.k3_bound_ms(2, 2, 2, 64))


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-11,
                      1.0 + 2**-11 + 2**-20], dtype=torch.float32)
    got = reference.to_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0, 1.0 + 2 * 2**-10, -1.0, 1.0 + 2**-10])
    assert torch.equal(got, want)


def test_reference_on_toy_graph_by_hand():
    """conv1 with identity-like weights on the toy graph, worked by hand."""
    g = dict(_toy_graph(), y=0.0, mol="toy")
    w = {k: torch.zeros(shape, dtype=torch.float64)
         for k, (shape, _) in GINET.param_table(_model()).items()}
    w["conv1.fc.weight"][0, 0] = 1.0  # tower 1, column 0: x[:, 0]
    w["conv2.fc.weight"][0, 0] = 1.0
    w["fc1.weight"][0, 0] = 1.0
    w["fc2.weight"][0, 0] = 1.0
    b = reference.Batch([g], "cpu")
    # conv1 sums ones over each row's edges: rows 0..3 have 1, 2, 2, 2
    # level-0 max: clusters {0,1} -> 2, {2,3} -> 2; conv2 over pooled edges
    # (0,1), (1,0): each cluster sums the other's 2 -> 2, 2; level-1 max 2;
    # mean 2; fc1 relu 2; fc2 2
    assert GINET.forward(w, b, _model()).tolist() == [2.0]
    assert reference.scores(GINET, w, b, _model(), fault="answer_altered").tolist() == [
        pytest.approx(2.05)]


@pytest.mark.parametrize("generator", ["atomic", "residue"])
def test_every_seed_the_same_shapes(generator):
    """A run's graphs: seed 0's edges and clusters in the seed's order, with
    the seed's own features and targets."""
    config = {"graphs": {"generator": generator, "nodes": 130, "edges_undirected": 250},
              "model": {"node_features": 48}}
    a, b = graphs.generate(config, 2**31 + 1, 6), graphs.generate(config, 2**31 + 2, 6)
    base = graphs.GENERATORS[generator][0](graphs.SHAPES_SEED, 6, 130, 250, 48)
    key = lambda g: (g["mol"], g["edge_index"].tobytes(), g["cluster0"].tobytes())  # noqa: E731
    assert sorted(map(key, a)) == sorted(map(key, b)) == sorted(map(key, base))
    assert [g["mol"] for g in a] != [g["mol"] for g in b]
    for g in a:
        assert g["x"].dtype == np.float32 and g["x"].shape == (130, 48)
        assert g["edge_attr"].shape == (500, 1)
        assert np.array_equal(g["internal_edge_attr"], g["edge_attr"][:250])
    assert not np.array_equal(a[0]["x"], b[0]["x"])
    assert _digest(graphs.generate(config, 9, 6)) == _digest(graphs.generate(config, 9, 6))

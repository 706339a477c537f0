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
    0->1, 1->0, 1->2, 2->1, 2->3, 3->2, 3->0 (directed), with the
    attributes 1 to 7."""
    row = np.array([0, 1, 1, 2, 2, 3, 3], np.int32)
    col = np.array([1, 0, 2, 1, 3, 2, 0], np.int32)
    return {"x": np.ones((4, 48), np.float32), "edge_index": np.stack([row, col]),
            "edge_attr": np.arange(1, 8, dtype=np.float32)[:, None],
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
    # pooled edges (0, 1) from 1->2, and (1, 0) from 2->1 and 3->0
    assert b.prow.tolist() == [0, 1] and b.pcol.tolist() == [1, 0]
    assert b.pea[:, 0].tolist() == [3.0, 4.0 + 7.0]
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


def _edge_graphs(generator: str) -> list:
    """A few small graphs of each generator, with edge attributes."""
    if generator == "atomic":
        return graphs.atomic(2**31 + 5, 3, 256, 1000, 48)
    return graphs.residue(2**31 + 5, 3, 130, 250, 48)


@pytest.mark.parametrize("generator", ["atomic", "residue"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_batch_edge_attributes_are_the_graphs(generator, dtype):
    """``Batch.ea`` holds each graph's own ``edge_attr``, bit for bit, in
    the raw order of ``row`` and ``col``."""
    gs = _edge_graphs(generator)
    b = reference.Batch(gs, "cpu", dtype)
    assert b.ea.dtype == dtype and b.ea.shape == (sum(len(g["edge_attr"]) for g in gs), 1)
    want = np.concatenate([g["edge_attr"] for g in gs])
    assert np.array_equal(b.ea.float().numpy(), want)
    rows = np.concatenate([g["edge_index"][0] + o for g, o in
                           zip(gs, np.cumsum([0] + [g["x"].shape[0] for g in gs]))])
    assert np.array_equal(b.row.numpy(), rows)


def _pooled_by_hand(gs: list) -> dict:
    """(source, target) level-0 cluster pair, offset by graph -> [sum of the
    float64 edge attributes of the edges between them, count of edges]."""
    out, off = {}, 0
    for g in gs:
        c0 = g["cluster0"].astype(np.int64) + off
        for e, (r, c) in enumerate(g["edge_index"].T):
            pr, pc = int(c0[r]), int(c0[c])
            if pr != pc:
                acc = out.setdefault((pr, pc), [np.zeros(g["edge_attr"].shape[1]), 0])
                acc[0] = acc[0] + g["edge_attr"][e].astype(np.float64)
                acc[1] += 1
        off += len(g["cluster1"])
    return out


@pytest.mark.parametrize("generator", ["atomic", "residue"])
def test_pooled_edge_attributes_by_hand(generator):
    """``Batch.pea`` is, for each pooled edge in ``(prow, pcol)`` order, the
    float64 sum of the attributes of the edges that map to it, grouped here
    by hand; the index fields are the ones ``torch.unique`` gave before the
    attributes were added."""
    gs = _edge_graphs(generator)
    b = reference.Batch(gs, "cpu")
    hand = _pooled_by_hand(gs)
    keys = sorted(hand)
    assert list(zip(b.prow.tolist(), b.pcol.tolist())) == keys
    sums = np.stack([hand[k][0] for k in keys])
    terms = max(n for _, n in hand.values())
    # both sum the same float64 values of [0, 2], in edge order here and in
    # index_add's order there: apart by float64 rounding of sums of `terms`
    np.testing.assert_allclose(b.pea.numpy(), sums, rtol=terms * 2.0**-52, atol=0)
    pr, pc = b.c0[b.row], b.c0[b.col]
    key = torch.unique(pr[pr != pc] * b.num_c0 + pc[pr != pc])
    assert torch.equal(b.prow, key // b.num_c0) and torch.equal(b.pcol, key % b.num_c0)


@pytest.mark.parametrize("generator", ["atomic", "residue"])
def test_pooled_edge_attributes_match_the_port(generator):
    """``Batch.pea`` agrees with the port's pooled attributes: its CPU
    ``collate`` (edges row-sorted, as ``GraphListDataSet`` sorts them), then
    ``segment_sum(edge_attr, edge_to_pe)`` as its attention conv sums them;
    the pooled edges are the same pairs in the same order."""
    from deeprank_gnn_tpu_torch import GraphListDataSet
    from deeprank_gnn_tpu_torch.data.batch import collate
    from deeprank_gnn_tpu_torch.data.dataset import GraphSample
    from deeprank_gnn_tpu_torch.ops.segment import segment_sum

    gs = _edge_graphs(generator)
    samples = GraphListDataSet([GraphSample(
        mol=g["mol"], x=g["x"], pos=g["pos"], edge_index=g["edge_index"],
        edge_attr=g["edge_attr"], internal_edge_index=g["internal_edge_index"],
        internal_edge_attr=g["internal_edge_attr"], cluster0=g["cluster0"],
        cluster1=g["cluster1"], y=g["y"]) for g in gs])
    batch, _ = collate([samples.get(i) for i in range(len(gs))])
    p = int(batch.pe_mask.sum())
    got = segment_sum(batch.edge_attr, batch.edge_to_pe.long(), batch.pe_index.shape[1])[:p]
    b = reference.Batch(gs, "cpu")
    assert torch.equal(batch.pe_index[0, :p].long(), b.prow)
    assert torch.equal(batch.pe_index[1, :p].long(), b.pcol)
    terms = max(n for _, n in _pooled_by_hand(gs).values())
    # the port sums float32 values of [0, 2] in float32, at most `terms` of
    # them a pooled edge (in another order for the residue graphs, whose
    # edges it row-sorts): each partial sum rounds once, to within 2**-24 of
    # itself, so the whole is within `terms` such roundings of the float64 sum
    np.testing.assert_allclose(got.double().numpy(), b.pea.numpy(), rtol=terms * 2.0**-24,
                               atol=0)

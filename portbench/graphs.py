"""The benchmark's graph generators: plain numpy arrays from a seed.

Frozen copies, so that no later change to the program moves the traffic:

- ``atomic`` is ``chip_smoke.py``'s ``build_atomic_graphs`` (itself
  ``bench.py``'s ``build_big_graphs`` value for value): ``n`` nodes of
  ``features`` standard-normal features, ``e_und`` random edges doubled and
  row-sorted with every node a source, one uniform edge feature, level-0
  clusters drawn from ``n // 4`` labels and level-1 clusters of three;
  target ``rand() * 10``.
- ``residue`` is ``chip_smoke.py``'s ``build_graphs`` (the fixture scale of
  PERF.md): ``n`` nodes with the 48 ``fold6`` columns (type one-hot 20,
  polarity one-hot 4, bsa, charge, cons and ic, pssm 20), ``e_und`` random
  edges doubled, unsorted, with the distance feature under the dataset's
  transform ``tanh(-d / 2 + 2) + 1``, level-0 clusters from 29 labels and
  level-1 clusters of three; target ``rand()``.

A graph is a dict of arrays: ``x [n, F]``, ``pos [n, 3]``, ``edge_index
[2, 2 e_und]`` int32, ``edge_attr [2 e_und, 1]``, the internal edges (the
first ``e_und`` of those, which paper mode never reads but the loader
plans), ``cluster0 [n]`` and ``cluster1 [C0]`` int32 (consecutive ids),
``y`` and ``mol``. The seed may be any whole number: numpy's generators
take it modulo 2**32.

A run's graphs (:func:`generate`) are the same set of shapes for every
seed: the edges and clusters of the generator's graphs from seed 0
(``bench.py``'s default), in an order drawn from the run's seed, with
features, edge features, positions and targets drawn anew from it, as each
generator draws them (``*_values``). The
engine pads every graph to the dataset's largest cluster layout, so graphs
drawn whole from each seed gave each seed its own padded shapes and a rate
of its own (up to 7% apart on the card where two runs of one seed agreed
within 0.1%, PERF.md).
"""

from __future__ import annotations

import numpy as np

SEED_MOD = 2**32


def atomic(seed: int, num_graphs: int, n: int, e_und: int, features: int) -> list:
    rng = np.random.RandomState(seed % SEED_MOD)
    graphs = []
    for gi in range(num_graphs):
        src = rng.randint(0, n, e_und)
        dst = (src + 1 + rng.randint(0, n - 1, e_und)) % n
        src[:n] = np.arange(n)
        ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])]).astype(np.int32)
        ea = rng.rand(2 * e_und, 1).astype(np.float32)
        order = np.argsort(ei[0], kind="stable")
        ei, ea = ei[:, order], ea[order]
        _, c0 = np.unique(rng.randint(0, n // 4, n), return_inverse=True)
        c1 = (np.arange(int(c0.max()) + 1) // 3).astype(np.int32)
        graphs.append({
            "mol": f"g{gi}",
            "x": rng.randn(n, features).astype(np.float32),
            "pos": rng.randn(n, 3).astype(np.float32),
            "edge_index": ei,
            "edge_attr": ea,
            "internal_edge_index": ei[:, :e_und],
            "internal_edge_attr": ea[:e_und],
            "cluster0": c0.astype(np.int32),
            "cluster1": c1,
            "y": float(rng.rand() * 10),
        })
    return graphs


def residue(seed: int, num_graphs: int, n: int, e_und: int, features: int) -> list:
    if features != 48:
        raise ValueError(f"the residue generator makes the 48 fold6 columns, not {features}")
    rng = np.random.default_rng(seed % SEED_MOD)
    graphs = []
    for gi in range(num_graphs):
        x = fold6_features(rng, n)
        src = rng.integers(0, n, e_und)
        dst = (src + 1 + rng.integers(0, n - 1, e_und)) % n
        src[:n] = np.arange(n)
        ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])]).astype(np.int32)
        dist = 2.0 + 6.5 * rng.random(e_und)
        ea = (np.tanh(-np.concatenate([dist, dist])[:, None] / 2.0 + 2.0) + 1.0).astype(np.float32)
        _, c0 = np.unique(rng.integers(0, 29, n), return_inverse=True)
        c1 = np.arange(int(c0.max()) + 1) // 3
        graphs.append({
            "mol": f"model_{gi:05d}",
            "x": x,
            "pos": rng.standard_normal((n, 3)).astype(np.float32),
            "edge_index": ei,
            "edge_attr": ea,
            "internal_edge_index": ei[:, :e_und],
            "internal_edge_attr": ea[:e_und],
            "cluster0": c0.astype(np.int32),
            "cluster1": c1.astype(np.int32),
            "y": float(rng.random()),
        })
    return graphs


def fold6_features(rng, n: int) -> np.ndarray:
    return np.hstack([
        np.eye(20)[rng.integers(0, 20, n)],  # type, one-hot
        np.eye(4)[rng.integers(0, 4, n)],  # polarity, one-hot
        rng.random((n, 4)),  # bsa, charge, cons, ic
        rng.standard_normal((n, 20)),  # pssm
    ]).astype(np.float32)


def atomic_values(rng, n: int, e_und: int, features: int) -> dict:
    return {"x": rng.standard_normal((n, features), dtype=np.float32),
            "pos": rng.standard_normal((n, 3), dtype=np.float32),
            "edge_attr": rng.random((2 * e_und, 1), dtype=np.float32),
            "y": float(rng.random() * 10)}


def residue_values(rng, n: int, e_und: int, features: int) -> dict:
    dist = 2.0 + 6.5 * rng.random(e_und)
    ea = np.tanh(-np.concatenate([dist, dist])[:, None] / 2.0 + 2.0) + 1.0
    return {"x": fold6_features(rng, n), "pos": rng.standard_normal((n, 3), dtype=np.float32),
            "edge_attr": ea.astype(np.float32), "y": float(rng.random())}


GENERATORS = {"atomic": (atomic, atomic_values), "residue": (residue, residue_values)}
SHAPES_SEED = 0


def generate(config: dict, seed: int, num_graphs: int) -> list:
    """``num_graphs`` graphs of the configuration's ``graphs`` block for the
    run's ``seed``: the shapes of seed 0's graphs, everything else from
    ``seed`` (the module's docstring)."""
    g = config["graphs"]
    make, values = GENERATORS[g["generator"]]
    n, e_und, f = g["nodes"], g["edges_undirected"], config["model"]["node_features"]
    shapes = make(SHAPES_SEED, num_graphs, n, e_und, f)
    rng = np.random.default_rng(seed % SEED_MOD)
    out = []
    for k in rng.permutation(num_graphs):
        v = values(rng, n, e_und, f)
        out.append({**shapes[k], **v, "internal_edge_attr": v["edge_attr"][:e_und]})
    return out

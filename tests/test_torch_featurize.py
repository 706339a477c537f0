"""PyTorch port vs JAX package: the featurizer (PDB -> interface graph -> HDF5).

The docking models are PDB texts written from a seed with numpy
(``chip_smoke.write_docking_models``: two chains of 45 and 40 residues with
the standard heavy atoms, a PSSM per chain, the unperturbed model as the
reference, and a glycine whose only contact is a pair of atoms exactly at
the residue graph's 8.5 Å cutoff). The JAX package runs its own geometry
(its C++ library, else ``cKDTree``); the port runs its torch geometry with
``device="cpu"``. Integer outputs (contact sets, node and edge lists) must
be bitwise equal; SASA, BSA, node and edge features within rtol 1e-9 and
atol 1e-9; contact distances within 1e-12; scores within 1e-9.
"""

import os
import re
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from chip_smoke import write_docking_models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = dict(rtol=1e-9, atol=1e-9)
DIST_TOL = dict(rtol=0, atol=1e-12)
MODELS = [0, 1, 2]
TIE_RESIDUE = ("B", 41, "GLY")  # chain B's last residue: the glycine at the cutoff


@pytest.fixture(scope="module")
def cx(tmp_path_factory):
    return write_docking_models(str(tmp_path_factory.mktemp("docking")), seed=5, n_models=3,
                                res_a=45, res_b=40, tie=True)


def assert_graphs_equal(j, t):
    """Nodes and edges bitwise, features within tolerance, the same
    feature names in the same order."""
    assert t.nodes == j.nodes and t.edges == j.edges
    assert list(t.node_data) == list(j.node_data)
    for k in j.node_data:
        np.testing.assert_allclose(np.asarray(t.node_data[k], dtype=np.float64),
                                   np.asarray(j.node_data[k], dtype=np.float64),
                                   err_msg=k, **FEAT_TOL)
    assert list(t.edge_data) == list(j.edge_data)
    assert t.edge_data["type"] == j.edge_data["type"]
    np.testing.assert_allclose(t.edge_data["dist"], j.edge_data["dist"], **DIST_TOL)


def test_pdb_round_trip(cx, tmp_path):
    """``read_pdb`` parses every column as JAX does; ``write_pdb`` writes
    JAX's text and reads back the same structure."""
    from deeprank_gnn_tpu.featurize.pdb import read_pdb as jax_read, write_pdb as jax_write
    from deeprank_gnn_tpu_torch.featurize.pdb import read_pdb, write_pdb

    want, got = jax_read(cx["pdbs"][1]), read_pdb(cx["pdbs"][1])
    for field in want.__dataclass_fields__:
        a, b = getattr(want, field), getattr(got, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    write_pdb(got, str(tmp_path / "port.pdb"))
    jax_write(want, str(tmp_path / "jax.pdb"))
    assert (tmp_path / "port.pdb").read_text() == (tmp_path / "jax.pdb").read_text()
    back = read_pdb(str(tmp_path / "port.pdb"))
    assert np.array_equal(back.xyz, got.xyz) and np.array_equal(back.name, got.name)
    assert back.residues() == got.residues()


@pytest.mark.parametrize("k", MODELS)
def test_sasa_and_bsa(cx, k):
    """Per-atom and per-residue SASA (ProtOr radii, and the truncated-name
    radii of the unbound chains), BSA, and the ``BSA`` class."""
    import deeprank_gnn_tpu.featurize.bsa as JB
    import deeprank_gnn_tpu.featurize.sasa as JS
    import deeprank_gnn_tpu_torch.featurize.bsa as TB
    import deeprank_gnn_tpu_torch.featurize.sasa as TS
    from deeprank_gnn_tpu_torch.featurize.pdb import read_pdb

    s = read_pdb(cx["pdbs"][k])
    np.testing.assert_allclose(TS.atom_sasa(s, device="cpu"), JS.atom_sasa(s), **FEAT_TOL)
    sub = s.select(s.chain == "B")
    radii = TS.addatom_radii(sub)
    np.testing.assert_array_equal(radii, JS.addatom_radii(sub))
    np.testing.assert_array_equal(TS.atom_radii(s), JS.atom_radii(s))
    np.testing.assert_array_equal(TS._fibonacci_sphere(500), JS._fibonacci_sphere(500))
    got = TS.residue_sasa(sub, radii=radii, device="cpu")
    want = JS.residue_sasa(sub, radii=radii)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), **FEAT_TOL)
    nodes = [r for r in s.residues() if r[0] == "A"][:10] + [TIE_RESIDUE]
    got = TS.buried_surface_area(s, nodes, device="cpu")
    want = JS.buried_surface_area(s, nodes)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), **FEAT_TOL)
    got = TB.BSA(cx["pdbs"][k], device="cpu").get_contact_residue_sasa()
    want = JB.BSA(cx["pdbs"][k]).get_contact_residue_sasa()
    assert list(got) == list(want) and TIE_RESIDUE in got
    np.testing.assert_allclose([v[0] for v in got.values()], [v[0] for v in want.values()],
                               **FEAT_TOL)


@pytest.mark.parametrize("k", MODELS)
def test_contacts(cx, k):
    """Interface contacts (with the pair exactly at 8.5 Å) and internal
    edges: the same residues in the same order, distances within 1e-12;
    residue centres bitwise."""
    import deeprank_gnn_tpu.featurize.contacts as JC
    import deeprank_gnn_tpu_torch.featurize.contacts as TC
    from deeprank_gnn_tpu_torch.featurize.pdb import read_pdb

    s = read_pdb(cx["pdbs"][k])
    pairs, dists = TC.get_contact_residues(s, device="cpu")
    want_pairs, want_dists = JC.get_contact_residues(s)
    assert pairs == want_pairs and list(dists) == list(want_dists)
    np.testing.assert_allclose(list(dists.values()), list(want_dists.values()), **DIST_TOL)
    tie = [(a, b) for (a, b) in dists if b == TIE_RESIDUE]
    assert len(tie) == 1 and dists[tie[0]] == 8.5  # only the pair at the cutoff
    nodes = list(pairs) + sorted({v for vs in pairs.values() for v in vs})
    edges, edists = TC.get_internal_edges(s, nodes, device="cpu")
    want_edges, want_edists = JC.get_internal_edges(s, nodes)
    assert edges == want_edges and len(edges) > 0
    np.testing.assert_allclose(edists, want_edists, **DIST_TOL)
    got, want = TC.residue_centers(s), JC.residue_centers(s)
    assert list(got) == list(want)
    assert all(np.array_equal(got[key], want[key]) for key in want)


@pytest.mark.parametrize("k,biopython", [(0, True), (1, False), (2, True)])
def test_residue_graph(cx, k, biopython):
    """``ResidueGraph`` with PSSMs (and depth and half-sphere exposure)."""
    from deeprank_gnn_tpu.featurize.residue_graph import ResidueGraph as JaxGraph
    from deeprank_gnn_tpu_torch.featurize.residue_graph import ResidueGraph

    j = JaxGraph(pdb=cx["pdbs"][k], pssm=cx["pssm_files"], biopython=biopython)
    t = ResidueGraph(pdb=cx["pdbs"][k], pssm=cx["pssm_files"], biopython=biopython,
                     device="cpu")
    assert_graphs_equal(j, t)
    assert TIE_RESIDUE in t.nodes
    if biopython:
        assert np.asarray(t.node_data["hse"]).any() and np.asarray(t.node_data["depth"]).any()


@pytest.mark.parametrize("k,pssm", [(0, True), (1, False)])
def test_atom_graph(cx, k, pssm):
    """The atomic graph, with and without PSSMs (depth and half-sphere
    exposure in the first)."""
    from deeprank_gnn_tpu.featurize.atom_graph import AtomGraph as JaxGraph
    from deeprank_gnn_tpu_torch.featurize.atom_graph import AtomGraph

    kw = dict(pssm=cx["pssm_files"], biopython=True) if pssm else {}
    assert_graphs_equal(JaxGraph(pdb=cx["pdbs"][k], **kw),
                        AtomGraph(pdb=cx["pdbs"][k], device="cpu", **kw))


@pytest.mark.parametrize("k", MODELS)
def test_similarity_scores(cx, k):
    """lrmsd, irmsd, fnat, DockQ and the classes against the reference."""
    from deeprank_gnn_tpu.featurize.similarity import compute_all_scores as jax_scores
    from deeprank_gnn_tpu_torch.featurize.similarity import compute_all_scores

    got = compute_all_scores(cx["pdbs"][k], cx["ref_file"], device="cpu")
    want = jax_scores(cx["pdbs"][k], cx["ref_file"])
    assert list(got) == list(want)
    assert (got["bin_class"], got["capri_class"]) == (want["bin_class"], want["capri_class"])
    np.testing.assert_allclose([got[n] for n in ("irmsd", "lrmsd", "fnat", "dockQ")],
                               [want[n] for n in ("irmsd", "lrmsd", "fnat", "dockQ")],
                               **FEAT_TOL)
    if k == 0:
        assert got["fnat"] == 1.0 and got["irmsd"] < 1e-9


def test_geometry_against_native(cx):
    """``geometry.contact_pairs`` and ``coalesce_pairs`` against the JAX
    package's (its C++ library, else its numpy equivalents), with ties at
    the cutoff on a 1 Å grid."""
    from deeprank_gnn_tpu import native
    from deeprank_gnn_tpu.featurize.contacts import _pairwise_residue_contacts
    from deeprank_gnn_tpu_torch.featurize import geometry

    rng = np.random.default_rng(3)
    xyz_a = rng.integers(0, 12, (300, 3)) / 1.0  # a 1 Å grid: many pairs at 2.0 exactly
    xyz_b = rng.integers(0, 12, (200, 3)) / 1.0
    # one atom a residue (so the ties show), then residues of several atoms
    for rid_a, rid_b in ((np.arange(300), np.arange(200) + 7),
                         (np.sort(rng.integers(0, 40, 300)), np.sort(rng.integers(0, 30, 200)))):
        ra, rb, d = geometry.contact_pairs(xyz_a, rid_a, xyz_b, rid_b, 2.0, device="cpu")
        want = _pairwise_residue_contacts(xyz_a, rid_a, xyz_b, rid_b, 2.0)
        assert list(zip(ra.tolist(), rb.tolist())) == sorted(want)
        np.testing.assert_allclose(d, [want[key] for key in sorted(want)], **DIST_TOL)
        assert len(want) > 10
    _, _, d = geometry.pairs_within(xyz_a, xyz_b, 2.0, device="cpu")
    assert (d == 2.0).sum() > 10  # pairs exactly at the cutoff count
    src, dst = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    got = geometry.coalesce_pairs(src, dst, device="cpu")
    lib = native.coalesce_pairs_native(src, dst)
    uniq, inv = np.unique(np.stack([src, dst], 1), axis=0, return_inverse=True)
    want = lib if lib is not None else (uniq[:, 0], uniq[:, 1], inv.ravel())
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)


def walk(path):
    """``[(dataset path, array)]`` of an HDF5 file, in h5py's order."""
    out = []
    with h5py.File(path, "r") as f5:
        f5.visititems(lambda name, obj: out.append((name, obj[()]))
                      if isinstance(obj, h5py.Dataset) else None)
    return out


def test_graphhdf5_matches_jax_and_nproc(cx, tmp_path):
    """``GraphHDF5`` with scores and PSSMs: the JAX package's groups and
    datasets in its order, integer and string datasets bitwise, floats
    within 1e-9; ``nproc=2`` (workers parse, this process featurizes)
    writes a file bitwise equal to ``nproc=1``'s."""
    from deeprank_gnn_tpu.featurize.graphgen import GraphHDF5 as JaxGraphHDF5
    from deeprank_gnn_tpu_torch.featurize.graphgen import GraphHDF5

    kw = dict(pdb_path=cx["pdb"], ref_path=cx["ref"], pssm_path=cx["pssm"])
    JaxGraphHDF5(outfile=str(tmp_path / "jax.hdf5"), **kw)
    GraphHDF5(outfile=str(tmp_path / "one.hdf5"), device="cpu", **kw)
    GraphHDF5(outfile=str(tmp_path / "two.hdf5"), nproc=2, device="cpu", **kw)
    want, one, two = (walk(str(tmp_path / f"{n}.hdf5")) for n in ("jax", "one", "two"))
    assert [n for n, _ in one] == [n for n, _ in want] and len(want) > 60
    for (name, a), (_, b), (_, c) in zip(want, one, two):
        assert b.dtype == a.dtype and np.shape(b) == np.shape(a), name
        assert np.array_equal(b, c), name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, err_msg=name, **FEAT_TOL)
        else:
            assert np.array_equal(b, a), name


def test_converter_matches_dataset(cx, tmp_path):
    """``Graph.to_sample`` is exactly ``HDF5DataSet.get`` on the group
    ``nx2h5`` writes: without clusters, and after ``PreCluster`` with
    ``cluster_sample``'s; 'all' features too."""
    from deeprank_gnn_tpu_torch.data.dataset import HDF5DataSet, PreCluster, cluster_sample
    from deeprank_gnn_tpu_torch.featurize.residue_graph import ResidueGraph

    graphs = [ResidueGraph(pdb=p, pssm=cx["pssm_files"], device="cpu") for p in cx["pdbs"]]
    for g in graphs:
        g.get_score(cx["ref_file"])
    path = str(tmp_path / "port.hdf5")
    with h5py.File(path, "w") as f5:
        for g in graphs:
            g.nx2h5(f5)
    feats = ["type", "polarity", "bsa", "charge", "cons", "ic", "pssm"]

    def check(samples, ds):
        assert len(ds) == len(samples)
        for i, s in enumerate(samples):
            want = ds.get(i)
            for field in want.__dataclass_fields__:
                a, b = getattr(want, field), getattr(s, field)
                assert (a is None and b is None) or (
                    np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)), field

    for nf, ef in ((feats, ["dist"]), ("all", "all")):
        ds = HDF5DataSet(database=path, node_feature=nf, edge_feature=ef, target="irmsd")
        check([g.to_sample(nf, ef, target="irmsd") for g in graphs], ds)
    PreCluster(HDF5DataSet(database=path, node_feature=feats, target="fnat"), "mcl")
    ds = HDF5DataSet(database=path, node_feature=feats, target="fnat")
    check([cluster_sample(g.to_sample(feats, target="fnat"), "mcl") for g in graphs], ds)
    assert ds.get(0).cluster0 is not None


def test_entry_points_raise_without_card(cx, tmp_path):
    """Every featurizer entry point runs on ``cuda`` unless it is passed
    ``device="cpu"``: without a card each raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from deeprank_gnn_tpu_torch.cli import main
    from deeprank_gnn_tpu_torch.featurize import AtomGraph, GraphHDF5, ResidueGraph
    from deeprank_gnn_tpu_torch.featurize.bsa import BSA
    from deeprank_gnn_tpu_torch.featurize.contacts import get_contact_residues
    from deeprank_gnn_tpu_torch.featurize.pdb import read_pdb
    from deeprank_gnn_tpu_torch.featurize.sasa import atom_sasa

    pdb = cx["pdbs"][0]
    s = read_pdb(pdb)
    calls = [lambda: ResidueGraph(pdb=pdb), lambda: AtomGraph(pdb=pdb),
             lambda: GraphHDF5(cx["pdb"], outfile=str(tmp_path / "g.hdf5")),
             lambda: BSA(pdb), lambda: atom_sasa(s), lambda: get_contact_residues(s),
             lambda: main(["graphgen", "--pdb", cx["pdb"], "--out", str(tmp_path / "c.hdf5")])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not os.path.exists(tmp_path / "g.hdf5")


PORTED = [
    "featurize/pdb.py", "featurize/geometry.py", "featurize/sasa.py", "featurize/contacts.py",
    "featurize/pssm.py", "featurize/similarity.py", "featurize/graph.py",
    "featurize/residue_graph.py", "featurize/biofeatures.py", "featurize/bsa.py",
    "featurize/atom_graph.py", "featurize/graphgen.py", "ops/coalesce.py",
    "community_pooling.py", "ops/__init__.py", "tools/__init__.py",
    "tools/customize_graph.py", "tools/hdf5_to_csv.py", "tools/embedding.py",
    "tools/pssm_3dcons.py", "h5x/__init__.py", "h5x/baseimport.py", "h5x/h5x.py",
    "h5x/h5x_menu.py", "cli.py",
]


def test_port_imports_no_jax():
    """The port's modules exist and no file of the package imports ``jax``,
    ``optax`` or ``deeprank_gnn_tpu``; without ``h5py`` (as on the card's
    machine) the featurizer builds a graph and converts it."""
    pkg = os.path.join(ROOT, "deeprank_gnn_tpu_torch")
    for rel in PORTED:
        assert os.path.isfile(os.path.join(pkg, rel)), rel
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|deeprank_gnn_tpu)(\.|\s|$)", re.M)
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert not bad.search(f.read()), os.path.join(dirpath, name)


def test_featurizer_runs_without_h5py(cx):
    """In a process where ``h5py``, ``jax`` and ``deeprank_gnn_tpu`` cannot
    be imported, a residue graph is built on the CPU and converted."""
    code = f"""
import sys
for name in ("h5py", "jax", "optax", "deeprank_gnn_tpu", "sklearn"):
    sys.modules[name] = None
import deeprank_gnn_tpu_torch.featurize as F
import deeprank_gnn_tpu_torch.community_pooling, deeprank_gnn_tpu_torch.tools
import deeprank_gnn_tpu_torch.h5x, deeprank_gnn_tpu_torch.ops
from deeprank_gnn_tpu_torch.data.dataset import cluster_sample
g = F.ResidueGraph(pdb={cx["pdbs"][1]!r}, pssm={cx["pssm_files"]!r}, device="cpu")
s = cluster_sample(g.to_sample(["type", "bsa", "pssm"]), "mcl")
assert s.x.shape == (len(g.nodes), 41) and s.cluster1 is not None
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]

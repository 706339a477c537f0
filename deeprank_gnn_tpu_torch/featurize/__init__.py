"""Offline featurization: PDB docking models -> interface graphs -> HDF5.

The port's counterpart of ``deeprank_gnn_tpu/featurize``: the residue and
atomic interface graphs with the JAX package's nodes, edges and features.
Parsing and the per-residue tables stay on the host; the geometry (contact
search, SASA, depth, half-sphere exposure) runs as torch on the
featurizer's device (:mod:`featurize.geometry`), ``cuda`` unless the caller
passes ``device="cpu"``. Importing the package loads neither ``h5py`` nor
torch: every export loads on first use.
"""

__all__ = ["GraphHDF5", "AtomGraph", "ResidueGraph"]

_EXPORTS = {
    "GraphHDF5": "deeprank_gnn_tpu_torch.featurize.graphgen",
    "AtomGraph": "deeprank_gnn_tpu_torch.featurize.atom_graph",
    "ResidueGraph": "deeprank_gnn_tpu_torch.featurize.residue_graph",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

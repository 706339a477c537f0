"""Plot callbacks for the HDF5 explorer (reference `h5x/baseimport.py`).

The port's own copy of ``deeprank_gnn_tpu/h5x/baseimport.py``.
"""

from __future__ import annotations

from deeprank_gnn_tpu_torch.featurize.graph import Graph


def _load(h5file: str, mol: str) -> Graph:
    g = Graph()
    g.h52nx(h5file, mol)
    return g


def tsne_graph(h5file: str, mol: str, method: str = "louvain", out=None):
    """2D tSNE-embedded interface plot (reference `baseimport.py:19-27`)."""
    g = _load(h5file, mol)
    return g.plotly_2d(out=out or mol, disable_plot=False, method=method)


graph2d = tsne_graph


def graph3d(h5file: str, mol: str, out=None):
    """3D graph plot (reference `baseimport.py:29-36`)."""
    g = _load(h5file, mol)
    return g.plotly_3d(out=out or mol, disable_plot=False)

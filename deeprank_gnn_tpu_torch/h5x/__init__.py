"""h5xplorer GUI plugin (reference `deeprank_gnn/h5x/`).

Provides the same context-menu hooks (tSNE 2D plot / 3D graph plot of
an HDF5 entry). The h5xplorer/PyQt5 stack is optional; importing this
package without them only disables the GUI launcher, while the
plotting callbacks remain usable headlessly.

The port's own copy of ``deeprank_gnn_tpu/h5x``, over the port's
:class:`~deeprank_gnn_tpu_torch.featurize.graph.Graph`.
"""

from deeprank_gnn_tpu_torch.h5x.baseimport import graph2d, graph3d, tsne_graph

__all__ = ["tsne_graph", "graph2d", "graph3d"]

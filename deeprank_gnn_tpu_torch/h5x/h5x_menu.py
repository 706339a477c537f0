"""Context menu for the HDF5 explorer (reference `h5x/h5x_menu.py`).

Right-click on a molecule group -> tSNE 2D plot or 3D graph plot.

The port's own copy of ``deeprank_gnn_tpu/h5x/h5x_menu.py``.
"""

from __future__ import annotations


def context_menu(self, treeview, position):  # pragma: no cover - GUI glue
    """Generate the context menu actions (mirrors the reference's
    `context_menu`, `h5x_menu.py:6-81`, on our plotting callbacks)."""
    from PyQt5 import QtWidgets

    items = treeview.selectedItems()
    if len(items) != 1:
        return
    item = items[0]
    data = treeview.model().hdf5data(item)
    try:
        _ = data["nodes"]
    except Exception:
        return

    menu = QtWidgets.QMenu()
    actions = {
        "tSNE plot": "tsne",
        "3D plot": "3d",
    }
    qactions = {menu.addAction(name): key for name, key in actions.items()}
    action = menu.exec_(treeview.viewport().mapToGlobal(position))
    if action not in qactions:
        return
    h5file = treeview.model().root_item.data_file.filename
    mol = item.name()
    from deeprank_gnn_tpu_torch.h5x import baseimport

    if qactions[action] == "tsne":
        baseimport.tsne_graph(h5file, mol)
    else:
        baseimport.graph3d(h5file, mol)

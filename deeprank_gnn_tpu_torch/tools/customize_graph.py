"""Inject custom target values into graph HDF5 files
(reference `tools/CustomizeGraph.py:8-75`).

The target file lists `model_name value` per line; every matching graph
group gets `score/<target_name>` created or overwritten.

The port's own copy of ``deeprank_gnn_tpu/tools/customize_graph.py``
(``h5py`` imported where the files are opened).
"""

from __future__ import annotations

import glob
import os
from typing import Dict


def add_target(
    graph_path: str, target_name: str, target_list: str, sep: str = " "
) -> None:
    import h5py

    target_dict: Dict[str, float] = {}
    with open(target_list, "r") as f:
        for line in f:
            parts = line.strip().split(sep)
            if len(parts) == 2:
                target_dict[parts[0]] = float(parts[1])

    if os.path.isdir(graph_path):
        graphs = glob.glob(os.path.join(graph_path, "*.hdf5"))
    elif graph_path.endswith(".hdf5"):
        graphs = [graph_path]
    else:
        raise ValueError(f"{graph_path} is neither an hdf5 file nor a directory")

    for hdf5 in graphs:
        print(hdf5)
        try:
            f5 = h5py.File(hdf5, "a")
            for model, value in target_dict.items():
                if model not in f5:
                    raise ValueError(
                        f"{hdf5} does not contain an entry named {model}"
                    )
                group = f5[f"{model}/score"]
                if target_name in group:
                    del group[target_name]
                group.create_dataset(target_name, data=value)
            f5.close()
        except BaseException:
            print(f"no graph for {hdf5}")

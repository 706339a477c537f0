"""Convert epoch-output HDF5 files (written by NeuralNet) to CSV
(reference `tools/hdf5_to_csv.py:6-74`), including per-class raw
probabilities for classification runs.

The port's own copy of ``deeprank_gnn_tpu/tools/hdf5_to_csv.py`` (``h5py``
imported where the file is opened).
"""

from __future__ import annotations

import csv

import numpy as np


def hdf5_to_csv(hdf5_path: str) -> str:
    import h5py

    outname = hdf5_path.rsplit(".", 1)[0] + ".csv"
    with h5py.File(hdf5_path, "r") as f5, open(outname, "w", newline="") as out:
        writer = None
        for epoch_key in f5.keys():
            epoch = f5[epoch_key]
            for pass_type in epoch.keys():
                grp = epoch[pass_type]
                if "mol" not in grp:
                    continue
                mols = [
                    m.decode() if isinstance(m, bytes) else str(m)
                    for m in grp["mol"][()]
                ]
                outputs = grp["outputs"][()] if "outputs" in grp else None
                targets = grp["targets"][()] if "targets" in grp else None
                raw = grp["raw_outputs"][()] if "raw_outputs" in grp else None

                n_raw = 0
                if raw is not None and np.ndim(raw) == 2:
                    n_raw = raw.shape[1]
                if writer is None:
                    # column names follow the reference converter
                    # (`hdf5_to_csv.py:33,50`)
                    header = ["epoch", "set", "model", "targets", "prediction"]
                    header += [f"raw_prediction_{i}" for i in range(n_raw)]
                    if n_raw == 0 and raw is not None:
                        header += ["raw_prediction"]
                    writer = csv.writer(out)
                    writer.writerow(header)
                for i, mol in enumerate(mols):
                    row = [epoch_key, pass_type, mol]
                    row.append(targets[i] if targets is not None and i < len(targets) else "")
                    row.append(outputs[i] if outputs is not None and i < len(outputs) else "")
                    if raw is not None and i < len(raw):
                        r = raw[i]
                        row += list(np.atleast_1d(r))
                    writer.writerow(row)
    return outname

"""Score docking models with the paper's pretrained fnat regressor, with the
PyTorch port.

The port's counterpart of ``score_docking_models.py`` (reference
`paper_pretrained_models/scoring_of_docking_models/test.py`): featurize the
docking models, then run the fold6 pretrained GINet (the reference's torch
``.pt`` checkpoint loads directly).

    python paper/score_docking_models_torch.py    # on the card
"""

import glob
import time

from deeprank_gnn_tpu_torch import GINet, NeuralNet
from deeprank_gnn_tpu_torch.featurize.graphgen import GraphHDF5

PDB_PATH = "../tests/data/pdb/1ATN/"
PSSM_PATH = "../tests/data/pssm/1ATN/"
PRETRAINED = "fold6_treg_yfnat_b128_e20_lr0.001_4.pt"


def main(pdb_path=PDB_PATH, pssm_path=PSSM_PATH, pretrained=PRETRAINED, nproc=4,
         device="cuda"):
    """Featurize into ``1ATN_residue.hdf5``, score every ``*.hdf5`` of the
    working directory with ``pretrained`` and print each model's
    prediction; returns the engine."""
    GraphHDF5(
        pdb_path=pdb_path,
        pssm_path=pssm_path,
        graph_type="residue",
        outfile="1ATN_residue.hdf5",
        nproc=nproc,
        device=device,
    )

    database_test = glob.glob("./*.hdf5")
    start_time = time.time()
    model = NeuralNet(database_test, GINet, pretrained_model=pretrained, device=device)
    model.test(threshold=0.3)
    print(f"Elapsed time: {time.time() - start_time:.2f} s")
    for mol, pred in zip(model.data["test"]["mol"], model.data["test"]["outputs"]):
        print(mol, pred)
    return model


if __name__ == "__main__":
    main()

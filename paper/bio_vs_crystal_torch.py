"""Classify biological vs crystal interfaces with the paper's pretrained
model, with the PyTorch port.

The port's counterpart of ``bio_vs_crystal.py`` (reference
`paper_pretrained_models/biological_vs_crystal_interfaces/prediction_phy_non-phy.py`).

    python paper/bio_vs_crystal_torch.py          # on the card
"""

from deeprank_gnn_tpu_torch import GINet, NeuralNet
from deeprank_gnn_tpu_torch.featurize.graphgen import GraphHDF5
from deeprank_gnn_tpu_torch.tools import add_target

PDB_PATH = "../DC/pdb/"
PSSM_PATH = "../DC/pssm/"
DATABASE = "biological_vs_crystal.hdf5"
PRETRAINED = "tclass_ybio_interface_b128_e50_lr0.001_26.pth.tar"


def main(pdb_path=PDB_PATH, pssm_path=PSSM_PATH, database=DATABASE, pretrained=PRETRAINED,
         target_list="bio_interfaces.txt", nproc=8, device="cuda"):
    """Featurize into ``database``, label it from ``target_list``, classify
    it with ``pretrained`` and print the metrics; returns the engine and
    the metrics."""
    GraphHDF5(
        pdb_path=pdb_path,
        pssm_path=pssm_path,
        biopython=False,
        graph_type="residue",
        outfile=database,
        nproc=nproc,
        device=device,
    )

    # benchmark mode: inject ground-truth labels to compute metrics
    add_target(graph_path=database, target_name="bio_interface", target_list=target_list)

    model = NeuralNet(database, GINet, pretrained_model=pretrained, device=device)
    model.test(hdf5="prediction_phy_non-phy.hdf5", threshold=1)

    m = model.get_metrics("test", threshold=1.0)
    print("accuracy:", m.accuracy)
    print("specificity:", m.specificity)
    print("sensitivity:", m.sensitivity)
    print("precision:", m.precision)
    print("FPR:", m.FPR)
    print("FNR:", m.FNR)
    return model, m


if __name__ == "__main__":
    main()

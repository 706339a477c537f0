"""Featurize docking models into residue interface graphs (HDF5), with the
PyTorch port.

The port's counterpart of ``create_graph.py`` (reference
`example/create_graph.py`): the same paths and output, the geometry
(contacts, SASA, depth, half-sphere exposure) as torch on ``device``.

    python example/create_graph_torch.py          # on the card
"""

from deeprank_gnn_tpu_torch.featurize.graphgen import GraphHDF5

pdb_path = "./data/pdb/1ATN/"
pssm_path = "./data/pssm/1ATN/"
ref = "./data/ref/1ATN/"


def main(pdb_path=pdb_path, pssm_path=pssm_path, ref=ref, outfile="1ATN_residue.hdf5",
         nproc=4, device="cuda"):
    """Write the residue graphs of the models in ``pdb_path`` to
    ``outfile``; ``device="cpu"`` runs the geometry on the CPU."""
    GraphHDF5(
        pdb_path=pdb_path,
        ref_path=ref,
        pssm_path=pssm_path,
        graph_type="residue",
        outfile=outfile,
        nproc=nproc,
        device=device,
    )


if __name__ == "__main__":
    main()

"""Featurize docking models into ATOM-level interface graphs (HDF5), with
the PyTorch port.

The port's counterpart of ``create_atomic_graph.py``: nodes are heavy
interface atoms (5.5 Å cross-chain contacts) with per-atom ``bsa`` and a
one-hot ``atomtype``, in the residue graphs' schema, so ``nn_torch.py``
trains on it unchanged once "atomtype" is added to ``node_feature``.

    python example/create_atomic_graph_torch.py   # on the card
"""

from deeprank_gnn_tpu_torch.featurize.graphgen import GraphHDF5

pdb_path = "./data/pdb/1ATN/"
pssm_path = "./data/pssm/1ATN/"
ref = "./data/ref/1ATN/"


def main(pdb_path=pdb_path, pssm_path=pssm_path, ref=ref, outfile="1ATN_atomic.hdf5",
         nproc=4, device="cuda"):
    """Write the atomic graphs of the models in ``pdb_path`` to
    ``outfile``; ``device="cpu"`` runs the geometry on the CPU."""
    GraphHDF5(
        pdb_path=pdb_path,
        ref_path=ref,
        pssm_path=pssm_path,
        graph_type="atomic",
        outfile=outfile,
        nproc=nproc,
        device=device,
    )


if __name__ == "__main__":
    main()

"""User-facing utilities (reference `deeprank_gnn/tools/`): target
injection, epoch-output CSV conversion, 2D embeddings, PSSM format
conversion.

The port's own copy of ``deeprank_gnn_tpu/tools``: host Python; ``h5py``
and ``scikit-learn`` are imported only inside the functions that use them.
"""

from deeprank_gnn_tpu_torch.tools.customize_graph import add_target
from deeprank_gnn_tpu_torch.tools.hdf5_to_csv import hdf5_to_csv
from deeprank_gnn_tpu_torch.tools.embedding import manifold_embedding
from deeprank_gnn_tpu_torch.tools.pssm_3dcons import pssm_3dcons_to_deeprank

__all__ = [
    "add_target",
    "hdf5_to_csv",
    "manifold_embedding",
    "pssm_3dcons_to_deeprank",
]

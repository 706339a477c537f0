"""deeprank_gnn_tpu_torch — the PyTorch/CUDA port of deeprank_gnn_tpu.

A second package beside the JAX one, for NVIDIA Hopper (sm_90a). It keeps
the JAX package's module layout and names; plain tensor code is PyTorch,
and the JAX package's Pallas kernels become CUDA kernels written by hand
(``ops/csrc``), each with a plain PyTorch version beside it.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``, which runs the plain versions. The package imports
nothing of JAX or of ``deeprank_gnn_tpu``; ``h5py`` and ``scikit-learn``
are imported only where files are read or metrics computed.

Ported so far: scoring with a pretrained net,
``NeuralNet(db, GINet, pretrained_model=ckpt).test()``, and training it,
``NeuralNet(db, GINet, ...).train()``, in the sparse and the dense layout,
for the whole model zoo: GINet in paper mode, with attention
(``functools.partial(GINet, attention=True)``) or with the internal tower
(sparse layout only), FoutNet and sGAT (ROADMAP.md); the device store,
scanned epochs and the fast mode; multi-device training and serving
over ``torch.distributed`` (``deeprank_gnn_tpu_torch.parallel``: the
graph-parallel meshes and the halo layout); and the featurizer
(``deeprank_gnn_tpu_torch.featurize``: PDB docking models to interface
graphs, its geometry on the card), edge coalescing, on-line clustering
(``community_pooling``), the tools and the rest of the CLI.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "HDF5DataSet": "deeprank_gnn_tpu_torch.data.dataset",
    "DivideDataSet": "deeprank_gnn_tpu_torch.data.dataset",
    "PreCluster": "deeprank_gnn_tpu_torch.data.dataset",
    "GraphListDataSet": "deeprank_gnn_tpu_torch.data.dataset",
    "GINet": "deeprank_gnn_tpu_torch.models.ginet",
    "FoutNet": "deeprank_gnn_tpu_torch.models.foutnet",
    "sGAT": "deeprank_gnn_tpu_torch.models.sgat",
    "NeuralNet": "deeprank_gnn_tpu_torch.train.neuralnet",
}

__all__ = [*_EXPORTS, "__version__"]


def __getattr__(name):
    # exports load on first use, so importing the package loads nothing heavy
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Checkpoint loading for both flavours, and weights carried across from JAX.

The port's counterpart of ``deeprank_gnn_tpu/train/checkpoint.py``. A
checkpoint is one dict with the model's weights and the data/config
context (reference `NeuralNet.py:768-792`). Two flavours exist:

1. reference torch files (``.pt``, ``.pth.tar``): ``model`` is a torch
   state dict with the reference's names (``conv1.fc.weight``, …,
   ``fc2.bias``);
2. pickles written by the JAX package (``__format__`` == ``MAGIC``):
   ``model`` is its parameter tree (``GINetParams``), the optimizer an
   optax Adam state.

A JAX pickle names classes of the JAX package and of optax, and a plain
``pickle.load`` would import both. :func:`load_state` reads it with an
unpickler that maps exactly those classes to local stand-ins and refuses
any other global except numpy's array reconstructors, so loading needs
neither JAX nor optax. Saving checkpoints comes with training.
"""

from __future__ import annotations

import collections
import pickle
import zipfile
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

MAGIC = "deeprank_gnn_tpu-checkpoint"


class _Fields:
    """Attribute bag standing in for a pickled parameter dataclass of the
    JAX package (its fields arrive as instance attributes)."""

    def __repr__(self) -> str:
        return f"_Fields({', '.join(sorted(vars(self)))})"


_STAND_INS = {
    ("deeprank_gnn_tpu.models.ginet", "GINetParams"): _Fields,
    ("deeprank_gnn_tpu.models.ginet", "GINetConvParams"): _Fields,
    ("optax._src.transform", "ScaleByAdamState"): collections.namedtuple(
        "ScaleByAdamState", "count mu nu"
    ),
    ("optax._src.base", "EmptyState"): collections.namedtuple("EmptyState", ""),
}

_NUMPY_GLOBALS = {
    ("numpy", "dtype"),
    ("numpy", "ndarray"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
}


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _STAND_INS:
            return _STAND_INS[(module, name)]
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint references {module}.{name}; only numpy arrays and "
            "the JAX package's GINet parameter and Adam state classes are read"
        )


def load_state(filename: str) -> Dict[str, Any]:
    """Load a checkpoint of either flavour. ``__format__`` says which:
    ``MAGIC`` for a JAX pickle, ``"torch"`` for a reference torch file."""
    if not zipfile.is_zipfile(filename):
        # a JAX pickle; a torch file in the legacy (non-zip) format
        # starts with a pickled magic number instead of a dict
        with open(filename, "rb") as f:
            payload = _JaxCheckpointUnpickler(f).load()
        if isinstance(payload, dict) and payload.get("__format__") == MAGIC:
            return payload
    state = torch.load(filename, map_location="cpu", weights_only=False)
    out = dict(state)
    out["__format__"] = "torch"
    return out


def _get(tree, name: str):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def state_dict_from_jax_params(net_name: str, params) -> Dict[str, torch.Tensor]:
    """The reference-named torch state dict of the JAX package's GINet
    parameters (the inverse of its ``torch_state_dict_to_params``).

    ``params`` is the ``GINetParams`` field tree (``conv1.fc_w``, …,
    ``fc2_b``; arrays of any kind numpy can read), given as nested dicts
    or as objects with those attributes.
    """
    if net_name != "GINet":
        raise NotImplementedError(
            f"{net_name}: only GINet is ported; see ROADMAP.md, queue 1"
        )
    sd = {}
    for conv in ("conv1", "conv2", "conv1_ext", "conv2_ext"):
        c = _get(params, conv)
        sd[f"{conv}.fc.weight"] = _tensor(_get(c, "fc_w"))
        sd[f"{conv}.fc_edge_attr.weight"] = _tensor(_get(c, "fc_edge_w"))
        sd[f"{conv}.fc_attention.weight"] = _tensor(_get(c, "fc_att_w"))
    for fc in ("fc1", "fc2"):
        sd[f"{fc}.weight"] = _tensor(_get(params, f"{fc}_w"))
        sd[f"{fc}.bias"] = _tensor(_get(params, f"{fc}_b"))
    return sd


def state_dict_from_checkpoint(net_name: str, payload: Dict[str, Any]):
    """The model's torch state dict from either checkpoint flavour."""
    if payload.get("__format__") == MAGIC:
        return state_dict_from_jax_params(net_name, payload["model"])
    return payload["model"]

"""Checkpoints of both flavours, and weights and Adam moments carried
across from JAX.

The port's counterpart of ``deeprank_gnn_tpu/train/checkpoint.py``. A
checkpoint is one dict with the model's weights and the data/config
context (reference `NeuralNet.py:768-792`). Two flavours exist:

1. reference torch files (``.pt``, ``.pth.tar``): ``model`` is a torch
   state dict with the reference's names (``conv1.fc.weight``, …,
   ``fc2.bias``) and ``optimizer`` a torch Adam ``state_dict()``;
2. pickles written by the JAX package (``__format__`` == ``MAGIC``):
   ``model`` is its parameter tree (``GINetParams``, ``FoutNetParams`` or
   ``SGATParams``), the optimizer an optax Adam state.

The port writes the first flavour (:func:`save_state`), which the reference
and the JAX package both read. A JAX pickle names classes of the JAX
package and of optax, and a plain ``pickle.load`` would import both.
:func:`load_state` reads it with an unpickler that maps exactly those
classes to local stand-ins and refuses any other global except numpy's
array reconstructors, so loading needs neither JAX nor optax.
"""

from __future__ import annotations

import collections
import pickle
import zipfile
from collections.abc import Mapping
from typing import Any, Dict, Optional

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
    ("deeprank_gnn_tpu.models.foutnet", "FoutNetParams"): _Fields,
    ("deeprank_gnn_tpu.models.foutnet", "FoutLayerParams"): _Fields,
    ("deeprank_gnn_tpu.models.sgat", "SGATParams"): _Fields,
    ("deeprank_gnn_tpu.models.sgat", "SGATLayerParams"): _Fields,
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
            "the JAX package's model parameter and Adam state classes are read"
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


# reference state-dict name -> JAX field, per conv layer of each net (the
# inverse of the JAX package's ``torch_state_dict_to_params``,
# ``train/checkpoint.py:67-126``)
_LAYER_FIELDS = {
    "GINet": (("conv1", "conv2", "conv1_ext", "conv2_ext"),
              {"fc.weight": "fc_w", "fc_edge_attr.weight": "fc_edge_w",
               "fc_attention.weight": "fc_att_w"}),
    "FoutNet": (("conv1", "conv2"), {"Wc": "wc", "Wn": "wn", "bias": "bias"}),
    "sGAT": (("conv1", "conv2"), {"weight": "weight", "bias": "bias"}),
}


def state_dict_from_jax_params(net_name: str, params) -> Dict[str, torch.Tensor]:
    """The reference-named torch state dict of the JAX package's parameters
    of ``net_name`` ("GINet", "FoutNet" or "sGAT"; the inverse of its
    ``torch_state_dict_to_params``).

    ``params`` is the JAX parameter field tree (``conv1.fc_w``, …,
    ``fc2_b``; arrays of any kind numpy can read), given as nested dicts
    or as objects with those attributes.
    """
    if net_name not in _LAYER_FIELDS:
        raise ValueError(f"unknown net {net_name!r}; want one of {sorted(_LAYER_FIELDS)}")
    convs, fields = _LAYER_FIELDS[net_name]
    sd = {}
    for conv in convs:
        c = _get(params, conv)
        for name, field in fields.items():
            sd[f"{conv}.{name}"] = _tensor(_get(c, field))
    for fc in ("fc1", "fc2"):
        sd[f"{fc}.weight"] = _tensor(_get(params, f"{fc}_w"))
        sd[f"{fc}.bias"] = _tensor(_get(params, f"{fc}_b"))
    return sd


def state_dict_from_checkpoint(net_name: str, payload: Dict[str, Any]):
    """The model's torch state dict from either checkpoint flavour."""
    if payload.get("__format__") == MAGIC:
        return state_dict_from_jax_params(net_name, payload["model"])
    return payload["model"]


def _on_cpu(obj):
    """``obj`` with every tensor in it detached and moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _on_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on_cpu(v) for v in obj)
    return obj


def save_state(filename: str, state: Dict[str, Any]) -> None:
    """Write a reference-format torch checkpoint: ``state`` with its
    tensors on the CPU (so it loads on any device), ``model`` a state
    dict and ``optimizer`` a torch Adam ``state_dict()``."""
    torch.save(_on_cpu(state), filename)


def _split_flat(vector, shapes):
    """A flat optax moment vector (``optax.flatten``, the JAX engine's
    optimizer) cut into one array per parameter shape, in order; None
    when the sizes disagree."""
    flat = np.asarray(vector, dtype=np.float32).reshape(-1)
    sizes = [int(np.prod(s)) for s in shapes]
    if flat.size != sum(sizes):
        return None
    return [a.reshape(s) for a, s in zip(np.split(flat, np.cumsum(sizes)[:-1]), shapes)]


def adam_state_from_jax(opt_state, params) -> Optional[Dict[str, Any]]:
    """A torch Adam ``state_dict()['state']`` from the optax Adam state of a
    JAX checkpoint, ``(ScaleByAdamState(count, mu, nu), EmptyState())``
    with ``mu`` and ``nu`` flat vectors in leaf order, for ``params`` (the
    model's parameters in order, which is the JAX package's leaf order:
    moments map by index). The inverse of the JAX package's
    ``adam_state_from_torch``. None when the state does not fit the
    parameters (the caller keeps fresh moments)."""
    try:
        adam = opt_state[0]
        count, mu, nu = adam.count, adam.mu, adam.nu
    except (TypeError, IndexError, AttributeError):
        return None
    shapes = [tuple(p.shape) for p in params]
    try:
        mu, nu = _split_flat(mu, shapes), _split_flat(nu, shapes)
    except (TypeError, ValueError):
        return None  # not a flat vector (a per-leaf moment tree)
    if mu is None or nu is None:
        return None
    step = float(np.asarray(count))
    return {
        i: {
            "step": torch.tensor(step),
            "exp_avg": torch.from_numpy(np.array(m, dtype=np.float32)),
            "exp_avg_sq": torch.from_numpy(np.array(v, dtype=np.float32)),
        }
        for i, (m, v) in enumerate(zip(mu, nu))
    }


def adam_state_from_checkpoint(payload: Dict[str, Any], params) -> Optional[Dict[str, Any]]:
    """The Adam moments of either checkpoint flavour as a torch Adam
    ``state_dict()['state']`` for ``params``, or None when the checkpoint
    holds none that fit (an empty ``optimizer``, another optimizer, other
    shapes)."""
    opt = payload.get("optimizer")
    if payload.get("__format__") == MAGIC:
        return adam_state_from_jax(opt, params)
    state = opt.get("state") if isinstance(opt, Mapping) else None
    if not state or len(state) != len(params):
        return None
    for i, p in enumerate(params):
        s = state.get(i)
        if s is None or "exp_avg" not in s or tuple(s["exp_avg"].shape) != tuple(p.shape):
            return None
    return state

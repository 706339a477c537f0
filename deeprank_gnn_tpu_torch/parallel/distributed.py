"""Multi-process start-up: one process is one rank is one shard.

The port's counterpart of ``deeprank_gnn_tpu/parallel/distributed.py``.
Where the JAX package joins a cluster with ``jax.distributed`` and then
sees every host's devices, here every rank is its own process and holds
one device; :func:`initialize` forms the ``torch.distributed`` process
group that the mesh (``parallel/mesh.py``) and its collectives
(``parallel/collectives.py``) run over.

Environment variables (used when the arguments are omitted), as in JAX:

    DEEPRANK_COORDINATOR   e.g. "10.0.0.1:9876", or a "file://..." store
    DEEPRANK_NUM_PROCESSES e.g. "4"
    DEEPRANK_PROCESS_ID    e.g. "0"

``torchrun`` sets ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
instead; ``initialize(coordinator_address="env://")`` takes those.

The backend follows the device: ``nccl`` for ``cuda``, ``gloo`` for
``cpu``. A caller may name ``gloo`` on ``cuda`` (several ranks sharing one
card, which NCCL refuses); its collectives then stage through host copies
(``parallel/collectives.py``). Each rank's device is
``cuda:(rank % torch.cuda.device_count())`` unless the caller names one.
The group has a finite ``timeout``, so that a lost peer fails the run
instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from deeprank_gnn_tpu_torch.device import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

# this process's rank device, set by initialize()
_rank_device: Optional[torch.device] = None


def _init_method(coordinator_address: str) -> str:
    """A ``host:port`` coordinator as a ``tcp://`` address; ``tcp://``,
    ``file://`` and ``env://`` addresses pass as given."""
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the process group (arguments, else the ``DEEPRANK_*``
    variables). Returns without a group when no coordinator is given
    (single process), as the JAX package does. ``device``: ``"cuda"``
    (default: this rank's card) or ``"cpu"``, or a device with an index;
    ``backend``: ``None`` follows the device, or ``"gloo"``/``"nccl"``."""
    global _rank_device
    coordinator_address = coordinator_address or os.environ.get("DEEPRANK_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("DEEPRANK_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("DEEPRANK_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator_address is None:
        return  # single process
    init = _init_method(coordinator_address)
    if init != "env://" and (num_processes is None or process_id is None):
        raise ValueError(
            "initialize: a coordinator needs num_processes and process_id "
            "(or DEEPRANK_NUM_PROCESSES and DEEPRANK_PROCESS_ID)"
        )
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, not {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend 'nccl' needs device 'cuda'")
    kw = {} if init == "env://" else {"world_size": num_processes, "rank": process_id}
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, timeout=timeout, **kw)
    _rank_device = dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The world size, or 1 without a process group."""
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank, or 0 without a process group."""
    return dist.get_rank() if is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given (``"cuda"`` without an
    index becomes ``cuda:(rank % device_count)``), else the one
    :func:`initialize` chose, else ``cuda``."""
    if device is None:
        if _rank_device is not None:
            return _rank_device
        device = "cuda"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_index() % torch.cuda.device_count())
    return dev


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    global _rank_device
    if is_initialized():
        dist.destroy_process_group()
    _rank_device = None

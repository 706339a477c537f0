"""Device choice and the numerics the port runs under.

Every entry point of the port runs on ``cuda`` unless its caller passes
``device="cpu"``; there it uses the kernels' plain versions. A request for
``cuda`` on a machine without a CUDA device raises: nothing slides to the
CPU.
"""

from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, checked: ``cuda`` must be available and
    only ``cuda`` and ``cpu`` are accepted."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def set_fp32_numerics() -> None:
    """fp32 throughout: TF32 off for matrix products and cuDNN, and the
    cuBLAS workspace setting that deterministic mode requires (it must be
    in the environment before the process's first cuBLAS call)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def deterministic():
    """Run the block under ``torch.use_deterministic_algorithms(True)``,
    restoring the caller's setting afterwards."""
    was_on = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was_on, warn_only=warn_only)

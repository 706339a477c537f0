"""The executable cache: ``NeuralNet(executable_cache_dir=...)``.

The JAX package (``deeprank_gnn_tpu/train/aot.py``) serializes its compiled
XLA programs, keyed by the lowered program's hash, so that a second process
at the same shapes skips compilation, which costs minutes on a remote TPU.

The port compiles nothing per shape: eager PyTorch launches precompiled
library kernels, and a scanned epoch's CUDA graph (``train/scan.py``) is
captured in a fraction of a second at the first epoch and cannot be
serialized. What a process of the port does compile is its hand kernels:
``nvcc`` builds each ``ops/csrc/*.cu`` into a library at first use
(``ops/kernels/build.py``), and the library's name carries a hash of its
source and flags. So the port's counterpart of "a second process skips
compilation" is the directory those libraries are built in and found in:
``executable_cache_dir`` sets it (default ``ops/_build/`` of the checkout),
and a second process with the same directory runs no ``nvcc``. Nothing is
built on the CPU, where the kernels' plain versions run.
"""

from __future__ import annotations

from deeprank_gnn_tpu_torch.ops.kernels import build


def use_executable_cache(cache_dir: str) -> None:
    """Build the hand kernels in ``cache_dir``, and reuse the libraries
    found there, for the rest of this process."""
    build.set_build_dir(cache_dir)

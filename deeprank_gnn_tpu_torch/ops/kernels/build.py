"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``ops/csrc/<name>.cu`` compiles on its own into a shared library with
a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o ops/_build/lib<name>-<hash>.so ops/csrc/<name>.cu

The build happens at first use on a CUDA tensor, never at import, and
writes into ``ops/_build/`` (ignored by git). The library name carries a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_OPS = Path(__file__).resolve().parent.parent
CSRC = _OPS / "csrc"
BUILD_DIR = _OPS / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills of every kernel, on stderr
    "-Xptxas=-v",
]

# C signatures of the exported functions: name -> (restype, argtypes)
_SIGNATURES = {
    "sorted_segment_sum": {
        "sorted_segment_sum_f32": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ),
    },
    "sorted_scatter_gather": {
        "sorted_scatter_gather_f32": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ),
    },
    "fused_gin_conv": {
        "fused_gin_conv_f32": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ),
        "fused_gin_conv_plan": (
            ctypes.c_int,
            [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
        ),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built from ops/csrc at first use"
        )
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile ``ops/csrc/<name>.cu`` unless its library is current;
    returns ``nvcc``'s output ("" when nothing was built). Raises with
    that output when the build fails. Builds of different sources may run
    at the same time (each ``nvcc`` is its own process)."""
    lib = library_path(name)
    if lib.is_file():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc exited {res.returncode} building {name}:\n{res.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return res.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    with _lock:
        if name not in _loaded:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
        return _loaded[name]

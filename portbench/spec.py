"""The benchmark's pieces, found by the names in ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` takes ``configs/<config>.json`` (the model, the
graphs' shapes, the engine's settings), ``mixes/<traffic>.json`` (what the
window runs: train or score, how many graphs, the batch, the store),
``limits/<cell>.json`` (the limit of each number the output check compares)
and, for each per-layer metric the cell reports, ``metrics/<metric>.py`` (a
``read(ctx)`` and the end-to-end metric it ``MOVES``). The configuration's
``model.net`` names ``nets/<net>.py``, the yardstick's own file of the net:
its plain forward pass, leaves and work counts, and, optionally, the port's
class it mirrors (``PORT``, the net's own name by default), the keyword
arguments the engine builds that class with (``OPTIONS``, none by default)
and the controls of the program's own paths that must fail on it
(``PROGRAM_CONTROLS``, :data:`PROGRAM_CONTROLS` by default). Adding a
cell, a configuration, a net or a metric adds files; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that must not be loaded in a run: JAX, and the JAX
# package with its scripts (the port's own name starts with the JAX
# package's, so names are compared whole)
FORBIDDEN = {"jax", "jaxlib", "flax", "deeprank_gnn_tpu", "chip_smoke", "bench"}
# the controls of the output check (``control.py``) that must fail on every
# net: the reference in TF32 in the program's place
REFERENCE_CONTROLS = ("tf32",)
# the program's own paths that a net file may name as controls, and that
# must fail on a net whose file names none: the bf16 path, which changes
# only paper mode's dense aggregations
PROGRAM_CONTROLS = ("fast",)


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def _load(folder: str, name: str):
    """The module ``<folder>/<name>.py``, loaded from its path (metric names
    hold dots)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py in the benchmark")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    """The per-layer metric ``name``'s reader, ``metrics/<name>.py``."""
    return _load("metrics", name)


def load_net(name: str):
    """The yardstick's net ``name``, ``nets/<name>.py``."""
    return _load("nets", name)


def port_net(net, name: str) -> tuple:
    """The name of the port's class that the net file ``nets/<name>.py``
    (loaded as ``net``) mirrors, and the keyword arguments the engine builds
    it with: the file's ``PORT`` and ``OPTIONS``, or else ``name`` and none."""
    return getattr(net, "PORT", name), dict(getattr(net, "OPTIONS", {}))


def controls(net) -> tuple:
    """The controls that must fail the output check of a cell on the net
    file ``net``: :data:`REFERENCE_CONTROLS`, then the file's
    ``PROGRAM_CONTROLS`` (or :data:`PROGRAM_CONTROLS`), which may name only
    those."""
    extra = tuple(getattr(net, "PROGRAM_CONTROLS", PROGRAM_CONTROLS))
    if not set(extra) <= set(PROGRAM_CONTROLS):
        raise ValueError(f"PROGRAM_CONTROLS {extra} names other than {PROGRAM_CONTROLS}")
    return REFERENCE_CONTROLS + extra


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, name: str, bench: dict = None):
        bench = bench or benchmark()
        entry = [w for w in bench["workloads"] if w["name"] == name]
        if not entry:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entry[0]
        self.name = name
        self.chips = self.entry["chips"]
        cfg = [c for c in bench["configs"] if c["name"] == self.entry["config"]][0]
        self.config = _json(ROOT / cfg["file"])
        self.net = load_net(self.config["model"]["net"])
        self.mix = _json(HERE / "mixes" / f"{self.entry['traffic']}.json")
        self.limits = _json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    @property
    def training(self) -> bool:
        return self.mix["mode"] == "train"

    @property
    def port_net(self) -> tuple:
        """The port's class the engine runs, by name, and its keyword
        arguments (:func:`port_net`)."""
        return port_net(self.net, self.config["model"]["net"])

    @property
    def controls(self) -> tuple:
        """The controls that must fail this cell's output check
        (:func:`controls`)."""
        return controls(self.net)


class Ctx:
    """What a traced run gathered, for the metric readers: the process's
    record (``rec``: ``setup``, ``stretch``, ``profile``) and what the
    cell's graphs give (``shared``: ``<work>_per_step`` of the net's
    ``work``, the card's peak)."""

    def __init__(self, mode: str, rec: dict, shared: dict):
        self.mode = mode  # "train" or "score"
        self.rec = rec
        self.shared = shared

"""The benchmark's pieces, found by the names in ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` takes ``configs/<config>.json`` (the model, the
graphs' shapes, the engine's settings), ``mixes/<traffic>.json`` (what the
window runs: train or score, how many graphs, the batch, the store),
``limits/<cell>.json`` (the limit of each number the output check compares)
and, for each per-layer metric the cell reports, ``metrics/<metric>.py`` (a
``read(ctx)`` and the end-to-end metric it ``MOVES``). The configuration's
``model.net`` names both the port's class the engine runs and
``nets/<net>.py``, the net's plain forward pass, leaves and work counts.
Adding a cell, a configuration, a net or a metric adds files; no file here
names one.
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
    """The net ``name`` of a configuration's ``model.net``, ``nets/<name>.py``."""
    return _load("nets", name)


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


class Ctx:
    """What a traced run gathered, for the metric readers: the process's
    record (``rec``: ``setup``, ``stretch``, ``profile``) and what the
    cell's graphs give (``shared``: ``<work>_per_step`` of the net's
    ``work``, the card's peak)."""

    def __init__(self, mode: str, rec: dict, shared: dict):
        self.mode = mode  # "train" or "score"
        self.rec = rec
        self.shared = shared

"""The output check on the CPU at a size a test run holds: the program
passes it, and its controls and planted faults fail it.

Each test drives the rest of a run (``run.execute``: set-up, a short
window, the output check) on the CPU in place of the card, with the
cell's own limits, on a few small graphs. The cells, their faults and their
controls come from ``BENCHMARK.json`` and the files it names, so that a cell
added there is tested here too. ``python -m pytest portbench/tests`` from
the root of the repo.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import control, run, spec  # noqa: E402
from portbench.tests import faults  # noqa: E402

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def small(name: str):
    """The cell at a test's size: a few graphs of a few hundred nodes; its
    widths, engine settings and limits unchanged."""
    c = spec.Cell(name)
    if c.config["graphs"]["generator"] == "atomic":
        c.config["graphs"].update(nodes=256, edges_undirected=1000)
    c.mix.update(graphs=8, batch=4)
    return c


BENCH = spec.benchmark()
ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


def port_class(cell):
    """The port's class that the cell's net file mirrors (its options left
    out): where a fault is planted."""
    import deeprank_gnn_tpu_torch as port

    return getattr(port, cell.port_net[0])


@pytest.mark.parametrize("name", ONE_CARD)
def test_program_passes(name, tmp_path):
    res = run.execute(small(name), SEEDS[0], 0.3, False, "cpu", str(tmp_path))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name", ONE_CARD)
@pytest.mark.parametrize("seed", SEEDS)
def test_controls_fail(name, seed):
    """Each control that the cell's net names (by default the reference in
    TF32 in the program's place, and the program's own bf16 path) fails one
    of the cell's numbers on every seed."""
    cell = small(name)
    for line in control.readings(cell, seed, 0.2, cell.controls, "cpu", log=lambda m: None):
        numbers = {k: v for k, v in line.items() if k in cell.limits}
        ok, checks = run.judge.verdict(numbers, cell.limits)
        assert not ok, (line["control"], checks)


FAULTS = [(n, f) for n in ONE_CARD for f in faults.BY_MODE[spec.Cell(n, BENCH).mix["mode"]]]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_fails(name, fault, tmp_path, monkeypatch):
    import deeprank_gnn_tpu_torch.train.neuralnet as neuralnet
    import torch.optim.adam as adam

    cell = small(name)
    net = port_class(cell)
    # the planted patches are undone after the test
    for obj, attr in ((adam, "adam"), (neuralnet, "mse_loss"), (net, "forward")):
        monkeypatch.setattr(obj, attr, getattr(obj, attr))
    faults.plant(fault, net, cell.training)
    res = run.execute(cell, SEEDS[1], 0.3, False, "cpu", str(tmp_path))
    assert not res["correct"], res["checks"]


def test_compared_pass_starts_from_the_initial_state(tmp_path):
    """The compared pass runs after the warm passes, from the initial
    weights and a cleared Adam state: its first loss is the reference's from
    the initial weights, with the dropout masks drawn before it skipped."""
    from portbench import cell as cell_mod

    cell = small("ginet_atomic.train_ops")
    rec = cell_mod.session(cell, SEEDS[2], 0.2, False, "cpu", str(tmp_path / "engine"),
                           str(tmp_path / "kernels"), 0.0)
    first = rec["first"]
    assert first["masks_before"] == 2 * (1 + cell.mix["warm_passes"])
    assert len(first["losses"]) == 2 and len(first["mols"]) == 2
    steps = run.judge.reference_train(cell, rec["graphs"], rec["weights"], first,
                                      cell_mod.program_seed(SEEDS[2]), "cpu")
    assert abs(first["losses"][0] - steps["losses"][0]) <= 1e-5 * abs(steps["losses"][0])
    # masks drawn from the generator's start would be another step's
    stale = dict(first, masks_before=0)
    other = run.judge.reference_train(cell, rec["graphs"], rec["weights"], stale,
                                      cell_mod.program_seed(SEEDS[2]), "cpu")
    assert other["losses"][0] != pytest.approx(steps["losses"][0], rel=1e-5)


@pytest.mark.parametrize("name", ONE_CARD)
def test_traced_run_reports_every_metric(name, tmp_path):
    """A ``--trace 1`` run reads each of the cell's per-layer metrics but
    those that only a card has (K3's and NCCL's kernels by name)."""
    cell = small(name)
    res = run.execute(cell, SEEDS[0], 0.2, True, "cpu", str(tmp_path))
    card_only = {"k3_ms.train", "k3_roofline.train"}
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer} - card_only
    assert res["device_extra"]["window_s"] > 0
    assert len(res["breakdown"]["device_ops"]) <= 10 and len(res["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD)
def test_controls_fail_on_card(name):
    """At the cell's own size on the card: the program passes, each control
    of the cell's net fails. The limits' readings come from ``control.py``
    on three seeds or more (PERF.md); this is one seed of them."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the cell's own size)")
    cell = spec.Cell(name)
    for line in control.readings(cell, SEEDS[0], 1.0, ["program", *cell.controls], "cuda",
                                 log=lambda m: None):
        ok, checks = run.judge.verdict({k: line[k] for k in cell.limits}, cell.limits)
        assert ok is (line["control"] == "program"), (line["control"], checks)

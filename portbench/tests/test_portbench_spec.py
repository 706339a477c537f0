"""The benchmark's files: every piece found by its name, and no JAX.

CPU only: ``python -m pytest portbench/tests`` from the root of the repo.
"""

from __future__ import annotations

import ast
import copy
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import spec  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
NETS = sorted({json.loads((ROOT / c["file"]).read_text())["model"]["net"]
               for c in BENCH["configs"]})


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200, w
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16, c
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}, w
        assert _line(w["why"]), w
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}, m
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}, m
        assert _line(m["layer"]), m
    for word in BENCH["command"]:
        assert _line(word), word


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = spec.Cell(cell, BENCH)
    assert c.mix["mode"] in ("train", "score")
    assert c.mix["graphs"] % c.mix["batch"] == 0
    assert c.mix["batch"] % c.chips == 0
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    want = set(c.limits)
    assert want == ({"loss_gap", "grad_gap", "change_gap"} if c.training else {"pred_gap"})
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    entry = [m for m in BENCH["per_layer"] if m["name"] == metric][0]
    reader = spec.load_reader(metric)
    assert reader.MOVES == entry["moves"]
    assert callable(reader.read)
    for cell in entry["workloads"]:
        assert cell in CELLS


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = ROOT / config["file"]
    assert path.is_relative_to(ROOT / "portbench")
    data = json.loads(path.read_text())
    for key in config["reduced"]:
        assert key in data
    assert data["source"] == config["source"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


# what the engine passes the model's class itself (``NeuralNet.build_model``):
# an option may not name one of these
ENGINE_ARGS = {"input_shape", "output_shape", "input_shape_edge", "device", "generator"}


def check_net(name: str, net) -> None:
    """The net file ``nets/<name>.py``, loaded as ``net``: its ``PORT`` (or
    ``name``) is a class of the port, its ``OPTIONS`` are keywords that
    class's constructor takes (and the engine does not pass), it has what
    the yardstick reads, and its controls start with the reference's."""
    import inspect

    import deeprank_gnn_tpu_torch as port

    cls_name, options = spec.port_net(net, name)
    cls = getattr(port, cls_name)
    assert isinstance(cls, type)
    assert not set(options) & ENGINE_ARGS, options
    inspect.signature(cls).bind_partial(**options)
    for fn in ("param_table", "forward", "dropout_width", "work"):
        assert callable(getattr(net, fn)), fn
    assert spec.controls(net)[:1] == spec.REFERENCE_CONTROLS


def _net_copy(name: str, **attrs):
    """A fresh copy of ``nets/<name>.py`` (``load_net`` runs the file anew
    each call), with ``attrs`` set on it: a net file a later cell could
    bring, without a file."""
    net = spec.load_net(name)
    for k, v in attrs.items():
        setattr(net, k, v)
    return net


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_net_found_by_name(config):
    """A configuration's ``model.net`` names the yardstick's file of the
    net, which names the port's class the engine runs and the options its
    constructor accepts."""
    name = json.loads((ROOT / config["file"]).read_text())["model"]["net"]
    check_net(name, spec.load_net(name))
    with pytest.raises(KeyError):
        spec.load_net("NoSuchNet")


def test_net_file_port_options_and_controls_checked():
    """A net file's ``PORT`` names the port's class under another name of
    its own; options the class's constructor takes pass, others fail; the
    TF32 control stays first whatever ``PROGRAM_CONTROLS`` names, and that
    names nothing but the program's own paths."""
    attention = _net_copy("GINet", PORT="GINet", OPTIONS={"attention": True},
                          PROGRAM_CONTROLS=())
    assert spec.port_net(attention, "GINetAttention") == ("GINet", {"attention": True})
    check_net("GINetAttention", attention)
    assert spec.port_net(spec.load_net("GINet"), "GINet") == ("GINet", {})
    assert spec.controls(spec.load_net("GINet")) == ("tf32", "fast")
    assert spec.controls(attention) == ("tf32",)
    with pytest.raises(AttributeError):
        check_net("GINetAttention", _net_copy("GINet"))
    with pytest.raises(TypeError):
        check_net("GINet", _net_copy("GINet", OPTIONS={"no_such_option": True}))
    with pytest.raises(AssertionError):
        check_net("GINet", _net_copy("GINet", OPTIONS={"device": "cpu"}))
    for extra in (("tf32",), ("ref:answer_altered",), ("program",)):
        with pytest.raises(ValueError):
            spec.controls(_net_copy("GINet", PROGRAM_CONTROLS=extra))


def _small_cell(name: str, net=None):
    """The cell at a test's size (as ``test_portbench_check.small``), on the
    net file ``net`` (default: a fresh copy of its own)."""
    c = spec.Cell(name, BENCH)
    c.config = copy.deepcopy(c.config)
    c.net = net or spec.load_net(c.config["model"]["net"])
    if c.config["graphs"]["generator"] == "atomic":
        c.config["graphs"].update(nodes=256, edges_undirected=1000)
    c.mix = dict(c.mix, graphs=8, batch=4)
    return c


def _engine(c, tmp_path, seed=2**31 + 7):
    from portbench import cell as cell_mod
    from portbench import graphs, reference

    gs = graphs.generate(c.config, seed, c.mix["graphs"])
    nn, loader = cell_mod.build_engine(c, gs, seed, "cpu", str(tmp_path / "engine"),
                                       str(tmp_path / "kernels"))
    table = c.net.param_table(c.config["model"])
    weights = reference.draw_weights(table, seed, "cpu")
    cell_mod.set_weights(nn, weights, table)
    return nn, loader


@pytest.mark.parametrize("name", CELLS)
def test_no_options_builds_the_bare_class(name, tmp_path):
    """A net file without ``OPTIONS`` (each cell's own, with any taken off)
    gives the engine its port class itself, as before options existed."""
    import deeprank_gnn_tpu_torch as port

    from portbench import cell as cell_mod

    c = _small_cell(name)
    if hasattr(c.net, "OPTIONS"):
        del c.net.OPTIONS
    cls = getattr(port, c.port_net[0])
    assert cell_mod.model_class(c) is cls
    nn, loader = _engine(c, tmp_path)
    assert nn.Net is cls and type(nn.model) is cls
    assert loader.precompute_ops is c.mix["precompute_ops"]


def test_options_reach_the_port_class(tmp_path):
    """A net file with ``PORT = "GINet"`` and ``OPTIONS = {"attention":
    True}``, on a copy of ``ginet_atomic``, builds ``GINet(attention=True)``,
    unfused, through ``build_engine``; ``nets/GINet.py``'s leaves fit it
    (the attention weights are leaves of paper mode too, dead there by quirk
    Q1), and its scores differ from paper mode's under the same weights."""
    import deeprank_gnn_tpu_torch as port

    from portbench import cell as cell_mod

    c = _small_cell("ginet_atomic.train_ops",
                    _net_copy("GINet", PORT="GINet", OPTIONS={"attention": True}))
    bound = cell_mod.model_class(c)
    assert bound.func is port.GINet and bound.keywords == {"attention": True}
    nn, loader = _engine(c, tmp_path)
    assert type(nn.model) is port.GINet
    assert nn.model.attention and not nn.model.fuse
    paper, paper_loader = _engine(_small_cell("ginet_atomic.train_ops"), tmp_path / "paper")
    got = nn.eval(nn._loader(loader.dataset))[0]
    want = paper.eval(paper._loader(paper_loader.dataset))[0]
    assert np.isfinite(got).all() and not np.allclose(got, want)


def test_idle_share_from_the_unprofiled_passes():
    """``device_idle`` sets the trace's busy time a pass against a pass's
    wall time with the profiler off, not against the profiled window."""
    rec = {"profile": {"busy_s": 0.06, "window_s": 0.2, "passes": 10},
           "stretch": {"pass_wall_s": 0.01}}
    for mode in ("train", "score"):
        reader = spec.load_reader(f"device_idle.{mode}")
        assert reader.read(spec.Ctx(mode, rec, {})) == pytest.approx(0.4)
        assert reader.read(spec.Ctx("score" if mode == "train" else "train", rec, {})) is None


def test_paths_hold_only_names():
    for p in (ROOT / "portbench").rglob("*"):
        if "_build" in p.parts or "__pycache__" in p.parts:
            continue
        for part in p.relative_to(ROOT).parts:
            assert NAME.match(part), p


def test_forbidden_names_whole():
    assert spec.forbidden_loaded(["deeprank_gnn_tpu_torch.models.ginet", "numpy"]) == []
    assert spec.forbidden_loaded(["deeprank_gnn_tpu.models"]) == ["deeprank_gnn_tpu"]
    assert spec.forbidden_loaded(["jax.numpy", "flax", "bench"]) == ["bench", "flax", "jax"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT) for p in
                                        (ROOT / "portbench").rglob("*.py")
                                        if "_build" not in p.parts), ids=str)
def test_no_forbidden_import(path):
    assert not _imports(ROOT / path) & spec.FORBIDDEN
    if path.parts[1] != "tests" and path.name not in ("cell.py", "control.py"):
        # only the modules that run the program import it; the yardstick stands alone
        assert "deeprank_gnn_tpu_torch" not in _imports(ROOT / path), path


def test_nothing_forbidden_loaded_in_a_run_process():
    """Every module of the harness and the program it drives, imported in a
    fresh process, loads no forbidden module."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.run, portbench.cell, portbench.control\n"
            "from portbench import spec; [spec.load_net(n) for n in %r]\n"
            "import deeprank_gnn_tpu_torch.train.neuralnet\n"
            "from portbench import spec; print(spec.forbidden_loaded())" % (str(ROOT), NETS))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_cards(tmp_path):
    """With no card the run exits non-zero and prints no result."""
    res = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          CELLS[0], "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "{" not in res.stdout

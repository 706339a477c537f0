"""The port's spans (``deeprank_gnn_tpu_torch/trace.py``), on the CPU.

- a scanned scoring pass and a scanned training epoch each record one
  ``pass`` holding ``pass.plan``, ``pass.issue``, ``pass.readback`` and
  ``pass.collect`` in that order, with the pass's graphs, steps and
  accumulated elements; the
  first pass builds the store inside ``pass.plan`` and runs the eager
  warm-up step; ``EpochSteps.last_issue_s`` is ``pass.issue``'s duration;
- a store built with the operators records one ``store.operators`` a graph
  inside ``store.build``, one built without them none;
- under ``torch.profiler`` each span is a range of the profiler's trace
  that holds the pass's aten operations; without a profiler no range is
  entered;
- the ring keeps its newest spans within its size, its memory within
  16 MB, and the spans of concurrent threads apart.
"""

import sys
import threading

import pytest
import torch

from test_torch_data import write_graphs_hdf5
from test_torch_train import port_engine

from deeprank_gnn_tpu_torch import trace

NUM_GRAPHS, BATCH = 10, 4
PHASES = ["pass.plan", "pass.issue", "pass.readback", "pass.collect"]


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_trace") / "g.hdf5"), num_graphs=NUM_GRAPHS, seed=5
    )


def scanned_engine(db, outdir):
    return port_engine(db, outdir, target="fnat", batch_size=BATCH, percent=[1.0, 0.0],
                       layout="dense", device_cache=True, scan_epochs=True, seed=0)


def run_pass(nn, loader, mode):
    return nn._run_pass(loader, training=True) if mode == "train" else nn.eval(loader)


def loader_of(nn, mode):
    return nn.train_loader if mode == "train" else nn._loader(nn.train_loader.dataset)


def newest_pass():
    return trace.passes()[-1]


@pytest.mark.parametrize("mode", ["score", "train"])
def test_scanned_pass_records_its_phases(db, tmp_path, mode):
    nn = scanned_engine(db, str(tmp_path))
    loader = loader_of(nn, mode)
    run_pass(nn, loader, mode)
    first = newest_pass()
    run_pass(nn, loader, mode)
    second = newest_pass()
    steps = -(-NUM_GRAPHS // BATCH)
    # the elements the steps accumulated: the same for two passes of the store
    accumulated = first.span.counts["accumulated"]
    for p in (first, second):
        root = p.span
        assert root.name == "pass" and root.counts == {"graphs": NUM_GRAPHS, "steps": steps,
                                                       "accumulated": accumulated}
        assert not p.profiled and not p.captured
        phases = [s for s in p.spans if s.parent == root.id]
        assert [s.name for s in phases] == PHASES
        assert all(s.root == root.id for s in p.spans)
        ends = [root.start_ns] + [t for s in phases for t in (s.start_ns, s.end_ns)]
        assert ends == sorted(ends) and ends[-1] <= root.end_ns
        assert root.self_ns == root.duration_ns - sum(s.duration_ns for s in phases)
        issue = [s for s in phases if s.name == "pass.issue"][0]
        assert issue.counts["replays"] == 0  # no graph replays on the CPU
    # the first pass builds the store inside its plan and warms up
    assert first.warmup and not second.warmup
    plan = [s for s in first.spans if s.name == "pass.plan"][0]
    build = [s for s in first.spans if s.name == "store.build"][0]
    assert build.parent == plan.id and build.counts["graphs"] == NUM_GRAPHS
    assert plan.self_ns <= plan.duration_ns - build.duration_ns
    assert [s.name for s in second.spans] == ["pass"] + PHASES
    assert second.ns("pass.issue") / 1e9 == nn._scan.last_issue_s


def test_chunked_pass_records_its_phases(db, tmp_path):
    """The chunked scanned pass: the same phases, ``pass.issue`` once a chunk."""
    nn = port_engine(db, str(tmp_path), target="fnat", batch_size=BATCH, percent=[1.0, 0.0],
                     layout="dense", device_cache="chunked", device_cache_bytes=1,
                     scan_epochs=True, seed=0)
    nn._run_pass(nn.train_loader, training=True)
    p = newest_pass()
    chunks = nn.train_loader._chunk_store.num_chunks
    assert chunks > 1
    phases = [s.name for s in p.spans if s.parent == p.span.id]
    assert phases == ["pass.plan"] + ["pass.issue"] * chunks + ["pass.readback", "pass.collect"]
    assert p.span.counts["graphs"] == NUM_GRAPHS


@pytest.mark.parametrize("precompute_ops", [True, False], ids=["operators", "no-operators"])
def test_store_build_records_its_stages(db, tmp_path, precompute_ops):
    nn = scanned_engine(db, str(tmp_path))
    loader = nn._loader(nn.train_loader.dataset, precompute_ops=precompute_ops)
    assert loader._maybe_build_store()
    build = trace.trees("store.build")[-1]
    root = build.span
    assert root.counts == {"graphs": NUM_GRAPHS, "bytes": loader._store.nbytes}
    names = [s.name for s in build.spans]
    assert names.count("store.operators") == (NUM_GRAPHS if precompute_ops else 0)
    # a fresh loader plans its graphs inside the build, before collating
    stages = [s.name for s in build.spans if s.parent == root.id]
    assert stages == ["loader.plan"] * NUM_GRAPHS + ["store.collate", "store.pack",
                                                      "store.upload"]
    collate = [s for s in build.spans if s.name == "store.collate"][0]
    assert all(s.parent == collate.id for s in build.spans if s.name == "store.operators")


def test_plans_recorded_once_a_graph(db, tmp_path):
    nn = scanned_engine(db, str(tmp_path))
    loader = nn._loader(nn.train_loader.dataset)
    before = len([s for s in trace.spans() if s.name == "loader.plan"])
    for _ in range(2):
        for i in range(NUM_GRAPHS):
            loader._get_plan(i, loader._get_sample(i))
    after = len([s for s in trace.spans() if s.name == "loader.plan"])
    assert after - before == NUM_GRAPHS


@pytest.fixture()
def ranges_entered(monkeypatch):
    """The names of the profiler ranges the spans enter."""
    entered = []
    fast = torch._C._profiler._RecordFunctionFast

    def spy(name):
        entered.append(name)
        return fast(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", spy)
    return entered


def test_spans_are_profiler_ranges(db, tmp_path, ranges_entered):
    from torch.profiler import ProfilerActivity, profile

    nn = scanned_engine(db, str(tmp_path))
    loader = loader_of(nn, "score")
    run_pass(nn, loader, "score")
    run_pass(nn, loader, "score")
    assert ranges_entered == [] and not newest_pass().profiled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_pass(nn, loader, "score")
    assert ranges_entered == ["pass"] + PHASES
    assert newest_pass().profiled
    events = prof.events()
    ranges = {e.name: e.time_range for e in events if e.name in ["pass"] + PHASES}
    assert set(ranges) == {"pass"} | set(PHASES)
    outer = ranges["pass"]
    inner = [ranges[n] for n in PHASES]
    assert all(outer.start <= r.start <= r.end <= outer.end for r in inner)
    assert all(a.end <= b.start for a, b in zip(inner, inner[1:]))
    ops = [e for e in events if e.name.startswith("aten::")
           and outer.start <= e.time_range.start <= outer.end]
    assert any(ranges["pass.issue"].start <= e.time_range.start <= ranges["pass.issue"].end
               for e in ops)
    for e in ops:
        assert any(r.start <= e.time_range.start and e.time_range.end <= r.end for r in inner), \
            e.name


def test_ring_keeps_the_newest_passes():
    rec = trace.Recorder(capacity=12)
    for i in range(7):
        with rec.span("pass", graphs=i):
            for name in PHASES:
                with rec.span(name):
                    pass
    held = rec.spans()
    assert len(held) <= 12
    assert [s.id for s in held] == list(range(35 - len(held) + 1, 36))
    # the passes whose every span is still held: the newest two
    whole = [p for p in rec.passes() if len(p.spans) == 5]
    assert [p.span.counts["graphs"] for p in whole] == [5, 6]


def test_ring_memory_bounded():
    assert trace.RECORDER.nbytes <= 16_000_000
    assert trace.RECORDER.capacity >= 16_384 * (1 + len(PHASES))
    with pytest.raises(ValueError):
        with trace.Recorder(capacity=4).span("pass", a=1, b=2, c=3, d=4):
            pass


def test_threads_nest_their_own_spans():
    """Many threads recording at once, with frequent switches: every span
    is held once and nests under its own thread's outer span."""
    rec = trace.Recorder(capacity=4096)
    threads, per = 16, 40
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(t):
        for _ in range(per):
            with rec.span(f"outer{t}"):
                with rec.span(f"inner{t}"):
                    pass

    try:
        workers = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    held = rec.spans()
    assert len(held) == len({s.id for s in held}) == 2 * threads * per
    by_id = {s.id: s for s in held}
    for s in held:
        if s.name.startswith("inner"):
            assert by_id[s.parent].name == "outer" + s.name[len("inner"):]
        else:
            assert s.parent == 0 and s.root == s.id

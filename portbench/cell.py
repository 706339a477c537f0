"""One process's part of a run: set-up, the window, the traced window.

The system under test is the port's engine, ``NeuralNet`` with the device
store and scanned epochs, driven through the calls a user makes:
``_run_pass(loader, training=True)`` for a training epoch (what ``train()``
runs each epoch, without its HDF5 export) and ``eval(loader)`` for a scoring
pass. The benchmark gives the engine its graphs and its initial weights,
both made here from the seed, and times it from outside; it reads the
engine's own counters (``EpochSteps.last_issue_s``, ``graph_stats()``) and
the profiler's trace, and never changes what a step computes.

Set-up builds the pooling plans (timed alone), the store (timed alone),
then runs a first pass, which captures every step's CUDA graph (its first
step runs eagerly, as the warm-up capture needs), and ``warm_passes`` more.
A training cell then puts the initial weights back and clears Adam's state,
in place (the graphs bind them by address), and runs the compared pass:
every step of it a replay of the graphs the window replays. Its per-step
losses, the first gradient (from Adam's state after the first replay) and
the weights after it are kept for the output check.
"""

from __future__ import annotations

import functools
import gc
import time

import numpy as np

from portbench import graphs as graphs_mod
from portbench import reference, roofline
from portbench.profiling import profile

SEED_MOD = 2**32  # the engine's seed feeds numpy's RandomState
PROFILED_PASSES = 10


def program_seed(seed: int) -> int:
    return seed % SEED_MOD


def sync_of(device):
    import torch

    if torch.device(device).type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def model_class(cell):
    """What the engine builds its model from: the port's class of the cell's
    ``port_net``, bound to its options as ``functools.partial(cls,
    **options)`` (the form ``NeuralNet`` takes publicly), or the class
    itself where the net file names no options."""
    import deeprank_gnn_tpu_torch as port

    name, options = cell.port_net
    cls = getattr(port, name)
    return functools.partial(cls, **options) if options else cls


def build_engine(cell, graphs: list, seed: int, device, outdir: str, kdir: str,
                 dense_fast: bool = False):
    """The engine on the cell's configuration and ``graphs``, running
    :func:`model_class` of the cell, and the loader the window drives: a
    training loader over every graph (shuffled, seeded), or a scoring loader
    in the graphs' order, as ``test()`` builds one."""
    from deeprank_gnn_tpu_torch import GraphListDataSet, NeuralNet
    from deeprank_gnn_tpu_torch.data.dataset import GraphSample

    cfg, mix = cell.config, cell.mix
    samples = [GraphSample(mol=g["mol"], x=g["x"], pos=g["pos"], edge_index=g["edge_index"],
                           edge_attr=g["edge_attr"], internal_edge_index=g["internal_edge_index"],
                           internal_edge_attr=g["internal_edge_attr"], cluster0=g["cluster0"],
                           cluster1=g["cluster1"], y=g["y"]) for g in graphs]
    eng = cfg["engine"]
    nn = NeuralNet(GraphListDataSet(samples), model_class(cell),
                   node_feature=[f"f{i}" for i in range(cfg["model"]["node_features"])],
                   edge_feature=eng["edge_feature"], target=eng["target"], lr=cfg["model"]["lr"],
                   batch_size=mix["batch"], percent=[1.0, 0.0], layout=eng["layout"],
                   device_cache=eng["device_cache"], scan_epochs=eng["scan_epochs"],
                   device_cache_bytes=mix["device_cache_bytes"], seed=program_seed(seed),
                   outdir=outdir, executable_cache_dir=kdir, dense_fast=dense_fast,
                   device=device)
    if cell.training:
        loader = nn.train_loader
        if not mix["precompute_ops"]:
            loader = nn.train_loader = nn._loader(loader.dataset, shuffle=True,
                                                  seed=program_seed(seed), precompute_ops=False)
    else:
        loader = nn._loader(nn.train_loader.dataset)
    return nn, loader


def set_weights(nn, weights: dict, table: dict) -> None:
    """Load the benchmark's weights, after checking that the engine's
    parameters are the reference's (``table``, the net's ``param_table``)
    by name and shape."""
    import torch

    want = {k: tuple(shape) for k, (shape, _) in table.items()}
    have = {k: tuple(p.shape) for k, p in nn.model.named_parameters()}
    if have != want:
        raise RuntimeError(f"the engine's parameters {have} are not the reference's {want}")
    with torch.no_grad():
        for k, p in nn.model.named_parameters():
            p.copy_(weights[k])


def build_store(loader, sync) -> dict:
    """The pooling plans, then the store, each timed; raises when the loader
    did not build its store (over its byte budget it would stream)."""
    import torch

    t0 = time.perf_counter()
    for i in range(len(loader.dataset)):
        loader._get_plan(i, loader._get_sample(i))
    plans_s = time.perf_counter() - t0
    dev = loader.device
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    t0 = time.perf_counter()
    built = loader._maybe_build_store()
    sync()
    store_s = time.perf_counter() - t0
    if not built or loader._store is None:
        raise RuntimeError(f"the loader built no device store (budget "
                           f"{loader.device_cache_bytes} B); the engine would stream")
    grown = (torch.cuda.memory_allocated(dev) - before) if dev.type == "cuda" else 0
    return {"plans_s": plans_s, "store_build_s": store_s, "store_bytes": loader._store.nbytes,
            "store_memory_growth": grown}


def reset_train_state(nn, weights: dict) -> None:
    """The initial weights back, and Adam's moments and step count cleared,
    each in place: the captured graphs read and write them by address."""
    import torch

    with torch.no_grad():
        for k, p in nn.model.named_parameters():
            p.copy_(weights[k])
        for p in nn.model.parameters():
            for key in ("exp_avg", "exp_avg_sq", "step"):
                nn.optimizer.state[p][key].zero_()


def compared_train_pass(nn, loader, weights: dict) -> dict:
    """A training pass from the initial state (:func:`reset_train_state`)
    through the window's own call, after the graphs are captured: its
    per-step losses (read as the engine writes them), the first gradient
    (Adam's first moment after the first step, over ``1 - beta1``), the
    weights after the pass, and its batches. On a card every step must be a
    replay of a captured graph, one step a replay; on the CPU the engine
    steps eagerly."""
    import torch

    reset_train_state(nn, weights)
    scan, opt = nn._scan, nn.optimizer
    names = {id(p): k for k, p in nn.model.named_parameters()}
    seen, moment, eager = [], {}, []

    def take_moment():
        if not moment:
            for group in opt.param_groups:
                for p in group["params"]:
                    moment[names[id(p)]] = opt.state[p]["exp_avg"].detach().double().cpu()

    run_into = nn._scan_into

    def spy(store, y_all, slots, training, y_rows, mask_rows, losses, preds):
        run_into(store, y_all, slots, training, y_rows, mask_rows, losses, preds)
        seen.append(losses.detach().double().cpu().numpy())

    replay = scan._replay

    def replay_then_read(*args):
        if not moment and args[-1] != 1:
            raise RuntimeError(f"the first replay runs {args[-1]} steps, not one")
        replay(*args)
        take_moment()

    def after_step(opt, args, kwargs):
        eager.append(1)
        take_moment()

    replays = sum(g["replays"] for g in scan.graph_stats() if g["training"])
    nn._scan_into, scan._replay = spy, replay_then_read
    hook = opt.register_step_post_hook(after_step)
    try:
        data = nn._run_pass(loader, training=True)[4]
    finally:
        hook.remove()
        del nn._scan_into, scan._replay
    replayed = sum(g["replays"] for g in scan.graph_stats() if g["training"]) - replays
    if len(seen) != 1:
        raise RuntimeError(f"the compared pass ran {len(seen)} scanned passes, not one: "
                           f"the engine did not scan its store")
    steps = len(loader)
    if loader.device.type == "cuda" and (eager or replayed != steps):
        raise RuntimeError(f"the compared pass ran {len(eager)} steps eagerly and {replayed} "
                           f"replays, not {steps} replays")
    batch = loader.batch_size
    mols = data["mol"]
    return {"losses": seen[0], "replayed": replayed,
            "mols": [mols[i: i + batch] for i in range(0, len(mols), batch)],
            "first_grad": {k: v / (1 - reference.BETAS[0]) for k, v in moment.items()},
            "weights": {k: p.detach().double().cpu() for k, p in nn.model.named_parameters()}}


def one_pass(nn, loader, training: bool):
    return nn._run_pass(loader, training=True) if training else nn.eval(loader)


def window(nn, loader, training: bool, stop, keep_outputs: bool) -> dict:
    """Passes until ``stop(elapsed)`` says so: each pass's seconds (from
    the call to its outputs on the host), the engine's host seconds issuing
    its steps, and with ``keep_outputs`` each pass's scores."""
    times, issue, outputs = [], [], []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        out = one_pass(nn, loader, training)
        te = time.perf_counter()
        times.append(te - ts)
        issue.append(nn._scan.last_issue_s)
        if keep_outputs:
            # float32 arrays, not the engine's lists of floats: held for the
            # whole window, lists would grow every collection of the
            # interpreter's garbage collector
            outputs.append(np.asarray(out[0], dtype=np.float32))
        if stop(te - t0):
            break
    return {"elapsed_s": time.perf_counter() - t0, "pass_s": times, "issue_s": issue,
            "outputs": outputs}


def work_per_step(cell, graphs: list) -> dict:
    """The net's ``work`` of a step, averaged over the dataset, as
    ``<name>_per_step``: the FLOPs it needs and its kernels' least times."""
    counts = [roofline.graph_counts(g) for g in graphs]
    steps = len(graphs) / cell.mix["batch"]
    total = {}
    for c in counts:
        for k, v in cell.net.work(c, cell.config["model"], cell.training).items():
            total[k] = total.get(k, 0.0) + v
    return {f"{k}_per_step": v / steps for k, v in total.items()}


def session(cell, seed: int, seconds: float, trace: bool, device, outdir: str, kdir: str,
            t_start: float, dense_fast: bool = False) -> dict:
    """One run of ``cell`` in this process; returns its record. ``t_start``:
    the run's start (``time.time()``), from which set-up is counted."""
    import torch

    stop = lambda elapsed: elapsed >= seconds  # noqa: E731
    sync = sync_of(device)
    model = cell.config["model"]
    table = cell.net.param_table(model)
    parts = {"before_graphs_s": time.time() - t_start}
    t0 = time.perf_counter()
    graphs = graphs_mod.generate(cell.config, seed, cell.mix["graphs"])
    weights = reference.draw_weights(table, seed, device)
    parts["graphs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nn, loader = build_engine(cell, graphs, seed, device, outdir, kdir, dense_fast)
    set_weights(nn, weights, table)
    parts["engine_s"] = time.perf_counter() - t0
    steps = len(loader)
    rec = {"setup": build_store(loader, sync), "steps_per_pass": steps}
    t0 = time.perf_counter()
    first = one_pass(nn, loader, cell.training)
    parts["first_pass_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(cell.mix["warm_passes"]):
        one_pass(nn, loader, cell.training)
    sync()
    parts["warm_s"] = time.perf_counter() - t0
    if cell.training:
        t0 = time.perf_counter()
        rec["first"] = compared_train_pass(nn, loader, weights)
        # the dropout masks the engine drew before it: one a step
        rec["first"]["masks_before"] = steps * (1 + cell.mix["warm_passes"])
        sync()
        parts["compared_pass_s"] = time.perf_counter() - t0
    else:
        rec["first"] = {"mols": first[4]["mol"]}
    rec["setup"]["setup_s"] = time.time() - t_start
    rec["setup"]["parts"] = parts
    if not trace:
        rec["window"] = window(nn, loader, cell.training, stop, not cell.training)
    else:
        rec["stretch"] = window(nn, loader, cell.training, stop, not cell.training)
        st = rec["stretch"]
        st["step_s"] = st["elapsed_s"] / (len(st["pass_s"]) * steps)
        st["pass_wall_s"] = st["elapsed_s"] / len(st["pass_s"])
        st["issue_ms"] = 1e3 * float(np.mean(st["issue_s"])) / steps

        def profiled():
            for _ in range(PROFILED_PASSES):
                one_pass(nn, loader, cell.training)

        nn._scan.reset_replays()
        rec["profile"] = profile(profiled, sync, on_cpu=torch.device(device).type == "cpu")
        rec["profile"]["passes"] = PROFILED_PASSES
        rec["profile"]["steps"] = PROFILED_PASSES * steps
        # K3 launches that ran: each captured graph's launches a replay times
        # its replays (the engine counts a launch where its wrapper launches)
        rec["profile"]["k3_launches_counted"] = sum(
            g["launches"].get("fused_gin_conv", 0) * g["replays"] for g in nn._scan.graph_stats())
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if torch.device(device).type == "cuda" else 0)
    rec["graph_stats"] = nn._scan.graph_stats()
    del nn, loader
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    rec["graphs"], rec["weights"] = graphs, weights
    return rec

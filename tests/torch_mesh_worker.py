"""One rank of the PyTorch port's multi-rank CPU tests (the role that
``multihost_worker.py`` plays for the JAX package). It imports torch and
the port, never JAX.

Usage: python torch_mesh_worker.py <spec.pt> <rank>

The spec (written with ``torch.save`` by the test) names the gloo group's
``file://`` store, the world size and the checks to run; the rank writes
its results to ``spec["out"].format(rank=rank)`` (an ``.npz``). With
``spec["env"]`` the group comes from the ``DEEPRANK_*`` variables instead.
"""

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

torch.set_num_threads(1)

FEATURES = ["type", "polarity", "bsa", "pssm"]


def _graphs(db):
    """The graphs of the HDF5 file ``db``, or with ``db`` a tuple ``("atomic",
    seed, graphs, nodes, undirected edges)`` ``chip_smoke.build_atomic_graphs``'
    graphs in memory, row-sorted as a dataset holds them."""
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet, HDF5DataSet

    if isinstance(db, tuple):
        from chip_smoke import build_atomic_graphs

        return GraphListDataSet(build_atomic_graphs(*db[1:])).graphs
    ds = HDF5DataSet(database=db, node_feature=FEATURES, edge_feature=["dist"],
                     target="fnat", tqdm=False)
    return [ds.get(i) for i in range(len(ds))]


def _batch(task, layout="sparse"):
    from deeprank_gnn_tpu_torch.data.batch import collate
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense

    graphs = _graphs(task["db"])
    fn = collate_dense if layout == "dense" else collate
    return fn(graphs, g_pad=task["g_pad"])[0]


def _model(name, kw, num_features, state):
    import deeprank_gnn_tpu_torch.models as T

    model = getattr(T, name)(num_features, 1, 1, device="cpu", **kw)
    model.load_state_dict(state)
    return model


@contextlib.contextmanager
def _no_dropout():
    from deeprank_gnn_tpu_torch.models import GINet

    rate = GINet.dropout_rate
    GINet.dropout_rate = 0.0
    try:
        yield
    finally:
        GINet.dropout_rate = rate


def _adam(model, lr):
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _params(out, prefix, model):
    for name, p in model.named_parameters():
        out[f"{prefix}param:{name}"] = p.detach().numpy().copy()


def _train(task, out, prefix, model, step, batch, after=lambda i: None):
    """The task's steps of ``step`` on ``batch`` with dropout off, ``after(i)``
    following step ``i``; with ``task["record"]`` each step's starting
    parameters (``{prefix}{i}_param:``) and the gradients it applied,
    summed over the ranks (``{prefix}{i}_grad:``). Returns the last
    predictions."""
    losses = []
    with _no_dropout():
        for i in range(task["steps"]):
            if task.get("record"):
                _params(out, f"{prefix}{i}_", model)
            loss, pred = step(batch)
            losses.append(float(loss))
            if task.get("record"):
                for name, p in model.named_parameters():
                    out[f"{prefix}{i}_grad:{name}"] = p.grad.numpy().copy()
            after(i)
    out[f"{prefix}losses"] = np.array(losses)
    return pred


def halo_eval(task, out, rank):
    """Each net's replicated predictions under make_halo_eval_step."""
    from deeprank_gnn_tpu_torch.parallel import halo as H
    from deeprank_gnn_tpu_torch.parallel.mesh import make_halo_mesh

    mesh = make_halo_mesh(device="cpu")
    batch = _batch(task)
    hb = H.shard_halo_batch(H.partition_batch(batch, mesh.size), mesh)
    for label, name, kw, state in task["nets"]:
        model = _model(name, kw, batch.x.shape[1], state)
        loss, pred = H.make_halo_eval_step(model, mesh)(hb)
        out[f"{label}:pred"] = pred.numpy()
        out[f"{label}:loss"] = loss.numpy()


def halo_train(task, out, rank):
    """The task's Adam steps of paper-mode GINet (dropout off) under the
    halo layout, with the collective bytes of the first step and the plan's
    sizes."""
    from deeprank_gnn_tpu_torch.parallel import collectives as C, halo as H
    from deeprank_gnn_tpu_torch.parallel.mesh import make_halo_mesh

    mesh = make_halo_mesh(device="cpu")
    batch = _batch(task)
    plan = H.partition_batch(batch, mesh.size)
    hb = H.shard_halo_batch(plan, mesh)
    model = _model("GINet", {}, batch.x.shape[1], task["state"])
    step = H.make_halo_train_step(model, _adam(model, task["lr"]), mesh)

    def first_bytes(i):
        if i == 0:
            for k, v in C.collective_bytes().items():
                out[f"bytes:{k}"] = np.int64(v)

    C.reset_collective_bytes()
    _train(task, out, "halo_", model, step, hb, first_bytes)
    out["plan"] = np.array([mesh.size, plan.send_idx.shape[-1], plan.nl,
                            plan.num_clusters0], dtype=np.int64)
    _params(out, "halo_", model)


def mesh_train(task, out, rank):
    """The task's Adam steps of paper-mode GINet (dropout off) on a
    graph-parallel mesh of the task's layout and shape."""
    from deeprank_gnn_tpu_torch.parallel import mesh as M
    from deeprank_gnn_tpu_torch.parallel.step import make_sharded_train_step

    layout = task["layout"]
    mesh = M.make_mesh(dp=task.get("dp"), ep=task.get("ep"), device="cpu")
    if layout == "dense":
        rb = M.shard_dense_batch(_batch(task, layout), mesh)
    else:
        rb = M.shard_batch(_graphs(task["db"]), mesh, g_pad=task["g_pad"])
    model = _model("GINet", {}, rb.batch.x.shape[-1], task["state"])
    step = make_sharded_train_step(model, _adam(model, task["lr"]), mesh)
    out[f"{layout}_pred"] = _train(task, out, f"{layout}_", model, step, rb).numpy()
    out[f"{layout}_mesh"] = np.array(mesh.shape + mesh.coords)
    _params(out, f"{layout}_", model)


def engine(task, out, rank):
    """NeuralNet on a mesh: train(nepoch=2, validate=True), then test()
    (``device_cache``: each rank's whole store on its device)."""
    from deeprank_gnn_tpu_torch import GINet, NeuralNet
    from deeprank_gnn_tpu_torch.parallel.mesh import make_halo_mesh, make_mesh

    label = task["label"]
    mesh = make_halo_mesh(device="cpu") if task["layout"] == "halo" else make_mesh(device="cpu")
    nn = NeuralNet(task["db"], GINet, node_feature=FEATURES, edge_feature=["dist"],
                   target="fnat", batch_size=4, percent=[0.5, 0.5], seed=5,
                   layout=task["layout"], mesh=mesh, device="cpu",
                   device_cache=task.get("device_cache", False),
                   outdir=os.path.join(task["outdir"], f"{label}{rank}"))
    nn.train(nepoch=2, validate=True)
    nn.test(task["db"])
    out[f"{label}:train_loss"] = np.array(nn.train_loss)
    out[f"{label}:valid_loss"] = np.array(nn.valid_loss)
    out[f"{label}:test_out"] = np.array(nn.test_out)
    out[f"{label}:test_loss"] = np.array(nn.test_loss)
    _params(out, f"{label}:", nn.model)


def scan_engine(task, out, rank):
    """NeuralNet on the dense mesh over every rank with the device store:
    ``train(**task["train"])`` with ``scan_epochs=task["scan"]``, then one
    more training pass with the collective bytes counted. ``looped``: the
    per-batch loop over the same loaders (the constructor refuses the
    chunked store on a mesh without scanned epochs, so the engine is built
    scanned and switched to the loop). ``no_dropout``: dropout off."""
    from deeprank_gnn_tpu_torch import GINet, NeuralNet
    from deeprank_gnn_tpu_torch.parallel import collectives
    from deeprank_gnn_tpu_torch.parallel.mesh import make_mesh

    label = task["label"]
    outdir = os.path.join(task["outdir"], f"{label}{rank}")
    from deeprank_gnn_tpu_torch.parallel.distributed import process_count

    kw = dict(layout="dense", mesh=make_mesh(dp=process_count(), ep=1, device="cpu"),
              device="cpu",
              outdir=outdir, scan_epochs=task["scan"] or True, **task["kw"])
    if "pretrained_model" not in kw:
        kw.update(node_feature=FEATURES, edge_feature=["dist"])
    with _no_dropout() if task.get("no_dropout") else contextlib.nullcontext():
        nn = NeuralNet(task["db"], GINet, **kw)
        nn.scan_epochs = task["scan"]
        nn.train(**task["train"])
        for name in ("train_loss", "valid_loss"):
            out[f"{label}:{name}"] = np.array(getattr(nn, name))
        for split, data in nn.data.items():
            for key in ("mol", "outputs", "raw_outputs", "targets"):
                out[f"{label}:data:{split}:{key}"] = np.array(data[key])
        _params(out, f"{label}:", nn.model)
        for i, st in nn.optimizer.state_dict()["state"].items():
            for key in ("step", "exp_avg", "exp_avg_sq"):
                out[f"{label}:adam:{i}:{key}"] = np.asarray(st[key])
        out[f"{label}:generator"] = nn._dropout_generator.get_state().numpy()
        out[f"{label}:checkpoints"] = np.array(sorted(
            f for f in os.listdir(outdir) if f.endswith(".pth.tar")))
        # how the last pass ran: the scanned steps per group (none when it
        # looped) and the chunks of the store
        out[f"{label}:meta:groups"] = np.array(nn._scan.last_groups, dtype=np.int64)
        cs = nn.train_loader._chunk_store
        out[f"{label}:meta:chunks"] = np.int64(0 if cs is None else cs.num_chunks)
        collectives.reset_collective_bytes()
        nn._run_pass(nn.train_loader, training=True)
        for k, v in collectives.collective_bytes().items():
            out[f"{label}:bytes:{k}"] = np.int64(v)
        out[f"{label}:batches"] = np.int64(len(nn.train_loader))
        out[f"{label}:params"] = np.int64(sum(p.numel() for p in nn.model.parameters()))


def rank_sums(task, out, rank):
    """Float terms of ``task["batches"]`` batches on this rank, seeded by
    the rank: each batch's pair summed over the ranks as a mesh step sums
    its loss terms, and the batches' first terms at once as a scanned pass
    does (``collectives.sum_values``); the same by all-reduce, kept for the
    record."""
    from deeprank_gnn_tpu_torch.parallel import collectives as C
    from deeprank_gnn_tpu_torch.parallel.mesh import make_mesh

    group = make_mesh(device="cpu").group
    rng = np.random.default_rng(100 + rank)
    b = task["batches"]
    terms = torch.from_numpy((rng.standard_normal((b, 2))
                              * 10.0 ** rng.integers(-3, 4, (b, 2))).astype(np.float32))
    out["sums:terms"] = terms.numpy()
    out["sums:step"] = np.stack([C.sum_values(t, group, "loss").numpy() for t in terms])
    out["sums:pass"] = C.sum_values(terms[:, 0].contiguous(), group, "loss").numpy()
    out["sums:all_reduce_step"] = np.stack([C.all_reduce_values(t, group, "loss").numpy()
                                            for t in terms])
    out["sums:all_reduce_pass"] = C.all_reduce_values(terms[:, 0].contiguous(), group,
                                                      "loss").numpy()


def env_step(task, out, rank):
    """One graph-parallel training step from a group formed from the
    DEEPRANK_* variables; prints the global loss."""
    from deeprank_gnn_tpu_torch.parallel import distributed
    from deeprank_gnn_tpu_torch.parallel import mesh as M
    from deeprank_gnn_tpu_torch.parallel.step import make_sharded_train_step

    mesh = M.make_mesh(device="cpu")
    rb = M.shard_batch(_graphs(task["db"]), mesh, g_pad=task["g_pad"])
    model = _model("GINet", {}, rb.batch.x.shape[1], task["state"])
    step = make_sharded_train_step(model, _adam(model, 1e-3), mesh)
    loss, _ = step(rb, torch.Generator().manual_seed(0))
    print(f"RANK_LOSS rank={rank} world={distributed.process_count()} "
          f"mesh={mesh.shape} loss={float(loss)!r}", flush=True)
    out["loss"] = loss.numpy()


TASKS = {f.__name__: f for f in (halo_eval, halo_train, mesh_train, engine, scan_engine,
                                 rank_sums, env_step)}


def main():
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    spec = torch.load(spec_path, weights_only=False)
    from deeprank_gnn_tpu_torch.parallel import distributed

    if spec.get("env"):
        distributed.initialize(device="cpu")
    else:
        distributed.initialize(f"file://{spec['store']}", spec["world"], rank, device="cpu")
    out = {}
    try:
        for task in spec["tasks"]:
            TASKS[task["kind"]](task, out, rank)
    finally:
        distributed.shutdown()
    np.savez(spec["out"].format(rank=rank), **out)


if __name__ == "__main__":
    main()

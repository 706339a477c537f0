"""The port's count of its index accumulation (``ops/lanes.py``
``ACCUMULATED``), as the benchmark's ``accum_mb.train`` reads it.

On the CPU: a dense attention training step counts the lanes and elements
its shapes give, its pools and its pooled edge attributes once (the
attention conv is kernel K4, whose plain version counts nothing); a
paper-mode K3 step on the same batch counts its pools alone (K3's plain
version stands in for a kernel and counts nothing); a
captured graph keeps its step's counts, which leave the counter at capture
and come back at each replay; and a scanned training pass carries its total
on its ``pass`` span.

CPU only; imports no JAX. ``python -m pytest tests/test_torch_accumulation_counter.py``.
"""

from __future__ import annotations

import contextlib
import functools
from collections import Counter

import pytest
import torch

from portbench import graphs

FE = 1


def _samples(n=4):
    from deeprank_gnn_tpu_torch import GraphListDataSet
    from deeprank_gnn_tpu_torch.data.dataset import GraphSample

    return GraphListDataSet([GraphSample(
        mol=g["mol"], x=g["x"], pos=g["pos"], edge_index=g["edge_index"],
        edge_attr=g["edge_attr"], internal_edge_index=g["internal_edge_index"],
        internal_edge_attr=g["internal_edge_attr"], cluster0=g["cluster0"],
        cluster1=g["cluster1"], y=g["y"]) for g in graphs.atomic(2**31 + 41, n, 64, 150, 48)])


def _batch():
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense

    return collate_dense(_samples().graphs[:3], g_pad=4, precompute_ops=False)[0]


def _step_counts(model, batch) -> Counter:
    """What one training step (forward, MSE, backward) adds to the counter."""
    from deeprank_gnn_tpu_torch.ops.lanes import ACCUMULATED
    from deeprank_gnn_tpu_torch.train.losses import mse_loss

    before = Counter(ACCUMULATED)
    mse_loss(model(batch)[:, 0], batch.y, batch.y_mask).backward()
    got = Counter(ACCUMULATED)
    got.subtract(before)
    return +got


def _pools(b) -> Counter:
    """The max pools' segment counts (``slot_max_pool`` through
    ``segment_max``): one lane an element over the node slots, then over the
    level-0 cluster slots."""
    g, ng = b.x.shape[:2]
    lanes = g * ng + g * b.pool0_mask.shape[1]
    return Counter(lanes=lanes, elements=lanes)


def test_dense_attention_step_counts_its_shapes():
    """Both towers' pools, and the pooled edge attributes once a step (both
    towers read the same sum); the four attention convs, forward and
    backward, count nothing."""
    from deeprank_gnn_tpu_torch import GINet

    b = _batch()
    g, eg = b.row.shape
    model = GINet(48, 1, 1, attention=True, device="cpu").train()
    got = _step_counts(model, b)
    pooled_attributes = Counter(lanes=g * eg, elements=g * eg * FE)
    assert got == _pools(b) + _pools(b) + pooled_attributes


def test_k3_step_counts_none_of_the_attention_sums():
    from deeprank_gnn_tpu_torch import GINet

    b = _batch()
    assert _step_counts(GINet(48, 1, 1, device="cpu").train(), b) == _pools(b)


def test_capture_keeps_the_counts_and_replays_add_them(monkeypatch):
    """``EpochSteps._capture`` records the accumulation its body counted and
    takes it back out of the counter (a capture runs nothing); each replay
    adds it again. The CUDA graph is stood in for on the CPU: its body runs
    once, as a capture traces it."""
    from deeprank_gnn_tpu_torch.ops.lanes import ACCUMULATED, index_add_rows
    from deeprank_gnn_tpu_torch.train import scan

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, stream=None: contextlib.nullcontext())
    steps = scan.EpochSteps(step=None)
    monkeypatch.setattr(steps, "_capture_stream", lambda: None)

    def body():
        index_add_rows(torch.ones(10, 3), torch.arange(10) % 4, 4)
        index_add_rows(torch.ones(6), torch.arange(6) % 2, 2)

    before = Counter(ACCUMULATED)
    cap = steps._capture(body, 1, True, "step", None, None, (), register=False)
    assert +Counter(ACCUMULATED) == +before
    assert cap.accumulated == Counter(lanes=16, elements=36)
    steps._graphs["k"] = cap
    assert steps.graph_stats()[0]["accumulated"] == {"lanes": 16, "elements": 36}
    scan._run_replay(cap)
    scan._run_replay(cap)
    assert Graph.replays == 2 and cap.replays == 2
    after = Counter(ACCUMULATED)
    after.subtract(before)
    assert +after == Counter(lanes=32, elements=72)


@pytest.mark.parametrize("attention", [True, False], ids=["attention", "paper"])
def test_pass_span_carries_the_pass_total(attention, tmp_path):
    """A scanned training pass over the store (eager steps on the CPU)
    carries its steps' accumulation on its ``pass`` span: every step of the
    store's fixed shapes counts what one step counts alone."""
    from deeprank_gnn_tpu_torch import GINet, NeuralNet, trace
    from deeprank_gnn_tpu_torch.train.scan import gather_store_batch

    data = _samples(8)
    net = functools.partial(GINet, attention=True) if attention else GINet
    nn = NeuralNet(data, net, node_feature=[f"f{i}" for i in range(48)], edge_feature=["dist"],
                   target="irmsd", batch_size=4, percent=[1.0, 0.0], layout="dense",
                   device_cache=True, scan_epochs=True, outdir=str(tmp_path), device="cpu")
    loader = nn.train_loader = nn._loader(nn.train_loader.dataset, shuffle=True, seed=3,
                                          precompute_ops=False)
    nn._run_pass(loader, training=True)
    counts = trace.passes()[-1].span.counts
    assert counts["steps"] == 2 and counts["graphs"] == 8
    store = loader._store.store
    batch = gather_store_batch(store, torch.zeros(store.num_slots), torch.arange(4))
    one = _step_counts(nn.model.train(), batch)
    assert counts["accumulated"] == 2 * one["elements"] > 0

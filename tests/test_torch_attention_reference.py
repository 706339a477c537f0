"""Attention GINet in the port against the benchmark's plain reference.

``functools.partial(GINet, attention=True)`` of the port, on the dense
layout (``collate_dense(precompute_ops=False)``, the attention conv's dense
edge-to-slot ops) and on the sparse layout (``collate``; K1 and K2 run as
their plain versions on the CPU), is held in float64 to
``portbench/nets/GINetAttention.py`` on the harness's seeded weights
(``reference.draw_weights``): the scores, the MSE loss and every leaf's
gradient, with the attention and edge-attribute weights of all four convs
live. The graphs are small atomic-like ones with a node that no edge
targets, a tie in one node's logits and a padded graph slot in the batch.

CPU only; imports no JAX. ``python -m pytest tests/test_torch_attention_reference.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from portbench import graphs, reference, spec

NET = spec.load_net("GINetAttention")
MODEL = {"node_features": 48, "edge_features": 1, "conv1_out": 16, "conv2_out": 32,
         "fc1_out": 128, "fc2_out": 1, "dropout": 0.4, "lr": 0.01}
SEED = 2**31 + 23
NO_IN_EDGES, TWIN_A, TWIN_B, TIED = 5, 10, 11, 12
ATTENTION_LEAVES = [f"{conv}{tower}.{leaf}.weight" for conv in ("conv1", "conv2")
                    for tower in ("", "_ext") for leaf in ("fc_attention", "fc_edge_attr")]
# Both sides compute in float64 and differ only in the order of their sums
# (edge order against the port's flattened slots, sorted runs or K1's CSR
# runs), each partial sum rounding at 2**-53 relative. Through the softmax,
# two max pools, the mean and the head that stays within ~1e-13 relative;
# 1e-9 leaves four orders of magnitude of room, and a float32 pass (~1e-7)
# fails it. A gradient element that cancels to ~0 is held to 1e-9 of its
# leaf's largest element instead of its own size.
RTOL = 1e-9


def _samples():
    """Three graphs of 64 nodes and ~300 directed edges (the atomic
    generator at a small size): node 5 is no edge's target, nodes 10 and 11
    carry the same features and each sends node 12 an edge with the same
    attribute, so node 12's two logits tie."""
    from deeprank_gnn_tpu_torch import GraphListDataSet
    from deeprank_gnn_tpu_torch.data.dataset import GraphSample

    out = []
    for g in graphs.atomic(SEED, 3, 64, 150, 48):
        row, col = g["edge_index"]
        keep = row != NO_IN_EDGES
        row = np.concatenate([row[keep], [TIED, TIED]]).astype(np.int32)
        col = np.concatenate([col[keep], [TWIN_A, TWIN_B]]).astype(np.int32)
        ea = np.concatenate([g["edge_attr"][keep], [[0.5], [0.5]]]).astype(np.float32)
        x = g["x"].copy()
        x[TWIN_B] = x[TWIN_A]
        out.append(GraphSample(mol=g["mol"], x=x, pos=g["pos"], edge_index=np.stack([row, col]),
                               edge_attr=ea, internal_edge_index=g["internal_edge_index"],
                               internal_edge_attr=g["internal_edge_attr"],
                               cluster0=g["cluster0"], cluster1=g["cluster1"], y=g["y"]))
    return GraphListDataSet(out).graphs


def _raw(s) -> dict:
    """A sample as the reference's raw graph."""
    return {"x": s.x, "edge_index": s.edge_index, "edge_attr": s.edge_attr,
            "cluster0": s.cluster0, "cluster1": s.cluster1, "y": s.y}


def _reference(samples, weights):
    p = {k: v.double().requires_grad_(True) for k, v in weights.items()}
    b = reference.Batch([_raw(s) for s in samples], "cpu")
    scores = NET.forward(p, b, MODEL)
    loss = ((scores - b.y) ** 2).sum() / len(samples)
    grads = torch.autograd.grad(loss, list(p.values()))
    return scores.detach(), loss.detach(), dict(zip(p, grads)), b


def _port(batch, weights, samples):
    from deeprank_gnn_tpu_torch import GINet
    from deeprank_gnn_tpu_torch.train.losses import mse_loss

    model = GINet(48, 1, 1, attention=True, device="cpu")
    with torch.no_grad():
        for k, w in model.named_parameters():
            w.copy_(weights[k])
    model = model.double().eval()
    # the targets as the reference holds them (the batch rounds them to float32)
    y = torch.tensor([s.y for s in samples] + [0.0] * (batch.y.shape[0] - len(samples)),
                     dtype=torch.float64)
    batch = dataclasses.replace(batch, x=batch.x.double(), edge_attr=batch.edge_attr.double(),
                                y=y)
    out = model(batch)[:, 0]
    loss = mse_loss(out, batch.y, batch.y_mask)
    loss.backward()
    return out.detach(), loss.detach(), {k: w.grad for k, w in model.named_parameters()}


def _collate(layout: str, samples):
    from deeprank_gnn_tpu_torch.data.batch import collate
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense

    if layout == "dense":
        return collate_dense(samples, g_pad=4, precompute_ops=False)[0]
    return collate(samples, g_pad=4)[0]


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_port_matches_reference(layout):
    samples = _samples()
    weights = reference.draw_weights(NET.param_table(MODEL), SEED, "cpu")
    want_s, want_l, want_g, b = _reference(samples, weights)
    batch = _collate(layout, samples)
    assert batch.y_mask.tolist() == [True, True, True, False]  # a padded graph slot
    got_s, got_l, got_g = _port(batch, weights, samples)
    torch.testing.assert_close(got_s[:3], want_s, rtol=RTOL, atol=0)
    torch.testing.assert_close(got_l, want_l, rtol=RTOL, atol=0)
    assert set(got_g) == set(want_g)
    for k in want_g:
        scale = float(want_g[k].abs().max())
        torch.testing.assert_close(got_g[k], want_g[k], rtol=RTOL, atol=RTOL * scale, msg=k)
    # the attention and edge-attribute weights are live in every conv
    for k in ATTENTION_LEAVES:
        assert float(want_g[k].abs().max()) > 1e-6, k
    # the cases the graphs were built for: node 5 is no edge's target, and
    # node 12's two logits from the twins tie
    assert not bool((b.row == NO_IN_EDGES).any())
    p = {k: v.double() for k, v in weights.items()}
    xw = b.x @ p["conv1.fc.weight"].T
    twins = (b.row == TIED) & ((b.col == TWIN_A) | (b.col == TWIN_B)) & (b.ea[:, 0] == 0.5)
    logits = torch.cat([xw[b.row[twins]], xw[b.col[twins]], b.ea[twins]
                        @ p["conv1.fc_edge_attr.weight"].T], 1) @ p["conv1.fc_attention.weight"].T
    assert twins.sum() == 2 and logits[0, 0] == logits[1, 0]


def test_attention_differs_from_paper_mode():
    """The reference's softmax is not Q1's weight of 1: paper mode's
    reference scores the same batch otherwise."""
    samples = _samples()
    weights = reference.draw_weights(NET.param_table(MODEL), SEED, "cpu")
    p = {k: v.double() for k, v in weights.items()}
    b = reference.Batch([_raw(s) for s in samples], "cpu")
    paper = spec.load_net("GINet").forward(p, b, MODEL)
    assert not torch.allclose(NET.forward(p, b, MODEL), paper, rtol=1e-3)


def test_tf32_control_moves_the_scores():
    """The reference in TF32 (the control of the benchmark's output check)
    departs from the float64 scores by far more than :data:`RTOL`."""
    samples = _samples()
    weights = reference.draw_weights(NET.param_table(MODEL), SEED, "cpu")
    p64 = {k: v.double() for k, v in weights.items()}
    b64 = reference.Batch([_raw(s) for s in samples], "cpu")
    b32 = reference.Batch([_raw(s) for s in samples], "cpu", torch.float32)
    exact = NET.forward(p64, b64, MODEL)
    tf32 = NET.forward(weights, b32, MODEL, tf32=True).double()
    assert float((tf32 - exact).abs().max() / exact.abs().max()) > 1e3 * RTOL

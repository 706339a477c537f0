"""Paper-mode GINet for the yardstick: its leaves, its plain forward pass, and
the work it needs. A configuration whose ``model.net`` is ``GINet`` takes
this file (``spec.load_net``); the engine runs the port's class of the same
name.

It follows the published model (DeepRank-GNN v0.1.4 ``deeprank_gnn/ginet.py``)
with the reference's two quirks, which the port keeps (``models/ginet.py``):
the attention logit is softmaxed over a size-1 axis, so each conv is
``segment_sum((x W^T)[col], row)`` and the attention and edge-attribute
weights are never read (Q1); and both towers run on the interface edges
(Q2). A graph's path: conv1 (both towers, 16 columns each) and ReLU, a max
over the members of each level-0 cluster, conv2 (32 columns a tower) over
the coalesced edges between distinct level-0 clusters and ReLU, a max over
each level-1 cluster, the mean over the graph's level-1 clusters, fc1 and
ReLU, inverted dropout in training, fc2.

It imports nothing of the program and works every aggregation and pool out
again from the raw arrays of a ``reference.Batch``.
"""

from __future__ import annotations

import torch

from portbench import roofline
from portbench.reference import linear, segment_max


def param_table(model: dict) -> dict:
    """Name -> (shape, fan-in of its layer) of the leaves, in the published
    state-dict names."""
    f, fe = model["node_features"], model["edge_features"]
    c1, c2 = model["conv1_out"], model["conv2_out"]
    hid, out = model["fc1_out"], model["fc2_out"]
    table = {}
    for tower in ("", "_ext"):
        for conv, (fin, fout) in (("conv1", (f, c1)), ("conv2", (c1, c2))):
            p = f"{conv}{tower}"
            table[f"{p}.fc.weight"] = ((fout, fin), fin)
            table[f"{p}.fc_edge_attr.weight"] = ((fe, fe), fin)
            table[f"{p}.fc_attention.weight"] = ((1, 2 * fout + fe), fin)
    table["fc1.weight"] = ((hid, 2 * c2), 2 * c2)
    table["fc1.bias"] = ((hid,), 2 * c2)
    table["fc2.weight"] = ((out, hid), hid)
    table["fc2.bias"] = ((out,), hid)
    return table


def forward(p: dict, b, model: dict, keep=None, tf32: bool = False) -> torch.Tensor:
    """Scores ``[G]`` of batch ``b`` under weights ``p``; ``keep``: the
    dropout mask of a training step (its first ``G`` rows are used)."""
    w1 = torch.cat([p["conv1.fc.weight"], p["conv1_ext.fc.weight"]])
    xw = linear(b.x, w1, tf32=tf32)
    h = torch.relu(xw.new_zeros(xw.shape).index_add(0, b.row, xw[b.col]))
    hp = segment_max(h, b.c0, b.num_c0)
    half = p["conv1.fc.weight"].shape[0]
    hw = torch.cat([linear(hp[:, :half], p["conv2.fc.weight"], tf32=tf32),
                    linear(hp[:, half:], p["conv2_ext.fc.weight"], tf32=tf32)], dim=1)
    h2 = torch.relu(hw.new_zeros(hw.shape).index_add(0, b.prow, hw[b.pcol]))
    hq = segment_max(h2, b.c1, b.num_c1)
    count = torch.bincount(b.c1_graph, minlength=b.num_graphs).to(hq.dtype)
    hg = hq.new_zeros((b.num_graphs, hq.shape[1])).index_add(0, b.c1_graph, hq) / count[:, None]
    f = torch.relu(linear(hg, p["fc1.weight"], p["fc1.bias"], tf32=tf32))
    if keep is not None:
        rate = model["dropout"]
        f = torch.where(keep[: b.num_graphs], f / (1.0 - rate), torch.zeros_like(f))
    return linear(f, p["fc2.weight"], p["fc2.bias"], tf32=tf32)[:, 0]


def dropout_width(model: dict) -> int:
    """The columns of a training step's dropout mask: fc1's outputs."""
    return model["fc1_out"]


def flops(c: dict, model: dict, training: bool) -> float:
    """FLOPs the model needs for one graph of counts ``c``
    (``roofline.graph_counts``), whatever computes them: the node products
    of both towers (2 per multiply-add), one add per edge and column of each
    aggregation, and the fc head; in training the backward at its own count
    (weight gradients of every product, input gradients of all but conv1's,
    the aggregations again). Pools, the loss and Adam are left out."""
    f, c1, c2 = model["node_features"], model["conv1_out"], model["conv2_out"]
    hid, out = model["fc1_out"], model["fc2_out"]
    conv1 = 2 * c["nodes"] * f * 2 * c1
    agg1 = c["edges"] * 2 * c1
    conv2 = 2 * c["c0"] * c1 * c2 * 2
    agg2 = c["pooled"] * 2 * c2
    head = 2 * (2 * c2) * hid + 2 * hid * out
    fwd = conv1 + agg1 + conv2 + agg2 + head
    if not training:
        return float(fwd)
    bwd = conv1 + agg1 + 2 * conv2 + agg2 + 2 * head
    return float(fwd + bwd)


def k3_bound_ms(c: dict, model: dict, training: bool) -> float:
    """K3's least time for one graph's share of a batch: conv1 at both
    towers' columns and conv2 likewise, forward and, in training, backward
    (the same sums with the edges reversed). Bytes add up over a batch's
    graphs, so a batch's bound is the sum of its graphs'."""
    w1, w2 = 2 * model["conv1_out"], 2 * model["conv2_out"]
    total = (roofline.k3_bound_ms(c["edge_sources"], c["nodes"], c["edges"], w1)
             + roofline.k3_bound_ms(c["pooled_sources"], c["c0"], c["pooled"], w2))
    if training:
        total += (roofline.k3_bound_ms(c["edge_targets"], c["nodes"], c["edges"], w1)
                  + roofline.k3_bound_ms(c["pooled_targets"], c["c0"], c["pooled"], w2))
    return total


def work(c: dict, model: dict, training: bool) -> dict:
    """One graph's share of a step, by the names the metric readers take
    per step (``<name>_per_step``): its FLOPs and K3's least time."""
    return {"flops": flops(c, model, training), "k3_bound_ms": k3_bound_ms(c, model, training)}

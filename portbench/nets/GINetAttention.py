"""Attention GINet for the yardstick: its leaves, its plain forward pass, and
the work it needs. A configuration whose ``model.net`` is ``GINetAttention``
takes this file (``spec.load_net``); the engine runs the port's ``GINet``
with ``attention=True`` (``PORT``, ``OPTIONS``).

It follows the published conv (DeepRank-GNN v0.1.4 ``deeprank_gnn/ginet.py``,
lines 50-73: ``x W^T``, the edge attributes through ``W_e``, the attention
logit ``leaky_relu([x_i W | x_j W | e_ij W_e] . a)``, its softmax, the
weighted messages summed onto their target row), with these departures:

- Q1 replaced: the published file softmaxes each logit over a size-1 axis,
  so every weight is 1 and ``fc_attention`` and ``fc_edge_attr`` are never
  read; here the softmax runs over each target row's edges (GAT's form),
  shifted by the row's largest logit, and a row with no edges gives 0. The
  shift is taken without a gradient: a softmax does not depend on it.
- Q2 kept: both towers run on the interface edges.
- The pooled edges' attributes are the sums of the attributes of the edges
  that map to them (``reference.Batch.pea``, torch-sparse's coalesce in the
  reference, ``community_pooling.py:204-205``).

A graph's path, each tower on its own: conv1 over ``(row, col, ea)`` (16
columns) and ReLU, a max over the members of each level-0 cluster, conv2
over the pooled edges ``(prow, pcol, pea)`` (32 columns) and ReLU, a max
over each level-1 cluster, the mean over the graph's level-1 clusters; the
two towers side by side, fc1 and ReLU, inverted dropout in training, fc2.
The leaves, their names and the head are ``nets/GINet.py``'s, whose
attention and edge-attribute weights are read here.

It imports nothing of the program and works every aggregation, softmax and
pool out again from the raw arrays of a ``reference.Batch``.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from portbench import spec
from portbench.reference import linear, segment_max

PORT = "GINet"
OPTIONS = {"attention": True}
# ``dense_fast`` rounds only paper mode's dense aggregations, which this net
# does not run: the program's fast path leaves its numbers as they are
PROGRAM_CONTROLS = ()
LEAKY_SLOPE = 0.01  # torch's leaky_relu default, as the published conv calls it

_GINET = spec.load_net("GINet")
param_table = _GINET.param_table
dropout_width = _GINET.dropout_width


def conv(p: dict, name: str, x, row, col, ea, tf32: bool = False) -> torch.Tensor:
    """One attention conv ``name`` (``conv1``, ``conv2_ext``, ...) of rows
    ``x [N, fin]`` over the edges ``row <- col`` with attributes ``ea``;
    ReLU not applied."""
    xw = linear(x, p[f"{name}.fc.weight"], tf32=tf32)
    msg, xrow = xw[col], xw[row]
    ed = linear(ea, p[f"{name}.fc_edge_attr.weight"], tf32=tf32)
    logit = linear(torch.cat([xrow, msg, ed], dim=1), p[f"{name}.fc_attention.weight"],
                   tf32=tf32)
    logit = F.leaky_relu(logit[:, 0], LEAKY_SLOPE)
    shift = segment_max(logit.detach()[:, None], row, x.shape[0])[:, 0]
    ex = torch.exp(logit - shift[row])
    denom = ex.new_zeros(x.shape[0]).index_add(0, row, ex)
    alpha = ex / denom[row]
    return xw.new_zeros(xw.shape).index_add(0, row, alpha[:, None] * msg)


def tower(p: dict, suffix: str, b, tf32: bool = False) -> torch.Tensor:
    """One tower's readout ``[G, conv2_out]``: ``suffix`` is ``""`` or
    ``"_ext"``."""
    h = torch.relu(conv(p, f"conv1{suffix}", b.x, b.row, b.col, b.ea, tf32))
    hp = segment_max(h, b.c0, b.num_c0)
    h2 = torch.relu(conv(p, f"conv2{suffix}", hp, b.prow, b.pcol, b.pea, tf32))
    hq = segment_max(h2, b.c1, b.num_c1)
    count = torch.bincount(b.c1_graph, minlength=b.num_graphs).to(hq.dtype)
    return hq.new_zeros((b.num_graphs, hq.shape[1])).index_add(0, b.c1_graph, hq) / count[:, None]


def forward(p: dict, b, model: dict, keep=None, tf32: bool = False) -> torch.Tensor:
    """Scores ``[G]`` of batch ``b`` under weights ``p``; ``keep``: the
    dropout mask of a training step (its first ``G`` rows are used)."""
    hg = torch.cat([tower(p, "", b, tf32), tower(p, "_ext", b, tf32)], dim=1)
    f = torch.relu(linear(hg, p["fc1.weight"], p["fc1.bias"], tf32=tf32))
    if keep is not None:
        rate = model["dropout"]
        f = torch.where(keep[: b.num_graphs], f / (1.0 - rate), torch.zeros_like(f))
    return linear(f, p["fc2.weight"], p["fc2.bias"], tf32=tf32)[:, 0]


def conv_flops(rows: int, edges: int, fin: int, fout: int, fe: int,
               training: bool) -> float:
    """FLOPs of one attention conv over ``rows`` nodes and ``edges`` edges
    (2 per multiply-add): the node product, the edge-attribute product, the
    logits' product over ``2 fout + fe`` columns, the softmax (6 an edge:
    leaky ReLU, max, shift, exp, sum, divide) and the weighted sums (a
    multiply and an add an edge and column). In training the backward at
    its own count: every product's weight gradient, the input gradients of
    the logits' product (the others' inputs are data or conv1's features),
    and the softmax and weighted sums again. The node product's input
    gradient is :func:`flops`'s to add where the input is not data."""
    node = 2 * rows * fin * fout
    edge = 2 * edges * fe * fe
    logits = 2 * edges * (2 * fout + fe)
    softmax = 6 * edges
    sums = 2 * edges * fout
    fwd = node + edge + logits + softmax + sums
    if not training:
        return float(fwd)
    return float(fwd + node + edge + 2 * logits + softmax + sums)


def flops(c: dict, model: dict, training: bool) -> float:
    """FLOPs the model needs for one graph of counts ``c``
    (``roofline.graph_counts``), whatever computes them: both towers' two
    attention convs (:func:`conv_flops`; conv2's node product also its
    input gradient in training) and the fc head as ``nets/GINet.py`` counts
    it. Pools, the pooled attributes' sums, the loss and Adam are left out."""
    f, fe = model["node_features"], model["edge_features"]
    c1, c2 = model["conv1_out"], model["conv2_out"]
    hid, out = model["fc1_out"], model["fc2_out"]
    conv2_input_grad = 2 * c["c0"] * c1 * c2 if training else 0
    tower_flops = (conv_flops(c["nodes"], c["edges"], f, c1, fe, training)
                   + conv_flops(c["c0"], c["pooled"], c1, c2, fe, training) + conv2_input_grad)
    head = 2 * (2 * c2) * hid + 2 * hid * out
    return float(2 * tower_flops + (3 if training else 1) * head)


def work(c: dict, model: dict, training: bool) -> dict:
    """One graph's share of a step, by the names the metric readers take
    per step (``<name>_per_step``): its FLOPs. No hand kernel runs, so
    there is no kernel's least time."""
    return {"flops": flops(c, model, training)}

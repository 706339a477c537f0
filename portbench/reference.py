"""The plain reference: a configuration's net, its MSE loss and Adam, in plain torch.

The net itself (its leaves and its forward pass) is ``nets/<net>.py``, found
by the configuration's ``model.net`` (``spec.load_net``); this module holds
what every net shares: the initial weights from the seed, the dropout masks,
a batch of raw graphs with every index and edge attribute worked out again,
TF32 products for the control, and the scoring and training loops.

It imports nothing of the program and takes no array the program made: it
works the aggregations, the pooled edges, their attributes and the pools
out again from the raw edge lists, edge attributes and cluster arrays of
``graphs.py``. It runs in float64 by default; ``tf32=True`` runs it in
float32 with the operands of every matrix product rounded to TF32 (10
explicit mantissa bits, to nearest even), the precision just below the
configuration's, for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def draw_weights(table: dict, seed: int, device) -> dict:
    """Initial weights of the leaves of ``table`` (a net's ``param_table``:
    name -> (shape, fan-in)) from ``seed``: one uniform draw on ``device``
    for all leaves, each scaled to U(-1/sqrt(fan_in), 1/sqrt(fan_in)), in
    float32."""
    total = sum(math.prod(shape) for shape, _ in table.values())
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for name, (shape, fan_in) in table.items():
        n = math.prod(shape)
        bound = 1.0 / math.sqrt(fan_in)
        out[name] = (u[pos: pos + n] * (2 * bound) - bound).reshape(shape)
        pos += n
    return out


def dropout_masks(seed: int, skip: int, steps: int, rows: int, width: int, rate: float,
                  device) -> list:
    """The keep masks of ``steps`` training steps after the first ``skip``:
    the program draws ``rand(rows, width) >= rate`` from a generator on its
    device seeded with its ``seed`` at every step, and nothing else from it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    masks = [torch.rand((rows, width), generator=gen, device=device) >= rate
             for _ in range(skip + steps)]
    return masks[skip:]


class Batch:
    """Graphs laid end to end on ``device``, with every index the model
    needs worked out from their raw arrays, and the edge attributes in
    ``dtype``: ``ea [E, fe]``, each graph's ``edge_attr`` in the order of
    ``row`` and ``col``, and ``pea [P, fe]``, a pooled edge's attributes in
    the order of ``prow`` and ``pcol``: the sum of ``ea`` over the edges
    between distinct level-0 clusters that map to it (torch-sparse's
    coalesce in the reference, ``community_pooling.py:204-205``)."""

    def __init__(self, graphs: list, device, dtype=torch.float64):
        off_n = np.cumsum([0] + [g["x"].shape[0] for g in graphs])
        off_c0 = np.cumsum([0] + [len(g["cluster1"]) for g in graphs])
        k1 = [int(g["cluster1"].max()) + 1 for g in graphs]
        off_c1 = np.cumsum([0] + k1)
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        self.num_graphs = len(graphs)
        self.x = as_t(np.concatenate([g["x"] for g in graphs])).to(dtype)
        self.row = as_t(np.concatenate([g["edge_index"][0] + o for g, o in zip(graphs, off_n)])
                        .astype(np.int64))
        self.col = as_t(np.concatenate([g["edge_index"][1] + o for g, o in zip(graphs, off_n)])
                        .astype(np.int64))
        self.c0 = as_t(np.concatenate([g["cluster0"] + o for g, o in zip(graphs, off_c0)])
                       .astype(np.int64))
        self.c1 = as_t(np.concatenate([g["cluster1"] + o for g, o in zip(graphs, off_c1)])
                       .astype(np.int64))
        self.num_c0, self.num_c1 = int(off_c0[-1]), int(off_c1[-1])
        self.c1_graph = as_t(np.repeat(np.arange(len(graphs)), k1))
        self.ea = as_t(np.concatenate([g["edge_attr"] for g in graphs])).to(dtype)
        # edges between level-0 clusters: each distinct (source, target)
        # pair once, no self-loops, their attributes summed (torch-sparse's
        # coalesce in the reference)
        pr, pc = self.c0[self.row], self.c0[self.col]
        keep = pr != pc
        key, to_pooled = torch.unique(pr[keep] * self.num_c0 + pc[keep], return_inverse=True)
        self.prow, self.pcol = key // self.num_c0, key % self.num_c0
        self.pea = self.ea.new_zeros((key.shape[0], self.ea.shape[1])).index_add(
            0, to_pooled, self.ea[keep])
        self.y = as_t(np.array([g["y"] for g in graphs])).to(dtype)


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32 (to nearest, ties to even)."""
    bits = a.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``x @ w.T`` as a TF32 tensor core computes it: both operands rounded
    to TF32, products summed in float32; the backward's two products
    likewise, on the rounded gradient."""

    @staticmethod
    def forward(ctx, x, w):
        xr, wr = to_tf32(x), to_tf32(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.T

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = to_tf32(g)
        return gr @ wr, gr.T @ xr


def linear(x, w, b=None, tf32: bool = False):
    """``x @ w.T (+ b)``, in TF32 with ``tf32``."""
    y = _TF32Product.apply(x, w) if tf32 else x @ w.T
    return y if b is None else y + b


def segment_max(h, seg, n):
    """The max of the rows of ``h`` over each of ``n`` segments ``seg``."""
    idx = seg[:, None].expand(-1, h.shape[1])
    return h.new_zeros((n, h.shape[1])).scatter_reduce(0, idx, h, "amax", include_self=False)


def scores(net, p: dict, b: Batch, model: dict, keep=None, tf32: bool = False,
           fault: str = None) -> torch.Tensor:
    """``net.forward``'s scores ``[G]`` of batch ``b``;
    ``fault="answer_altered"`` moves the first graph's score by 0.05."""
    out = net.forward(p, b, model, keep, tf32)
    if fault == "answer_altered":
        out = out + 0.05 * (torch.arange(b.num_graphs, device=out.device) == 0)
    return out


def predict(net, model: dict, weights: dict, graphs: list, device, block: int,
            tf32: bool = False, fault: str = None) -> np.ndarray:
    """Scores of ``graphs``, ``block`` graphs at a time. ``fault``: as
    :func:`scores`, or ``"half_batch"``: each block's second half of scores
    lost (zero)."""
    dtype = torch.float32 if tf32 else torch.float64
    p = {k: v.to(device=device, dtype=dtype) for k, v in weights.items()}
    out = []
    with torch.no_grad():
        for i in range(0, len(graphs), block):
            o = scores(net, p, Batch(graphs[i: i + block], device, dtype), model, tf32=tf32,
                       fault=fault)
            if fault == "half_batch":
                o[o.shape[0] // 2:] = 0
            out.append(o.cpu())
    return torch.cat(out).double().numpy()


def train(net, model: dict, weights: dict, batches: list, masks: list, device,
          tf32: bool = False, fault: str = None) -> dict:
    """Adam steps at ``model["lr"]`` on ``batches`` (lists of graphs) with
    dropout masks ``masks``: each step's loss, the first gradient per leaf,
    and the weights after the last step.

    ``fault`` puts the reference in the program's place with a fault of the
    output check's list: ``"answer_altered"`` (:func:`scores`) or
    ``"half_batch"`` (the loss is the mean over each batch's first half)."""
    dtype = torch.float32 if tf32 else torch.float64
    lr = model["lr"]
    p = {k: v.to(device=device, dtype=dtype).clone().requires_grad_(True)
         for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    for t, (graphs, keep) in enumerate(zip(batches, masks), start=1):
        n = len(graphs)
        b = Batch(graphs, device, dtype)
        sq = (scores(net, p, b, model, keep, tf32=tf32, fault=fault) - b.y) ** 2
        loss = sq[: n // 2].mean() if fault == "half_batch" else sq.sum() / n
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        with torch.no_grad():
            grads = {k: torch.zeros_like(w) if g is None else g
                     for (k, w), g in zip(p.items(), grads)}
            if first_grad is None:
                first_grad = {k: g.double().cpu() for k, g in grads.items()}
            c1, c2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
            for k, w in p.items():
                m[k].mul_(BETAS[0]).add_(grads[k], alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(grads[k], grads[k], value=1 - BETAS[1])
                w.sub_(lr / c1 * m[k] / (v2[k].sqrt() / math.sqrt(c2) + EPS))
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first_grad,
            "weights": {k: w.detach().double().cpu() for k, w in p.items()}}

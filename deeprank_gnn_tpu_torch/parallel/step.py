"""Training and evaluation steps over a graph-parallel mesh.

The port's counterpart of ``deeprank_gnn_tpu/parallel/step.py``. JAX
compiles one program over the mesh and lets the partitioner reduce the
loss and the gradients; here each rank runs the single-device model on its
graphs (``data.batch.RankBatch``) and the step issues the collectives
itself:

- forward on this rank's graphs, dropout drawn at the global batch's
  shape from the engine's generator (whose state is equal on every rank)
  and cut to this rank's rows, so a mesh run follows the single-device
  trajectory as JAX's global ``jax.random`` draw does;
- the global loss: this rank's masked sum over the global normalizer (the
  valid targets, or under class weights the weight sum of the valid
  targets, as ``train/losses.py`` normalizes), both summed by one
  all-reduce;
- backward, then the gradients summed by one all-reduce of all of them at
  once, then the optimizer step, identical on every rank;
- the global predictions, gathered in rank order, so that every rank sees
  the whole batch for its metrics, as JAX's replicated ``out_shardings``
  give it.

:class:`MeshSteps` also takes the halo layout's steps
(``parallel/halo.py``), which differ only in the loss's normalization and
in needing no gather of the predictions.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeprank_gnn_tpu_torch.device import deterministic
from deeprank_gnn_tpu_torch.parallel.collectives import (
    all_gather_values,
    all_reduce_values,
    group_size,
)
from deeprank_gnn_tpu_torch.parallel.mesh import Mesh, RankBatch


def loss_terms(task: str, pred: torch.Tensor, y: torch.Tensor, y_mask: torch.Tensor,
               class_weights: Optional[torch.Tensor], transform_sigmoid: bool):
    """``(numerator, normalizer, pred)`` of the masked loss: MSE (``pred``
    reshaped to ``[G]``, optionally through a sigmoid) or class-weighted
    cross-entropy, as ``train/losses.py`` computes them; the loss is
    ``numerator / max(normalizer, floor)`` with :func:`normalizer_floor`."""
    if task == "class":
        logp = torch.log_softmax(pred, dim=-1)
        y_safe = torch.clamp(y.long(), 0, pred.shape[-1] - 1)
        nll = -logp.gather(1, y_safe[:, None])[:, 0]
        w = torch.ones_like(nll) if class_weights is None else class_weights[y_safe]
        w = torch.where(y_mask, w, torch.zeros_like(w))
        return (w * nll).sum(), w.sum(), pred
    p = pred.reshape(-1)
    if transform_sigmoid:
        p = torch.sigmoid(p)
    sq = (p - y) ** 2
    return torch.where(y_mask, sq, torch.zeros_like(sq)).sum(), y_mask.sum().to(p.dtype), p


def normalizer_floor(task: str) -> float:
    return 1e-12 if task == "class" else 1.0


def sum_gradients(params, group) -> None:
    """Every parameter's gradient summed over the ranks by one all-reduce
    (a parameter without one gets zeros first, as the engine's step gives
    quirk Q1's dead parameters)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if group is None:
        return
    flat = all_reduce_values(torch.cat([p.grad.reshape(-1) for p in params]), group,
                             "gradients")
    off = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[off: off + n].view_as(p))
        off += n


def _gather_rows(local: torch.Tensor, rb: RankBatch, group) -> torch.Tensor:
    """Every rank's rows of ``local [hi - lo, ...]`` in rank order,
    ``[num_graphs, ...]`` (ranges may differ by one row: each is padded to
    the longest for the gather)."""
    d = group_size(group)
    q, rem = divmod(rb.num_graphs, d)
    width = q + (1 if rem else 0)
    padded = local.new_zeros((width,) + tuple(local.shape[1:]))
    padded[: local.shape[0]] = local
    parts = all_gather_values(padded, group, "outputs")
    return torch.cat([parts[r, : q + (1 if r < rem else 0)] for r in range(d)])


class MeshSteps:
    """The train and eval steps of ``model`` on ``mesh``, for either
    placement of a batch. Both take this rank's batch on the model's device
    and return the global loss and the global predictions (``[G]``, or
    ``[G, classes]`` for a class task), detached.

    - A :class:`RankBatch` (graph-parallel, see the module docstring):
      this rank's masked loss sum over the global normalizer, the
      predictions gathered in rank order.
    - A halo batch (``parallel/halo.py``, ``halo=True``): every rank
      computes the same replicated loss and predictions, and runs its
      backward scaled by ``1 / D``; the collectives' backward sum the
      ranks' cotangents.

    Either way one all-reduce then sums the parameter gradients: the
    single-device gradient on every rank."""

    def __init__(self, model, optimizer, mesh: Mesh, task: str = "reg",
                 class_weights: Optional[torch.Tensor] = None,
                 transform_sigmoid: bool = False, halo: bool = False):
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.task = task
        self.class_weights = class_weights
        self.transform_sigmoid = transform_sigmoid
        self.halo = halo

    def _forward(self, batch, generator):
        """``(objective, loss, pred)``: this rank's term to differentiate,
        the global loss and the global predictions (not detached)."""
        floor = normalizer_floor(self.task)
        if self.halo:
            pred = self.model(batch, generator)
            num, den, p = loss_terms(self.task, pred, batch.y, batch.y_mask,
                                     self.class_weights, self.transform_sigmoid)
            loss = num / torch.clamp(den, min=floor)
            return loss / group_size(self.mesh.group), loss, p
        rb, local = batch, batch.batch
        pred = self.model(local, generator, dropout_rows=(rb.num_graphs, rb.lo))
        num, den, p = loss_terms(self.task, pred, local.y, local.y_mask, self.class_weights,
                                 self.transform_sigmoid)
        sums = all_reduce_values(torch.stack([num.detach(), den.detach()]), self.mesh.group,
                                 "loss")
        norm = torch.clamp(sums[1], min=floor)
        return num / norm, sums[0] / norm, _gather_rows(p.detach(), rb, self.mesh.group)

    def train(self, batch, generator: Optional[torch.Generator] = None):
        """One optimizer step on the global batch that ``batch`` is this
        rank's part of; the loss and predictions are those before the
        update."""
        with deterministic():
            self.model.train()
            self.optimizer.zero_grad(set_to_none=False)
            objective, loss, p = self._forward(batch, generator)
            objective.backward()
            sum_gradients(self.model.parameters(), self.mesh.group)
            self.optimizer.step()
            return loss.detach(), p.detach()

    def eval(self, batch):
        with torch.inference_mode(), deterministic():
            self.model.eval()
            _objective, loss, p = self._forward(batch, None)
            return loss, p


def make_sharded_train_step(model, optimizer, mesh: Mesh, task: str = "reg",
                            class_weights: Optional[torch.Tensor] = None,
                            transform_sigmoid: bool = False):
    """``step(rank_batch, generator) -> (loss, pred)``: one optimizer step
    over the graph-parallel mesh (:meth:`MeshSteps.train`)."""
    return MeshSteps(model, optimizer, mesh, task, class_weights, transform_sigmoid).train

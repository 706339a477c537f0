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
  targets, as ``train/losses.py`` normalizes), both summed in rank order
  from one all-gather (``collectives.sum_values``: the scanned pass sums
  the same terms over all its batches at once, and gets the same bits);
- backward, then the gradients summed by one all-reduce of all of them at
  once, then the optimizer step, identical on every rank;
- the global predictions, gathered in rank order, so that every rank sees
  the whole batch for its metrics, as JAX's replicated ``out_shardings``
  give it.

:class:`MeshSteps` also takes the halo layout's steps
(``parallel/halo.py``), which differ only in the loss's normalization and
in needing no gather of the predictions.

For scanned epochs on a mesh (``train/scan.py``; JAX's sharded
``lax.scan``) it also gives the step in parts, so that the gradient
all-reduce is the step's only collective, as in JAX: the loss normalizers
of a pass's batches, summed by one all-gather before its first step
(:meth:`MeshSteps.scan_normalizers`); per step the forward and backward on
this rank's graphs into one flat gradient buffer
(:meth:`MeshSteps.scan_gradients`), its all-reduce
(:meth:`MeshSteps.reduce_gradients`) and the update
(:meth:`MeshSteps.apply_gradients`); and after the last step the loss
numerators summed and the predictions gathered
(:meth:`MeshSteps.scan_finish`). The numbers are the looped step's.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeprank_gnn_tpu_torch.device import deterministic
from deeprank_gnn_tpu_torch.parallel.collectives import (
    all_gather_values,
    all_reduce_values,
    group_size,
    sum_values,
)
from deeprank_gnn_tpu_torch.parallel.mesh import Mesh, RankBatch


def _class_weights_of(y: torch.Tensor, y_mask: torch.Tensor,
                      class_weights: Optional[torch.Tensor], num_classes: int):
    """``(y_safe, w)``: the class indices clamped into range and each
    graph's weight in the cross-entropy (0 where masked)."""
    y_safe = torch.clamp(y.long(), 0, num_classes - 1)
    w = (torch.ones(y.shape, dtype=torch.float32, device=y.device) if class_weights is None
         else class_weights[y_safe])
    return y_safe, torch.where(y_mask, w, torch.zeros_like(w))


def loss_normalizer(task: str, y: torch.Tensor, y_mask: torch.Tensor,
                    class_weights: Optional[torch.Tensor], num_classes: int) -> torch.Tensor:
    """The normalizer of :func:`loss_terms` from the targets alone: the
    valid targets' count, or their class weights' sum."""
    if task == "class":
        return _class_weights_of(y, y_mask, class_weights, num_classes)[1].sum()
    return y_mask.sum().to(torch.float32)


def loss_terms(task: str, pred: torch.Tensor, y: torch.Tensor, y_mask: torch.Tensor,
               class_weights: Optional[torch.Tensor], transform_sigmoid: bool):
    """``(numerator, normalizer, pred)`` of the masked loss: MSE (``pred``
    reshaped to ``[G]``, optionally through a sigmoid) or class-weighted
    cross-entropy, as ``train/losses.py`` computes them; the loss is
    ``numerator / max(normalizer, floor)`` with :func:`normalizer_floor`."""
    if task == "class":
        logp = torch.log_softmax(pred, dim=-1)
        y_safe, w = _class_weights_of(y, y_mask, class_weights, pred.shape[-1])
        nll = -logp.gather(1, y_safe[:, None])[:, 0]
        return (w * nll).sum(), w.sum(), pred
    p = pred.reshape(-1)
    if transform_sigmoid:
        p = torch.sigmoid(p)
    sq = (p - y) ** 2
    return (torch.where(y_mask, sq, torch.zeros_like(sq)).sum(),
            loss_normalizer(task, y, y_mask, None, 1), p)


def normalizer_floor(task: str) -> float:
    return 1e-12 if task == "class" else 1.0


def gather_columns(local: torch.Tensor, num_graphs: int, group) -> torch.Tensor:
    """Every rank's graphs of ``local [B, hi - lo, ...]`` (this rank's
    range of ``B`` batches of ``num_graphs`` graphs) in rank order,
    ``[B, num_graphs, ...]``, by one all-gather (ranges may differ by one
    graph: each is padded to the longest for the gather)."""
    d = group_size(group)
    q, rem = divmod(num_graphs, d)
    width = q + (1 if rem else 0)
    padded = local.new_zeros((local.shape[0], width) + tuple(local.shape[2:]))
    padded[:, : local.shape[1]] = local
    parts = all_gather_values(padded, group, "outputs")
    return torch.cat([parts[r, :, : q + (1 if r < rem else 0)] for r in range(d)], dim=1)


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
        self._flat = None  # the flat gradients, one buffer for every step

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
        sums = sum_values(torch.stack([num.detach(), den.detach()]), self.mesh.group, "loss")
        norm = torch.clamp(sums[1], min=floor)
        return (num / norm, sums[0] / norm,
                gather_columns(p.detach()[None], rb.num_graphs, self.mesh.group)[0])

    def train(self, batch, generator: Optional[torch.Generator] = None):
        """One optimizer step on the global batch that ``batch`` is this
        rank's part of; the loss and predictions are those before the
        update."""
        with deterministic():
            self.model.train()
            self.optimizer.zero_grad(set_to_none=False)
            objective, loss, p = self._forward(batch, generator)
            objective.backward()
            self._flatten_gradients()
            self.reduce_gradients()
            self.apply_gradients()
            return loss.detach(), p.detach()

    def eval(self, batch):
        with torch.inference_mode(), deterministic():
            self.model.eval()
            _objective, loss, p = self._forward(batch, None)
            return loss, p

    # -- the scanned epoch's step (``train/scan.py``): the loss normalizers
    # of every batch are summed over the ranks before the epoch's first
    # step and the numerators after its last, so that the gradient
    # all-reduce is the step's only collective, as in JAX's sharded scan

    def scan_normalizers(self, y: torch.Tensor, y_mask: torch.Tensor,
                         num_classes: int) -> torch.Tensor:
        """``[B]``: each batch's global normalizer, clamped, from this
        rank's targets ``y [B, hi - lo]`` and ``y_mask``; one all-gather."""
        local = torch.stack([loss_normalizer(self.task, y[i], y_mask[i], self.class_weights,
                                             num_classes) for i in range(y.shape[0])])
        sums = sum_values(local, self.mesh.group, "loss")
        return torch.clamp(sums, min=normalizer_floor(self.task))

    def _scan_terms(self, rb: RankBatch, generator):
        pred = self.model(rb.batch, generator, dropout_rows=(rb.num_graphs, rb.lo))
        return loss_terms(self.task, pred, rb.batch.y, rb.batch.y_mask, self.class_weights,
                          self.transform_sigmoid)

    def scan_gradients(self, rb: RankBatch, generator, norm: torch.Tensor):
        """This rank's part of a scanned training step up to its
        collective: forward and backward of ``numerator / norm`` (``norm``:
        the batch's global normalizer), the gradients copied into one flat
        buffer (the same buffer at every call). Returns the loss numerator
        and this rank's predictions, detached."""
        self.optimizer.zero_grad(set_to_none=False)
        num, _den, p = self._scan_terms(rb, generator)
        (num / norm).backward()
        self._flatten_gradients()
        return num.detach(), p.detach()

    def _flatten_gradients(self) -> None:
        """Every parameter's gradient into the flat buffer (a parameter
        without one, quirk Q1's dead ones, gets zeros first, as the engine's
        step gives them)."""
        params = list(self.model.parameters())
        for q in params:
            if q.grad is None:
                q.grad = torch.zeros_like(q)
        flat = torch.cat([q.grad.reshape(-1) for q in params])
        if self._flat is None:
            self._flat = torch.empty_like(flat)
        self._flat.copy_(flat)

    def reduce_gradients(self) -> None:
        """The flat gradients summed over the ranks, in place (the step's
        one collective)."""
        if self.mesh.group is not None:
            self._flat.copy_(all_reduce_values(self._flat, self.mesh.group, "gradients"))

    def apply_gradients(self) -> None:
        """The flat gradients into the parameters' gradients, then the
        optimizer step."""
        off = 0
        for q in self.model.parameters():
            n = q.numel()
            q.grad.copy_(self._flat[off: off + n].view_as(q))
            off += n
        self.optimizer.step()

    def scan_eval(self, rb: RankBatch):
        """The loss numerator and this rank's predictions of ``rb``."""
        num, _den, p = self._scan_terms(rb, None)
        return num, p

    def scan_finish(self, nums: torch.Tensor, norms: torch.Tensor, preds: torch.Tensor,
                    num_graphs: int):
        """A scanned pass's global ``[B]`` losses and ``[B, num_graphs,
        ...]`` predictions from this rank's numerators and predictions: two
        all-gathers."""
        sums = sum_values(nums, self.mesh.group, "loss")
        return sums / norms, gather_columns(preds, num_graphs, self.mesh.group)


def make_sharded_train_step(model, optimizer, mesh: Mesh, task: str = "reg",
                            class_weights: Optional[torch.Tensor] = None,
                            transform_sigmoid: bool = False):
    """``step(rank_batch, generator) -> (loss, pred)``: one optimizer step
    over the graph-parallel mesh (:meth:`MeshSteps.train`)."""
    return MeshSteps(model, optimizer, mesh, task, class_weights, transform_sigmoid).train

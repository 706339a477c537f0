"""Scanned epochs: an epoch over the device store as replays of one step.

The port's counterpart of ``deeprank_gnn_tpu/train/scan.py``. The JAX
package rolls an epoch over its device store into one ``lax.scan``, so the
host dispatches one program per epoch and reads back one stacked (losses,
predictions) pair. Eager PyTorch has no such loop: the per-batch path
(``NeuralNet._run_pass``) dispatches a few hundred device operations per
batch from Python and reads every batch's loss and predictions back.

Here a step (the batch's gather from the store, the forward pass and, when
training, the backward pass and the Adam update) is captured once as a
``torch.cuda.CUDAGraph`` for each (store buffers, training, steps), kept
across epochs, and replayed:

- an epoch is a Python loop over its slot matrix (uploaded once): per
  replay, a device copy of the next ``steps`` slot rows into the graph's
  index buffer, the replay, and copies of its losses and predictions into
  the epoch's ``[B]`` and ``[B, ...]`` device buffers, which the host reads
  once, when the epoch (or, for ``scan_epochs="full"``, the run) ends;
- ``unroll`` captures that many consecutive steps in one graph; the
  batches left over take a graph of their own length;
- a capture executes nothing, so the first step of the first epoch of each
  (store buffers, training) runs eagerly on the capture stream, as the
  warm-up that capture needs: a real step of the epoch;
- dropout draws from the engine's generator, which is registered with each
  training graph: a replay draws what the eager step would have drawn and
  advances the generator as far;
- the optimizer is ``torch.optim.Adam(capturable=True)`` on a card (on both
  paths), whose step count and bias corrections live on the device.

The graphs bind the engine's parameters, gradients and optimizer state, the
store's matrices and the targets by address; all are updated in place, and
each graph keeps its store and targets alive. A capture or replay that
fails raises. On the CPU the same loop runs the steps eagerly, with the
same buffers and one readback.

On a mesh (``parallel/step.py``) a step also takes its batch's loss
normalizer (:meth:`EpochSteps.run`'s ``aux``) and issues the gradient
all-reduce. The backend decides how a card captures it: NCCL's all-reduce
is captured with the rest of the step (torch 2.11's ``ProcessGroupNCCL``
captures in the global mode); gloo stages CUDA tensors through the host,
which no graph can hold, so the step runs split (``split``): a graph up to
the flat gradients, the host's all-reduce, a graph of the update. Each
graph records the collective bytes counted while it was captured, beside
its launches. A graph that captured a collective keeps NCCL from
finalizing its communicator, so :class:`EpochSteps` then registers with
``parallel.distributed.hold_graphs`` and gives its graphs up
(:meth:`EpochSteps.release_graphs`) when the process leaves the group.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from time import perf_counter
from typing import Optional

import torch

from deeprank_gnn_tpu_torch.data.dense_batch import DenseGraphBatch
from deeprank_gnn_tpu_torch.data.device_store import PackedStore, gather_packed
from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
from deeprank_gnn_tpu_torch.parallel import distributed
from deeprank_gnn_tpu_torch.parallel.collectives import BYTES


def gather_store_batch(store: PackedStore, y_all: torch.Tensor,
                       idx: torch.Tensor) -> DenseGraphBatch:
    """The batch of store slots ``idx``, gathered on the store's device
    (JAX ``train/scan.py:36``). ``y_all`` holds the (class-remapped)
    targets of every slot on the device, so no step reads the host copy."""
    batch = gather_packed(store, idx)
    return dataclasses.replace(batch, y=y_all.index_select(0, idx))


@dataclasses.dataclass
class _Captured:
    graph: object
    steps: int  # steps one replay runs
    training: bool
    part: str  # "step", or "gradients" / "update" of a split step
    idx: Optional[torch.Tensor]  # [steps, batch_size] slot rows the replay reads
    aux: Optional[torch.Tensor]  # [steps] the steps' per-batch inputs
    loss: Optional[torch.Tensor]  # [steps] written by each replay
    pred: Optional[torch.Tensor]  # [steps, batch_size, ...]
    launches: Counter  # hand-kernel launches counted while capturing
    collective_bytes: Counter  # collective bytes counted while capturing
    inputs: tuple  # the store and targets the graph reads, kept alive
    replays: int = 0


class EpochSteps:
    """The steps of scanned epochs for one engine (JAX ``make_epoch_steps``
    and ``make_train_scan``, which share one step).

    ``step(store, y_all, idx, training[, aux]) -> (loss, pred)`` is the
    engine's step on the batch of slots ``idx`` (``aux``: the batch's entry
    of :meth:`run`'s ``aux``, when given). :meth:`run` runs an epoch of it
    and writes each batch's loss and predictions into device buffers.

    ``split``: ``(gradients, reduce, update)`` for a mesh whose collectives
    run on host copies (gloo on a card, ``parallel/collectives.py``), which
    no graph can capture. A training step is then ``gradients`` (the same
    arguments as ``step``: gather, forward, backward, the gradients into
    one flat buffer), ``reduce()`` (the all-reduce of that buffer, issued
    by the host) and ``update()`` (the buffer into the gradients and the
    optimizer step), and ``step`` must compute the same as the three in
    turn. On a card each training step is then two replays around the
    host's all-reduce, one graph of ``gradients`` per (store buffers) and
    one of ``update``, so ``unroll`` does not join training steps there.
    Without ``split`` (one device, or NCCL, whose all-reduce is captured
    with the rest) a training graph holds whole steps."""

    def __init__(self, step, *, unroll: int = 1, generator=None, split=None):
        self._step = step
        self.unroll = unroll
        self._generator = generator
        self.split = split
        self._graphs: dict = {}
        self._warm: set = set()
        self._stream = None
        # the last run: its steps per replay (the warm-up step counted as
        # one) and the seconds the host spent issuing them
        self.last_groups: list = []
        self.last_issue_s = 0.0

    def run(self, store: PackedStore, y_all: torch.Tensor, slots: torch.Tensor,
            training: bool, losses: torch.Tensor, preds: torch.Tensor,
            aux: Optional[torch.Tensor] = None) -> None:
        """Steps over the rows of ``slots [B, batch_size]`` (on the store's
        device), batch ``i``'s loss and predictions into ``losses[i]`` and
        ``preds[i]``, with ``aux[i]`` passed on to the step when ``aux``
        (``[B]``) is given. Reads nothing back. On the CPU each group of
        steps that a card replays as one graph runs eagerly."""
        t0 = perf_counter()
        cuda = slots.device.type == "cuda"
        split = training and self.split is not None
        inputs = (tuple((m.data_ptr(), tuple(m.shape)) for m in store.segments.values())
                  + ((y_all.data_ptr(), tuple(y_all.shape)),))
        groups, pos = [], 0
        if (inputs, training) not in self._warm:
            self._warm_up(store, y_all, slots, training, losses, preds, aux)
            self._warm.add((inputs, training))
            groups, pos = [1], 1
        while pos < slots.shape[0]:
            n = 1 if split else min(self.unroll, slots.shape[0] - pos)
            if cuda:
                replay = self._replay_split if split else self._replay
                replay(store, y_all, slots, training, losses, preds, aux, inputs, pos, n)
            else:
                for i in range(pos, pos + n):
                    losses[i], preds[i] = self._step(store, y_all, slots[i], training,
                                                     *_aux_at(aux, i))
            groups.append(n)
            pos += n
        self.last_groups = groups
        self.last_issue_s = perf_counter() - t0

    def _replay(self, store, y_all, slots, training, losses, preds, aux, inputs, pos, n) -> None:
        """Steps ``pos .. pos + n - 1`` as one replay of the graph of ``n``
        steps over these inputs, captured at first use."""
        key = (inputs, training, n, "step")
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._capture_steps(store, y_all, slots.shape[1], n, training, aux,
                                      self._step, "step")
            self._graphs[key] = cap
        self._feed(cap, slots, aux, pos, n)
        cap.graph.replay()
        cap.replays += 1
        losses[pos: pos + n].copy_(cap.loss)
        preds[pos: pos + n].copy_(cap.pred)

    def _replay_split(self, store, y_all, slots, training, losses, preds, aux, inputs, pos,
                      n) -> None:
        """Training step ``pos`` as a replay of its gradients' graph, the
        host's all-reduce, and a replay of the update's graph."""
        gradients, reduce, update = self.split
        key = (inputs, True, 1, "gradients")
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._capture_steps(store, y_all, slots.shape[1], 1, True, aux, gradients,
                                      "gradients")
            self._graphs[key] = cap
        upd = self._graphs.get("update")
        if upd is None:
            upd = self._graphs["update"] = self._capture(update, 1, True, "update", None,
                                                         None, (), register=False)
        self._feed(cap, slots, aux, pos, 1)
        cap.graph.replay()
        cap.replays += 1
        reduce()
        upd.graph.replay()
        upd.replays += 1
        losses[pos: pos + 1].copy_(cap.loss)
        preds[pos: pos + 1].copy_(cap.pred)

    @staticmethod
    def _feed(cap: _Captured, slots, aux, pos: int, n: int) -> None:
        cap.idx.copy_(slots[pos: pos + n])
        if cap.aux is not None:
            cap.aux.copy_(aux[pos: pos + n])

    def _capture_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def _warm_up(self, store, y_all, slots, training, losses, preds, aux) -> None:
        """The epoch's first step, eagerly (on a card, on the capture
        stream)."""
        if slots.device.type != "cuda":
            losses[0], preds[0] = self._step(store, y_all, slots[0], training, *_aux_at(aux, 0))
            return
        stream = self._capture_stream()
        current = torch.cuda.current_stream()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            losses[0], preds[0] = self._step(store, y_all, slots[0], training, *_aux_at(aux, 0))
        current.wait_stream(stream)

    def _capture_steps(self, store, y_all, batch_size: int, n: int, training: bool, aux,
                       step, part: str) -> _Captured:
        """Capture ``n`` consecutive calls of ``step`` reading their slots
        (and per-batch inputs) from one index buffer."""
        idx = torch.zeros((n, batch_size), dtype=torch.int64, device=y_all.device)
        aux_buf = None if aux is None else torch.zeros(n, dtype=aux.dtype, device=aux.device)

        def body():
            outs = [step(store, y_all, idx[j], training, *_aux_at(aux_buf, j))
                    for j in range(n)]
            return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

        return self._capture(body, n, training, part, idx, aux_buf, (store, y_all),
                             register=training)

    def _capture(self, body, n: int, training: bool, part: str, idx, aux_buf, inputs,
                 register: bool) -> _Captured:
        """Capture ``body()`` (``(loss, pred)``, or None); records the
        hand-kernel launches and the collective bytes counted meanwhile
        (each runs at every replay)."""
        graph = torch.cuda.CUDAGraph()
        if register and self._generator is not None:
            graph.register_generator_state(self._generator)
        launches_before, bytes_before = Counter(LAUNCHES), Counter(BYTES)
        with torch.cuda.graph(graph, stream=self._capture_stream()):
            loss, pred = body() or (None, None)
        launches, nbytes = Counter(LAUNCHES), Counter(BYTES)
        launches.subtract(launches_before)
        nbytes.subtract(bytes_before)
        if +nbytes:
            distributed.hold_graphs(self)
        return _Captured(graph=graph, steps=n, training=training, part=part, idx=idx,
                         aux=aux_buf, loss=loss, pred=pred, launches=+launches,
                         collective_bytes=+nbytes, inputs=inputs)

    def graph_stats(self) -> list:
        """Per captured graph: its steps, whether it trains, its part of
        the step, the hand-kernel launches and collective bytes of one
        replay, and its replays so far."""
        return [{"steps": cap.steps, "training": cap.training, "part": cap.part,
                 "launches": dict(cap.launches),
                 "collective_bytes": dict(cap.collective_bytes), "replays": cap.replays}
                for cap in self._graphs.values()]

    def reset_replays(self) -> None:
        for cap in self._graphs.values():
            cap.replays = 0

    def release_graphs(self) -> None:
        """Drop every captured graph (a later run warms up and captures
        anew): ``parallel.distributed.shutdown`` calls it before the
        process group goes, since NCCL cannot finalize a communicator that
        a live graph's collectives still reference."""
        self._graphs.clear()
        self._warm.clear()


def _aux_at(aux, i: int) -> tuple:
    """The step's extra argument for batch ``i``: none without ``aux``."""
    return () if aux is None else (aux[i],)

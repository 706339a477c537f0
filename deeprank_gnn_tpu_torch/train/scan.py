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
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from time import perf_counter

import torch

from deeprank_gnn_tpu_torch.data.dense_batch import DenseGraphBatch
from deeprank_gnn_tpu_torch.data.device_store import PackedStore, gather_packed
from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES


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
    idx: torch.Tensor  # [steps, batch_size] slot rows the replay reads
    loss: torch.Tensor  # [steps] written by each replay
    pred: torch.Tensor  # [steps, batch_size, ...]
    launches: Counter  # hand-kernel launches counted while capturing
    inputs: tuple  # the store and targets the graph reads, kept alive
    replays: int = 0


class EpochSteps:
    """The steps of scanned epochs for one engine (JAX ``make_epoch_steps``
    and ``make_train_scan``, which share one step).

    ``step(store, y_all, idx, training) -> (loss, pred)`` is the engine's
    step on the batch of slots ``idx``. :meth:`run` runs an epoch of it and
    writes each batch's loss and predictions into device buffers."""

    def __init__(self, step, *, unroll: int = 1, generator=None):
        self._step = step
        self.unroll = unroll
        self._generator = generator
        self._graphs: dict = {}
        self._warm: set = set()
        self._stream = None
        # the last run: its steps per replay (the warm-up step counted as
        # one) and the seconds the host spent issuing them
        self.last_groups: list = []
        self.last_issue_s = 0.0

    def run(self, store: PackedStore, y_all: torch.Tensor, slots: torch.Tensor,
            training: bool, losses: torch.Tensor, preds: torch.Tensor) -> None:
        """Steps over the rows of ``slots [B, batch_size]`` (on the store's
        device), batch ``i``'s loss and predictions into ``losses[i]`` and
        ``preds[i]``. Reads nothing back. On the CPU each group of steps
        that a card replays as one graph runs eagerly."""
        t0 = perf_counter()
        cuda = slots.device.type == "cuda"
        inputs = (tuple((m.data_ptr(), tuple(m.shape)) for m in store.segments.values())
                  + ((y_all.data_ptr(), tuple(y_all.shape)),))
        groups, pos = [], 0
        if (inputs, training) not in self._warm:
            self._warm_up(store, y_all, slots, training, losses, preds)
            self._warm.add((inputs, training))
            groups, pos = [1], 1
        while pos < slots.shape[0]:
            n = min(self.unroll, slots.shape[0] - pos)
            if cuda:
                self._replay(store, y_all, slots, training, losses, preds, inputs, pos, n)
            else:
                for i in range(pos, pos + n):
                    losses[i], preds[i] = self._step(store, y_all, slots[i], training)
            groups.append(n)
            pos += n
        self.last_groups = groups
        self.last_issue_s = perf_counter() - t0

    def _replay(self, store, y_all, slots, training, losses, preds, inputs, pos, n) -> None:
        """Steps ``pos .. pos + n - 1`` as one replay of the graph of ``n``
        steps over these inputs, captured at first use."""
        cap = self._graphs.get((inputs, training, n))
        if cap is None:
            cap = self._capture(store, y_all, slots.shape[1], n, training)
            self._graphs[(inputs, training, n)] = cap
        cap.idx.copy_(slots[pos: pos + n])
        cap.graph.replay()
        cap.replays += 1
        losses[pos: pos + n].copy_(cap.loss)
        preds[pos: pos + n].copy_(cap.pred)

    def _capture_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def _warm_up(self, store, y_all, slots, training, losses, preds) -> None:
        """The epoch's first step, eagerly (on a card, on the capture
        stream)."""
        if slots.device.type != "cuda":
            losses[0], preds[0] = self._step(store, y_all, slots[0], training)
            return
        stream = self._capture_stream()
        current = torch.cuda.current_stream()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            losses[0], preds[0] = self._step(store, y_all, slots[0], training)
        current.wait_stream(stream)

    def _capture(self, store, y_all, batch_size: int, n: int, training: bool) -> _Captured:
        """Capture ``n`` consecutive steps reading their slots from one
        index buffer; records the hand-kernel launches counted meanwhile
        (each runs at every replay)."""
        idx = torch.zeros((n, batch_size), dtype=torch.int64, device=y_all.device)
        graph = torch.cuda.CUDAGraph()
        if training and self._generator is not None:
            graph.register_generator_state(self._generator)
        before = Counter(LAUNCHES)
        with torch.cuda.graph(graph, stream=self._capture_stream()):
            outs = [self._step(store, y_all, idx[j], training) for j in range(n)]
            loss = torch.stack([o[0] for o in outs])
            pred = torch.stack([o[1] for o in outs])
        launches = Counter(LAUNCHES)
        launches.subtract(before)
        return _Captured(graph=graph, idx=idx, loss=loss, pred=pred,
                         launches=+launches, inputs=(store, y_all))

    def graph_stats(self) -> list:
        """Per captured graph: its steps, whether it trains, the hand-kernel
        launches of one replay and its replays so far."""
        return [{"steps": n, "training": training, "launches": dict(cap.launches),
                 "replays": cap.replays}
                for (_inputs, training, n), cap in self._graphs.items()]

    def reset_replays(self) -> None:
        for cap in self._graphs.values():
            cap.replays = 0

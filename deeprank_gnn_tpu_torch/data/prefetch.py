"""Background host collation feeding asynchronous copies to the card.

The port's counterpart of ``deeprank_gnn_tpu/data/prefetch.py``. A worker
thread iterates the loader (HDF5 reads and numpy collation) and, for a
CUDA target, pins each batch in page-locked memory (a sparse ``GraphBatch``
or a ``DenseGraphBatch``: both move all their tensors with ``pin_memory``
and ``to``); the consuming thread
starts the ``non_blocking`` copy on its current stream and yields the
batch. The copy and the kernels that read the batch are ordered on that
one stream, so no event is needed; PyTorch's pinned-memory allocator keeps
the host buffer alive until the copy has run. While the card works on
batch k, the worker collates batch k+1. A device-store batch
(``data/device_store.py``) is gathered on the card by the worker, on the
same default stream; only its host-side ``y`` and ``y_mask`` are pinned and
copied, the rest is not copied again.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import torch

_SENTINEL = object()


class PrefetchIterator:
    """Wrap a ``(batch, meta)`` iterable of CPU batches; yields
    ``(batch on device, meta)``."""

    def __init__(self, iterable: Iterable, device: torch.device, size: int = 2):
        self._iterable = iterable
        self._device = torch.device(device)
        self._size = size

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._size)
        stop = threading.Event()
        err: list = []
        pin = self._device.type == "cuda"

        def put(item) -> bool:
            # blocks while the queue is full, gives up once the consumer
            # has stopped (a consumer that breaks early never drains it)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def collator():
            try:
                for batch, meta in self._iterable:
                    if pin:
                        batch = batch.pin_memory()
                    if not put((batch, meta)):
                        return
            except Exception as exc:  # surfaced in the consumer thread
                err.append(exc)
            finally:
                put(_SENTINEL)

        worker = threading.Thread(target=collator, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                batch, meta = item
                yield batch.to(self._device, non_blocking=pin), meta
        finally:
            stop.set()
            worker.join()
        if err:
            raise err[0]


def prefetch(loader, device, size: int = 2) -> PrefetchIterator:
    return PrefetchIterator(loader, device=device, size=size)

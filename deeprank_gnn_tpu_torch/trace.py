"""Spans: where the host's time goes in the engine, the store and the loader.

``span(name, **counts)`` times a block of host work::

    with trace.span("pass", graphs=2048) as sp:
        ...
        sp.add(steps=16)

It records the name, the start and end (``time.perf_counter_ns``), the
thread and up to three integer counts; spans of one thread nest, so the
reading gives each span its parent (the innermost span of its thread that
encloses it) and its root (the outermost: every span of one pass shares the
pass's id). Recording is always on and costs a few microseconds a pass; the
records go into a fixed ring of :data:`CAPACITY` spans (9.4 MB), so a long
run keeps its newest spans and no more.

While a ``torch.profiler`` recording is active, each span is also a range
of host work in the profiler's trace (``RecordFunctionFast``, the kind of
range ``record_function`` makes without its user-annotation scope, so
operations in it stay host operations), on the clock of the device's
kernels: ``NeuralNet.train(profile=dir)`` shows the engine's phases beside
the kernels they wait on. Without a profiler no range is entered.

The spans the port records:

- ``pass`` (counts ``graphs``, ``steps``, ``accumulated``: the elements
  its steps summed in ``ops/lanes.py``'s index accumulation, replays
  included): one ``NeuralNet._run_pass``
  (a training epoch or an ``eval``/``test`` pass); a scanned pass holds
  ``pass.plan`` (the epoch's slot matrix, the targets and the buffers on
  the device), ``pass.issue`` (``EpochSteps.run``, counts ``replays``,
  ``captures``, ``warmups``), ``pass.readback`` (the host's wait for the
  losses and predictions) and ``pass.collect`` (the host's bookkeeping);
- ``store.build`` (counts ``graphs``, ``bytes``): the device store's build,
  holding ``store.collate``, ``store.pack`` and ``store.upload``;
- ``store.operators``: one graph's operator fields in a dense collation;
- ``loader.plan``: one graph's pooling plan.

:func:`passes` and :func:`trees` read the newest spans back in a running
process, each with its self time (its duration less its children's).
"""

from __future__ import annotations

import dataclasses
import itertools
import struct
import threading
from collections import defaultdict, namedtuple
from threading import get_ident
from time import perf_counter_ns

import numpy as np
import torch

# spans held: 26,214 scanned passes of five spans
CAPACITY = 1 << 17
MAX_COUNTS = 3
_PROFILED, _COUNTED = 1, 2
# a span's row: id, start, end (int64), thread (uint64), name key << 2 | flags
# (uint32); then, for a span with counts, their keys (uint32) and values
# (int64)
_HEAD = struct.Struct("<3qQI")
_COUNTS = struct.Struct(f"<{MAX_COUNTS}I{MAX_COUNTS}q")
_ROW_SIZE = _HEAD.size + _COUNTS.size
_DTYPE = np.dtype(
    [("id", "<i8"), ("start", "<i8"), ("end", "<i8"), ("thread", "<u8"), ("name", "<u4")]
    + [(f"k{i}", "<u4") for i in range(MAX_COUNTS)] + [(f"v{i}", "<i8") for i in range(MAX_COUNTS)])
assert _DTYPE.itemsize == _ROW_SIZE

# one C call: whether a torch.profiler recording is active
_profiler_enabled = torch._C._autograd._profiler_enabled

Span = namedtuple("Span", "id name start_ns end_ns duration_ns self_ns parent root profiled "
                          "counts")
Span.__doc__ = """A finished span: ``parent`` 0 at the top of its thread,
``root`` the id of the outermost span it ran in (its own at the top),
``profiled`` whether a profiler was recording when it started."""


@dataclasses.dataclass(frozen=True)
class Tree:
    """A span and the spans it encloses, in start order (the span first)."""

    spans: tuple

    @property
    def span(self) -> Span:
        return self.spans[0]

    @property
    def profiled(self) -> bool:
        """Whether a profiler recorded any of its spans."""
        return any(s.profiled for s in self.spans)

    @property
    def captured(self) -> bool:
        """Whether it captured a CUDA graph."""
        return any(s.counts.get("captures", 0) for s in self.spans)

    @property
    def warmup(self) -> bool:
        """Whether it ran an eager warm-up step."""
        return any(s.counts.get("warmups", 0) for s in self.spans)

    def ns(self, name: str, own: bool = False) -> int:
        """Nanoseconds in its spans named ``name``: their durations, or
        with ``own`` their self times."""
        return sum(s.self_ns if own else s.duration_ns for s in self.spans if s.name == name)


class _Open:
    """A span being recorded; what ``span()`` returns."""

    __slots__ = ("_rec", "_range", "name", "counts", "id", "flags", "start_ns", "end_ns")

    def __init__(self, rec, name: str, counts: dict):
        self._rec, self.name, self.counts = rec, name, counts

    def add(self, **counts) -> None:
        """Set counts known only inside the span."""
        self.counts.update(counts)

    @property
    def seconds(self) -> float:
        """The finished span's duration."""
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self):
        self.id = next(self._rec._ids)
        if _profiler_enabled():
            self.flags = _PROFILED
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        else:
            self.flags = 0
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = self.end_ns = perf_counter_ns()
        flags = self.flags
        if flags:
            self._range.__exit__(None, None, None)
        rec, i = self._rec, self.id
        at = i % rec.capacity * _ROW_SIZE
        key = rec._key_of.get(self.name) or rec._key(self.name)
        if self.counts:
            _COUNTS.pack_into(rec._buf, at + _HEAD.size, *rec._counts(self.counts))
            flags |= _COUNTED
        _HEAD.pack_into(rec._buf, at, i, self.start_ns, end, get_ident(), key << 2 | flags)


class Recorder:
    """A ring of the newest ``capacity`` finished spans, shared by the
    process's threads."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._buf = bytearray(capacity * _ROW_SIZE)
        self._ids = itertools.count(1)  # next() is atomic under the interpreter lock
        self._names = [""]
        self._key_of = {}
        self._count_keys = {}
        self._lock = threading.Lock()

    @property
    def nbytes(self) -> int:
        return len(self._buf)

    def span(self, name: str, **counts) -> _Open:
        """A context manager timing its block as the span ``name``."""
        return _Open(self, name, counts)

    def _key(self, name: str) -> int:
        key = self._key_of.get(name)
        if key is None:
            with self._lock:
                key = self._key_of.setdefault(name, len(self._names))
                if key == len(self._names):
                    self._names.append(name)
        return key

    def _counts(self, counts: dict) -> tuple:
        """``counts`` as the row's keys, then its values, zero-padded."""
        pad = MAX_COUNTS - len(counts)
        if pad < 0:
            raise ValueError(f"a span has more than {MAX_COUNTS} counts: {counts}")
        keys = self._count_keys.get(tuple(counts))
        if keys is None:
            keys = self._count_keys[tuple(counts)] = (
                tuple(self._key(k) for k in counts) + (0,) * pad)
        return (*keys, *counts.values(), *(0,) * pad)

    def spans(self) -> list:
        """Every finished span held, oldest first, each with its parent,
        root and self time."""
        rows = np.frombuffer(bytes(self._buf), dtype=_DTYPE)
        rows = rows[rows["id"] > 0]
        rows = rows[np.lexsort((rows["id"], rows["thread"]))].tolist()
        names = self._names
        out, covered = [], defaultdict(int)
        open_, thread = [], None
        for r in rows:
            i, start, end = r[0], r[1], r[2]
            if r[3] != thread:
                open_, thread = [], r[3]
            # the spans of a thread nest: those still open at this start enclose it
            while open_ and open_[-1][1] <= start:
                open_.pop()
            parent, root = (open_[-1][0], open_[0][0]) if open_ else (0, i)
            open_.append((i, end))
            covered[parent] += end - start
            counts = {}
            if r[4] & _COUNTED:
                counts = {names[r[5 + k]]: r[5 + MAX_COUNTS + k] for k in range(MAX_COUNTS)
                          if r[5 + k]}
            out.append([i, names[r[4] >> 2], start, end, end - start, 0, parent, root,
                        bool(r[4] & _PROFILED), counts])
        out.sort()
        for o in out:
            o[5] = o[4] - covered[o[0]]
        return [Span(*o) for o in out]

    def trees(self, name: str) -> list:
        """Each finished span named ``name`` that is held, with the spans
        it encloses, oldest first."""
        spans = self.spans()
        children = defaultdict(list)
        for s in spans:
            children[s.parent].append(s)
        out = []
        for s in spans:
            if s.name != name:
                continue
            found, todo = [], [s]
            while todo:
                t = todo.pop()
                found.append(t)
                todo += children[t.id]
            out.append(Tree(tuple(sorted(found, key=lambda t: t.id))))
        return out

    def passes(self) -> list:
        """The engine's passes held (``pass`` spans), oldest first."""
        return self.trees("pass")


RECORDER = Recorder()
span = RECORDER.span
spans = RECORDER.spans
trees = RECORDER.trees
passes = RECORDER.passes

"""Accumulation and row gathers that keep a batch's padding lanes apart.

Under ``torch.use_deterministic_algorithms(True)`` (``device.deterministic``)
an accumulating op on a card (``index_add_``, ``index_put_`` with
``accumulate=True``, ``scatter_add_``, ``scatter_reduce_`` and the backward
of ``index_select``) sorts its indices and then sums each run of equal
indices serially. Every padding lane of a padded batch carries one sentinel
index, so a dump row of the usual kind (``out[n]``, sliced off) makes the
batch's whole padding one run: tens of thousands of serial adds of zeros.

The port's rule: no accumulating op sees a run of padding lanes. A lane
whose index lies outside ``[0, n)`` goes to a row of its own, ``n + lane``,
in a buffer of ``n + L`` rows, and the ``L`` rows past ``n`` are sliced off.
The shapes stay fixed and nothing syncs with the host, so the same code runs
inside a captured CUDA graph. The real rows receive the same values in the
same order as before (a stable sort keeps the lanes' order within a run, and
the padding lanes sort after every real row either way), so their sums are
bitwise unchanged.

``ACCUMULATED`` counts what :func:`index_add_rows` accumulates: per call its
``lanes`` (``L``) and its ``elements`` (``L`` times the columns). The counts
come from shapes alone, with no host sync, so a call counts while a CUDA
graph is captured too; ``train/scan.py`` moves a captured call's counts to
its graph and adds them again at each replay, so the counter holds what ran.
A hand kernel's plain version does not count (``counted=False``, or its calls
inside :func:`not_counted`): on a card the kernel runs in its place and
accumulates nothing here.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Optional

import torch

ACCUMULATED: Counter = Counter()
_counting = True


@contextlib.contextmanager
def not_counted():
    """:func:`index_add_rows` counts nothing inside the block (a hand
    kernel's plain version built from the counted ops)."""
    global _counting
    was, _counting = _counting, False
    try:
        yield
    finally:
        _counting = was


def lane_rows(index: torch.Tensor, n: int, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 row of each lane of ``index [L]`` in an ``[n + L]``-row buffer:
    a valid lane (by default: an index in ``[0, n)``) keeps its index, any
    other lane gets ``n + lane``, a row of its own."""
    if valid is None:
        valid = (index >= 0) & (index < n)
    lanes = torch.arange(index.shape[0], dtype=torch.int64, device=index.device)
    return torch.where(valid, index.long(), n + lanes)


def index_add_rows(values: torch.Tensor, index: torch.Tensor, n: int,
                   valid: Optional[torch.Tensor] = None, counted: bool = True) -> torch.Tensor:
    """``out[r] = sum of values[l] over the valid lanes l with index[l] == r``,
    for ``r`` in ``[0, n)``, in lane order; ``values [L, ...]``, ``index
    [L]``. An invalid lane (see :func:`lane_rows`) drops out. Counted in
    :data:`ACCUMULATED` unless ``counted`` is False (a kernel's plain
    version)."""
    if counted and _counting:
        ACCUMULATED["lanes"] += values.shape[0]
        ACCUMULATED["elements"] += values.numel()
    out = values.new_zeros((n + values.shape[0],) + tuple(values.shape[1:]))
    out.index_add_(0, lane_rows(index, n, valid), values)
    return out[:n]


class RowGather(torch.autograd.Function):
    """``data.index_select(0, index)`` for an ``index`` already clamped into
    ``[0, n)``, over ``groups`` equal groups of rows (the graphs of a dense
    batch; 1 otherwise) and as many equal groups of lanes. Its backward
    gives the same gradient as autograd's, without a run of padding lanes:
    each valid lane's cotangent is added at its row (:func:`index_add_rows`),
    and a padding lane (not ``valid``), which read the first or the last row
    of its group, reaches that row through a masked sum over the group's
    lanes. The paths' masks make those cotangents 0."""

    @staticmethod
    def forward(ctx, data, index, valid, groups):
        ctx.save_for_backward(index, valid)
        ctx.rows, ctx.groups = data.shape[0], groups
        return data.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        index, valid = ctx.saved_tensors
        g = ctx.groups
        s = ctx.rows // g
        out = index_add_rows(grad, index, ctx.rows, valid)
        pad = (~valid).reshape(g, -1, 1)
        last = pad & (index.reshape(g, -1, 1) % s == s - 1)
        lanes = grad.reshape(g, pad.shape[1], -1)
        zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
        ends = out.view(g, s, -1)
        ends[:, 0] += torch.where(pad & ~last, lanes, zero).sum(dim=1)
        ends[:, s - 1] += torch.where(last, lanes, zero).sum(dim=1)
        return out, None, None, None


def needs_grad(t: torch.Tensor) -> bool:
    """Whether autograd will record an op on ``t``: only then does an op
    here need what its backward reads (the valid lanes, a pool's ties)."""
    return torch.is_grad_enabled() and t.requires_grad


def gather_rows(data: torch.Tensor, index: torch.Tensor,
                valid: Optional[torch.Tensor] = None, groups: int = 1) -> torch.Tensor:
    """Rows of ``data [n, ...]`` at ``index [L]``; a lane outside ``[0, n)``,
    or not ``valid`` where that is given, is padding and reads the clamped
    row. With ``groups`` (``n`` and ``L`` both split into that many equal
    groups, lane group k indexing row group k) ``index`` must already lie
    in its group, and ``valid`` must be given where ``data`` needs a
    gradient. The gradient is autograd's, without a run of padding lanes
    (:class:`RowGather`). Without a gradient this is ``index_select``."""
    n = data.shape[0]
    idx = torch.clamp(index, 0, max(n - 1, 0)) if groups == 1 else index
    if not needs_grad(data):
        return data.index_select(0, idx)
    if valid is None:
        valid = (index >= 0) & (index < n)
    return RowGather.apply(data, idx, valid, groups)

"""The dense layout's edge-to-slot ops at ``bench.py``'s atomic per-graph
shapes, on the CPU.

``edge_sum_to_slots``, ``edge_count_to_slots``, ``edge_mean_to_slots`` and
``dense_segment_softmax`` (``deeprank_gnn_tpu_torch/ops/dense.py``) at a
batch of 64 graphs of 30,080 edge lanes, into 5,216 slots (conv1's
run-padded nodes) and 28,416 (the pooled edges), with the last quarter of
every graph's lanes padding:

- against a numpy reference that sums in edge order (``np.add.at``, and
  ``np.maximum.at`` for the softmax's shift): the sums, counts and means
  bitwise, the softmax at rtol 2e-4, atol 1e-5 (its ``exp`` is numpy's);
- each op, forward and backward, first runs on the ``meta`` device under a
  dispatch mode that records every tensor an op makes: none may be larger
  than the flattened sum's buffer, ``(G * E + G * size) * F`` values. The
  JAX package's one-hot form would make ``[G, E, size]`` ones, 219 GB at
  the pooled edges' size;
- the softmax with an all-padding graph and empty slots: JAX's NaN guards
  give finite weights and gradients, 0 at every padding lane.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeprank_gnn_tpu_torch.ops import dense as D

G, E = 64, 30080
SIZES = (5216, 28416)
TOL = dict(rtol=2e-4, atol=1e-5)


class LargestTensor(TorchDispatchMode):
    """Records the most elements of any tensor an op returns under it."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def largest_tensor(fn, value_shape, size: int) -> int:
    """The largest tensor ``fn(values, idx, size)`` and its backward make,
    run on the ``meta`` device (shapes only, no memory)."""
    values = torch.zeros(value_shape, device="meta", requires_grad=True)
    idx = torch.zeros((G, E), dtype=torch.int32, device="meta")
    with LargestTensor() as mode:
        fn(values, idx, size).sum().backward()
    return mode.numel


def slots(size: int, seed: int) -> np.ndarray:
    """Per-graph slot indices [G, E]: the last quarter of each graph's lanes
    padding (the sentinel ``size``)."""
    idx = np.random.default_rng(seed).integers(0, size, (G, E)).astype(np.int32)
    idx[:, E - E // 4:] = size
    return idx


def flat_ids(idx: np.ndarray, size: int) -> np.ndarray:
    """Flattened slot ids, padding at ``G * size`` (a row sliced off)."""
    return np.where(idx < size, idx + np.arange(G)[:, None] * size, G * size).reshape(-1)


def np_sum(values: np.ndarray, idx: np.ndarray, size: int) -> np.ndarray:
    """Sums in edge order: ``np.add.at`` over the flattened ids."""
    f = values.shape[-1]
    out = np.zeros((G * size + 1, f), np.float32)
    np.add.at(out, flat_ids(idx, size), values.reshape(-1, f))
    return out[:-1].reshape(G, size, f)


def np_count(idx: np.ndarray, size: int) -> np.ndarray:
    out = np.zeros(G * size + 1, np.float32)
    np.add.at(out, flat_ids(idx, size), np.float32(1))
    return out[:-1].reshape(G, size)


def np_softmax(logits: np.ndarray, idx: np.ndarray, size: int) -> np.ndarray:
    """JAX's ``dense_segment_softmax`` in numpy, sums and maxes by slot in
    edge order, with its guards."""
    flat = flat_ids(idx, size)
    shift = np.full(G * size + 1, -np.inf, np.float32)
    np.maximum.at(shift, flat, logits.reshape(-1))
    shift = np.where(np.isfinite(shift), shift, np.float32(0))
    valid = idx < size
    shifted = np.where(valid, logits - shift[flat].reshape(G, E), np.float32(0))
    expv = np.where(valid, np.exp(shifted), np.float32(0)).astype(np.float32)
    denom = np.zeros(G * size + 1, np.float32)
    np.add.at(denom, flat, expv.reshape(-1))
    denom = np.where(denom > 0, denom, np.float32(1))
    denom[G * size] = 1.0
    return expv / denom[flat].reshape(G, E)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("f", [1, 32])
def test_edge_sum_bitwise_edge_order(size, f):
    assert largest_tensor(D.edge_sum_to_slots, (G, E, f), size) <= (G * E + G * size) * f
    idx = slots(size, size + f)
    values = np.random.default_rng(f).standard_normal((G, E, f)).astype(np.float32)
    got = D.edge_sum_to_slots(torch.from_numpy(values), torch.from_numpy(idx), size)
    assert got.shape == (G, size, f)
    np.testing.assert_array_equal(got.numpy(), np_sum(values, idx, size))


@pytest.mark.parametrize("size", SIZES)
def test_edge_count_bitwise(size):
    count = lambda v, i, s: D.edge_count_to_slots(i, s) + v.sum()  # noqa: E731
    assert largest_tensor(count, (1,), size) <= G * E + G * size
    idx = slots(size, size)
    got = D.edge_count_to_slots(torch.from_numpy(idx), size)
    assert got.dtype == torch.float32 and got.shape == (G, size)
    np.testing.assert_array_equal(got.numpy(), np_count(idx, size))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("f", [1, 32])
def test_edge_mean_bitwise_edge_order(size, f):
    assert largest_tensor(D.edge_mean_to_slots, (G, E, f), size) <= (G * E + G * size) * f
    idx = slots(size, size + 2 * f)
    values = np.random.default_rng(2 * f).standard_normal((G, E, f)).astype(np.float32)
    got = D.edge_mean_to_slots(torch.from_numpy(values), torch.from_numpy(idx), size)
    want = np_sum(values, idx, size) / np.maximum(np_count(idx, size), 1)[..., None]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", SIZES)
def test_softmax_matches_edge_order_reference_with_guards(size):
    softmax = lambda v, i, s: D.dense_segment_softmax(v[..., 0], i, s)  # noqa: E731
    assert largest_tensor(softmax, (G, E, 1), size) <= G * E + G * size
    idx = slots(size, 3 * size)
    idx[0] = size  # a graph all padding
    rng = np.random.default_rng(size)
    # large logits: without the shift exp would overflow
    logits = (rng.standard_normal((G, E)) * 30).astype(np.float32)
    logits[:, E - E // 4:] = 1e30  # a huge logit at every padding lane
    assert (np_count(idx, size)[1:] == 0).any()  # empty slots in the real graphs
    x = torch.from_numpy(logits).requires_grad_(True)
    got = D.dense_segment_softmax(x, torch.from_numpy(idx), size)
    cot = torch.from_numpy(rng.standard_normal((G, E)).astype(np.float32))
    (got * cot).sum().backward()
    w = got.detach().numpy()
    assert np.isfinite(w).all() and np.isfinite(x.grad.numpy()).all()
    pad = idx >= size
    assert not w[pad].any() and not x.grad.numpy()[pad].any()
    np.testing.assert_allclose(w, np_softmax(logits, idx, size), **TOL)
    # each populated slot's weights sum to 1
    sums = np_sum(w[..., None], idx, size)[..., 0]
    populated = np_count(idx, size) > 0
    np.testing.assert_allclose(sums[populated], 1.0, **TOL)

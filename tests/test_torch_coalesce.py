"""PyTorch port vs JAX package: edge coalescing, on-line clustering and the
``ops`` exports.

- ``coalesce_edges`` on the same padded edge lists (duplicates, self-loops,
  padding lanes) up to E = 4,096 and N = 5,000, so keys pass 2^24: indices
  and mask bitwise, attributes at rtol 2e-4 and atol 1e-5. On the CPU its
  attribute sums are K1's plain version; ``chip_smoke.py`` holds the kernel
  bitwise to it on the card.
- ``community_pooling``, ``community_detection``,
  ``community_detection_per_batch``, ``get_preloaded_cluster`` and
  ``graclus_cluster``: cluster ids and pooled edges bitwise, pooled values
  within tolerance.
- ``segment_min`` and ``community_pooling_pos``; the ``ops`` export list.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = dict(rtol=2e-4, atol=1e-5)


def padded_edges(rng, e, n, f, valid_frac=0.8, self_frac=0.1, dup_frac=0.3):
    """``[2, E]`` int32 endpoints in ``[0, n)`` with duplicate pairs and
    self-loops, a validity mask with trailing and scattered padding, and
    ``[E, F]`` float32 attributes."""
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    dup = rng.random(e) < dup_frac
    take = rng.integers(0, e, e)
    src[dup], dst[dup] = src[take[dup]], dst[take[dup]]
    loops = rng.random(e) < self_frac
    dst[loops] = src[loops]
    src[: min(e, 8)] = n - 1  # the largest keys
    mask = rng.random(e) < valid_frac
    mask[int(0.9 * e):] = False
    index = np.stack([src, dst]).astype(np.int32)
    index[:, ~mask] = n  # padding endpoints, as the collate writes them
    return index, mask, rng.standard_normal((e, f)).astype(np.float32)


@pytest.mark.parametrize("e,n,f,self_loops", [
    (4096, 5000, 3, True),
    (4096, 5000, 1, False),
    (1000, 37, 16, True),
    (257, 3, 2, True),
    (0, 10, 4, True),
], ids=["E4096-N5000-F3", "E4096-N5000-keep-loops", "E1000-N37-F16", "E257-N3", "empty"])
def test_coalesce_edges_matches_jax(e, n, f, self_loops):
    from deeprank_gnn_tpu.ops.coalesce import coalesce_edges as jax_coalesce
    from deeprank_gnn_tpu_torch.ops import coalesce_edges
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES

    index, mask, attr = padded_edges(np.random.default_rng(e + n + f), e, n, f)
    want = jax_coalesce(jnp.asarray(index), jnp.asarray(attr), jnp.asarray(mask), n,
                        remove_self_loops=self_loops)
    before = dict(LAUNCHES)
    got = coalesce_edges(torch.from_numpy(index), torch.from_numpy(attr),
                         torch.from_numpy(mask), n, remove_self_loops=self_loops)
    assert dict(LAUNCHES) == before  # the plain version on the CPU
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    if e and n == 5000:
        keys = got[0][0].long() * n + got[0][1].long()
        assert int(keys[got[2]].max()) > 2**24  # past fp32's exact integers


def test_coalesce_edges_refuses_large_keys():
    from deeprank_gnn_tpu_torch.ops import coalesce_edges

    z = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="too large for int32"):
        coalesce_edges(z, torch.zeros((4, 1)), torch.ones(4, dtype=torch.bool), 46341)


class Data:
    """The reference's two-triangle batch, larger: two graphs, features,
    positions, attributed interface and internal edges, as arrays."""

    def __init__(self, rng):
        self.batch = np.repeat([0, 1], [14, 11])
        n = len(self.batch)
        src = np.concatenate([rng.integers(0, 14, 40), rng.integers(14, n, 30)])
        dst = np.concatenate([rng.integers(0, 14, 40), rng.integers(14, n, 30)])
        self.edge_index = np.stack([src, dst])
        self.edge_attr = rng.standard_normal((70, 2)).astype(np.float32)
        self.internal_edge_index = self.edge_index[:, ::2].copy()
        self.internal_edge_attr = self.edge_attr[::2].copy()
        self.x = rng.standard_normal((n, 5)).astype(np.float32)
        self.pos = rng.standard_normal((n, 3)).astype(np.float32)


def torch_data(d):
    out = Data.__new__(Data)
    for k, v in vars(d).items():
        setattr(out, k, None if v is None else torch.from_numpy(v))
    return out


@pytest.mark.parametrize("method", ["mcl", "louvain"])
def test_community_detection_per_batch_and_preloaded(method):
    import deeprank_gnn_tpu.community_pooling as J
    import deeprank_gnn_tpu_torch.community_pooling as T

    d = Data(np.random.default_rng(1))
    n = len(d.batch)
    want = J.community_detection_per_batch(d.edge_index, d.batch, n, method=method)
    got = T.community_detection_per_batch(torch.from_numpy(d.edge_index),
                                          torch.from_numpy(d.batch), n, method=method)
    np.testing.assert_array_equal(got.numpy(), want)
    one = d.edge_index[:, :40]
    np.testing.assert_array_equal(T.community_detection(torch.from_numpy(one), 14,
                                                        method=method).numpy(),
                                  J.community_detection(one, 14, method=method))
    local = np.concatenate([want[:14], want[14:] - want[14:].min()])
    np.testing.assert_array_equal(
        T.get_preloaded_cluster(torch.from_numpy(local), torch.from_numpy(d.batch)).numpy(),
        J.get_preloaded_cluster(local, d.batch))


@pytest.mark.parametrize("weighted", [False, True])
def test_graclus_cluster(weighted):
    import deeprank_gnn_tpu.community_pooling as J
    import deeprank_gnn_tpu_torch.community_pooling as T

    rng = np.random.default_rng(7)
    ei = rng.integers(0, 40, (2, 120))
    w = rng.random(120) if weighted else None
    want = J.graclus_cluster(ei, 45, edge_weight=w)
    got = T.graclus_cluster(torch.from_numpy(ei), 45,
                            edge_weight=None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_community_pooling_matches_jax():
    """Max-pooled features, mean-pooled positions, coalesced interface and
    internal edges with summed attributes, the pooled batch vector."""
    import deeprank_gnn_tpu.community_pooling as J
    import deeprank_gnn_tpu_torch.community_pooling as T

    d = Data(np.random.default_rng(2))
    cluster = J.community_detection_per_batch(d.edge_index, d.batch, len(d.batch))
    want = J.community_pooling(cluster, d)
    got = T.community_pooling(torch.from_numpy(cluster), torch_data(d))
    np.testing.assert_array_equal(got.x.numpy(), want.x)
    np.testing.assert_allclose(got.pos.numpy(), want.pos, **TOL)
    np.testing.assert_array_equal(got.batch.numpy(), want.batch)
    for idx, attr in (("edge_index", "edge_attr"),
                      ("internal_edge_index", "internal_edge_attr")):
        assert getattr(got, idx).dtype == torch.int64
        np.testing.assert_array_equal(getattr(got, idx).numpy(), getattr(want, idx))
        np.testing.assert_allclose(getattr(got, attr).numpy(), getattr(want, attr), **TOL)
    assert got.num_nodes == want.num_nodes


def test_community_pooling_without_attributes_and_loops_only():
    import deeprank_gnn_tpu.community_pooling as J
    import deeprank_gnn_tpu_torch.community_pooling as T

    d = Data(np.random.default_rng(3))
    d.edge_attr = None
    del d.internal_edge_index, d.internal_edge_attr
    cluster = d.batch.copy()  # one cluster per graph: every pooled edge a self-loop
    want = J.community_pooling(cluster, d)
    got = T.community_pooling(torch.from_numpy(cluster), torch_data(d))
    assert tuple(got.edge_index.shape) == want.edge_index.shape == (2, 0)
    assert tuple(got.edge_attr.shape) == want.edge_attr.shape == (0, 0)
    assert got.internal_edge_index is None
    np.testing.assert_array_equal(got.x.numpy(), want.x)


def test_segment_min_and_pooling_pos():
    from deeprank_gnn_tpu.ops import community_pooling_pos as jax_pos, segment_min as jax_min
    from deeprank_gnn_tpu_torch.ops import community_pooling_pos, segment_min

    rng = np.random.default_rng(4)
    data = rng.standard_normal((60, 3)).astype(np.float32)
    ids = rng.integers(0, 12, 60).astype(np.int32)
    ids[:5] = 12  # padding rows route to the dump row
    np.testing.assert_array_equal(
        segment_min(torch.from_numpy(data), torch.from_numpy(ids), 14).numpy(),
        np.asarray(jax_min(jnp.asarray(data), jnp.asarray(ids), 14)))
    np.testing.assert_allclose(
        community_pooling_pos(torch.from_numpy(data), torch.from_numpy(ids), 14).numpy(),
        np.asarray(jax_pos(jnp.asarray(data), jnp.asarray(ids), 14)), **TOL)


def test_ops_exports_match_jax():
    import deeprank_gnn_tpu.ops as J
    import deeprank_gnn_tpu_torch.ops as T

    assert T.__all__ == J.__all__
    assert all(callable(getattr(T, name)) for name in T.__all__)


def test_plot_graph(tmp_path):
    import networkx as nx

    from deeprank_gnn_tpu_torch.community_pooling import plot_graph

    g = nx.cycle_graph(6)
    out = str(tmp_path / "clusters.png")
    plot_graph(g, torch.tensor([0, 0, 0, 1, 1, 1]), out)
    assert os.path.getsize(out) > 0


@pytest.mark.cuda
def test_coalesce_edges_cuda_matches_cpu():
    """On the card the attribute sums are K1, bitwise its plain version on
    the CPU; the keys are exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 runs only on the card)")
    from deeprank_gnn_tpu_torch.ops import coalesce_edges
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES

    index, mask, attr = padded_edges(np.random.default_rng(0), 4096, 5000, 3)
    args = (torch.from_numpy(index), torch.from_numpy(attr), torch.from_numpy(mask))
    want = coalesce_edges(*args, 5000)
    before = LAUNCHES["sorted_segment_sum"]
    got = coalesce_edges(*(a.cuda() for a in args), 5000)
    assert LAUNCHES["sorted_segment_sum"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)

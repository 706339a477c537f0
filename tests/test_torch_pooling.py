"""PyTorch port vs JAX package: member-table max pooling and the pooling
functions (bitwise where the math is a max, else atol = rtol = 1e-5)."""

import numpy as np
import pytest
import torch

from test_torch_data import datasets, write_graphs_hdf5


def test_member_max_pool_bitwise_with_ties_and_padding():
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.dense import member_max_pool as jax_pool
    from deeprank_gnn_tpu_torch.ops.dense import member_max_pool

    rng = np.random.default_rng(0)
    g, s, f, c, m = 3, 20, 5, 7, 6
    # small integers: many ties; negative values: -inf padding must not win
    h = rng.integers(-3, 3, (g, s, f)).astype(np.float32)
    mem = np.full((g, c, m), s, dtype=np.int32)  # pad sentinel == S
    assign = np.full((g, s), c, dtype=np.int32)
    for gi in range(g):
        nodes = rng.permutation(s)[: 15]
        clusters = rng.integers(0, c - 1, 15)  # cluster c-1 stays empty
        for ci in range(c):
            members = nodes[clusters == ci][:m]
            mem[gi, ci, : len(members)] = members
            assign[gi, members] = ci
    want = np.asarray(jax_pool(jnp.asarray(h), jnp.asarray(mem), jnp.asarray(assign)))
    got = member_max_pool(torch.from_numpy(h), torch.from_numpy(mem),
                          torch.from_numpy(assign)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, c - 1] == 0).all()  # empty cluster gives 0
    assert (got < 0).any()  # all-negative clusters keep their max


@pytest.fixture(scope="module")
def batch_pair(tmp_path_factory):
    from deeprank_gnn_tpu.data.batch import collate as jax_collate
    from deeprank_gnn_tpu_torch.data.batch import collate

    path = write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_pool") / "g.hdf5"), num_graphs=6, seed=2
    )
    jds, tds = datasets(path)
    jb, _ = jax_collate([jds.get(i) for i in range(len(jds))])
    tb, _ = collate([tds.get(i) for i in range(len(tds))])
    return jb, tb


@pytest.mark.parametrize("member_table", [True, False])
def test_pooling_functions_match_jax(batch_pair, member_table):
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops import pooling as J
    from deeprank_gnn_tpu_torch.ops import pooling as T

    jb, tb = batch_pair
    rng = np.random.default_rng(1)
    h = np.maximum(rng.standard_normal((tb.num_nodes, 8)), 0).astype(np.float32)
    jm0 = jb.mem0_idx if member_table else None
    tm0 = tb.mem0_idx if member_table else None
    jm1 = jb.mem1_idx if member_table else None
    tm1 = tb.mem1_idx if member_table else None

    want = np.asarray(J.community_pooling_x(jnp.asarray(h), jb.assign0, jb.num_clusters0, jm0))
    got = T.community_pooling_x(torch.from_numpy(h), tb.assign0, tb.num_clusters0, tm0).numpy()
    np.testing.assert_array_equal(got, want)

    hp = np.ascontiguousarray(got)
    want = np.asarray(J.max_pool_x(jnp.asarray(hp), jb.assign1, jb.num_clusters1, jm1))
    got = T.max_pool_x(torch.from_numpy(hp), tb.assign1, tb.num_clusters1, tm1).numpy()
    np.testing.assert_array_equal(got, want)

    hq = np.ascontiguousarray(got)
    want = np.asarray(J.graph_mean_pool(jnp.asarray(hq), jb.pool1_graph, jb.num_graphs))
    got = T.graph_mean_pool(torch.from_numpy(hq), tb.pool1_graph, tb.num_graphs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

"""PyTorch port vs JAX package: the rest of the model zoo.

GINet with attention (both layouts), with the internal tower (sparse only,
with and without attention), FoutNet and sGAT (both layouts), each against
the JAX package's ``apply`` with the same weights (carried across by
``state_dict_from_jax_params``): forward at rtol 2e-4, atol 1e-5 and every
parameter's gradient at rtol 5e-4, atol 1e-5, with no NaN (the pad-edge
softmax backward, as ``tests/test_dense_layout.py:86-107`` pins it for the
JAX package). Also the dense edge-to-slot ops, the kernel launches per
forward pass, and the state-dict names.
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_data import datasets, write_graphs_hdf5

TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
NUM_GRAPHS = 7


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    from deeprank_gnn_tpu.data.batch import collate as jax_collate
    from deeprank_gnn_tpu.data.dense_batch import collate_dense as jax_collate_dense
    from deeprank_gnn_tpu_torch.data.batch import collate
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense

    path = write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_zoo") / "g.hdf5"), num_graphs=NUM_GRAPHS, seed=12
    )
    jds, tds = datasets(path)
    jg = [jds.get(i) for i in range(len(jds))]
    tg = [tds.get(i) for i in range(len(tds))]
    return {
        ("jax", "sparse"): jax_collate(jg, g_pad=8)[0],
        ("jax", "dense"): jax_collate_dense(jg, g_pad=8)[0],
        ("port", "sparse"): collate(tg, g_pad=8)[0],
        ("port", "dense"): collate_dense(tg, g_pad=8)[0],
    }


# (net name, constructor keywords, layout)
CASES = [
    ("GINet", {"attention": True}, "sparse"),
    ("GINet", {"attention": True}, "dense"),
    ("GINet", {"internal_tower": True}, "sparse"),
    ("GINet", {"attention": True, "internal_tower": True}, "sparse"),
    ("FoutNet", {}, "sparse"),
    ("FoutNet", {}, "dense"),
    ("sGAT", {}, "sparse"),
    ("sGAT", {}, "dense"),
]


def case_id(case):
    name, kw, layout = case
    return "-".join([name, *sorted(kw), layout])


def models(name, kw, num_features, output_shape=1, seed=0):
    """The JAX net, its parameters, and the port's net with those weights."""
    import jax

    import deeprank_gnn_tpu.models as J
    import deeprank_gnn_tpu_torch.models as T
    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    jm = getattr(J, name)(num_features, output_shape, 1, **kw)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = getattr(T, name)(num_features, output_shape, 1, device="cpu", **kw)
    tm.load_state_dict(state_dict_from_jax_params(name, params))
    tm.eval()
    return jm, params, tm


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_zoo_matches_jax(batches, case):
    import jax

    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    name, kw, layout = case
    jb, tb = batches[("jax", layout)], batches[("port", layout)]
    num_features = tb.x.shape[-1]
    jm, params, tm = models(name, kw, num_features, seed=len(case_id(case)))

    def loss(p):
        return (jm.apply(p, jb)[:NUM_GRAPHS] ** 2).sum()

    want = np.asarray(jm.apply(params, jb))
    want_grads = state_dict_from_jax_params(name, jax.grad(loss)(params))
    out = tm(tb)
    (out[:NUM_GRAPHS] ** 2).sum().backward()
    got = out.detach().numpy()
    assert got.shape == (8, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got[:NUM_GRAPHS], want[:NUM_GRAPHS], **TOL)
    assert got[:NUM_GRAPHS].std() > 1e-4  # the graphs are told apart
    for pname, p in tm.named_parameters():
        want_grad = want_grads[pname].numpy()
        if p.grad is None:
            # paper mode's dead attention parameters (Q1) without attention
            assert not kw.get("attention") and pname.split(".")[1] in (
                "fc_edge_attr", "fc_attention"), pname
            assert not want_grad.any(), pname
            continue
        assert np.isfinite(p.grad.numpy()).all(), pname
        np.testing.assert_allclose(p.grad.numpy(), want_grad, err_msg=pname, **GRAD_TOL)
        if kw.get("attention"):
            assert p.grad.any(), pname  # the attention branch is live


@pytest.mark.parametrize("name", ["GINet-attention", "FoutNet", "sGAT"])
def test_dense_matches_sparse_in_port(batches, name):
    """The port's two layouts give the same scores (the JAX package's
    ``test_dense_matches_sparse`` and ``test_dense_attention_matches_sparse``)."""
    net, kw = ("GINet", {"attention": True}) if name == "GINet-attention" else (name, {})
    _, _, tm = models(net, kw, batches[("port", "sparse")].x.shape[1], seed=5)
    with torch.inference_mode():
        sparse = tm(batches[("port", "sparse")])[:NUM_GRAPHS]
        dense = tm(batches[("port", "dense")])[:NUM_GRAPHS]
    torch.testing.assert_close(dense, sparse, **TOL)


def test_sgat_layer_directed_matches_jax():
    """``sgat_layer(undirected=False)``: each edge averaged into both of its
    endpoints jointly, as the JAX package's branch does."""
    import jax.numpy as jnp

    from deeprank_gnn_tpu.models.sgat import SGATLayerParams
    from deeprank_gnn_tpu.models.sgat import sgat_layer as jax_layer
    from deeprank_gnn_tpu_torch.models.sgat import SGATLayer, sgat_layer

    rng = np.random.default_rng(2)
    n, e, f = 30, 80, 5
    rows = np.sort(rng.integers(0, n, e)).astype(np.int32)
    cols = rng.integers(0, n, e).astype(np.int32)
    x = rng.standard_normal((n, f)).astype(np.float32)
    attr = rng.random((e, 1)).astype(np.float32)
    layer = SGATLayer(f, 4, torch.Generator().manual_seed(0))
    jp = SGATLayerParams(weight=jnp.asarray(layer.weight.detach().numpy()),
                         bias=jnp.asarray(layer.bias.detach().numpy()))
    ei = np.stack([rows, cols])
    ptr = torch.from_numpy(np.searchsorted(rows, np.arange(n + 1)).astype(np.int32))
    t = torch.from_numpy
    for undirected in (True, False):
        want = np.asarray(jax_layer(jp, jnp.asarray(x), jnp.asarray(ei), jnp.asarray(attr), n,
                                    undirected=undirected))
        with torch.no_grad():
            got = sgat_layer(layer, t(x), t(ei), t(attr), n, ptr, undirected=undirected)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _vjp_pair(jax_fn, torch_fn, x, cot):
    import jax
    import jax.numpy as jnp

    want, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = torch_fn(xt)
    (got * torch.from_numpy(cot)).sum().backward()
    return (got.detach().numpy(), xt.grad.numpy()), (np.asarray(want), np.asarray(want_grad))


def test_dense_edge_ops_match_jax():
    """``gather_nodes``, ``edge_{sum,count,mean}_to_slots`` and
    ``dense_segment_softmax`` against the JAX functions, forward and
    gradient, with sentinel indices (== size), an empty slot and large pad
    logits: no NaN."""
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops import dense as J
    from deeprank_gnn_tpu_torch.ops import dense as T

    rng = np.random.default_rng(4)
    g, s, e, f = 3, 20, 60, 4
    idx = rng.integers(0, s, (g, e)).astype(np.int32)
    idx[:, ::7] = s  # sentinels
    idx[idx == 5] = 6  # slot 5 stays empty
    x = rng.standard_normal((g, s, f)).astype(np.float32)
    vals = rng.standard_normal((g, e, f)).astype(np.float32)
    logits = (4 * rng.standard_normal((g, e))).astype(np.float32)
    logits[:, ::7] = 200.0  # a pad logit whose exp overflows
    ji, ti = jnp.asarray(idx), torch.from_numpy(idx)
    pairs = [
        _vjp_pair(lambda v: J.gather_nodes(v, ji), lambda v: T.gather_nodes(v, ti),
                  x, rng.standard_normal((g, e, f)).astype(np.float32)),
        _vjp_pair(lambda v: J.edge_sum_to_slots(v, ji, s), lambda v: T.edge_sum_to_slots(v, ti, s),
                  vals, rng.standard_normal((g, s, f)).astype(np.float32)),
        _vjp_pair(lambda v: J.edge_mean_to_slots(v, ji, s),
                  lambda v: T.edge_mean_to_slots(v, ti, s),
                  vals, rng.standard_normal((g, s, f)).astype(np.float32)),
        _vjp_pair(lambda v: J.dense_segment_softmax(v, ji, s),
                  lambda v: T.dense_segment_softmax(v, ti, s),
                  logits, rng.standard_normal((g, e)).astype(np.float32)),
    ]
    for (got, got_grad), (want, want_grad) in pairs:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got_grad, want_grad, **GRAD_TOL)
        assert np.isfinite(got_grad).all()
    np.testing.assert_array_equal(T.edge_count_to_slots(ti, s).numpy(),
                                  np.asarray(J.edge_count_to_slots(ji, s)))
    assert not T.edge_count_to_slots(ti, s)[:, 5].any()
    softmax = pairs[3][0][0]
    assert (softmax[:, ::7] == 0).all()  # sentinel edges get weight 0


# launches per forward pass: (K1 sorted_segment_sum, K2 sorted_scatter_gather)
LAUNCH_CASES = [
    ("GINet", {"attention": True}, 4, 4),
    ("GINet", {"internal_tower": True}, 4, 0),
    ("FoutNet", {}, 2, 0),
    ("sGAT", {}, 2, 0),
]


@pytest.mark.parametrize("name,kw,k1,k2", LAUNCH_CASES,
                         ids=["GINet-attention", "GINet-internal", "FoutNet", "sGAT"])
def test_zoo_routes_through_kernels(batches, monkeypatch, name, kw, k1, k2):
    """Every sparse aggregation of the zoo takes K1 and every attention
    softmax K2 (their wrappers, as the ``segment`` module calls them); a
    training step of attention GINet adds one K2 call per K2 call (the
    softmax passes no ``out`` cotangent, so K2's backward is K2 on the
    ``d2`` cotangent) and no K1 call."""
    from deeprank_gnn_tpu_torch.ops import segment

    calls = []
    for fn in ("sorted_segment_sum", "sorted_scatter_gather"):
        real = getattr(segment, fn)
        monkeypatch.setattr(segment, fn, functools.partial(
            lambda real, fn, d, p: calls.append(fn) or real(d, p), real, fn))
    tb = batches[("port", "sparse")]
    _, _, tm = models(name, kw, tb.x.shape[1])
    out = tm(tb)
    assert (calls.count("sorted_segment_sum"), calls.count("sorted_scatter_gather")) == (k1, k2)
    out.sum().backward()
    assert (calls.count("sorted_segment_sum"), calls.count("sorted_scatter_gather")) == (k1, 2 * k2)


def test_dense_internal_tower_raises(batches):
    from deeprank_gnn_tpu_torch.models import GINet

    model = GINet(batches[("port", "dense")].x.shape[2], 1, 1, internal_tower=True, device="cpu")
    assert not model.fuse
    with pytest.raises(NotImplementedError, match="layout='sparse'"):
        model(batches[("port", "dense")])
    model(batches[("port", "sparse")])  # the sparse layout runs


ZOO_NAMES = {
    "FoutNet": [f"conv{i}.{p}" for i in (1, 2) for p in ("Wc", "Wn", "bias")],
    "sGAT": [f"conv{i}.{p}" for i in (1, 2) for p in ("weight", "bias")],
}


@pytest.mark.parametrize("name", ["FoutNet", "sGAT"])
def test_zoo_state_dict_names_and_round_trip(name):
    """The reference's state-dict names in the JAX package's leaf order;
    port state dict -> JAX params (its ``torch_state_dict_to_params``) ->
    port state dict is the identity."""
    import deeprank_gnn_tpu.models as J
    import deeprank_gnn_tpu_torch.models as T
    from deeprank_gnn_tpu.train.checkpoint import torch_state_dict_to_params
    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    model = getattr(T, name)(13, 2, 1, device="cpu", generator=torch.Generator().manual_seed(1))
    sd = model.state_dict()
    assert list(sd) == ZOO_NAMES[name] + ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]
    assert sd["fc1.weight"].shape == (64, 32) and sd["fc2.weight"].shape == (2, 64)
    width = 13 if name == "FoutNet" else 26
    assert sd["conv1.bias"].abs().max() <= width ** -0.5  # uniform(size) bounds
    params = torch_state_dict_to_params(getattr(J, name)(13, 2, 1),
                                        {k: v.numpy() for k, v in sd.items()})
    back = state_dict_from_jax_params(name, params)
    assert list(back) == list(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)

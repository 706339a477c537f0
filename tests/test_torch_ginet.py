"""PyTorch port vs JAX package: GINet forward with weights carried across.

The JAX model is initialised from a JAX key; its parameters go through
``state_dict_from_jax_params`` into the port's reference-named state dict,
so both packages run the same weights. Tolerance rtol 2e-4, atol 1e-5 (the
JAX golden tests' tolerance, ``tests/test_models_golden.py:166``).
"""

import numpy as np
import pytest
import torch

from test_torch_data import datasets, write_graphs_hdf5

TOL = dict(rtol=2e-4, atol=1e-5)

REFERENCE_NAMES = [
    f"{conv}.{part}.weight"
    for conv in ("conv1", "conv2", "conv1_ext", "conv2_ext")
    for part in ("fc", "fc_edge_attr", "fc_attention")
] + ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]


@pytest.fixture(scope="module")
def batch_pair(tmp_path_factory):
    from deeprank_gnn_tpu.data.batch import collate as jax_collate
    from deeprank_gnn_tpu_torch.data.batch import collate

    path = write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_ginet") / "g.hdf5"), num_graphs=8, seed=4
    )
    jds, tds = datasets(path)
    jb, _ = jax_collate([jds.get(i) for i in range(len(jds))])
    tb, _ = collate([tds.get(i) for i in range(len(tds))])
    return jb, tb


def _models(num_features, output_shape, fuse, seed=0):
    import jax

    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    jm = JaxGINet(num_features, output_shape, 1)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = GINet(num_features, output_shape, 1, fuse=fuse, device="cpu")
    tm.load_state_dict(state_dict_from_jax_params("GINet", params))
    tm.eval()
    return jm, params, tm


@pytest.mark.parametrize("output_shape", [1, 2], ids=["reg", "class"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_ginet_forward_matches_jax(batch_pair, output_shape, fuse):
    jb, tb = batch_pair
    jm, params, tm = _models(tb.x.shape[1], output_shape, fuse)
    want = np.asarray(jm.apply(params, jb))
    with torch.inference_mode():
        got = tm(tb).numpy()
    assert got.shape == (tb.num_graphs, output_shape)
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_and_unfused_agree_and_route_through_k1(batch_pair, monkeypatch):
    from deeprank_gnn_tpu_torch.ops import segment

    _, tb = batch_pair
    _, _, fused = _models(tb.x.shape[1], 1, True, seed=3)
    _, _, unfused = _models(tb.x.shape[1], 1, False, seed=3)
    calls = []
    real = segment.sorted_segment_sum
    monkeypatch.setattr(
        segment, "sorted_segment_sum", lambda d, p: calls.append(d.shape[1]) or real(d, p)
    )
    with torch.inference_mode():
        a = fused(tb)
        assert calls == [32, 64]  # one sorted segment sum per conv level
        b = unfused(tb)
    assert calls[2:] == [16, 32, 16, 32]
    torch.testing.assert_close(a, b, **TOL)


def test_state_dict_names_and_round_trip():
    from deeprank_gnn_tpu.models import GINet as JaxGINet
    from deeprank_gnn_tpu.train.checkpoint import torch_state_dict_to_params
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.train.checkpoint import state_dict_from_jax_params

    model = GINet(13, 2, 1, device="cpu", generator=torch.Generator().manual_seed(1))
    sd = model.state_dict()
    assert list(sd) == REFERENCE_NAMES
    assert sd["conv1.fc.weight"].shape == (16, 13)
    assert sd["conv1.fc_attention.weight"].shape == (1, 33)
    assert sd["fc2.weight"].shape == (2, 128)
    # port state dict -> JAX params -> port state dict is the identity
    jm = JaxGINet(13, 2, 1)
    params = torch_state_dict_to_params(jm, {k: v.numpy() for k, v in sd.items()})
    back = state_dict_from_jax_params("GINet", params)
    for k in REFERENCE_NAMES:
        assert torch.equal(back[k], sd[k]), k
    # nested dicts work too
    nested = {
        "conv1": {"fc_w": params.conv1.fc_w, "fc_edge_w": params.conv1.fc_edge_w,
                  "fc_att_w": params.conv1.fc_att_w},
    }
    for name in ("conv2", "conv1_ext", "conv2_ext"):
        c = getattr(params, name)
        nested[name] = {"fc_w": c.fc_w, "fc_edge_w": c.fc_edge_w, "fc_att_w": c.fc_att_w}
    for name in ("fc1_w", "fc1_b", "fc2_w", "fc2_b"):
        nested[name] = np.asarray(getattr(params, name))
    from_nested = state_dict_from_jax_params("GINet", nested)
    assert all(torch.equal(from_nested[k], sd[k]) for k in REFERENCE_NAMES)
    with pytest.raises(ValueError, match="unknown net"):
        state_dict_from_jax_params("GAT", params)


def test_init_bounds_and_generator():
    from deeprank_gnn_tpu_torch.models import GINet

    torch.manual_seed(0)
    state = torch.random.get_rng_state()
    a = GINet(20, 1, 1, device="cpu", generator=torch.Generator().manual_seed(5))
    b = GINet(20, 1, 1, device="cpu", generator=torch.Generator().manual_seed(5))
    assert torch.equal(torch.random.get_rng_state(), state)  # global RNG untouched
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    # reference bounds: conv tensors 1/sqrt(in_channels), fc heads 1/sqrt(fan_in)
    sd = a.state_dict()
    assert sd["conv1.fc.weight"].abs().max() <= 20 ** -0.5
    assert sd["conv2.fc_attention.weight"].abs().max() <= 16 ** -0.5
    assert sd["fc1.bias"].abs().max() <= 64 ** -0.5
    assert sd["fc2.weight"].abs().max() <= 128 ** -0.5
    assert sd["conv1.fc.weight"].abs().max() > 0.5 * 20 ** -0.5


def test_dropout_only_in_training(batch_pair):
    _, tb = batch_pair
    _, _, model = _models(tb.x.shape[1], 1, True)
    with torch.inference_mode():
        ev = model(tb)
        model.train()
        g = torch.Generator().manual_seed(0)
        tr1 = model(tb, generator=g)
        tr2 = model(tb, generator=torch.Generator().manual_seed(0))
        model.eval()
    assert torch.equal(tr1, tr2)
    assert not torch.equal(ev, tr1)


def test_unported_modes_and_missing_card_raise():
    """Attention and the internal tower are ported, and unfuse the towers
    as the JAX package's rule does; a missing card is refused."""
    from deeprank_gnn_tpu_torch.models import GINet

    assert GINet(10, 1, 1, device="cpu").fuse
    for kw in ({"attention": True}, {"internal_tower": True}):
        model = GINet(10, 1, 1, device="cpu", **kw)
        assert not model.fuse and model.attention == kw.get("attention", False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GINet(10, 1, 1)

"""PyTorch port vs JAX package: the fast mode and the executable cache, on
the CPU.

The JAX package's fast mode (``DRGNN_DENSE_FAST``) runs K3 and ``adj_conv``
as one bf16 MXU pass with fp32 accumulation on the TPU; JAX on the CPU
ignores ``exact``, so the JAX side here gets its input rounded to bf16
through ``ml_dtypes`` first, which is what the TPU's single pass computes.

- K3's fast variant (``fused_gin_conv(..., exact=False)``), forward and
  gradient (the cotangent rounded too), against JAX's ``fused_gin_conv`` on
  the rounded values at rtol 2e-4, atol 1e-5 (gradients 5e-4); its plain
  version is bitwise the fp32 plain version on the rounded values;
- ``adj_conv(exact=False)`` against JAX's ``adj_conv`` on the rounded
  ``v`` (and cotangent), the same tolerances;
- GINet's dense forward with ``dense_fast`` on the K3 path and on the
  operator path: every fast aggregation within ``FAST_BOUND`` (2^-8 plus
  fp32 rounding) of the exact aggregation of the same input, relative to
  the sum of the magnitudes it adds; the engine's ``dense_fast`` keyword
  reaches the model and refuses models and layouts without a fast mode;
- ``executable_cache_dir`` sets the kernels' build directory; no build
  happens on the CPU.

Tests of the kernel itself carry the ``cuda`` marker and skip without a
card (``chip_smoke.py`` holds it there bitwise to its plain version).
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_data import FEATURE_NAMES, datasets, write_graphs_hdf5
from test_torch_dense import k3_inputs
from test_torch_train import port_engine

TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
# a bf16 operand is within 2^-8 of its fp32 value, relative; the fp32 sums
# of both sides add at most a few units of 2^-24 per edge
FAST_BOUND = 2.0 ** -8 + 2.0 ** -20


def bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16 (to nearest even) and back to float32."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return write_graphs_hdf5(
        str(tmp_path_factory.mktemp("torch_fast") / "g.hdf5"), num_graphs=10, seed=17
    )


@pytest.mark.parametrize("shape", [(3, 40, 17, 150), (8, 272, 32, 512), (8, 32, 64, 512)],
                         ids=["F17", "conv1", "conv2"])
def test_fast_k3_matches_jax_on_rounded_input(shape):
    import jax
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.pallas import fused_gin_conv as jax_fused
    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import (
        fused_gin_conv,
        fused_gin_conv_plain,
    )

    g, s, f, e = shape
    rng = np.random.default_rng(f)
    xw, row, col = k3_inputs(rng, g, s, f, e)
    cot = rng.standard_normal((g, s, f)).astype(np.float32)
    r, c = torch.from_numpy(row), torch.from_numpy(col)
    want, vjp = jax.vjp(lambda v: jax_fused(v, jnp.asarray(row), jnp.asarray(col), False),
                        jnp.asarray(bf16(xw)))
    (want_grad,) = vjp(jnp.asarray(bf16(cot)))

    x = torch.from_numpy(xw).requires_grad_(True)
    got = fused_gin_conv(x, r, c, exact=False)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **GRAD_TOL)
    assert got.dtype == torch.float32 and x.grad.dtype == torch.float32
    # the plain version: the fp32 one on the rounded values, bitwise
    assert torch.equal(got.detach(), fused_gin_conv_plain(torch.from_numpy(bf16(xw)), r, c))
    assert torch.equal(x.grad, fused_gin_conv_plain(torch.from_numpy(bf16(cot)), c, r))
    assert not torch.equal(got.detach(), fused_gin_conv(torch.from_numpy(xw), r, c))


def test_fast_adj_conv_matches_jax_on_rounded_input():
    import jax
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.dense import adj_conv as jax_adj_conv
    from deeprank_gnn_tpu_torch.ops.dense import adj_conv

    rng = np.random.default_rng(3)
    g, s, f = 4, 24, 64
    adj = rng.integers(0, 3, (g, s, s)).astype(np.float32)
    v = rng.standard_normal((g, s, f)).astype(np.float32)
    cot = rng.standard_normal((g, s, f)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_adj_conv(a, jnp.asarray(adj), False), jnp.asarray(bf16(v)))
    (want_grad,) = vjp(jnp.asarray(bf16(cot)))
    x = torch.from_numpy(v).requires_grad_(True)
    got = adj_conv(x, torch.from_numpy(adj), exact=False)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **GRAD_TOL)
    assert not torch.equal(got.detach(), adj_conv(torch.from_numpy(v), torch.from_numpy(adj)))


@pytest.fixture(scope="module")
def dense_batches(db):
    from deeprank_gnn_tpu_torch.data.dense_batch import collate_dense

    _, tds = datasets(db)
    tg = [tds.get(i) for i in range(len(tds))]
    return {"k3": collate_dense(tg, g_pad=10)[0],
            "operators": collate_dense(tg, g_pad=10, precompute_ops=True)[0]}


@pytest.mark.parametrize("path", ["k3", "operators"])
def test_fast_ginet_dense_within_bound(dense_batches, monkeypatch, path):
    """Each fast aggregation of GINet's dense forward (K3's two levels, or
    the operator path's ``adj_conv``) within ``FAST_BOUND`` of the exact
    aggregation of its input, relative to the sum of magnitudes it adds;
    the predictions within 2e-2 relative of the exact model's."""
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.models import ginet as ginet_module
    from deeprank_gnn_tpu_torch.ops.dense import adj_conv
    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import fused_gin_conv

    batch = dense_batches[path]
    calls = []

    def record(fn):
        def wrapped(v, *idx_and_exact):
            out = fn(v, *idx_and_exact)
            calls.append((fn, v.detach(), idx_and_exact, out.detach()))
            return out
        return wrapped

    monkeypatch.setattr(ginet_module, "fused_gin_conv", record(fused_gin_conv))
    monkeypatch.setattr(ginet_module, "adj_conv", record(adj_conv))
    exact = GINet(batch.x.shape[2], 1, 1, device="cpu", generator=torch.Generator().manual_seed(4))
    fast = GINet(batch.x.shape[2], 1, 1, dense_fast=True, device="cpu",
                 generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        want = exact.eval()(batch)
        assert all(call[2][-1] for call in calls)  # the exact model's: exact=True
        calls.clear()
        got = fast.eval()(batch)
    kinds = [fn for fn, *_ in calls]
    assert kinds == ([fused_gin_conv, fused_gin_conv] if path == "k3" else [adj_conv])
    for fn, v, args, out in calls:
        assert args[-1] is False  # exact=False
        ref = fn(v, *args[:-1])
        mag = fn(v.abs(), *args[:-1])
        assert ((out - ref).abs() <= FAST_BOUND * mag + 1e-30).all()
        assert not torch.equal(out, ref)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2, atol=1e-4)


def test_engine_dense_fast(db, tmp_path):
    """``NeuralNet(dense_fast=True)`` hands the mode to GINet's dense
    branches and trains; other layouts and models refuse it."""
    from deeprank_gnn_tpu_torch import FoutNet, NeuralNet

    kw = dict(target="fnat", batch_size=4, percent=[0.8, 0.2], layout="dense", seed=0)
    exact = port_engine(db, str(tmp_path / "e"), **kw)
    fast = port_engine(db, str(tmp_path / "f"), dense_fast=True, **kw)
    assert fast.model.dense_fast and not exact.model.dense_fast
    exact.train(nepoch=2, validate=True)
    fast.train(nepoch=2, validate=True)
    assert np.isfinite(fast.train_loss + fast.valid_loss).all()
    assert fast.train_loss != exact.train_loss
    np.testing.assert_allclose(fast.train_loss, exact.train_loss, rtol=5e-2)
    with pytest.raises(ValueError, match="dense_fast requires layout='dense'"):
        port_engine(db, str(tmp_path / "s"), target="fnat", dense_fast=True)
    with pytest.raises(ValueError, match="FoutNet has no fast mode"):
        NeuralNet(db, FoutNet, node_feature=FEATURE_NAMES, edge_feature=["dist"],
                  target="fnat", layout="dense", dense_fast=True, device="cpu",
                  outdir=str(tmp_path / "fout"))


def test_executable_cache_dir_sets_build_dir(db, tmp_path, monkeypatch):
    """The port's executable cache is the kernels' build directory: the
    engine points the build there (a second process with the same
    directory finds the libraries and runs no ``nvcc``); on the CPU nothing
    is built."""
    from deeprank_gnn_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "_build_dir", build.build_dir())
    cache = tmp_path / "kernels"
    nn = port_engine(db, str(tmp_path / "o"), target="fnat", batch_size=4, layout="dense",
                     device_cache=True, scan_epochs=True, executable_cache_dir=str(cache))
    assert nn.executable_cache_dir == str(cache)
    assert build.build_dir() == cache.resolve()
    for name in ("sorted_segment_sum", "sorted_scatter_gather", "fused_gin_conv"):
        assert build.library_path(name).parent == cache.resolve()
    nn.train(nepoch=1)
    assert not cache.exists() or not os.listdir(cache)


@pytest.mark.cuda
def test_fast_k3_cuda_matches_plain():
    """The fast variant on the card, forward and backward, bitwise the
    fp32 plain version on the rounded values on the CPU. Its launch plan,
    the one the path runs: where the exact kernel stages the fp32 slab, it
    stages the same slab plus the slab's bf16 copy, and it splits a graph
    over no more blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import (
        fused_gin_conv,
        fused_gin_conv_plain,
        launch_plan,
    )

    rng = np.random.default_rng(0)
    for g, s, f, e in ((4, 40, 17, 300), (8, 272, 32, 512), (2, 4000, 64, 6000)):
        xw, row, col = k3_inputs(rng, g, s, f, e)
        cot = rng.standard_normal((g, s, f)).astype(np.float32)
        x = torch.from_numpy(xw).cuda().requires_grad_(True)
        r, c = torch.from_numpy(row).cuda(), torch.from_numpy(col).cuda()
        before = LAUNCHES["fused_gin_conv_bf16"]
        out = fused_gin_conv(x, r, c, exact=False)
        out.backward(torch.from_numpy(cot).cuda())
        assert LAUNCHES["fused_gin_conv_bf16"] == before + 2
        want = fused_gin_conv_plain(torch.from_numpy(bf16(xw)), torch.from_numpy(row),
                                    torch.from_numpy(col))
        want_grad = fused_gin_conv_plain(torch.from_numpy(bf16(cot)), torch.from_numpy(col),
                                         torch.from_numpy(row))
        assert torch.equal(out.detach().cpu(), want)
        assert torch.equal(x.grad.cpu(), want_grad)
        exact_plan, fast_plan = launch_plan("cuda", s, f, e), launch_plan("cuda", s, f, e, True)
        assert fast_plan["slab"] == exact_plan["slab"]
        assert fast_plan["blocks_per_graph"] <= exact_plan["blocks_per_graph"]
        if exact_plan["slab"]:
            # the bf16 copy in whole 16-byte units, and 9 more counters (one
            # per warp, and the row's offset) for each row a block adds
            copy = -(-s * f // 8) * 8 * 2
            rows = fast_plan["rows_per_block"] - exact_plan["rows_per_block"]
            assert fast_plan["smem_bytes"] == exact_plan["smem_bytes"] + copy + 9 * 4 * rows

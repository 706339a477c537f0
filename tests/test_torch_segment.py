"""PyTorch port vs JAX package: K1 (sorted segment sum) and the segment ops.

K1's plain version is held against the JAX package's ``segment_sum`` (its
XLA path on the CPU) and against the Pallas kernel in interpret mode, at
atol = rtol = 1e-5 (the summation order differs). The CUDA kernel itself
is checked on the card by ``chip_smoke.py``; ``test_k1_cuda_matches_plain``
runs it where a card is present. The plain version sums each row in
ascending edge order, bitwise a loop over the edges, and so does the
kernel: the card's checks compare the two bitwise.
"""

import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-5)


def sorted_rows(rng, n, e_valid, e_pad, long_run=False):
    """Nondecreasing rows in [0, n) with empty rows, optionally one run of
    many edges, then padding rows == n."""
    rows = np.sort(rng.choice(np.arange(0, n, 2), e_valid))  # odd rows empty
    if long_run:
        rows[: e_valid // 2] = n // 2
        rows = np.sort(rows)
    return np.concatenate([rows, np.full(e_pad - e_valid, n)]).astype(np.int32)


@pytest.mark.parametrize("f", [1, 16, 32, 64])
def test_k1_plain_matches_jax(f):
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.pallas.segment import required_window
    from deeprank_gnn_tpu.ops.pallas.segment import sorted_segment_sum as pallas_sss
    from deeprank_gnn_tpu.ops.segment import segment_sum as jax_segment_sum
    from deeprank_gnn_tpu_torch.ops.kernels.segment import sorted_segment_sum_plain

    rng = np.random.default_rng(f)
    n, e_valid, e_pad = 300, 1200, 1300
    rows = sorted_rows(rng, n, e_valid, e_pad, long_run=(f == 16))
    data = rng.standard_normal((e_pad, f)).astype(np.float32)
    row_ptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int32)

    ref = np.asarray(jax_segment_sum(jnp.asarray(data), jnp.asarray(rows), n))
    window = required_window(rows, n)
    pallas = np.asarray(
        pallas_sss(jnp.asarray(data), jnp.asarray(rows), n, True, window)
    )
    t = torch.from_numpy
    from_ptr = sorted_segment_sum_plain(t(data), t(row_ptr)).numpy()
    from_rows = sorted_segment_sum_plain(t(data), t(row_ptr), t(rows)).numpy()
    assert from_ptr.shape == (n, f)
    for got in (from_ptr, from_rows):
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, pallas, **TOL)
    # empty rows give 0, padding edges drop out
    assert (from_ptr[1::2] == 0).all()
    np.testing.assert_allclose(from_ptr.sum(0), data[:e_valid].sum(0), rtol=1e-4, atol=1e-3)


def edge_order_sum(data, row_ptr):
    """Each row's run summed as a loop over its edges in ascending order,
    one float32 add per edge and column, from 0."""
    out = np.zeros((len(row_ptr) - 1, data.shape[1]), dtype=np.float32)
    for r in range(len(row_ptr) - 1):
        acc = np.zeros(data.shape[1], dtype=np.float32)
        for e in range(max(row_ptr[r], 0), row_ptr[r + 1]):
            acc += data[e]
        out[r] = acc
    return out


def long_run_rows(rng, n, lead, trail):
    """Nondecreasing rows with 2 of 3 rows empty, one run of 8,000 edges and
    ``lead`` edges before the first row's run and ``trail`` after the last
    (rows -1 and n: padding)."""
    rows = np.sort(rng.choice(np.arange(0, n, 3), 12000))
    rows[:8000] = 3 * (n // 6)
    return np.concatenate([np.full(lead, -1), np.sort(rows), np.full(trail, n)]).astype(np.int32)


@pytest.mark.parametrize("f", [1, 16, 32, 64])
def test_k1_plain_sums_in_edge_order(f):
    """The plain version on the CPU sums each row in ascending edge order:
    bitwise the loop, with random values (so the order shows in the bits),
    an 8,000-edge run, empty rows and leading and trailing padding. The
    kernel sums in the same order, so the card's check holds it to the plain
    version on the CPU bitwise."""
    from deeprank_gnn_tpu_torch.ops.kernels.segment import sorted_segment_sum

    rng = np.random.default_rng(20 + f)
    n = 1200
    rows = long_run_rows(rng, n, lead=70, trail=130)
    ptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int32)
    data = rng.standard_normal((len(rows), f)).astype(np.float32)
    got = sorted_segment_sum(torch.from_numpy(data), torch.from_numpy(ptr)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), edge_order_sum(data, ptr).view(np.int32))


def test_segment_sum_routes_sorted_ids_to_k1(monkeypatch):
    from deeprank_gnn_tpu_torch.ops import segment
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES

    calls = []
    real = segment.sorted_segment_sum
    monkeypatch.setattr(
        segment, "sorted_segment_sum", lambda d, p: calls.append(1) or real(d, p)
    )
    rng = np.random.default_rng(0)
    rows = sorted_rows(rng, 50, 200, 230)
    data = torch.from_numpy(rng.standard_normal((230, 8)).astype(np.float32))
    ptr = torch.from_numpy(np.searchsorted(rows, np.arange(51)).astype(np.int32))
    launches = dict(LAUNCHES)
    a = segment.segment_sum(data, torch.from_numpy(rows), 50, row_ptr=ptr)
    b = segment.segment_sum(data, torch.from_numpy(rows), 50)
    assert calls == [1]
    torch.testing.assert_close(a, b, **TOL)
    # the CPU path runs the plain version and launches nothing
    assert dict(LAUNCHES) == launches
    with pytest.raises(ValueError, match="row_ptr"):
        segment.segment_sum(data, torch.from_numpy(rows), 50, row_ptr=ptr[:-1])


def test_segment_ops_match_jax():
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops import segment as J
    from deeprank_gnn_tpu_torch.ops import segment as T

    rng = np.random.default_rng(5)
    s, e = 40, 300
    ids = rng.integers(-3, s + 3, e).astype(np.int32)  # out of range drops out
    ids[ids == 7] = 8  # segment 7 stays empty
    data = rng.standard_normal((e, 6)).astype(np.float32)
    jd, ji = jnp.asarray(data), jnp.asarray(ids)
    td, ti = torch.from_numpy(data), torch.from_numpy(ids)
    pairs = [
        (J.segment_sum(jd, ji, s), T.segment_sum(td, ti, s)),
        (J.segment_count(ji, s), T.segment_count(ti, s)),
        (J.segment_mean(jd, ji, s), T.segment_mean(td, ti, s)),
        (J.segment_mean(jd, ji, s, nan_empty=True), T.segment_mean(td, ti, s, nan_empty=True)),
        (J.segment_max(jd, ji, s), T.segment_max(td, ti, s)),
        (J.gather(jd, ji), T.gather(td, ti)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), equal_nan=True, **TOL)
    assert np.isnan(pairs[3][1].numpy()[7]).all()
    assert (pairs[4][1].numpy()[7] == 0).all()


def test_k1_wrapper_never_falls_back():
    """Only a CPU tensor takes the plain version. Off the CPU the kernel
    path's own checks run (here on meta tensors, which need no card) and
    a device other than CUDA raises; nothing gives way to the plain
    version. Asking for ``cuda`` without a card is refused earlier, by
    ``device.resolve_device`` (see the GINet and NeuralNet tests)."""
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.ops.kernels.segment import sorted_segment_sum

    meta = torch.empty((10, 4), device="meta")
    ptr = torch.empty((3,), dtype=torch.int32, device="meta")
    launches = dict(LAUNCHES)
    with pytest.raises(ValueError, match="cpu or cuda"):
        sorted_segment_sum(meta, ptr)
    with pytest.raises(TypeError, match="float32"):
        sorted_segment_sum(meta.double(), ptr)
    with pytest.raises(TypeError, match="int32"):
        sorted_segment_sum(meta, ptr.long())
    with pytest.raises(ValueError, match="contiguous"):
        sorted_segment_sum(torch.empty((4, 10), device="meta").t(), ptr)
    with pytest.raises(ValueError, match="on meta but row_ptr on cpu"):
        sorted_segment_sum(meta, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[E, F\]"):
        sorted_segment_sum(torch.zeros(10), torch.zeros(3, dtype=torch.int32))
    assert dict(LAUNCHES) == launches


def test_kernel_build_only_on_first_cuda_use(monkeypatch, tmp_path):
    """Importing and using the kernel module on the CPU builds nothing;
    asking for the build without nvcc raises instead of falling back."""
    from deeprank_gnn_tpu_torch.ops.kernels import build
    from deeprank_gnn_tpu_torch.ops.kernels.segment import sorted_segment_sum

    x = torch.ones((6, 3))
    ptr = torch.tensor([0, 2, 2, 6], dtype=torch.int32)
    torch.testing.assert_close(
        sorted_segment_sum(x, ptr), torch.tensor([[2.0] * 3, [0.0] * 3, [4.0] * 3])
    )
    assert "sorted_segment_sum" not in build._loaded
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    # the library name follows the source and the flags
    lib = build.library_path("sorted_segment_sum")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libsorted_segment_sum-")


@pytest.mark.cuda
def test_k1_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.ops.kernels.segment import (
        sorted_segment_sum,
        sorted_segment_sum_plain,
    )

    rng = np.random.default_rng(0)
    for f in (1, 17, 32, 64, 100):
        rows = sorted_rows(rng, 500, 4000, 4300, long_run=True)
        ptr = np.searchsorted(rows, np.arange(501)).astype(np.int32)
        data = torch.from_numpy(rng.standard_normal((4300, f)).astype(np.float32)).cuda()
        ptr_t = torch.from_numpy(ptr).cuda()
        before = LAUNCHES["sorted_segment_sum"]
        a = sorted_segment_sum(data, ptr_t)
        b = sorted_segment_sum(data, ptr_t)
        torch.cuda.synchronize()
        assert LAUNCHES["sorted_segment_sum"] == before + 2
        assert torch.equal(a, b)
        want = sorted_segment_sum_plain(data.cpu(), torch.from_numpy(ptr))
        assert torch.equal(a.cpu(), want)  # both sum in edge order


def _softmax_inputs(seed):
    """Sorted ids with empty rows and padding lanes (== n), logits with a
    wide range so the max shift matters."""
    rng = np.random.default_rng(seed)
    n, e_valid, e_pad = 80, 300, 340
    rows = sorted_rows(rng, n, e_valid, e_pad, long_run=True)
    logits = (5 * rng.standard_normal(e_pad)).astype(np.float32)
    cot = rng.standard_normal(e_pad).astype(np.float32)
    ptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int32)
    return n, e_valid, rows, ptr, logits, cot


@pytest.mark.parametrize("with_row_ptr", [True, False], ids=["k2", "plain"])
def test_segment_softmax_matches_jax(with_row_ptr):
    """``segment_softmax`` with its denominator from K2 (``row_ptr``) and in
    the plain dump-row form, against the JAX package's, forward and
    gradient: padding lanes get weight exp(logit) / 1 and a zero gradient
    contribution, and nothing is NaN."""
    import jax
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.segment import segment_softmax as jax_softmax
    from deeprank_gnn_tpu_torch.ops import segment as T

    n, e_valid, rows, ptr, logits, cot = _softmax_inputs(7)
    jr = jnp.asarray(rows)
    want, vjp = jax.vjp(lambda v: jax_softmax(v, jr, n), jnp.asarray(logits))
    (want_grad,) = vjp(jnp.asarray(cot))

    x = torch.from_numpy(logits).requires_grad_(True)
    got = T.segment_softmax(x, torch.from_numpy(rows), n,
                            row_ptr=torch.from_numpy(ptr) if with_row_ptr else None)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=5e-4, atol=1e-5)
    assert np.isfinite(x.grad.numpy()).all()
    # each row's weights sum to 1
    sums = np.bincount(rows[:e_valid], got.detach().numpy()[:e_valid], minlength=n)
    np.testing.assert_allclose(sums[np.bincount(rows[:e_valid], minlength=n) > 0], 1.0,
                               rtol=1e-5)


def test_segment_softmax_routes_through_k2(monkeypatch):
    from deeprank_gnn_tpu_torch.ops import segment

    calls = []
    real = segment.sorted_scatter_gather
    monkeypatch.setattr(segment, "sorted_scatter_gather",
                        lambda d, p: calls.append(tuple(d.shape)) or real(d, p))
    n, _, rows, ptr, logits, _ = _softmax_inputs(8)
    segment.segment_softmax(torch.from_numpy(logits), torch.from_numpy(rows), n)
    assert calls == []
    segment.segment_softmax(torch.from_numpy(logits), torch.from_numpy(rows), n,
                            row_ptr=torch.from_numpy(ptr))
    assert calls == [(len(rows), 1)]  # one K2 call, at F = 1


def test_segment_mean_sorted_matches_jax():
    """``segment_mean(row_ptr=...)`` (the sum on K1, the counts from the
    runs' lengths) against the JAX package's ``segment_mean(sorted_ids=
    True)``, forward and gradient, with empty rows and padding."""
    import jax
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.segment import segment_mean as jax_mean
    from deeprank_gnn_tpu_torch.ops.segment import segment_mean

    rng = np.random.default_rng(9)
    n, e_valid, e_pad, f = 90, 400, 450, 6
    rows = sorted_rows(rng, n, e_valid, e_pad, long_run=True)
    ptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int32)
    data = rng.standard_normal((e_pad, f)).astype(np.float32)
    cot = rng.standard_normal((n, f)).astype(np.float32)
    jr = jnp.asarray(rows)
    want, vjp = jax.vjp(lambda d: jax_mean(d, jr, n, sorted_ids=True), jnp.asarray(data))
    (want_grad,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(data).requires_grad_(True)
    got = segment_mean(x, torch.from_numpy(rows), n, row_ptr=torch.from_numpy(ptr))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=5e-4, atol=1e-5)
    assert not x.grad[e_valid:].any()
    np.testing.assert_allclose(
        got.detach().numpy(), segment_mean(torch.from_numpy(data), torch.from_numpy(rows), n),
        **TOL)

"""PyTorch port vs JAX package: K2 (sorted scatter-gather).

K2's plain version is held against the JAX package's Pallas kernel in
interpret mode (``deeprank_gnn_tpu/ops/pallas/segment.py:
sorted_scatter_gather``, as ``tests/test_pallas_sorted.py`` runs it),
forward and VJP, with padding rows, empty rows and a run across the Pallas
kernel's block boundary. The sums agree at rtol 2e-4, atol 1e-5 (the
summation order differs), gradients at rtol 5e-4; ``d2`` is bitwise
``out[rows]``, 0 at padding. The plain version sums each row in ascending
edge order, bitwise a loop over the edges, and so does the kernel. The CUDA
kernel itself is checked on the card by ``chip_smoke.py``, bitwise against
the plain version on the CPU; ``test_k2_cuda_matches_plain`` runs it where a
card is present.
"""

import numpy as np
import pytest
import torch

TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)


def sorted_rows(rng, n, e_valid, e_pad, long_run=False):
    """Nondecreasing rows in [0, n) with empty rows (two of three), optionally
    one run of many edges, then padding rows == n."""
    rows = np.sort(rng.choice(np.arange(0, n, 3), e_valid))
    if long_run:
        rows[: e_valid // 2] = 3 * (n // 6)  # an empty-row pattern row
        rows = np.sort(rows)
    return np.concatenate([rows, np.full(e_pad - e_valid, n)]).astype(np.int32)


def csr(rows, n):
    return np.searchsorted(rows, np.arange(n + 1)).astype(np.int32)


def jax_scatter_gather(data, rows, n):
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.pallas.segment import required_window, sorted_scatter_gather

    return sorted_scatter_gather(jnp.asarray(data), jnp.asarray(rows), n, True,
                                 required_window(rows, n))


@pytest.mark.parametrize("f", [1, 8, 17])
def test_k2_plain_matches_jax_interpret(f):
    from deeprank_gnn_tpu_torch.ops.kernels.scatter_gather import sorted_scatter_gather_plain

    rng = np.random.default_rng(f)
    n, e_valid, e_pad = 400, 1500, 1600
    rows = sorted_rows(rng, n, e_valid, e_pad, long_run=f == 8)
    data = rng.standard_normal((e_pad, f)).astype(np.float32)
    want_out, want_d2 = (np.asarray(a) for a in jax_scatter_gather(data, rows, n))
    t = torch.from_numpy
    for out, d2 in (sorted_scatter_gather_plain(t(data), t(csr(rows, n))),
                    sorted_scatter_gather_plain(t(data), t(csr(rows, n)), t(rows))):
        assert out.shape == (n, f) and d2.shape == (e_pad, f)
        np.testing.assert_allclose(out.numpy(), want_out, **TOL)
        np.testing.assert_allclose(d2.numpy(), want_d2, **TOL)
        # d2 is out gathered at each edge's row, 0 at padding, bitwise
        np.testing.assert_array_equal(d2.numpy()[:e_valid], out.numpy()[rows[:e_valid]])
        assert not d2[e_valid:].any()
        assert not out[1::3].any() and not out[2::3].any()  # empty rows give 0


def test_k2_multiblock_boundary_matches_jax():
    """A run across the Pallas kernel's block boundary (its gather phase
    must see the final sums), ones as values: every sum is exact, so the
    port and the interpret-mode kernel agree bitwise."""
    from deeprank_gnn_tpu.ops.pallas.segment import BLOCK_EDGES
    from deeprank_gnn_tpu_torch.ops.kernels.scatter_gather import sorted_scatter_gather_plain

    e, n = 2 * BLOCK_EDGES, 600
    rows = np.full(e, 511, dtype=np.int32)
    rows[: BLOCK_EDGES // 2] = 3
    rows[-BLOCK_EDGES // 2:] = 598
    data = np.ones((e, 4), dtype=np.float32)
    want_out, want_d2 = (np.asarray(a) for a in jax_scatter_gather(data, rows, n))
    out, d2 = sorted_scatter_gather_plain(torch.from_numpy(data), torch.from_numpy(csr(rows, n)))
    np.testing.assert_array_equal(out.numpy(), want_out)
    np.testing.assert_array_equal(d2.numpy(), want_d2)
    assert out[511, 0] == BLOCK_EDGES


def test_k2_leading_padding_and_no_rows():
    """The CSR convention allows edges before ``row_ptr[0]``: they gather 0
    as trailing padding does. With no rows at all every edge gathers 0."""
    from deeprank_gnn_tpu_torch.ops.kernels.scatter_gather import sorted_scatter_gather

    data = torch.arange(1.0, 13.0).reshape(6, 2)
    ptr = torch.tensor([2, 2, 4, 5], dtype=torch.int32)  # edges 0, 1 and 5 outside
    out, d2 = sorted_scatter_gather(data, ptr)
    torch.testing.assert_close(out, torch.tensor([[0.0, 0.0], [12.0, 14.0], [9.0, 10.0]]))
    torch.testing.assert_close(d2, torch.tensor(
        [[0.0, 0.0], [0.0, 0.0], [12.0, 14.0], [12.0, 14.0], [9.0, 10.0], [0.0, 0.0]]))
    out, d2 = sorted_scatter_gather(data, torch.tensor([6], dtype=torch.int32))
    assert out.shape == (0, 2) and d2.shape == (6, 2) and not d2.any()


def test_k2_vjp_matches_jax_interpret():
    """``SortedScatterGather`` (the JAX package's ``_sg_bwd``: the scatter of
    the d2-cotangent added to the out-cotangent, then gathered) against the
    Pallas kernel's custom VJP in interpret mode, with both cotangents and
    with the out-cotangent absent (None), as on the softmax path."""
    import jax
    import jax.numpy as jnp

    from deeprank_gnn_tpu.ops.pallas.segment import required_window, sorted_scatter_gather
    from deeprank_gnn_tpu_torch.ops.segment import SortedScatterGather

    rng = np.random.default_rng(3)
    n, e_valid, e_pad, f = 300, 900, 1000, 5
    rows = sorted_rows(rng, n, e_valid, e_pad)
    data = rng.standard_normal((e_pad, f)).astype(np.float32)
    w1 = rng.standard_normal((n, f)).astype(np.float32)
    w2 = rng.standard_normal((e_pad, f)).astype(np.float32)
    jr, window = jnp.asarray(rows), required_window(rows, n)
    ptr = torch.from_numpy(csr(rows, n))
    for use_out in (True, False):
        def jax_loss(d):
            o, g = sorted_scatter_gather(d, jr, n, True, window)
            return (g * w2).sum() + ((o * w1).sum() if use_out else 0.0)

        want = np.asarray(jax.grad(jax_loss)(jnp.asarray(data)))
        x = torch.from_numpy(data).requires_grad_(True)
        out, d2 = SortedScatterGather.apply(x, ptr)
        loss = (d2 * torch.from_numpy(w2)).sum()
        if use_out:
            loss = loss + (out * torch.from_numpy(w1)).sum()
        loss.backward()
        np.testing.assert_allclose(x.grad.numpy(), want, **GRAD_TOL)
        assert not x.grad[e_valid:].any()  # padding edges get no gradient


@pytest.mark.parametrize("padding", ["leading", "trailing"])
def test_k2_plain_sums_in_edge_order(padding):
    """At F = 1, the softmax's width, the plain version on the CPU sums each
    row in ascending edge order: ``out`` bitwise a loop over the edges from
    0, ``d2`` bitwise ``out[rows]`` and 0 at padding, with random values, an
    8,000-edge run (longer than the kernel's shared-memory tile), empty rows
    and padding before the first row's run or after the last. The kernel
    sums in the same order, so the card's check holds it to the plain
    version on the CPU bitwise."""
    from deeprank_gnn_tpu_torch.ops.kernels.scatter_gather import sorted_scatter_gather
    from test_torch_segment import edge_order_sum, long_run_rows

    rng = np.random.default_rng(31)
    n = 1500
    lead, trail = (300, 0) if padding == "leading" else (0, 777)
    rows = long_run_rows(rng, n, lead, trail)
    ptr = csr(rows, n)
    data = rng.standard_normal((len(rows), 1)).astype(np.float32)
    out, d2 = (a.numpy() for a in sorted_scatter_gather(torch.from_numpy(data),
                                                        torch.from_numpy(ptr)))
    want = edge_order_sum(data, ptr)
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))
    valid = (rows >= 0) & (rows < n)
    np.testing.assert_array_equal(d2[valid].view(np.int32), want[rows[valid]].view(np.int32))
    assert not d2[~valid].any() and (~valid).sum() == lead + trail


@pytest.mark.parametrize("cotangents", ["d2", "both", "out"])
def test_k2_backward_routes(monkeypatch, cotangents):
    """``SortedScatterGather.backward`` with only the ``d2`` cotangent (the
    softmax path) is one K2 call on it and no K1 call; with both it is one
    K1 call and no K2 call (then the gather); with only ``out``'s, neither.
    The gradient is bitwise the JAX ``_sg_bwd`` composition computed with
    K1's plain version: ``(g_out + segment_sum(g_d2))[rows]``, 0 at
    padding."""
    from deeprank_gnn_tpu_torch.ops import segment
    from deeprank_gnn_tpu_torch.ops.kernels.segment import (
        sorted_segment_sum_backward,
        sorted_segment_sum_plain,
    )

    calls = []
    real_k1, real_k2 = segment.sorted_segment_sum, segment.sorted_scatter_gather
    monkeypatch.setattr(segment, "sorted_segment_sum",
                        lambda d, p: calls.append("K1") or real_k1(d, p))
    monkeypatch.setattr(segment, "sorted_scatter_gather",
                        lambda d, p: calls.append("K2") or real_k2(d, p))
    rng = np.random.default_rng(4)
    n, e_valid, e_pad = 200, 700, 760
    rows = sorted_rows(rng, n, e_valid, e_pad, long_run=True)
    ptr = torch.from_numpy(csr(rows, n))
    data = torch.from_numpy(rng.standard_normal((e_pad, 1)).astype(np.float32))
    g_out = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32))
    g_d2 = torch.from_numpy(rng.standard_normal((e_pad, 1)).astype(np.float32))
    x = data.clone().requires_grad_(True)
    out, d2 = segment.SortedScatterGather.apply(x, ptr)
    assert calls == ["K2"]  # the forward
    calls.clear()
    loss = 0.0
    if cotangents in ("d2", "both"):
        loss = loss + (d2 * g_d2).sum()
    if cotangents in ("out", "both"):
        loss = loss + (out * g_out).sum()
    loss.backward()
    assert calls == {"d2": ["K2"], "both": ["K1"], "out": []}[cotangents]
    dout = torch.zeros((n, 1))
    if cotangents != "out":
        dout = sorted_segment_sum_plain(g_d2, ptr)
    if cotangents != "d2":
        dout = g_out if cotangents == "out" else g_out + dout
    want = sorted_segment_sum_backward(dout, torch.from_numpy(rows))
    assert torch.equal(x.grad, want)
    assert not x.grad[e_valid:].any()


def test_k2_wrapper_never_falls_back():
    """Only a CPU tensor takes the plain version. Off the CPU the kernel
    path's own checks run (on meta tensors, which need no card) and a
    device other than CUDA raises; nothing gives way to the plain version."""
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.ops.kernels.scatter_gather import sorted_scatter_gather

    meta = torch.empty((10, 4), device="meta")
    ptr = torch.empty((3,), dtype=torch.int32, device="meta")
    launches = dict(LAUNCHES)
    with pytest.raises(ValueError, match="sorted_scatter_gather runs on cpu or cuda"):
        sorted_scatter_gather(meta, ptr)
    with pytest.raises(TypeError, match="float32"):
        sorted_scatter_gather(meta.double(), ptr)
    with pytest.raises(TypeError, match="int32"):
        sorted_scatter_gather(meta, ptr.long())
    with pytest.raises(ValueError, match="contiguous"):
        sorted_scatter_gather(torch.empty((4, 10), device="meta").t(), ptr)
    with pytest.raises(ValueError, match="on meta but row_ptr on cpu"):
        sorted_scatter_gather(meta, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[E, F\]"):
        sorted_scatter_gather(torch.zeros(10), torch.zeros(3, dtype=torch.int32))
    assert dict(LAUNCHES) == launches


@pytest.mark.cuda
def test_k2_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.ops.kernels.scatter_gather import (
        sorted_scatter_gather,
        sorted_scatter_gather_plain,
    )

    rng = np.random.default_rng(0)
    for f in (1, 2, 17, 32, 100):
        rows = sorted_rows(rng, 500, 4000, 4300, long_run=True)
        data = torch.from_numpy(rng.standard_normal((4300, f)).astype(np.float32)).cuda()
        ptr = torch.from_numpy(csr(rows, 500)).cuda()
        before = LAUNCHES["sorted_scatter_gather"]
        a_out, a_d2 = sorted_scatter_gather(data, ptr)
        b_out, b_d2 = sorted_scatter_gather(data, ptr)
        torch.cuda.synchronize()
        assert LAUNCHES["sorted_scatter_gather"] == before + 2
        assert torch.equal(a_out, b_out) and torch.equal(a_d2, b_d2)
        want_out, want_d2 = sorted_scatter_gather_plain(data.cpu(), ptr.cpu())
        # both sum in edge order
        assert torch.equal(a_out.cpu(), want_out) and torch.equal(a_d2.cpu(), want_d2)
        assert torch.equal(a_d2[:4000], a_out[torch.from_numpy(rows[:4000]).cuda().long()])
        assert not a_d2[4000:].any()

"""PyTorch port vs JAX package: K2 (sorted scatter-gather).

K2's plain version is held against the JAX package's Pallas kernel in
interpret mode (``deeprank_gnn_tpu/ops/pallas/segment.py:
sorted_scatter_gather``, as ``tests/test_pallas_sorted.py`` runs it),
forward and VJP, with padding rows, empty rows and a run across the Pallas
kernel's block boundary. The sums agree at rtol 2e-4, atol 1e-5 (the
summation order differs), gradients at rtol 5e-4; ``d2`` is bitwise
``out[rows]``, 0 at padding. The CUDA kernel itself is checked on the card
by ``chip_smoke.py``; ``test_k2_cuda_matches_plain`` runs it where a card
is present.
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
        want_out, want_d2 = sorted_scatter_gather_plain(data, ptr)
        torch.testing.assert_close(a_out, want_out, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(a_d2, want_d2, rtol=1e-5, atol=1e-5)
        assert torch.equal(a_d2[:4000], a_out[torch.from_numpy(rows[:4000]).cuda().long()])
        assert not a_d2[4000:].any()

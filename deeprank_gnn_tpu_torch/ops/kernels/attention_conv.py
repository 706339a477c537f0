"""K4: the dense attention conv as one edge kernel per call, forward and
backward, over a per-graph CSR (CUDA kernels, plain versions, autograd
Function).

GINet's attention conv (``attention=True``, reference ``ginet.py:50-73``) in
the dense layout. Its logit ``[x_r W | x_c W | e W_e] . a`` splits into one
scalar a node at each end and one an edge: with ``xw = x W``,
``p = xw . a[:F]``, ``q = xw . a[F:2F]`` ([G, S] each) and ``b = (e W_e) .
a[2F:]`` ([G, E]), a lane ``e`` of graph ``g`` with row ``r`` and col ``c``
has ``z_e = leaky_relu((p[r] + q[c]) + b_e)``, and::

    alpha = softmax of z over each row's lanes
    out[g, r] = sum over the row's lanes e of alpha_e * xw[g, c_e]

A lane whose row or col lies outside ``[0, S)`` (the dense collate's
sentinel ``S``) drops out (weight 0); a row without lanes gives 0. The caller
computes ``xw``, ``p``, ``q`` and ``b`` in plain torch, so autograd gives the
gradients of ``fc``, ``fc_attention`` and ``fc_edge_attr`` from this op's
gradients with respect to them.

It replaces no TPU kernel: the JAX package leaves the conv to XLA
(``deeprank_gnn_tpu/models/ginet.py`` ``conv_att``). The plain version
(:func:`fused_attention_conv_plain`) is the formula above in torch over
``[G, E]`` edge slots, with ``ops/dense.py``'s ``dense_segment_softmax`` and
``edge_sum_to_slots``; it runs on the CPU in any dtype, and its backward
(:func:`fused_attention_conv_plain_bwd`) is the kernels' formula:

    dA_e = dout[r] . xw[c],  s_r = sum alpha_e dA_e,
    db_e = alpha_e (dA_e - s_r) leaky_relu'(pre_e),  dp[r] = sum db_e,
    dxw[c] = sum alpha_e dout[r_e],  dq[c] = sum db_e.

On a card (``ops/csrc/fused_attention_conv.cu``): :func:`attention_csr`
sorts a graph's lanes by one index into ``ptr [G, S + 1]`` and ``perm
[G, E]`` (one block a graph, counts and stable ranks in shared memory); the
forward walks each row's lanes in ascending lane order (a group of lanes a
row: max, denominator, weights and the weighted sum, written once, with the
weights saved); the backward is two passes, by row over the row CSR and by
col over the col CSR. Every sum adds in ascending lane order with no
atomics, so two launches are bitwise equal. A step builds
each of its four CSRs once (conv1's and conv2's, by row and by col), and the
four convs of both towers share them.

``LAUNCHES`` counts ``attention_csr`` once a build, ``fused_attention_conv``
once a forward call and ``fused_attention_conv_bwd`` twice a backward call
(its two passes).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch.nn import functional as F

from deeprank_gnn_tpu_torch.ops.dense import dense_segment_softmax, edge_sum_to_slots, gather_nodes
from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES, build
from deeprank_gnn_tpu_torch.ops.lanes import not_counted

LIBRARY = "fused_attention_conv"
NAME = "fused_attention_conv"
NAME_BWD = "fused_attention_conv_bwd"
NAME_CSR = "attention_csr"


class AttentionCSR(NamedTuple):
    """A graph's lanes sorted by one index: ``perm[g, ptr[g, k]:ptr[g, k + 1]]``
    are the lanes of row ``k`` in ascending order, and ``perm[g, ptr[g, S]:]``
    the dropped lanes, ascending. Both int32."""

    ptr: torch.Tensor  # [G, S + 1]
    perm: torch.Tensor  # [G, E]


def _kept(key: torch.Tensor, other: torch.Tensor, size: int) -> torch.Tensor:
    """``key`` where both indices lie in ``[0, size)``, else ``size``."""
    keep = (key >= 0) & (key < size) & (other >= 0) & (other < size)
    return torch.where(keep, key, size)


def attention_csr_plain(key: torch.Tensor, other: torch.Tensor, size: int) -> AttentionCSR:
    """The plain version of :func:`attention_csr`: a stable sort of each
    graph's lanes by ``key`` (a lane with ``key`` or ``other`` outside
    ``[0, size)`` sorts as ``size``), and each row's first place by a search
    of the sorted keys."""
    bucket = _kept(key.long(), other.long(), size)
    sorted_keys, perm = torch.sort(bucket, dim=1, stable=True)
    rows = torch.arange(size + 1, device=key.device).expand(key.shape[0], -1).contiguous()
    ptr = torch.searchsorted(sorted_keys, rows)
    return AttentionCSR(ptr.to(torch.int32), perm.to(torch.int32))


def _check_pair(key: torch.Tensor, other: torch.Tensor) -> None:
    if key.dim() != 2 or key.shape != other.shape:
        raise ValueError(f"want key, other [G, E]; got {tuple(key.shape)}, {tuple(other.shape)}")
    if key.device != other.device:
        raise ValueError(f"key on {key.device}, other on {other.device}")


def _check_cuda(name: str, sizes, ints=(), floats=()) -> None:
    """Raise unless every tensor is contiguous on a CUDA device, ``ints``
    int32 and ``floats`` float32, and every size fits in int32."""
    for t in (*ints, *floats):
        if t.device.type != "cuda":
            raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
    if any(t.dtype != torch.int32 for t in ints) or any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{name} takes float32 values and int32 indices; got "
                        f"{[t.dtype for t in (*floats, *ints)]}")
    if max(sizes) >= 2**31:
        raise ValueError(f"{name}: sizes must fit in int32")


def attention_csr(key: torch.Tensor, other: torch.Tensor, size: int) -> AttentionCSR:
    """Each graph's lanes of ``key [G, E]`` sorted by row (``size`` rows),
    ties in ascending lane order; a lane with ``key`` or ``other`` outside
    ``[0, size)`` is left out of the rows and listed last. On a CPU tensor
    the plain version; on a CUDA tensor one launch (contiguous int32 in) or
    a raise."""
    _check_pair(key, other)
    if key.device.type == "cpu":
        return attention_csr_plain(key, other, size)
    g, e = key.shape
    _check_cuda(NAME_CSR, (g, e, size + 1), ints=(key, other))
    ptr = torch.empty((g, size + 1), dtype=torch.int32, device=key.device)
    perm = torch.empty((g, e), dtype=torch.int32, device=key.device)
    lib = build.load(LIBRARY)
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream(key.device).cuda_stream
        err = lib.attention_csr(key.data_ptr(), other.data_ptr(), ptr.data_ptr(),
                                perm.data_ptr(), g, size, e, stream)
    if err != 0:
        raise RuntimeError(f"attention_csr launch failed: CUDA error {err}")
    LAUNCHES[NAME_CSR] += 1
    return AttentionCSR(ptr, perm)


def fused_attention_conv_plain(xw, p, q, b, row, col):
    """The plain version of the forward: ``(out [G, S, F], alpha [G, E])``,
    the logits from the scalars, ``dense_segment_softmax`` over the kept
    lanes' rows and ``edge_sum_to_slots`` of ``xw[col] * alpha``. Counts
    nothing in ``ACCUMULATED``."""
    s = xw.shape[1]
    with not_counted():
        rows = _kept(row, col, s)
        pre = gather_nodes(p[..., None], rows)[..., 0] + gather_nodes(q[..., None], col)[..., 0] + b
        alpha = dense_segment_softmax(F.leaky_relu(pre), rows, s)
        out = edge_sum_to_slots(gather_nodes(xw, col) * alpha[..., None], rows, s)
    return out, alpha


def fused_attention_conv_plain_bwd(dout, xw, p, q, b, row, col, alpha):
    """The plain version of the backward: ``(dxw, dp, dq, db)`` for the
    cotangent ``dout``, the kernels' formula (module docstring) with the
    sums in lane order. Counts nothing in ``ACCUMULATED``."""
    s = xw.shape[1]
    with not_counted():
        rows, cols = _kept(row, col, s), _kept(col, row, s)
        dr = gather_nodes(dout, rows)
        da = (dr * gather_nodes(xw, col)).sum(dim=-1)
        sr = edge_sum_to_slots((alpha * da)[..., None], rows, s)
        u = alpha * (da - gather_nodes(sr, rows)[..., 0])
        pre = gather_nodes(p[..., None], rows)[..., 0] + gather_nodes(q[..., None], col)[..., 0] + b
        db = torch.where(pre > 0, u, u * 0.01)
        dp = edge_sum_to_slots(db[..., None], rows, s)[..., 0]
        dxw = edge_sum_to_slots(alpha[..., None] * dr, cols, s)
        dq = edge_sum_to_slots(db[..., None], cols, s)[..., 0]
    return dxw, dp, dq, db


def _check(xw, p, q, b, row, col, by_row: Optional[AttentionCSR]) -> None:
    if xw.dim() != 3:
        raise ValueError(f"want xw [G, S, F]; got {tuple(xw.shape)}")
    _check_pair(row, col)
    g, s, _ = xw.shape
    e = row.shape[1]
    want = {"p": (g, s), "q": (g, s), "b": (g, e), "row": (g, e), "ptr": (g, s + 1),
            "perm": (g, e)}
    csr = () if by_row is None else (("ptr", by_row.ptr), ("perm", by_row.perm))
    for name, t in (("p", p), ("q", q), ("b", b), ("row", row), *csr):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: want {want[name]} for xw {tuple(xw.shape)} and "
                             f"{e} lanes; got {tuple(t.shape)}")
    if len({t.device for t in (xw, p, q, b, row, *(t for _, t in csr))}) != 1:
        raise ValueError("xw, p, q, b, row, col and the CSR must share a device")


def _need_csr(name: str, **csrs) -> None:
    missing = [k for k, v in csrs.items() if v is None]
    if missing:
        raise RuntimeError(f"{name} on a card needs the {' and '.join(missing)} CSR "
                           "(attention_csr(row, col, S), attention_csr(col, row, S))")


def fused_attention_conv_forward(xw, p, q, b, row, col,
                                 by_row: Optional[AttentionCSR] = None):
    """The forward without autograd: ``(out, alpha)``. On CPU tensors the
    plain version, which reads no CSR; on CUDA tensors one launch over the
    row CSR ``by_row`` (``attention_csr(row, col, S)``): float32 values and
    int32 indices, all contiguous, or a raise."""
    _check(xw, p, q, b, row, col, by_row)
    if xw.device.type == "cpu":
        return fused_attention_conv_plain(xw, p, q, b, row, col)
    _need_csr(NAME, row=by_row)
    g, s, f = xw.shape
    e = row.shape[1]
    _check_cuda(NAME, (g, s + 1, f, e), ints=(row, col, *by_row), floats=(xw, p, q, b))
    alpha = torch.empty((g, e), dtype=torch.float32, device=xw.device)
    out = torch.empty_like(xw)
    lib = build.load(LIBRARY)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        err = lib.fused_attention_conv_f32(
            xw.data_ptr(), p.data_ptr(), q.data_ptr(), b.data_ptr(), col.data_ptr(),
            by_row.ptr.data_ptr(), by_row.perm.data_ptr(), out.data_ptr(), alpha.data_ptr(),
            g, s, f, e, stream)
    if err != 0:
        raise RuntimeError(f"fused_attention_conv launch failed: CUDA error {err}")
    LAUNCHES[NAME] += 1
    return out, alpha


def fused_attention_conv_backward(dout, xw, p, q, b, row, col, alpha,
                                  by_row: Optional[AttentionCSR] = None,
                                  by_col: Optional[AttentionCSR] = None):
    """The backward without autograd: ``(dxw, dp, dq, db)``. On CPU tensors
    the plain version, which reads no CSR; on CUDA tensors two launches, by
    row over ``by_row`` and by col over ``by_col`` (``attention_csr(col,
    row, S)``), or a raise."""
    _check(xw, p, q, b, row, col, by_row)
    if tuple(dout.shape) != tuple(xw.shape) or tuple(alpha.shape) != tuple(row.shape):
        raise ValueError(f"dout {tuple(dout.shape)} and alpha {tuple(alpha.shape)} do not "
                         f"fit xw {tuple(xw.shape)} and row {tuple(row.shape)}")
    if xw.device.type == "cpu":
        return fused_attention_conv_plain_bwd(dout, xw, p, q, b, row, col, alpha)
    _need_csr(NAME_BWD, row=by_row, col=by_col)
    if tuple(by_col.ptr.shape) != tuple(by_row.ptr.shape) or \
            tuple(by_col.perm.shape) != tuple(by_row.perm.shape):
        raise ValueError("the col CSR does not fit the row CSR")
    g, s, f = xw.shape
    e = row.shape[1]
    _check_cuda(NAME_BWD, (g, s + 1, f, e), ints=(row, col, *by_row, *by_col),
                floats=(dout, xw, p, q, b, alpha))
    dxw = torch.empty_like(xw)
    dp = torch.empty_like(p)
    dq = torch.empty_like(q)
    db = torch.empty_like(b)
    lib = build.load(LIBRARY)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        err = lib.fused_attention_conv_bwd_f32(
            dout.data_ptr(), xw.data_ptr(), p.data_ptr(), q.data_ptr(), b.data_ptr(),
            row.data_ptr(), col.data_ptr(), alpha.data_ptr(), by_row.ptr.data_ptr(),
            by_row.perm.data_ptr(), by_col.ptr.data_ptr(), by_col.perm.data_ptr(),
            dxw.data_ptr(), dp.data_ptr(), dq.data_ptr(), db.data_ptr(), g, s, f, e, stream)
    if err != 0:
        raise RuntimeError(f"fused_attention_conv_bwd launch failed: CUDA error {err}")
    LAUNCHES[NAME_BWD] += 2
    return dxw, dp, dq, db


def launch_plan(device, s: int, f: int) -> dict:
    """The launches for ``S`` rows of ``F`` columns on ``device``: the
    conv passes' ``lanes_per_row``, ``vec`` (floats a lane loads at a time
    where the pointers are 16-byte aligned) and ``rows_per_block``; the CSR
    build's ``csr_warps`` and ``csr_smem_bytes`` (one block a graph)."""
    lib = build.load(LIBRARY)
    plan = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = lib.fused_attention_conv_plan(s, f, plan)
    if err != 0:
        raise RuntimeError(f"fused_attention_conv plan: CUDA error {err}")
    return dict(zip(("lanes_per_row", "vec", "rows_per_block", "csr_warps", "csr_smem_bytes"),
                    plan))


class FusedAttentionConv(torch.autograd.Function):
    """The conv with its gradients with respect to ``xw``, ``p``, ``q`` and
    ``b``; on a card the backward needs the col CSR."""

    @staticmethod
    def forward(ctx, xw, p, q, b, row, col, by_row, by_col):
        xw, p, q, b = (t.contiguous() for t in (xw, p, q, b))
        out, alpha = fused_attention_conv_forward(xw, p, q, b, row, col, by_row)
        ctx.save_for_backward(xw, p, q, b, row, col, alpha)
        ctx.by_row, ctx.by_col = by_row, by_col
        return out

    @staticmethod
    def backward(ctx, dout):
        xw, p, q, b, row, col, alpha = ctx.saved_tensors
        grads = fused_attention_conv_backward(dout.contiguous(), xw, p, q, b, row, col, alpha,
                                              ctx.by_row, ctx.by_col)
        return (*grads, None, None, None, None)


def fused_attention_conv(xw: torch.Tensor, p: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                         row: torch.Tensor, col: torch.Tensor,
                         by_row: Optional[AttentionCSR] = None,
                         by_col: Optional[AttentionCSR] = None) -> torch.Tensor:
    """``out [G, S, F]`` of the attention conv (module docstring) from
    ``xw [G, S, F]``, ``p``, ``q [G, S]``, ``b [G, E]`` and ``row``, ``col
    [G, E]``, differentiable in the four value tensors. On a card
    ``by_row``, ``attention_csr(row, col, S)``, is needed, and for a
    backward ``by_col``, ``attention_csr(col, row, S)``; the plain version
    on the CPU reads neither."""
    return FusedAttentionConv.apply(xw, p, q, b, row, col, by_row, by_col)

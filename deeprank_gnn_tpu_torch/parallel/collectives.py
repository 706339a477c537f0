"""The collectives of the multi-device paths, with their transposes.

In the JAX package ``shard_map`` and XLA's partitioner derive these; here
each is issued by hand over a process group (``parallel/mesh.py``), and
the differentiable ones are ``torch.autograd.Function``s whose backward is
their transpose:

- :func:`all_to_all` (``lax.all_to_all``, tiled on axis 0): block ``d`` of
  ``x [D, ...]`` goes to rank ``d``; its transpose is the reverse
  all-to-all, which is the same call;
- :func:`all_gather` (``lax.all_gather``) -> ``[D, ...]`` in rank order;
  its transpose is a reduce-scatter: the ranks' cotangents summed, each
  rank keeping its own block;
- :func:`all_reduce` (``lax.psum``, a sum); its transpose is itself.

The route follows the group's backend, never a caught failure. NCCL takes
CUDA tensors as they are (the reduce-scatter is NCCL's). Gloo stages CUDA
tensors through host copies (the device-to-host copy, the collective on
the host, the copy back), and writes the reduce-scatter as an all-reduce
and a slice, since gloo lacks a reduce-scatter for CUDA tensors. With no
process group (a one-rank mesh in a single process) each is the identity,
``all_gather`` adds the unit axis, and nothing is issued.

``BYTES`` counts the bytes each rank hands to the collectives it issues,
by ``"<op>/<role>"``: the operand of the call (for an all-to-all the whole
``[D, ...]`` send buffer, for an all-gather this rank's block, for its
backward, the reduce-scatter, the ``[D, ...]`` cotangent), with role ``forward`` or
``backward`` for the differentiable ones and the caller's role (``loss``,
``gradients``, ``outputs``) for the others. It is the port's counterpart of
``parallel/hlo_bytes.py``: there is no compiled program to read here, so
the port counts what it issues. :func:`collective_bytes` reads it and
:func:`reset_collective_bytes` clears it.
"""

from __future__ import annotations

from collections import Counter
import torch
import torch.distributed as dist

BYTES: Counter = Counter()


def collective_bytes() -> dict:
    """The bytes counted since the last reset, by ``"<op>/<role>"``."""
    return dict(BYTES)


def reset_collective_bytes() -> None:
    BYTES.clear()


def group_size(group) -> int:
    """Ranks in ``group``; 1 for ``None`` (no process group)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(x: torch.Tensor, group) -> bool:
    """Gloo with a CUDA tensor: the collective runs on a host copy."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _count(op: str, role: str, x: torch.Tensor) -> None:
    BYTES[f"{op}/{role}"] += x.numel() * x.element_size()


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    staged = _staged(x, group)
    src = x.cpu() if staged else x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if staged else out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    staged = _staged(x, group)
    src = x.cpu() if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return out.to(x.device) if staged else out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    staged = _staged(x, group)
    out = x.cpu() if staged else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device) if staged else out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x [D, ...]`` over the ranks; this rank's block ``[...]``."""
    if dist.get_backend(group) == "gloo":
        return _all_reduce(x, group)[group_rank(group)]
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count("all_to_all", "forward", x)
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        _count("all_to_all", "backward", g)
        return _all_to_all(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count("all_gather", "forward", x)
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        _count("all_gather", "backward", g)
        return _reduce_scatter(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count("all_reduce", "forward", x)
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        _count("all_reduce", "backward", g)
        return _all_reduce(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``d`` of ``x [D, ...]`` to rank ``d``; block ``s`` of the
    result came from rank ``s``. Differentiable."""
    if group is None:
        return x
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, ``[D, *x.shape]``.
    Differentiable (backward: reduce-scatter)."""
    if group is None:
        return x[None]
    return _AllGather.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``. Differentiable (backward: itself)."""
    if group is None:
        return x
    return _AllReduce.apply(x, group)


def all_reduce_values(x: torch.Tensor, group, role: str) -> torch.Tensor:
    """:func:`all_reduce` of a tensor outside autograd (a loss's terms, the
    gradients), counted under ``role``."""
    if group is None:
        return x
    _count("all_reduce", role, x)
    return _all_reduce(x.detach(), group)


def all_gather_values(x: torch.Tensor, group, role: str) -> torch.Tensor:
    """:func:`all_gather` outside autograd, counted under ``role``."""
    if group is None:
        return x[None]
    _count("all_gather", role, x)
    return _all_gather(x.detach(), group)

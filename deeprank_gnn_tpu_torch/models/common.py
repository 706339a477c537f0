"""Shared model utilities: initializers, linear layer, dropout, and the
skeleton of the single-tower nets.

The port's counterpart of ``deeprank_gnn_tpu/models/common.py``, with the
reference's initializer bounds:

- PyG's ``uniform(size, tensor)`` (all conv parameters, reference
  `ginet.py:43-48`) draws U(-1/sqrt(size), 1/sqrt(size));
- torch ``nn.Linear``'s default (the fc heads) draws weight and bias
  from U(-1/sqrt(fan_in), 1/sqrt(fan_in)).

Weights are in torch layout ``[out, in]`` (applied as x @ W.T), so the
reference's state dicts load unchanged. Draws come from an explicit CPU
``torch.Generator``, so a seed gives the same weights on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from deeprank_gnn_tpu_torch.data.dense_batch import DenseGraphBatch
from deeprank_gnn_tpu_torch.device import resolve_device, set_fp32_numerics


def uniform_init(
    shape: Tuple[int, ...], size: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """PyG `torch_geometric.nn.inits.uniform`: U(-1/sqrt(size), 1/sqrt(size))."""
    bound = 1.0 / (size ** 0.5)
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2 * bound) - bound


def linear_init(
    in_features: int, out_features: int, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch nn.Linear default init -> (weight [out, in], bias [out])."""
    w = uniform_init((out_features, in_features), in_features, generator)
    b = uniform_init((out_features,), in_features, generator)
    return w, b


def linear_module(weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> nn.Linear:
    """An ``nn.Linear`` holding the given tensors (built uninitialized,
    so it draws nothing from the global RNG)."""
    m = nn.utils.skip_init(
        nn.Linear, weight.shape[1], weight.shape[0], bias=bias is not None
    )
    with torch.no_grad():
        m.weight.copy_(weight)
        if bias is not None:
            m.bias.copy_(bias)
    return m


def linear(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """x @ W.T (+ b) with torch-layout weight [out, in]."""
    y = x @ w.T
    if b is not None:
        y = y + b
    return y


def dropout(
    x: torch.Tensor,
    rate: float,
    generator: Optional[torch.Generator],
    training: bool,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Inverted dropout matching `F.dropout` (reference `ginet.py:138`);
    the mask is drawn from ``generator`` (on x's device), or from torch's
    default generator when it is None. ``rows = (num_rows, lo)``: ``x`` is
    rows ``[lo, lo + len(x))`` of a ``[num_rows, ...]`` array whose other
    rows lie on other ranks; the mask is drawn at the whole shape and these
    rows are kept, so that a mesh with equal generators on every rank draws
    the single-device mask (as JAX's draw at the global shape does)."""
    if not training or rate == 0.0:
        return x
    if rows is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    else:
        num_rows, lo = rows
        full = torch.rand((num_rows,) + tuple(x.shape[1:]), generator=generator,
                          device=x.device)
        keep = full[lo: lo + x.shape[0]] >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class SingleTowerNet(nn.Module):
    """The skeleton FoutNet and sGAT share (reference `foutnet.py:90-126`,
    `sGAT.py:101-139`): two conv layers of ``layer_cls`` (16 and 32
    channels) around community pooling, a cluster max pool and a per-graph
    mean (``_pooled``, ``_pooled_dense``, per net), then the fc head 32 ->
    64 -> ``output_shape`` without dropout (the reference's is dead code).
    Parameters are drawn on the CPU from ``generator`` and moved to
    ``device``; their order is the JAX package's leaf order, so Adam
    moments map by index."""

    def __init__(self, layer_cls, input_shape: int, output_shape: int, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        dev = resolve_device(device)
        if dev.type == "cuda":
            set_fp32_numerics()
        self.conv1 = layer_cls(input_shape, 16, generator)
        self.conv2 = layer_cls(16, 32, generator)
        self.fc1 = linear_module(*linear_init(32, 64, generator))
        self.fc2 = linear_module(*linear_init(64, output_shape, generator))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.fc1.weight.device

    def forward(self, batch, generator: Optional[torch.Generator] = None,
                dropout_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """[G, output_shape] scores of a sparse ``GraphBatch``, a
        ``DenseGraphBatch`` or a rank's ``parallel.halo.HaloBatch`` (moved to
        the model's device first). ``generator`` and ``dropout_rows`` are
        unused: the net has no dropout."""
        batch = batch.to(self.device)
        if getattr(batch, "is_halo", False):
            from deeprank_gnn_tpu_torch.parallel.halo import single_tower_pooled_halo

            h = single_tower_pooled_halo(self, batch)
        elif isinstance(batch, DenseGraphBatch):
            h = self._pooled_dense(batch)
        else:
            h = self._pooled(batch)
        h = torch.relu(linear(h, self.fc1.weight, self.fc1.bias))
        return linear(h, self.fc2.weight, self.fc2.bias)

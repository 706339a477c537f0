"""Shared model utilities: initializers, linear layer, dropout.

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
) -> torch.Tensor:
    """Inverted dropout matching `F.dropout` (reference `ginet.py:138`);
    the mask is drawn from ``generator`` (on x's device), or from torch's
    default generator when it is None."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))

"""Masked losses matching the reference's torch loss selection
(reference `NeuralNet.py:239-263`): MSELoss for regression and
(optionally class-weighted) CrossEntropyLoss for classification.

The port's counterpart of ``deeprank_gnn_tpu/train/losses.py``. Every
batch is padded to a static graph count, so the losses take a validity
mask and reduce only over real graphs.
"""

from __future__ import annotations

from typing import Optional

import torch


def mse_loss(pred: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """torch MSELoss(reduction='mean') over real graphs."""
    sq = (pred - y) ** 2
    denom = torch.clamp(mask.sum().to(pred.dtype), min=1.0)
    return torch.where(mask, sq, torch.zeros_like(sq)).sum() / denom


def cross_entropy_loss(
    logits: torch.Tensor,
    y_idx: torch.Tensor,
    mask: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """torch CrossEntropyLoss(weight=w, reduction='mean'):
    sum_i w[y_i] * nll_i / sum_i w[y_i] (reference `NeuralNet.py:262`)."""
    logp = torch.log_softmax(logits, dim=-1)
    y_safe = torch.clamp(y_idx.long(), 0, logits.shape[-1] - 1)
    nll = -logp.gather(1, y_safe[:, None])[:, 0]
    w = torch.ones_like(nll) if weights is None else weights[y_safe]
    w = torch.where(mask, w, torch.zeros_like(w))
    return (w * nll).sum() / torch.clamp(w.sum(), min=1e-12)

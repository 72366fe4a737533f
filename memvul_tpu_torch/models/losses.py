"""Shared loss primitives (the JAX package's ``models/losses.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
    total: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean cross-entropy over rows with nonzero weight (dead padding rows
    weigh 0).  The softmax is taken in f32.  ``total`` is the weight sum
    to divide by: a data-parallel rank passes the global one, so the
    ranks' losses (and gradients) sum to the whole batch's."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    weights = weights.to(torch.float32)
    if total is None:
        total = weights.sum()
    return (nll * weights).sum() / total.clamp_min(1.0)

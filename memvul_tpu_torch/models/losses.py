"""Shared loss primitives (the JAX package's ``models/losses.py``)."""

from __future__ import annotations

import torch


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Mean cross-entropy over rows with nonzero weight (dead padding rows
    weigh 0).  The softmax is taken in f32."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    weights = weights.to(torch.float32)
    return (nll * weights).sum() / weights.sum().clamp_min(1.0)

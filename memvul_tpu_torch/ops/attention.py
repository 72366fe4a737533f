"""Attention with a swappable implementation (the JAX package's
``ops/attention.py``).

:func:`dot_product_attention` is the one function the encoder calls, on
``[B, T, H, Dh]`` tensors; ``impl`` picks the backend:

* ``"xla"``   the plain einsum formulation of the JAX package's
              ``_xla_attention``: scores scaled in the query dtype, softmax
              in f32, weights cast back before the PV product;
* ``"flash"`` blockwise exact attention (:mod:`.flash_attention`): the
              hand-written CUDA kernel on the card, its plain version on
              the CPU.

``segment_ids`` ([B, T] int32, 0 = dead padding) switches to the packed
serve path: attention is masked on segment equality instead of ``bias``,
through :mod:`.ragged_attention` (its CUDA kernel on the card, its plain
version on the CPU).  It overrides ``impl``, as in the JAX package.

Attention-probability dropout (``training`` with ``dropout_rate`` > 0)
exists only in the ``"xla"`` formulation, so a training step with it
takes that formulation whatever ``impl`` says (the flash kernel has no
dropout), and the packed path, which never trains, refuses it.  Its masks
come from ``generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention
from .ragged_attention import ragged_flash_attention


def dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    impl: str = "xla",
    segment_ids: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Scaled dot-product attention, [B, T, H, Dh] in, [B, Tq, H, Dh] out
    in the query dtype; ``bias`` broadcastable to [B, H, Tq, Tk]."""
    dropout = training and dropout_rate > 0.0
    if segment_ids is not None:
        if dropout:
            raise ValueError(
                "ragged segment attention is an inference path: attention "
                "dropout is not supported with segment_ids"
            )
        return ragged_flash_attention(query, key, value, segment_ids)
    if impl == "flash":
        if not dropout:
            return flash_attention(query, key, value, bias)
    elif impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} (want xla | flash)")
    return xla_attention(query, key, value, bias, dropout_rate if dropout else 0.0, generator)


def xla_attention(
    query, key, value, bias=None, dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The JAX package's ``_xla_attention``: scores in the query dtype,
    softmax in f32, weights cast back, then (``dropout_rate`` > 0) the
    weights dropped with masks from ``generator`` and rescaled."""
    depth = query.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", query, key) / torch.sqrt(
        torch.tensor(depth, dtype=query.dtype, device=query.device)
    )
    if bias is not None:
        scores = scores + bias
    weights = torch.softmax(scores.to(torch.float32), dim=-1).to(query.dtype)
    if dropout_rate > 0.0:
        keep = torch.empty(weights.shape, device=weights.device).bernoulli_(
            1.0 - dropout_rate, generator=generator
        )
        weights = weights * keep.to(weights.dtype) / (1.0 - dropout_rate)
    return torch.einsum("bhqk,bkhd->bqhd", weights, value)


def mask_to_bias(attention_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, T] {0,1} mask → additive bias [B, 1, 1, T] in ``dtype``, with the
    finite ``finfo(dtype).min`` (never -inf) on padded keys."""
    neg = torch.finfo(dtype).min
    zero = torch.zeros((), dtype=dtype, device=attention_mask.device)
    fill = torch.full((), neg, dtype=dtype, device=attention_mask.device)
    return torch.where(attention_mask[:, None, None, :] > 0, zero, fill)

"""Attention with a swappable implementation (the JAX package's
``ops/attention.py``).

:func:`dot_product_attention` is the one function the encoder calls, on
``[B, T, H, Dh]`` tensors; ``impl`` picks the backend:

* ``"xla"``   the plain einsum formulation of the JAX package's
              ``_xla_attention``: scores scaled in the query dtype, softmax
              in f32, weights cast back before the PV product.  On the card
              the hand-written kernel of :mod:`.plain_attention` computes it
              with the same rounding points wherever
              :func:`.plain_attention.kernel_takes` holds (bf16, head dim
              64, at most 512 keys, a key-only bias, no dropout, no
              gradient); every other call runs :func:`xla_attention`;
* ``"flash"`` blockwise exact attention (:mod:`.flash_attention`): the
              hand-written CUDA kernel on the card, its plain version on
              the CPU;
* ``"ring"``  sequence-parallel ring attention (:mod:`..parallel.ring`)
              over the process group that ``encode_sequence_parallel``
              binds; the bias travels with its key/value block, and
              attention dropout raises.

``segment_ids`` ([B, T] int32, 0 = dead padding) switches to the packed
serve path: attention is masked on segment equality instead of ``bias``,
through :mod:`.ragged_attention` (its CUDA kernel on the card, its plain
version on the CPU).  It overrides ``impl``, as in the JAX package.

``causal`` (a decoder's self-attention: a query reads no key past its
own position) and k/v with fewer heads than q (``[B, T, Hkv, Dh]``,
grouped-query attention: query head h reads K/V head ``h // (H //
Hkv)``) are taken by ``"flash"`` (K2 on the card) and by the plain
``"xla"`` formulation, which on the card runs plain PyTorch for them (K4
takes neither); ``"ring"`` and the packed path refuse them.

Attention-probability dropout (``training`` with ``dropout_rate`` > 0)
exists only in the ``"xla"`` formulation, so a training step with it
takes that formulation whatever ``impl`` says (the flash kernel has no
dropout), and the packed path, which never trains, refuses it.  Its masks
come from ``generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import plain_attention
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
    causal: bool = False,
) -> torch.Tensor:
    """Scaled dot-product attention, [B, T, H, Dh] in, [B, Tq, H, Dh] out
    in the query dtype; ``bias`` broadcastable to [B, H, Tq, Tk]."""
    dropout = training and dropout_rate > 0.0
    grouped = key.shape[2] != query.shape[2]
    if (causal or grouped) and (segment_ids is not None or impl == "ring"):
        raise ValueError(
            "causal and grouped-query attention run on impl 'flash' or 'xla', not on "
            + ("the packed segment path" if segment_ids is not None else "ring attention"))
    if segment_ids is not None:
        if dropout:
            raise ValueError(
                "ragged segment attention is an inference path: attention "
                "dropout is not supported with segment_ids"
            )
        return ragged_flash_attention(query, key, value, segment_ids)
    if impl == "flash":
        if not dropout:
            return flash_attention(query, key, value, bias, causal=causal)
        return xla_attention(query, key, value, bias, dropout_rate, generator, causal=causal)
    if impl == "ring":
        if dropout:
            raise ValueError(
                "ring attention has no dropout support: set attention_dropout=0 "
                "for sequence-parallel training"
            )
        from ..parallel.ring import current_group, ring_attention

        return ring_attention(query, key, value, key_bias=bias, group=current_group())
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} (want xla | flash | ring)")
    rate = dropout_rate if dropout else 0.0
    if not causal and plain_attention.kernel_takes(query, key, value, bias, rate):
        return plain_attention.launch_taken(query, key, value, bias)
    plain_attention.count_plain_on_card(query)
    return xla_attention(query, key, value, bias, rate, generator, causal=causal)


def xla_attention(
    query, key, value, bias=None, dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None, causal: bool = False,
) -> torch.Tensor:
    """The JAX package's ``_xla_attention``: scores in the query dtype,
    softmax in f32, weights cast back, then (``dropout_rate`` > 0) the
    weights dropped with masks from ``generator`` and rescaled.  The
    scores' divisor is ``sqrt(depth)`` in the query dtype, computed on the
    host and filled on the device, so no call waits for the card.  K/V
    with fewer heads than q serve groups of query heads; ``causal`` sets
    each score past its query's position to -inf before the softmax."""
    from .flash_attention import check_causal, kv_group

    group = kv_group(query, key)
    check_causal(query, key, causal)
    if group > 1:
        key, value = (t.repeat_interleave(group, dim=2) for t in (key, value))
    divisor = plain_attention.score_divisor(query.shape[-1], query.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", query, key) / torch.full(
        (), divisor, dtype=query.dtype, device=query.device
    )
    if bias is not None:
        scores = scores + bias
    if causal:
        t = query.shape[1]
        ahead = torch.ones(t, t, dtype=torch.bool, device=query.device).triu(1)
        scores = scores.masked_fill(ahead, float("-inf"))
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

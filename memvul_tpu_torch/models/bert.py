"""The BERT encoder in PyTorch (the JAX package's ``models/bert.py``).

Parameters are named as in HF's ``BertModel`` (``embeddings.*``,
``encoder.layer.{i}.attention.self.query`` …), which is also the layout
``memvul_tpu.models.convert.export_bert_state_dict`` writes.  They stay
f32 and are cast to ``config.dtype`` at use, as flax's ``Dense(dtype=…)``
does; LayerNorm statistics are taken in f32.  Attention goes through
:func:`memvul_tpu_torch.ops.attention.dot_product_attention`, so
``attention_impl="flash"`` runs the hand-written CUDA kernel on the card.

Dropout sits where the JAX package has it: after the embeddings, on the
attention probabilities (the ``"xla"`` formulation only), after the
attention output, after the FFN output and after the pooler.  It runs
when the module is in training mode (``model.train()``, the JAX
``deterministic=False``), with masks drawn from the ``generator`` passed
down the forward call; ``model.eval()`` makes it the identity.

``scan_layers`` is a layout knob of the JAX package with no effect on the
forward.  ``remat`` is the JAX package's ``nn.remat`` per layer: while
training with grad enabled, each :class:`BertLayer` runs under
``torch.utils.checkpoint`` (non-reentrant), which keeps only the layer's
input for the backward and runs the layer's forward again there, so the
attention kernel's forward launches twice a step.  The recompute must
draw the same dropout masks: ``checkpoint`` replays the default CPU and
CUDA generators but not a generator passed down the forward, so
:func:`_checkpointed_layer` snapshots that generator before the layer,
runs both passes on a generator restored from the snapshot, and leaves
the caller's generator where an un-rematted forward would leave it.
Scoring (``eval()`` or no grad) never rematerialises.

``quant`` (``"int8_dynamic"`` or ``"int8"``) makes the six projections
of every layer (q, k, v, the attention output, the FFN's intermediate and
output) :class:`~memvul_tpu_torch.ops.quant.QuantLinear`: same weights,
an int8 contraction.  The pooler and the header stay full precision.
``last_layer_only=False`` mixes every layer's output with
:class:`ScalarMix` instead of taking the last.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import dot_product_attention, mask_to_bias
from ..ops.quant import QUANT_MODES, QuantLinear, make_linear
from ..ops.ragged_attention import pack_segments


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: Any = torch.float32
    attention_impl: str = "xla"
    remat: bool = False
    scan_layers: bool = False
    last_layer_only: bool = True
    quant: Optional[str] = None
    anchor_match_impl: str = "auto"

    @classmethod
    def tiny(cls, vocab_size: int = 2048, **kw) -> "BertConfig":
        """2-layer config for tests."""
        defaults = dict(
            vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=128,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def base(cls, vocab_size: int = 30522, **kw) -> "BertConfig":
        """bert-base-uncased geometry."""
        return cls(vocab_size=vocab_size, **kw)

    @classmethod
    def large(cls, vocab_size: int = 30522, **kw) -> "BertConfig":
        """bert-large geometry."""
        defaults = dict(
            vocab_size=vocab_size, hidden_size=1024, num_layers=24, num_heads=16,
            intermediate_size=4096,
        )
        defaults.update(kw)
        return cls(**defaults)

    def replace(self, **kw) -> "BertConfig":
        return dataclasses.replace(self, **kw)


def linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """``x @ W.T + b`` with input and params cast to ``dtype`` (through the
    int8 contraction for a :class:`QuantLinear`)."""
    if isinstance(layer, QuantLinear):
        return layer.quantized(x, dtype)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _project(x: torch.Tensor, layer: nn.Linear, dtype, tp_group=None) -> torch.Tensor:
    """:func:`linear`, or with ``tp_group`` the row-parallel product: this
    rank's partial sum, reduced over the group, then the bias."""
    if tp_group is None:
        return linear(x, layer, dtype)
    from ..parallel.sharding import reduce_from_group

    out = reduce_from_group(F.linear(x.to(dtype), layer.weight.to(dtype)), tp_group)
    return out + layer.bias.to(dtype)


def dropout(
    x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Flax's ``Dropout``: in training, each element kept with probability
    ``1 - rate`` (masks from ``generator``) and scaled by its inverse;
    otherwise the identity."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(keep, generator=generator)
    return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype) -> torch.Tensor:
    """LayerNorm with statistics in f32, output in ``dtype``."""
    return F.layer_norm(
        x.to(torch.float32), ln.normalized_shape, ln.weight, ln.bias, ln.eps
    ).to(dtype)


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig) -> None:
        super().__init__()
        self.config = c
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, input_ids, token_type_ids, position_ids=None, generator=None):
        c = self.config
        dt = c.dtype
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1], device=input_ids.device)[None, :]
        word = F.embedding(input_ids, self.word_embeddings.weight).to(dt)
        pos = F.embedding(position_ids, self.position_embeddings.weight).to(dt)
        typ = F.embedding(token_type_ids, self.token_type_embeddings.weight).to(dt)
        x = layer_norm(word + pos + typ, self.LayerNorm, dt)
        return dropout(x, c.hidden_dropout, self.training, generator)


class BertSelfAttention(nn.Module):
    """The q/k/v projections (HF ``attention.self``)."""

    def __init__(self, c: BertConfig) -> None:
        super().__init__()
        self.query = make_linear(c.hidden_size, c.hidden_size, c.quant)
        self.key = make_linear(c.hidden_size, c.hidden_size, c.quant)
        self.value = make_linear(c.hidden_size, c.hidden_size, c.quant)


class BertSelfOutput(nn.Module):
    def __init__(self, c: BertConfig, in_features: int) -> None:
        super().__init__()
        self.dense = make_linear(in_features, c.hidden_size, c.quant)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class BertAttention(nn.Module):
    def __init__(self, c: BertConfig) -> None:
        super().__init__()
        self.config = c
        self.self = BertSelfAttention(c)
        self.output = BertSelfOutput(c, c.hidden_size)

    # the model group of a tensor-parallel encoder (parallel/sharding.py):
    # q/k/v then hold this rank's heads and the output projection its rows
    tp_group = None

    def forward(self, hidden, bias, segment_ids=None, generator=None):
        c = self.config
        b, t, _ = hidden.shape
        head_dim = c.hidden_size // c.num_heads
        x = hidden
        if self.tp_group is not None:
            from ..parallel.sharding import copy_to_group

            x = copy_to_group(hidden, self.tp_group)

        def heads(layer):
            out = linear(x, layer, c.dtype)
            return out.view(b, t, out.shape[-1] // head_dim, head_dim)

        attn = dot_product_attention(
            heads(self.self.query), heads(self.self.key), heads(self.self.value),
            bias=bias, impl=c.attention_impl, segment_ids=segment_ids,
            dropout_rate=c.attention_dropout, training=self.training, generator=generator,
        )
        out = _project(attn.reshape(b, t, -1), self.output.dense, c.dtype, self.tp_group)
        out = dropout(out, c.hidden_dropout, self.training, generator)
        return layer_norm(hidden + out, self.output.LayerNorm, c.dtype)


class BertIntermediate(nn.Module):
    def __init__(self, c: BertConfig) -> None:
        super().__init__()
        self.dense = make_linear(c.hidden_size, c.intermediate_size, c.quant)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig) -> None:
        super().__init__()
        self.config = c
        self.attention = BertAttention(c)
        self.intermediate = BertIntermediate(c)
        self.output = BertSelfOutput(c, c.intermediate_size)

    tp_group = None  # as BertAttention's: the FFN's columns and rows of this rank

    def forward(self, hidden, bias, segment_ids=None, generator=None):
        c = self.config
        dt = c.dtype
        hidden = self.attention(hidden, bias, segment_ids, generator)
        x = hidden
        if self.tp_group is not None:
            from ..parallel.sharding import copy_to_group

            x = copy_to_group(hidden, self.tp_group)
        inter = F.gelu(linear(x, self.intermediate.dense, dt))  # exact (erf)
        out = dropout(_project(inter, self.output.dense, dt, self.tp_group),
                      c.hidden_dropout, self.training, generator)
        return layer_norm(hidden + out, self.output.LayerNorm, dt)


def _checkpointed_layer(layer: "BertLayer", hidden, bias, segment_ids, generator):
    """``layer(hidden, bias, segment_ids, generator)`` under
    ``torch.utils.checkpoint``, its dropout masks replayed in the recompute:
    both passes draw from a generator restored from a snapshot of
    ``generator`` taken here, and ``generator`` then advances as the plain
    forward would have advanced it."""
    if generator is None:  # dropout draws from the default generators, which checkpoint replays
        return torch.utils.checkpoint.checkpoint(
            layer, hidden, bias, segment_ids, None, use_reentrant=False)
    snapshot = generator.get_state()
    first_pass = []

    def run(h, b):
        replay = torch.Generator(device=generator.device)
        replay.set_state(snapshot)
        first_pass.append(replay)
        return layer(h, b, segment_ids, replay)

    out = torch.utils.checkpoint.checkpoint(run, hidden, bias, use_reentrant=False)
    generator.set_state(first_pass[0].get_state())
    return out


class BertEncoderStack(nn.Module):
    """The last layer's hidden states, or every layer's output stacked
    ``[L, B, T, H]`` when ``config.last_layer_only`` is False; with
    ``config.remat``, each layer rematerialised in the backward while
    training (:func:`_checkpointed_layer`)."""

    def __init__(self, c: BertConfig) -> None:
        super().__init__()
        self.collect = not c.last_layer_only
        self.remat = c.remat
        self.layer = nn.ModuleList(BertLayer(c) for _ in range(c.num_layers))

    def forward(self, hidden, bias, segment_ids=None, generator=None):
        outputs = []
        remat = self.remat and self.training and torch.is_grad_enabled()
        for layer in self.layer:
            if remat:
                hidden = _checkpointed_layer(layer, hidden, bias, segment_ids, generator)
            else:
                hidden = layer(hidden, bias, segment_ids, generator)
            if self.collect:
                outputs.append(hidden)
        return torch.stack(outputs) if self.collect else hidden


class ScalarMix(nn.Module):
    """A learned softmax-weighted sum of every layer's output, scaled by a
    learned gamma (the reference embedder's option for
    ``last_layer_only=False``).  The weights' softmax is taken in f32; the
    sum runs in the compute dtype."""

    def __init__(self, num_layers: int) -> None:
        super().__init__()
        self.scalar_weights = nn.Parameter(torch.zeros(num_layers))
        self.gamma = nn.Parameter(torch.ones(()))

    def forward(self, stacked: torch.Tensor) -> torch.Tensor:  # [L, B, T, H] → [B, T, H]
        norm = torch.softmax(self.scalar_weights.to(torch.float32), dim=0).to(stacked.dtype)
        return self.gamma.to(stacked.dtype) * torch.einsum("l,l...->...", norm, stacked)


class BertEncoder(nn.Module):
    """input ids → contextual embeddings [B, T, H] in ``config.dtype``."""

    def __init__(self, c: BertConfig) -> None:
        super().__init__()
        if c.quant is not None and c.quant not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {c.quant!r}")
        if c.attention_impl not in ("xla", "flash", "ring"):
            raise ValueError(f"unknown attention impl {c.attention_impl!r}")
        self.config = c
        self.embeddings = BertEmbeddings(c)
        self.encoder = BertEncoderStack(c)
        if not c.last_layer_only:
            self.scalar_mix = ScalarMix(c.num_layers)

    def forward(
        self, input_ids, attention_mask, token_type_ids=None,
        position_ids=None, segment_ids=None, generator=None,
    ):
        c = self.config
        if position_ids is None and input_ids.shape[-1] > c.max_position_embeddings:
            raise ValueError(
                f"sequence length {input_ids.shape[-1]} exceeds "
                f"max_position_embeddings={c.max_position_embeddings}; "
                "fold or truncate long inputs before encoding"
            )
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        hidden = self.embeddings(input_ids, token_type_ids, position_ids, generator)
        if segment_ids is None:
            out = self.encoder(hidden, mask_to_bias(attention_mask, c.dtype), generator=generator)
        else:
            # the packed path: one tile table for all the layers of the pack
            out = self.encoder(hidden, None, pack_segments(segment_ids), generator)
        return out if c.last_layer_only else self.scalar_mix(out)


class BertPooler(nn.Module):
    """dropout(tanh(dense(CLS)))."""

    def __init__(self, c: BertConfig) -> None:
        super().__init__()
        self.config = c
        self.dense = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, hidden, generator=None):
        c = self.config
        pooled = torch.tanh(linear(hidden[:, 0], self.dense, c.dtype))
        return dropout(pooled, c.hidden_dropout, self.training, generator)


def init_weights(module: nn.Module, std: float, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's initialisation: N(0, std) weights and
    embeddings, zero biases, unit LayerNorm scales (draws from
    ``generator`` when given)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            nn.init.normal_(m.weight, std=std, generator=generator)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)

"""The Siamese memory-network matcher (the JAX package's
``models/memory.py``).

Encode a text with BERT, take the tanh-pooled CLS, optionally pass the
ReLU projection header.  With an :class:`~memvul_tpu_torch.models.lfm2.
Lfm2Config` the encoder is LFM2-MoE (``model.*``, a causal decoder) and the
text's embedding is its last real token's final-normed hidden state
(BERT's tanh pooler is BERT's own pretrained layer, so it has none); the
header and the classifier are the same.  That encoder scores only: the
packed paths and training refuse it.  Training classifies each pair
``[u, v, |u−v|]`` with the bias-free pair kernel (:meth:`MemoryModel.pair_logits`, a plain
matmul) and :func:`pair_loss` takes the cross-entropy of the logits over
the temperature.  Inference matches the report against the whole anchor
bank through the decomposed classifier

    logits[b, a] = u[b]·W_u + v[a]·W_v + |u[b] − v[a]|·W_d

(:mod:`memvul_tpu_torch.ops.anchor_match`: the hand-written CUDA kernel
on the card, its plain version on the CPU).  Samples are dicts
{input_ids, attention_mask[, token_type_ids]} of tensors.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.anchor_match import anchor_match
from .bert import BertConfig, BertEncoder, BertPooler, dropout, init_weights, linear
from .lfm2 import Lfm2Model, is_lfm2, refuse
from .losses import masked_cross_entropy


class ProjectionHeader(nn.Module):
    """dropout(ReLU(dense(hidden → header_dim)))."""

    def __init__(self, config: BertConfig, header_dim: int = 512) -> None:
        super().__init__()
        self.config = config
        self.dense = nn.Linear(config.hidden_size, header_dim)

    def forward(self, x, generator=None):
        x = torch.relu(linear(x, self.dense, self.config.dtype))
        return dropout(x, self.config.hidden_dropout, self.training, generator)


class MemoryModel(nn.Module):
    def __init__(
        self,
        config: BertConfig,
        use_header: bool = True,
        header_dim: int = 512,
        temperature: float = 0.1,
        num_classes: int = 2,
    ) -> None:
        super().__init__()
        self.config = config
        self.use_header = use_header
        self.temperature = temperature
        self.lfm2 = is_lfm2(config)
        if self.lfm2:
            self.model = Lfm2Model(config)
            self.pooler = None
        else:
            self.bert = BertEncoder(config)
            self.pooler = BertPooler(config)
        if use_header:
            self.header = ProjectionHeader(config, header_dim)
        out_dim = header_dim if use_header else config.hidden_size
        # the bias-free pair classifier over [u, v, |u-v|]
        self.pair_kernel = nn.Parameter(torch.empty(3 * out_dim, num_classes))
        if not self.lfm2:
            init_weights(self, config.initializer_range)
        elif use_header:  # the LFM2 encoder drew its own parameters
            init_weights(self.header, config.initializer_range)
        nn.init.normal_(self.pair_kernel, std=config.initializer_range)

    def encode(
        self, input_ids, attention_mask, token_type_ids=None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Token batch → [B, D] embeddings in ``config.dtype``."""
        if self.lfm2:
            pooled = self.model.encode_last(input_ids, attention_mask)
            return self.header(pooled, generator) if self.use_header else pooled
        hidden = self.bert(input_ids, attention_mask, token_type_ids, generator=generator)
        return self._pool(hidden, generator)

    def _pool(self, hidden: torch.Tensor, generator=None) -> torch.Tensor:
        pooled = self.pooler(hidden, generator)
        return self.header(pooled, generator) if self.use_header else pooled

    def encode_ragged(self, sample: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One packed flat batch (:func:`~memvul_tpu_torch.data.batching.
        collate_ragged`, as tensors) → per-row embeddings [max_rows, D].

        The encoder runs once over the ``[1, token_budget]`` row, its
        attention masked on ``segment_ids`` and its positions restarting
        per request; each row's first (CLS) token is then gathered by
        ``row_starts`` and goes through the same pooler and header as the
        padded path.  Dead rows gather position 0; callers slice them off."""
        if self.lfm2:
            refuse("packed (ragged or continuous) serving path")
        hidden = self.bert(
            sample["input_ids"], sample["attention_mask"], sample.get("token_type_ids"),
            position_ids=sample["position_ids"], segment_ids=sample["segment_ids"],
        )
        cls = hidden[0].index_select(0, sample["row_starts"])[:, None, :]
        return self._pool(cls)

    def score_ragged(
        self, sample: Dict[str, torch.Tensor], anchors: torch.Tensor, impl: Optional[str] = None
    ) -> torch.Tensor:
        """Packed flat batch × bank [A, D] → anchor logits [max_rows, A, C]."""
        return self.match_anchors(self.encode_ragged(sample), anchors, impl=impl)

    def match_anchors(
        self, u: torch.Tensor, anchors: torch.Tensor, impl: Optional[str] = None
    ) -> torch.Tensor:
        """[B, D] × [A, D] → logits [B, A, C] against the full bank."""
        kernel = self.pair_kernel.to(u.dtype)
        return anchor_match(u, anchors, kernel, impl=impl or self.config.anchor_match_impl)

    def pair_logits(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """[B, D] × [B, D] → [B, C] (the training path)."""
        features = torch.cat([u, v, (u - v).abs()], dim=-1)
        return features @ self.pair_kernel.to(features.dtype)

    def forward(
        self,
        sample1: Dict[str, torch.Tensor],
        sample2: Optional[Dict[str, torch.Tensor]] = None,
        anchors: Optional[torch.Tensor] = None,
        anchor_impl: Optional[str] = None,
        sample2_index: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Training: (sample1, sample2) → pair logits [B, C].  Inference:
        (sample1, anchors=[A, D]) → anchor logits [B, A, C]; sample1 alone
        → embeddings [B, D].  ``sample2_index`` [B] is the dedup gather:
        sample2 then holds only the batch's unique rows, and each pair's
        embedding is gathered back (``index_select``, whose backward
        scatter-adds).  Dropout masks come from ``generator``."""
        if self.lfm2 and (sample2 is not None or self.training):
            refuse("training path")
        u = self.encode(
            sample1["input_ids"], sample1["attention_mask"], sample1.get("token_type_ids"),
            generator=generator,
        )
        if anchors is not None:
            return self.match_anchors(u, anchors, impl=anchor_impl)
        if sample2 is None:
            return u
        v = self.encode(
            sample2["input_ids"], sample2["attention_mask"], sample2.get("token_type_ids"),
            generator=generator,
        )
        if sample2_index is not None:
            v = v.index_select(0, sample2_index.long())
        return self.pair_logits(u, v)


def pair_loss(logits, labels, weights, temperature: float, total=None) -> torch.Tensor:
    """Mean cross-entropy over the real rows of ``logits / temperature``,
    in f32 (over ``total`` weight, see :func:`masked_cross_entropy`)."""
    return masked_cross_entropy(logits.to(torch.float32) / temperature, labels, weights, total)


def anchor_probs(anchor_logits: torch.Tensor, same_index: int = 0) -> torch.Tensor:
    """[B, A, 2] logits → per-anchor P(same) [B, A], softmax in f32."""
    return torch.softmax(anchor_logits.to(torch.float32), dim=-1)[..., same_index]


def best_anchor_score(anchor_logits: torch.Tensor, same_index: int = 0):
    """The report's positive-class probability is its best anchor match:
    (max P(same) [B], argmax anchor index [B])."""
    p_same = anchor_probs(anchor_logits, same_index)
    return p_same.max(dim=-1)

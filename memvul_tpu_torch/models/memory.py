"""The Siamese memory-network matcher (the JAX package's
``models/memory.py``), inference path.

Encode a text with BERT, take the tanh-pooled CLS, optionally pass the
ReLU projection header, then match the report against the whole anchor
bank through the decomposed bias-free ``[u, v, |u−v|]`` classifier:

    logits[b, a] = u[b]·W_u + v[a]·W_v + |u[b] − v[a]|·W_d

(:mod:`memvul_tpu_torch.ops.anchor_match`: the hand-written CUDA kernel
on the card, its plain version on the CPU).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.anchor_match import anchor_match
from .bert import BertConfig, BertEncoder, BertPooler, init_weights, linear


class ProjectionHeader(nn.Module):
    """dense(hidden → header_dim) + ReLU (dropout is inactive at inference)."""

    def __init__(self, config: BertConfig, header_dim: int = 512) -> None:
        super().__init__()
        self.config = config
        self.dense = nn.Linear(config.hidden_size, header_dim)

    def forward(self, x):
        return torch.relu(linear(x, self.dense, self.config.dtype))


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
        self.bert = BertEncoder(config)
        self.pooler = BertPooler(config)
        if use_header:
            self.header = ProjectionHeader(config, header_dim)
        out_dim = header_dim if use_header else config.hidden_size
        # the bias-free pair classifier over [u, v, |u-v|]
        self.pair_kernel = nn.Parameter(torch.empty(3 * out_dim, num_classes))
        init_weights(self, config.initializer_range)
        nn.init.normal_(self.pair_kernel, std=config.initializer_range)

    def encode(self, input_ids, attention_mask, token_type_ids=None) -> torch.Tensor:
        """Token batch → [B, D] embeddings in ``config.dtype``."""
        hidden = self.bert(input_ids, attention_mask, token_type_ids)
        return self._pool(hidden)

    def _pool(self, hidden: torch.Tensor) -> torch.Tensor:
        pooled = self.pooler(hidden)
        return self.header(pooled) if self.use_header else pooled

    def encode_ragged(self, sample: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One packed flat batch (:func:`~memvul_tpu_torch.data.batching.
        collate_ragged`, as tensors) → per-row embeddings [max_rows, D].

        The encoder runs once over the ``[1, token_budget]`` row, its
        attention masked on ``segment_ids`` and its positions restarting
        per request; each row's first (CLS) token is then gathered by
        ``row_starts`` and goes through the same pooler and header as the
        padded path.  Dead rows gather position 0; callers slice them off."""
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

    def forward(self, input_ids, attention_mask, anchors=None, anchor_impl=None):
        """(ids, mask) → [B, D]; with ``anchors`` [A, D] → logits [B, A, C]."""
        u = self.encode(input_ids, attention_mask)
        if anchors is None:
            return u
        return self.match_anchors(u, anchors, impl=anchor_impl)


def anchor_probs(anchor_logits: torch.Tensor, same_index: int = 0) -> torch.Tensor:
    """[B, A, 2] logits → per-anchor P(same) [B, A], softmax in f32."""
    return torch.softmax(anchor_logits.to(torch.float32), dim=-1)[..., same_index]


def best_anchor_score(anchor_logits: torch.Tensor, same_index: int = 0):
    """The report's positive-class probability is its best anchor match:
    (max P(same) [B], argmax anchor index [B])."""
    p_same = anchor_probs(anchor_logits, same_index)
    return p_same.max(dim=-1)

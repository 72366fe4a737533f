"""The single (no-memory) classifier, MemVul-m (the JAX package's
``models/single.py``).

Plain BERT sequence classification: the tanh-pooled CLS, the ReLU
projection header (hidden → ``header_dim``, dropout), then a bias-free
``Linear(header_dim → 2)``.  The encoder runs through the port's
:class:`~memvul_tpu_torch.models.bert.BertEncoder`, so
``attention_impl="flash"`` launches the hand-written attention kernel on
the card.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from .bert import BertConfig, BertEncoder, BertPooler, init_weights, linear
from .losses import masked_cross_entropy
from .memory import ProjectionHeader

# flax's lecun_normal: a normal truncated at two standard deviations, its
# scale corrected so the truncated draw has variance 1 / fan_in
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """Fill ``weight`` from flax's default kernel initializer
    (``lecun_normal``) for a layer with ``fan_in`` inputs."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class SingleModel(nn.Module):
    def __init__(self, config: BertConfig, header_dim: int = 512, num_classes: int = 2) -> None:
        super().__init__()
        self.config = config
        self.bert = BertEncoder(config)
        self.pooler = BertPooler(config)
        self.header = ProjectionHeader(config, header_dim)
        self.classifier = nn.Linear(header_dim, num_classes, bias=False)
        self.init_weights()

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's initialisation: N(0, initializer_range) for the
        encoder and pooler, flax's lecun-normal default for the header and
        the classifier, zero biases, unit LayerNorm scales."""
        with torch.no_grad():
            init_weights(self, self.config.initializer_range, generator=generator)
            for layer in (self.header.dense, self.classifier):
                lecun_normal_(layer.weight, layer.in_features, generator=generator)

    def forward(
        self, sample1: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """{input_ids, attention_mask[, token_type_ids]} → logits [B, C] in
        ``config.dtype``; dropout masks from ``generator`` in training."""
        hidden = self.bert(
            sample1["input_ids"], sample1["attention_mask"], sample1.get("token_type_ids"),
            generator=generator,
        )
        pooled = self.header(self.pooler(hidden, generator), generator)
        return linear(pooled, self.classifier, self.config.dtype)


def classification_loss(logits, labels, weights) -> torch.Tensor:
    """Mean cross-entropy over the real rows, in f32."""
    return masked_cross_entropy(logits, labels, weights)

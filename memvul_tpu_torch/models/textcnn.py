"""The TextCNN baseline classifier (the JAX package's ``models/textcnn.py``).

Word ids → a trainable ``embed_dim`` embedding (GloVe vectors when given)
→ one bank of ``num_filters`` convolutions per n-gram size, each
max-pooled over time → the ReLU header → a bias-free ``Linear(→ 2)``.
The convolutions are ``F.conv1d`` (the reference's are XLA convolutions,
not TPU kernels).  Inputs shorter than the largest n-gram are padded up
to it; padding embeddings are zeroed, windows that start past the real
tokens are masked to the dtype's minimum before the max-pool, and the
pooled features are clamped at 0, so an all-padding row gives zeros.

Parameters keep the flax names: ``embedding``, ``conv_{n}`` (a torch
conv weight is ``[out, in, n]`` where flax's kernel is ``[n, in, out]``),
``header`` and ``classifier``.  :meth:`TextCNN.init_weights` draws from
flax's defaults: N(0, 1/embed_dim) embeddings, lecun-normal kernels,
zero biases.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .bert import dropout
from .single import lecun_normal_


class TextCNN(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        embed_dim: int = 300,
        num_filters: int = 256,
        ngram_sizes: Sequence[int] = (2, 3, 4, 5),
        header_dim: int = 512,
        num_classes: int = 2,
        dropout: float = 0.1,
        pad_id: int = 0,
    ) -> None:
        super().__init__()
        self.ngram_sizes = tuple(int(n) for n in ngram_sizes)
        self.dropout = float(dropout)
        self.pad_id = int(pad_id)
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        for n in self.ngram_sizes:
            self.add_module(f"conv_{n}", nn.Conv1d(embed_dim, num_filters, n))
        self.header = nn.Linear(num_filters * len(self.ngram_sizes), header_dim)
        self.classifier = nn.Linear(header_dim, num_classes, bias=False)
        self.init_weights()

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            dim = self.embedding.embedding_dim
            self.embedding.weight.normal_(0.0, 1.0 / math.sqrt(dim), generator=generator)
            for n in self.ngram_sizes:
                conv = getattr(self, f"conv_{n}")
                lecun_normal_(conv.weight, n * conv.in_channels, generator=generator)
                conv.bias.zero_()
            for layer in (self.header, self.classifier):
                lecun_normal_(layer.weight, layer.in_features, generator=generator)
            self.header.bias.zero_()

    def forward(
        self, sample1: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """{input_ids, attention_mask} → logits [B, C] (f32)."""
        ids, mask = sample1["input_ids"], sample1["attention_mask"]
        short = max(self.ngram_sizes) - ids.shape[-1]
        if short > 0:
            ids = F.pad(ids, (0, short), value=self.pad_id)
            mask = F.pad(mask, (0, short))
        x = F.embedding(ids, self.embedding.weight)
        x = torch.where(mask[..., None] > 0, x, torch.zeros((), dtype=x.dtype, device=x.device))
        neg = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype, device=x.device)
        channels = x.transpose(1, 2)  # [B, E, T]
        pooled = []
        for n in self.ngram_sizes:
            conv = getattr(self, f"conv_{n}")
            out = torch.relu(F.conv1d(channels, conv.weight, conv.bias))  # [B, F, T - n + 1]
            starts = mask[:, None, : out.shape[-1]]
            pooled.append(torch.where(starts > 0, out, neg).amax(dim=-1))
        features = torch.cat(pooled, dim=-1).clamp_min(0.0)  # all-padding rows → zeros
        features = dropout(features, self.dropout, self.training, generator)
        hidden = torch.relu(F.linear(features, self.header.weight, self.header.bias))
        hidden = dropout(hidden, self.dropout, self.training, generator)
        return F.linear(hidden, self.classifier.weight)

    def load_pretrained_embedding(self, vectors: np.ndarray) -> "TextCNN":
        """Replace the embedding table (e.g. GloVe vectors in the
        tokenizer's vocabulary order).  Returns the model."""
        table = self.embedding.weight
        if tuple(vectors.shape) != tuple(table.shape):
            raise ValueError(f"vector table {tuple(vectors.shape)} != embedding {tuple(table.shape)}")
        with torch.no_grad():
            table.copy_(torch.as_tensor(np.asarray(vectors, np.float32)))
        return self


def load_glove_vectors(
    path: str, vocab: Sequence[str], dim: int = 300, seed: int = 0
) -> np.ndarray:
    """A GloVe .txt file assembled into a [V, dim] table in vocabulary
    order; words it lacks get N(0, 0.1) vectors from ``seed``."""
    rng = np.random.default_rng(seed)
    table = rng.normal(scale=0.1, size=(len(vocab), dim)).astype(np.float32)
    wanted = {w: i for i, w in enumerate(vocab)}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if parts[0] in wanted and len(parts) == dim + 1:
                table[wanted[parts[0]]] = np.asarray(parts[1:], dtype=np.float32)
    return table

"""Long-sequence segment folding (the JAX package's ``models/folding.py``;
numpy, shared by no device code).

The reference handles inputs longer than ``max_length`` by folding: the
token stream is split into segments, each wrapped with [CLS] … [SEP], the
segments encoded independently as a bigger batch, and the embeddings
unfolded and stitched back to ``[B, total_len, D]``.  For the CLS-pooled
models here folding predicts what truncation predicts (the pooled vector
is segment 0's CLS either way), so the scoring paths truncate; this module
serves embedder-level parity and consumers that pool over the whole token
stream (the port's ``BertModel`` takes the folded ``[B·S, L]`` batch as
any other).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def fold_tokens(
    ids: np.ndarray,
    mask: np.ndarray,
    max_length: int,
    cls_id: int,
    sep_id: int,
    pad_id: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Fold [B, T] token ids (already CLS/SEP framed) into
    [B·S, max_length] segments, each re-framed with CLS/SEP.

    Returns (folded_ids, folded_mask, num_segments).
    """
    batch, total = ids.shape
    inner = max_length - 2  # room for the per-segment CLS/SEP
    # copies: the SEP-strip below must not write through into caller arrays
    body = ids[:, 1:].copy()  # drop the leading CLS; keep content + SEP
    body_mask = mask[:, 1:].copy()
    # strip the final SEP from the content stream (it is re-added per segment)
    lengths = body_mask.sum(axis=1)
    for b in range(batch):
        if lengths[b] > 0 and body[b, lengths[b] - 1] == sep_id:
            body[b, lengths[b] - 1] = pad_id
            body_mask[b, lengths[b] - 1] = 0
    # number of segments from the longest *actual* content run (masks are
    # contiguous prefixes by construction)
    longest = int(body_mask.sum(axis=1).max()) if batch else 0
    num_segments = max(1, -(-longest // inner))
    width = num_segments * inner
    copy = min(width, body.shape[1])
    padded = np.full((batch, width), pad_id, dtype=ids.dtype)
    padded_mask = np.zeros_like(padded)
    padded[:, :copy] = body[:, :copy]
    padded_mask[:, :copy] = body_mask[:, :copy]

    segments = padded.reshape(batch * num_segments, inner)
    seg_mask = padded_mask.reshape(batch * num_segments, inner)

    folded = np.full((batch * num_segments, max_length), pad_id, dtype=ids.dtype)
    folded_mask = np.zeros_like(folded)
    has_content = seg_mask.sum(axis=1) > 0
    # the first segment of each report always participates (CLS pooling)
    has_content[:: num_segments] = True
    folded[:, 0] = cls_id
    folded[:, 1:-1] = segments
    folded_mask[:, 0] = 1
    folded_mask[:, 1:-1] = seg_mask
    # close each non-empty segment with SEP at the end of its content
    content_len = folded_mask.sum(axis=1)
    for i in range(folded.shape[0]):
        if has_content[i]:
            end = int(content_len[i])
            folded[i, end] = sep_id
            folded_mask[i, end] = 1
        else:
            folded_mask[i, :] = 0
    return folded, folded_mask, num_segments


def unfold_embeddings(
    embeddings: np.ndarray,
    num_segments: int,
    folded_mask: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """[B·S, L, D] per-segment embeddings → ([B, S·(L-2), D] stitched
    stream, [B, S·(L-2)] validity mask), mirroring the reference's unfold
    (custom_PTM_embedder.py:286-381).

    Positions 0 and L-1 of every segment (the re-inserted CLS and the
    worst-case SEP slot) are dropped structurally; ``folded_mask`` (the
    mask returned by :func:`fold_tokens`) additionally invalidates the SEP
    of partially-filled segments and padding, which sit *inside* the
    [1:-1] window.  Without it the validity mask only reflects the
    structural trim."""
    bs, length, dim = embeddings.shape
    batch = bs // num_segments
    inner = embeddings[:, 1:-1, :]
    stream = inner.reshape(batch, num_segments * (length - 2), dim)
    if folded_mask is not None:
        valid = folded_mask.copy()
        # invalidate each segment's trailing SEP (last masked position)
        lengths = valid.sum(axis=1)
        for i in range(bs):
            if lengths[i] > 0:
                valid[i, lengths[i] - 1] = 0
        valid = valid[:, 1:-1].reshape(batch, num_segments * (length - 2))
    else:
        valid = np.ones((batch, num_segments * (length - 2)), dtype=np.int32)
    return stream, valid

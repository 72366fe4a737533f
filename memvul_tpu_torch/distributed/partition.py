"""Deterministic corpus partitioning for sharded scoring (the JAX
package's ``distributed/partition.py``).

The partition must be a pure function of (corpus length, shard count): the
coordinator recomputes it on every start, the merge verifier recomputes it
to prove exactly-once coverage, and a resumed worker's journal only makes
sense for the span it was launched with.
"""

from __future__ import annotations

from typing import List, Tuple


def partition_rows(corpus_len: int, n_shards: int) -> List[Tuple[int, int]]:
    """``range(corpus_len)`` as ``n_shards`` contiguous ``[start, end)``
    spans, as even as can be: the first ``corpus_len % n_shards`` shards
    carry one extra row.  Shards past the corpus get empty spans rather
    than being dropped, so shard *i* always exists."""
    if corpus_len < 0:
        raise ValueError(f"corpus_len must be >= 0, got {corpus_len}")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    base, extra = divmod(corpus_len, n_shards)
    spans: List[Tuple[int, int]] = []
    start = 0
    for i in range(n_shards):
        end = start + base + (1 if i < extra else 0)
        spans.append((start, end))
        start = end
    return spans

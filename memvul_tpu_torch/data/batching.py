"""Instance streams → fixed-shape batches (the scoring path of the JAX
package's ``data/batching.py``).

Every batch is padded to a fixed row count (dead rows carry weight 0) and
to a bucketed sequence length, so the encoder sees a small closed set of
shapes: :func:`bucketed_batches_from_instances` routes each report to the
smallest bucket covering its token length and emits a batch when a
bucket fills; :func:`bucket_batch_sizes` sizes the buckets at a constant
token budget.  Batches stay numpy; the predictor moves them to the
device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np

LABELS_SIAMESE = {"same": 0, "diff": 1}


class CachedEncoder:
    """Memoizing wrapper around ``tokenizer.encode`` at a fixed cap."""

    def __init__(self, tokenizer, max_length: int, cache_size: int = 200_000):
        self._tokenizer = tokenizer
        self._max_length = max_length
        self._cache: Dict[str, List[int]] = {}
        self._cache_size = cache_size

    @property
    def pad_id(self) -> int:
        return self._tokenizer.pad_id

    @property
    def max_length(self) -> int:
        return self._max_length

    def encode_many(self, texts: Sequence[str]) -> List[List[int]]:
        out = []
        for text in texts:
            ids = self._cache.get(text)
            if ids is None:
                ids = self._tokenizer.encode(text, max_length=self._max_length)
                if len(self._cache) < self._cache_size:
                    self._cache[text] = ids
            out.append(ids)
        return out


def _pad_block(
    seqs: Sequence[List[int]], batch_size: int, pad_id: int, length: int
) -> Dict[str, np.ndarray]:
    ids = np.full((batch_size, length), pad_id, dtype=np.int32)
    mask = np.zeros((batch_size, length), dtype=np.int32)
    for i, seq in enumerate(seqs):
        seq = seq[:length]
        ids[i, : len(seq)] = seq
        mask[i, : len(seq)] = 1
    return {"input_ids": ids, "attention_mask": mask}


def _bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket covering ``length``; longer sequences clamp to the
    largest bucket."""
    for b in buckets:
        if b >= length:
            return b
    return buckets[-1]


def _blocks(it: Iterable[Dict], size: int) -> Iterator[List[Dict]]:
    block: List[Dict] = []
    for x in it:
        block.append(x)
        if len(block) == size:
            yield block
            block = []
    if block:
        yield block


def _labels(chunk: List[Dict], label_map: Dict[str, int], batch_size: int) -> np.ndarray:
    labels = []
    for inst in chunk:
        label = inst.get("label")
        if label not in label_map:
            raise ValueError(
                f"label {label!r} not in label map {sorted(label_map)}; "
                "pass the matching label_map for this reader"
            )
        labels.append(label_map[label])
    return np.array(labels + [0] * (batch_size - len(chunk)), dtype=np.int32)


def _weights(n: int, batch_size: int) -> np.ndarray:
    return np.array([1.0] * n + [0.0] * (batch_size - n), dtype=np.float32)


def batches_from_instances(
    instances: Iterable[Dict],
    encoder: CachedEncoder,
    batch_size: int,
    label_map: Optional[Dict[str, int]] = None,
) -> Iterator[Dict]:
    """Fixed-row batches padded to ``encoder.max_length`` (the unbucketed
    scoring path): ``sample1`` {input_ids, attention_mask}, ``label``,
    ``weight`` (0 on dead rows) and ``meta`` (real rows only)."""
    label_map = label_map or LABELS_SIAMESE
    for chunk in _blocks(instances, batch_size):
        yield _collate(chunk, encoder, batch_size, label_map)


def _collate(chunk, encoder, batch_size, label_map) -> Dict:
    seqs = encoder.encode_many([inst["text1"] for inst in chunk])
    return {
        "sample1": _pad_block(seqs, batch_size, encoder.pad_id, encoder.max_length),
        "label": _labels(chunk, label_map, batch_size),
        "weight": _weights(len(chunk), batch_size),
        "meta": [inst.get("meta", {}) for inst in chunk],
    }


def bucketed_batches_from_instances(
    instances: Iterable[Dict],
    encoder: CachedEncoder,
    batch_size: Union[int, Dict[int, int]],
    label_map: Optional[Dict[str, int]] = None,
    buckets: Sequence[int] = (64, 128, 256, 512),
) -> Iterator[Dict]:
    """Length-binned batching: each instance goes to the smallest bucket
    covering its token length; a batch is emitted whenever a bucket fills,
    and tails flush as dead-row-padded batches when the stream ends.
    Instances are re-ordered across buckets (metas travel with their rows).
    ``batch_size`` may map each bucket to its own row count."""
    label_map = label_map or LABELS_SIAMESE
    buckets = tuple(sorted(buckets))
    if isinstance(batch_size, dict):
        sizes = {b: int(batch_size[b]) for b in buckets}
    else:
        sizes = {b: int(batch_size) for b in buckets}
    pending: Dict[int, List[Dict]] = {b: [] for b in buckets}
    for block in _blocks(instances, 512):
        texts = []
        for inst in block:
            if inst.get("text2") is not None:
                raise ValueError("bucketed batching supports single-text instances only")
            texts.append(inst["text1"])
        for inst, seq in zip(block, encoder.encode_many(texts)):
            bucket = _bucket_for(len(seq), buckets)
            slot = dict(inst)
            slot["_ids"] = seq
            pending[bucket].append(slot)
            if len(pending[bucket]) == sizes[bucket]:
                yield _collate_bucket(pending[bucket], encoder, sizes[bucket], label_map, bucket)
                pending[bucket] = []
    for bucket in buckets:
        if pending[bucket]:
            yield _collate_bucket(pending[bucket], encoder, sizes[bucket], label_map, bucket)


def _collate_bucket(chunk, encoder, batch_size, label_map, length) -> Dict:
    return {
        "sample1": _pad_block([inst["_ids"] for inst in chunk], batch_size, encoder.pad_id, length),
        "label": _labels(chunk, label_map, batch_size),
        "weight": _weights(len(chunk), batch_size),
        "meta": [inst.get("meta", {}) for inst in chunk],
    }


def bucket_batch_sizes(
    buckets: Sequence[int],
    tokens_per_batch: int,
    multiple_of: int = 8,
) -> Dict[int, int]:
    """Per-bucket row counts at a constant token budget, rounded down to a
    multiple of ``multiple_of`` (and at least that)."""
    sizes = {}
    for b in sorted(buckets):
        sizes[int(b)] = max(multiple_of, (tokens_per_batch // int(b)) // multiple_of * multiple_of)
    return sizes


def validate_buckets(buckets: Sequence[int], max_length: int):
    """Buckets must cover ``max_length``, or sequences between the largest
    bucket and the cap would be silently truncated."""
    out = tuple(sorted(int(b) for b in buckets))
    if not out:
        raise ValueError("buckets must be non-empty")
    if out[-1] < max_length:
        raise ValueError(
            f"largest bucket {out[-1]} < max_length {max_length}: sequences "
            f"between them would be silently truncated; include "
            f"{max_length} as the final bucket (or lower max_length)"
        )
    return out


def prefetch(iterator: Iterator, depth: int = 4) -> Iterator:
    """Run ``iterator`` on a background thread with a bounded queue, so
    host tokenization and collation overlap the device.  Safe against an
    early consumer exit: the worker stops instead of blocking forever."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()
    error: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for item in iterator:
                if not _put(item):
                    return
        except BaseException as e:  # re-raised in the consumer
            error.append(e)
        finally:
            _put(end)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        thread.join(timeout=5.0)

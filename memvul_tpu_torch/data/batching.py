"""Instance streams → fixed-shape batches (the scoring path of the JAX
package's ``data/batching.py``).

Every batch is padded to a fixed row count (dead rows carry weight 0) and
to a bucketed sequence length, so the encoder sees a small closed set of
shapes: :func:`bucketed_batches_from_instances` routes each report to the
smallest bucket covering its token length and emits a batch when a
bucket fills; :func:`bucket_batch_sizes` sizes the buckets at a constant
token budget.  Batches stay numpy; the predictor moves them to the
device.

The packed serve path lays many requests end to end in one fixed
``[1, token_budget]`` row instead: :func:`pack_token_budget` groups
requests into packs, :class:`PackSlotAllocator` writes them into a
reusable page table one at a time, and :func:`collate_ragged` is its
one-shot form.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

LABELS_SIAMESE = {"same": 0, "diff": 1}


class CachedEncoder:
    """Memoizing wrapper around ``tokenizer.encode`` at a fixed cap."""

    def __init__(self, tokenizer, max_length: int, cache_size: int = 200_000):
        self._tokenizer = tokenizer
        self._max_length = max_length
        self._cache: Dict[str, List[int]] = {}
        self._cache_size = cache_size
        self._beyond: Dict[Tuple[int, str], bool] = {}  # encodes_beyond memo

    @property
    def pad_id(self) -> int:
        return self._tokenizer.pad_id

    @property
    def max_length(self) -> int:
        return self._max_length

    def encodes_beyond(self, text: str, cap: int) -> bool:
        """Whether ``text`` tokenizes to more than ``cap`` tokens (the
        serving truncation probe, ``serve.truncated``).  A capped encode
        cannot tell "exactly cap" from "clamped", so this re-encodes at
        ``cap + 1``; callers probe only sequences at the cap, and the
        verdict is memoized."""
        key = (cap, text)
        hit = self._beyond.get(key)
        if hit is None:
            hit = len(self._tokenizer.encode(text, max_length=cap + 1)) > cap
            if len(self._beyond) < self._cache_size:
                self._beyond[key] = hit
        return hit

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


def pack_token_budget(
    lengths: Sequence[int],
    token_budget: int,
    max_rows: int,
) -> List[List[int]]:
    """Group row lengths into fixed-budget packs, greedily and strictly in
    input order: row ``i`` joins the open pack unless its tokens would
    overflow ``token_budget`` or the pack already holds ``max_rows`` rows,
    and then the open pack is sealed.  The packs covering a prefix of the
    input never depend on what follows it.  Returns index lists; every
    index appears in exactly one.  Lengths clamp to ``token_budget``."""
    if token_budget < 1:
        raise ValueError(f"token_budget must be >= 1, got {token_budget}")
    if max_rows < 1:
        raise ValueError(f"max_rows must be >= 1, got {max_rows}")
    packs: List[List[int]] = []
    open_pack: List[int] = []
    used = 0
    for i, length in enumerate(lengths):
        n = max(1, min(int(length), token_budget))
        if open_pack and (used + n > token_budget or len(open_pack) == max_rows):
            packs.append(open_pack)
            open_pack, used = [], 0
        open_pack.append(i)
        used += n
    if open_pack:
        packs.append(open_pack)
    return packs


class PackSlotAllocator:
    """A reusable ``[1, token_budget]`` page table of live segments, filled
    one request at a time (the continuous dispatcher keeps a pack open
    while the previous one is on the card).

    :meth:`admit` writes one segment in place (tokens, mask, 1-based
    segment id, positions restarting at 0, row start) and returns its row
    index, or ``None`` when it does not fit the remaining budget or rows:
    the caller then seals the pack (:meth:`sample`, fresh copies) and
    :meth:`reset`\\ s the pages.  ``slots_reused`` counts admissions into a
    row slot an earlier pack used (``serve.pack_slots_reused``).

    ``share_prefixes`` aliases exact duplicates: when a sequence's
    cap-truncated tokens equal a segment already in the open pack, the new
    row writes no tokens and its ``row_starts`` entry points at that
    segment's first token, so segment ids in a pack can skip values.  Only
    whole-segment identity is shared: a shared prefix would change the
    prefix tokens' bidirectional attention.  Aliased rows need a row slot
    but no budget (``rows_aliased`` / ``tokens_aliased``).
    """

    def __init__(
        self,
        token_budget: int,
        max_rows: int,
        pad_id: int,
        share_prefixes: bool = False,
    ) -> None:
        if token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        if max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {max_rows}")
        self.token_budget = int(token_budget)
        self.max_rows = int(max_rows)
        self.pad_id = pad_id
        self.share_prefixes = bool(share_prefixes)
        # open-pack segment table: cap-truncated tokens → row index
        self._segment_index: Dict[Tuple[int, ...], int] = {}
        self.rows_aliased = 0
        self.tokens_aliased = 0
        self._ids = np.full((1, self.token_budget), pad_id, dtype=np.int32)
        self._mask = np.zeros((1, self.token_budget), dtype=np.int32)
        self._segments = np.zeros((1, self.token_budget), dtype=np.int32)
        self._positions = np.zeros((1, self.token_budget), dtype=np.int32)
        self._row_starts = np.zeros(self.max_rows, dtype=np.int32)
        self._rows = 0
        self._offset = 0
        self._real_tokens = 0
        self._high_water = 0  # deepest row slot any sealed pack used
        self._generation = 0  # completed reset() count
        self.slots_reused = 0

    @property
    def rows(self) -> int:
        """Live segments in the open pack."""
        return self._rows

    @property
    def used_tokens(self) -> int:
        """Token positions the open pack has written."""
        return self._offset

    @property
    def real_tokens(self) -> int:
        """Real tokens the open pack carries (the padding ledger's
        numerator)."""
        return self._real_tokens

    def fits(self, seq: Sequence[int]) -> bool:
        """Whether :meth:`admit` would take ``seq`` now."""
        if self._rows >= self.max_rows:
            return False
        if self.share_prefixes and tuple(seq[: self.token_budget]) in self._segment_index:
            return True
        return self._offset + min(len(seq), self.token_budget) <= self.token_budget

    def admit(self, seq: Sequence[int]) -> Optional[int]:
        """Write one segment into the open pack; its row index, or
        ``None`` when it does not fit."""
        if not self.fits(seq):
            return None
        seq = seq[: self.token_budget]
        n = len(seq)
        row = self._rows
        if self._generation and row < self._high_water:
            self.slots_reused += 1
        if self.share_prefixes:
            key = tuple(seq)
            orig = self._segment_index.get(key)
            if orig is not None:
                self._row_starts[row] = self._row_starts[orig]
                self._rows = row + 1
                self.rows_aliased += 1
                self.tokens_aliased += n
                return row
            self._segment_index[key] = row
        offset = self._offset
        self._ids[0, offset : offset + n] = seq
        self._mask[0, offset : offset + n] = 1
        self._segments[0, offset : offset + n] = row + 1
        self._positions[0, offset : offset + n] = np.arange(n, dtype=np.int32)
        self._row_starts[row] = offset
        self._rows = row + 1
        self._offset = offset + n
        self._real_tokens += n
        return row

    def sample(self) -> Dict[str, np.ndarray]:
        """The open pack as the flat sample the ragged score path takes,
        in fresh copies (the pages may refill while the card reads it)."""
        return {
            "input_ids": self._ids.copy(),
            "attention_mask": self._mask.copy(),
            "segment_ids": self._segments.copy(),
            "position_ids": self._positions.copy(),
            "row_starts": self._row_starts.copy(),
        }

    def reset(self) -> None:
        """Recycle the pages: clear only the written prefix."""
        offset, rows = self._offset, self._rows
        if offset:
            self._ids[0, :offset] = self.pad_id
            self._mask[0, :offset] = 0
            self._segments[0, :offset] = 0
            self._positions[0, :offset] = 0
        if rows:
            self._row_starts[:rows] = 0
        self._high_water = max(self._high_water, rows)
        self._rows = 0
        self._offset = 0
        self._real_tokens = 0
        self._segment_index.clear()
        self._generation += 1


def collate_ragged(
    seqs: Sequence[List[int]],
    token_budget: int,
    max_rows: int,
    pad_id: int,
) -> Dict[str, np.ndarray]:
    """One pack of sequences → the fixed-shape flat sample, all int32:
    ``input_ids``/``attention_mask``/``segment_ids``/``position_ids``
    ``[1, token_budget]`` (row ``i`` carries segment ``i + 1``, positions
    restart at each row, pad/0 past the packed tail) and ``row_starts``
    ``[max_rows]`` (each row's first token; dead rows point at 0)."""
    if len(seqs) > max_rows:
        raise ValueError(f"{len(seqs)} rows exceed max_rows={max_rows}")
    alloc = PackSlotAllocator(token_budget, max_rows, pad_id)
    for i, seq in enumerate(seqs):
        if alloc.admit(seq) is None:
            n = len(seq[:token_budget])
            raise ValueError(
                f"pack overflows token_budget={token_budget} at row {i} "
                f"(offset {alloc.used_tokens} + {n} tokens); pack with "
                "pack_token_budget first"
            )
    return alloc.sample()


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

"""Instance streams → fixed-shape batches (the scoring path of the JAX
package's ``data/batching.py``).

Every batch is padded to a fixed row count (dead rows carry weight 0) and
to a bucketed sequence length, so the encoder sees a small closed set of
shapes: :func:`bucketed_batches_from_instances` routes each report to the
smallest bucket covering its token length and emits a batch when a
bucket fills; :func:`bucket_batch_sizes` sizes the buckets at a constant
token budget.  Batches stay numpy; the predictor moves them to the
device.

Training pairs go through :func:`bucketed_pair_batches_from_instances`:
each side of a pair is bucketed on its own (reports are long, anchors and
CVE descriptions short), and with ``dedup_side2`` the second side carries
only the batch's unique rows plus a ``sample2_index`` gather map.

The packed serve path lays many requests end to end in one fixed
``[1, token_budget]`` row instead: :func:`pack_token_budget` groups
requests into packs, :class:`PackSlotAllocator` writes them into a
reusable page table one at a time, and :func:`collate_ragged` is its
one-shot form.

While the process records spans (:mod:`memvul_tpu_torch.telemetry.spans`),
the feed thread of a bucketed stream leaves ``feed.tokenize`` (each block
of 512 instances, with its block number), ``feed.collate`` (each batch,
with its id: its place in the stream) and, in :func:`prefetch`,
``feed.put_wait`` (each item's put on the queue, blocked while it is full).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..telemetry import spans

LABELS_SIAMESE = {"same": 0, "diff": 1}
LABELS_BINARY = {"pos": 0, "neg": 1}


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
    scoring path, and pad-to-max training): ``sample1`` {input_ids,
    attention_mask}, ``sample2`` when the instances are pairs, ``label``,
    ``weight`` (0 on dead rows) and ``meta`` (real rows only)."""
    label_map = label_map or LABELS_SIAMESE
    for chunk in _blocks(instances, batch_size):
        yield _collate(chunk, encoder, batch_size, label_map)


def _collate(chunk, encoder, batch_size, label_map) -> Dict:
    seqs = encoder.encode_many([inst["text1"] for inst in chunk])
    batch = {
        "sample1": _pad_block(seqs, batch_size, encoder.pad_id, encoder.max_length),
        "label": _labels(chunk, label_map, batch_size),
        "weight": _weights(len(chunk), batch_size),
        "meta": [inst.get("meta", {}) for inst in chunk],
    }
    if chunk and chunk[0].get("text2") is not None:
        seqs2 = encoder.encode_many([inst["text2"] for inst in chunk])
        batch["sample2"] = _pad_block(seqs2, batch_size, encoder.pad_id, encoder.max_length)
    return batch


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
    emitted = itertools.count()  # batch ids, in the order the batches leave
    for n, block in enumerate(_blocks(instances, 512)):
        texts = []
        for inst in block:
            if inst.get("text2") is not None:
                raise ValueError("bucketed batching supports single-text instances only")
            texts.append(inst["text1"])
        with spans.span("feed.tokenize", n):
            seqs = encoder.encode_many(texts)
        for inst, seq in zip(block, seqs):
            bucket = _bucket_for(len(seq), buckets)
            slot = dict(inst)
            slot["_ids"] = seq
            pending[bucket].append(slot)
            if len(pending[bucket]) == sizes[bucket]:
                yield _collate_bucket(pending[bucket], encoder, sizes[bucket], label_map, bucket,
                                      next(emitted))
                pending[bucket] = []
    for bucket in buckets:
        if pending[bucket]:
            yield _collate_bucket(pending[bucket], encoder, sizes[bucket], label_map, bucket,
                                  next(emitted))


def _collate_bucket(chunk, encoder, batch_size, label_map, length, batch_id=None) -> Dict:
    with spans.span("feed.collate", batch_id):
        return {
            "sample1": _pad_block([inst["_ids"] for inst in chunk], batch_size, encoder.pad_id,
                                  length),
            "label": _labels(chunk, label_map, batch_size),
            "weight": _weights(len(chunk), batch_size),
            "meta": [inst.get("meta", {}) for inst in chunk],
        }


def dedup_capacities(batch_size: int, floor: int = 8) -> Tuple[int, ...]:
    """The closed set of unique-row capacities a deduped side-2 block may
    take: powers of two from ``floor`` up, plus the row count itself, so
    the block shapes stay few while tower 2 runs the nearest power of two
    above the unique count."""
    caps: List[int] = []
    c = floor
    while c < batch_size:
        caps.append(c)
        c *= 2
    caps.append(int(batch_size))
    return tuple(caps)


def _dedup_side2(
    seqs: Sequence[List[int]], batch_size: int, cap_floor: int = 8
) -> Tuple[List[List[int]], np.ndarray, int]:
    """Order-preserving unique rows and per-row gather indices:
    ``(unique_seqs, index[batch_size], capacity)``, the capacity the
    smallest of :func:`dedup_capacities` covering the unique count.  Dead
    rows map to index 0; they carry zero weight."""
    unique: Dict[Tuple[int, ...], int] = {}
    index = np.zeros(batch_size, dtype=np.int32)
    seq_list: List[List[int]] = []
    for i, seq in enumerate(seqs):
        key = tuple(seq)
        slot = unique.get(key)
        if slot is None:
            slot = unique[key] = len(seq_list)
            seq_list.append(seq)
        index[i] = slot
    cap = next(c for c in dedup_capacities(batch_size, floor=cap_floor) if c >= len(seq_list))
    return seq_list, index, cap


def bucketed_pair_batches_from_instances(
    instances: Iterable[Dict],
    encoder: CachedEncoder,
    batch_size: Union[int, Dict[int, int]],
    label_map: Optional[Dict[str, int]] = None,
    buckets: Sequence[int] = (64, 128, 256, 512),
    dedup_side2: bool = True,
    dedup_cap_floor: int = 8,
) -> Iterator[Dict]:
    """Length-binned batching of Siamese pair streams.  Each pair goes to
    the grid cell ``(b1, b2)`` of the smallest buckets covering its two
    sides independently; a batch is emitted when a cell fills, and tails
    flush as dead-row-padded batches, in sorted cell order, when the
    stream ends.  ``batch_size`` may map the side-1 bucket to a row count.

    With ``dedup_side2`` the second side holds only the batch's unique
    rows (``sample2`` [cap, L2], cap from :func:`dedup_capacities` with
    ``dedup_cap_floor``) and ``sample2_index`` [B] gathers each pair's
    embedding back."""
    label_map = label_map or LABELS_SIAMESE
    buckets = tuple(sorted(int(b) for b in buckets))
    if isinstance(batch_size, dict):
        sizes = {b: int(batch_size[b]) for b in buckets}
    else:
        sizes = {b: int(batch_size) for b in buckets}
    pending: Dict[Tuple[int, int], List[Dict]] = {}
    for block in _blocks(instances, 512):
        for inst in block:
            if inst.get("text2") is None:
                raise ValueError(
                    "bucketed pair batching needs text2 on every instance; "
                    "single-text streams use bucketed_batches_from_instances"
                )
        seqs1 = encoder.encode_many([inst["text1"] for inst in block])
        seqs2 = encoder.encode_many([inst["text2"] for inst in block])
        for inst, s1, s2 in zip(block, seqs1, seqs2):
            cell = (_bucket_for(len(s1), buckets), _bucket_for(len(s2), buckets))
            slot = dict(inst)
            slot["_ids1"], slot["_ids2"] = s1, s2
            rows = pending.setdefault(cell, [])
            rows.append(slot)
            if len(rows) == sizes[cell[0]]:
                yield _collate_pair_cell(
                    rows, encoder, sizes[cell[0]], label_map, cell, dedup_side2, dedup_cap_floor
                )
                pending[cell] = []
    for cell in sorted(pending):
        if pending[cell]:
            yield _collate_pair_cell(
                pending[cell], encoder, sizes[cell[0]], label_map, cell, dedup_side2,
                dedup_cap_floor,
            )


def _collate_pair_cell(
    chunk: List[Dict],
    encoder: CachedEncoder,
    batch_size: int,
    label_map: Dict[str, int],
    cell: Tuple[int, int],
    dedup: bool,
    dedup_cap_floor: int = 8,
) -> Dict:
    length1, length2 = cell
    batch: Dict = {
        "sample1": _pad_block([inst["_ids1"] for inst in chunk], batch_size, encoder.pad_id, length1),
        "label": _labels(chunk, label_map, batch_size),
        "weight": _weights(len(chunk), batch_size),
        "meta": [inst.get("meta", {}) for inst in chunk],
    }
    seqs2 = [inst["_ids2"] for inst in chunk]
    if dedup:
        unique, index, cap = _dedup_side2(seqs2, batch_size, dedup_cap_floor)
        batch["sample2"] = _pad_block(unique, cap, encoder.pad_id, length2)
        batch["sample2_index"] = index
    else:
        batch["sample2"] = _pad_block(seqs2, batch_size, encoder.pad_id, length2)
    return batch


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


def auto_buckets(
    lengths: Sequence[int],
    max_length: int,
    n_buckets: int = 4,
    align: int = 8,
) -> Tuple[int, ...]:
    """Bucket boundaries that minimise the padded tokens of a sample of
    sequence lengths: an exact interval-partition DP over the lengths
    rounded up to ``align``, at most ``n_buckets`` boundaries (at least
    one), ``max_length`` always the last."""
    if not len(lengths):
        return (max_length,)
    ls = np.minimum(np.asarray(lengths, np.int64), max_length)
    # candidate boundaries with (count, length sum) each: the DP runs over
    # at most max_length / align values whatever the sample's size
    aligned = np.minimum(max_length, -(-ls // align) * align)
    values, inverse = np.unique(aligned, return_inverse=True)
    counts = np.bincount(inverse)
    sums = np.bincount(inverse, weights=ls.astype(np.float64))
    if int(values[-1]) < max_length:
        # the cap is a boundary: a zero-count top candidate that the DP may
        # also use to cover stragglers, counted against n_buckets
        values = np.concatenate([values, [max_length]])
        counts = np.concatenate([counts, [0]])
        sums = np.concatenate([sums, [0.0]])
    m = len(values)
    n_pre = np.concatenate([[0], np.cumsum(counts)])
    s_pre = np.concatenate([[0.0], np.cumsum(sums)])

    def cost(i: int, j: int) -> float:
        # one bucket over candidates (i, j]: each sequence pads to values[j-1]
        return float(values[j - 1]) * (n_pre[j] - n_pre[i]) - (s_pre[j] - s_pre[i])

    inf = float("inf")
    k_max = max(1, n_buckets)
    f = [[inf] * (m + 1) for _ in range(k_max + 1)]
    arg = [[0] * (m + 1) for _ in range(k_max + 1)]
    f[0][0] = 0.0
    for k in range(1, k_max + 1):
        for j in range(1, m + 1):
            best, best_i = inf, 0
            for i in range(j):
                if f[k - 1][i] == inf:
                    continue
                c = f[k - 1][i] + cost(i, j)
                if c < best:
                    best, best_i = c, i
            f[k][j] = best
            arg[k][j] = best_i
    k_best = min(range(1, k_max + 1), key=lambda k: f[k][m])
    bounds = []
    j = m
    for k in range(k_best, 0, -1):
        bounds.append(int(values[j - 1]))
        j = arg[k][j]
    return tuple(sorted(set(bounds) | {max_length}))


def pow2_buckets(max_length: int, floor: int = 64) -> Tuple[int, ...]:
    """Powers of two from ``floor`` up, capped by (and always including)
    ``max_length``: the default training bucket grid."""
    out: List[int] = []
    b = int(floor)
    while b < max_length:
        out.append(b)
        b *= 2
    out.append(int(max_length))
    return tuple(out)


def resolve_train_buckets(spec, max_length: int) -> Optional[Tuple[int, ...]]:
    """The ``train_buckets`` knob → a bucket tuple: ``"pow2"`` derives
    :func:`pow2_buckets`, ``None`` means pad-to-max, and an explicit list
    must cover ``max_length`` (:func:`validate_buckets`)."""
    if spec is None:
        return None
    if spec == "pow2":
        return pow2_buckets(max_length)
    if isinstance(spec, str):
        raise ValueError(
            f"train_buckets {spec!r} not understood: use 'pow2', null "
            "(pad-to-max), or an explicit bucket list"
        )
    return validate_buckets([int(b) for b in spec], max_length)


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


def prefetch(iterator: Iterator, depth: int = 4, commit=None, occupancy=None) -> Iterator:
    """Run ``iterator`` on a background thread with a bounded queue, so
    host tokenization and collation overlap the device.  With ``commit``
    (the trainer's host-to-device copy) the worker applies it to every
    item before enqueueing, so the copy of batch N+1 overlaps step N.
    ``occupancy`` (a telemetry gauge) tracks the queue fill after every put
    and get: pinned at 0 the feed is the bottleneck, at ``depth`` the
    device.  Safe against an early consumer exit: the worker stops instead
    of blocking forever."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()
    error: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                if occupancy is not None:
                    occupancy.set(q.qsize())
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for n, item in enumerate(iterator):
                if commit is not None:
                    item = commit(item)
                with spans.span("feed.put_wait", n):
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
            if occupancy is not None:
                occupancy.set(q.qsize())
            if item is end:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        thread.join(timeout=5.0)

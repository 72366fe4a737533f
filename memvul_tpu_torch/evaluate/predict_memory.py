"""Siamese memory-model inference (the JAX package's
``evaluate/predict_memory.py``): corpus scoring and the serving
predictor.

Encode the anchor bank in fixed chunks and keep it on the device in the
working dtype; stream the corpus in length buckets, each batch one
encoder pass plus the anchor match and per-anchor softmax, with two
batches in flight before the oldest is pulled to the host; write the
reference-format result lines on a writer thread; then ``cal_metrics``.

For serving, ``score_impl`` picks how requests reach the model:
``"bucketed"`` pads them to length buckets (:meth:`SiamesePredictor.
score_block`), ``"ragged"`` and ``"continuous"`` pack them into one
``[1, token_budget]`` row scored through the segment-masked attention
kernel (:meth:`SiamesePredictor.score_ragged_sample`).

``stream`` (a ``torch.cuda.Stream``) runs the predictor's bank encodes
and serving calls under that stream: the replicas of a fleet that share a
card each get one, so their packs can overlap on the card.  Every tensor
such a call makes is made, read and freed on its stream, and the shared
weights are only read.

``encoder_precision="int8"`` adds an int8 twin of the model that shares
its weights (``BertConfig.quant="int8"``, the projections' int8 codes
cached once); ``score_impl="cascade"`` serves through it first and
rescores the rows whose best probability lies in the cascade band on the
full-precision model (:class:`~memvul_tpu_torch.serving.dispatch.
CascadeDispatcher`).

A corpus pass can be made restartable: ``resume`` keeps a journal of
committed output lines (:mod:`memvul_tpu_torch.resilience.journal`) and a
restarted run skips what it covers, ending with the same bytes as an
uninterrupted run; ``quarantine`` dead-letters records the stream cannot
score; ``retry_policy`` retries a batch's transient failures (never
rerouting it to a plain version); ``heartbeat_batches`` logs progress;
``attribute_anchors`` adds the winning anchor to every output record.
The counters go to the predictor's ``telemetry`` registry (and, when it has
a run directory, the heartbeat to its ``HEARTBEAT.json``: the sharded
scorer's workers); each batch passes the ``score.batch`` fault point inside
its retried window.

PyTorch runs eagerly, so the JAX package's AOT compile and its trace
counter have no counterpart here; :meth:`SiamesePredictor.
warmup_bank_shapes` instead runs each shape once, which builds the kernel
library and launches the kernels before the first request
(``aot_warmup``).  Each shape the predictor runs is a program of its
program registry (``telemetry/programs.py``; ``program_registry=``, else
the process-wide one): the first call of a shape registers it with that
call's wall time and its analytic cost, and every call books its work and,
on the card, its device time from CUDA events around its launches (read
once the host copy has waited for them).  A shape met for the first time
after the warmup counts as a recompile.  Meshes belong to a later slice.
"""

from __future__ import annotations

import contextlib
import json
import logging
import queue
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.batching import (
    LABELS_SIAMESE,
    CachedEncoder,
    _pad_block,
    batches_from_instances,
    bucket_batch_sizes,
    bucketed_batches_from_instances,
    collate_ragged,
    pack_token_budget,
    prefetch,
    validate_buckets,
)
from ..data.readers import MemoryReader
from ..models.memory import MemoryModel, anchor_probs
from ..resilience import faults
from ..resilience.journal import DeadLetter, ScoreJournal
from ..resilience.retry import RetryPolicy, exception_text
from ..telemetry import Registry
from ..telemetry.programs import get_program_registry, model_bytes, score_cost, shape_key
from .measure import cal_metrics
from .metrics import SiameseMeasure

logger = logging.getLogger(__name__)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SiamesePredictor:
    def __init__(
        self,
        model: MemoryModel,
        tokenizer,
        batch_size: int = 512,
        max_length: int = 512,
        buckets: Optional[Sequence[int]] = None,
        tokens_per_batch: Optional[int] = None,
        anchor_chunk: int = 128,
        anchor_match_impl: Optional[str] = None,
        score_impl: str = "bucketed",
        token_budget: Optional[int] = None,
        max_rows_per_pack: Optional[int] = None,
        encoder_precision: str = "fp32",
        cascade_low: float = 0.3,
        cascade_high: float = 0.7,
        stream: Optional["torch.cuda.Stream"] = None,
        program_registry=None,
    ) -> None:
        if score_impl not in ("bucketed", "ragged", "continuous", "cascade"):
            raise ValueError(
                f"score_impl must be 'bucketed', 'ragged', 'continuous' or "
                f"'cascade', got {score_impl!r}"
            )
        if encoder_precision not in ("fp32", "int8"):
            raise ValueError(f"encoder_precision must be 'fp32' or 'int8', got {encoder_precision!r}")
        if score_impl == "cascade" and encoder_precision != "int8":
            raise ValueError("score_impl='cascade' needs the int8 tier: pass encoder_precision='int8'")
        if encoder_precision == "int8" and score_impl in ("ragged", "continuous"):
            raise ValueError(
                f"encoder_precision='int8' scores bucket blocks; score_impl={score_impl!r} "
                "is not cascadable"
            )
        if not 0.0 <= cascade_low <= cascade_high <= 1.0:
            raise ValueError(
                f"cascade band must satisfy 0 <= low <= high <= 1, got "
                f"[{cascade_low!r}, {cascade_high!r}]"
            )
        # rows whose best probability lies in [low, high] (inclusive) are
        # rescored on the full-precision model; the rest keep the int8 score
        self.cascade_band = (float(cascade_low), float(cascade_high))
        self.encoder_precision = encoder_precision
        if token_budget is None:
            token_budget = 4 * max_length
        if token_budget < max_length:
            raise ValueError(
                f"token_budget {token_budget} < max_length {max_length}: one "
                "cap-length request must fit a pack"
            )
        self.score_impl = score_impl
        self.token_budget = int(token_budget)
        self.max_rows_per_pack = int(max_rows_per_pack if max_rows_per_pack is not None else batch_size)
        if self.max_rows_per_pack < 1:
            raise ValueError("max_rows_per_pack must be >= 1")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        if stream is not None and self.device.type != "cuda":
            raise ValueError("a CUDA stream needs a model on the card")
        self.stream = stream
        self.batch_size = batch_size
        self.anchor_chunk = anchor_chunk
        self.anchor_match_impl = anchor_match_impl
        self.encoder = CachedEncoder(tokenizer, max_length=max_length)
        self.buckets = validate_buckets(buckets, max_length) if buckets else None
        # constant-token-budget batching: short buckets run bigger batches
        self.bucket_sizes = (
            bucket_batch_sizes(self.buckets, tokens_per_batch, multiple_of=8)
            if self.buckets and tokens_per_batch else None
        )
        self.anchor_bank: Optional[torch.Tensor] = None  # [A, D] on the device
        self.n_anchors = 0
        self.anchor_labels: List[str] = []
        # what the last run did: anchor chunks and seconds, scored batches,
        # and device seconds per bucket length
        self.stats: Dict = {}
        self.telemetry = Registry()
        self.int8_model = _int8_twin(self.model) if encoder_precision == "int8" else None
        self.programs = program_registry if program_registry is not None \
            else get_program_registry()
        self._weight_bytes = model_bytes(self.model)
        header = getattr(self.model, "header", None) if getattr(self.model, "use_header", False) \
            else None
        self._header_dim = header.dense.out_features if header is not None else None
        self._num_classes = int(self.model.pair_kernel.shape[1])

    def _on_stream(self):
        """The context the predictor's device calls run in: its stream."""
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def _wait(self) -> None:
        """Wait for the predictor's own work: its stream, else the device
        (a replica built beside busy ones never waits for their packs)."""
        if self.stream is not None:
            self.stream.synchronize()
        else:
            _sync(self.device)

    # -- the program registry ------------------------------------------------

    def _cost(self, processed: int, lengths, rows: int, n_anchors: int):
        return score_cost(
            self.model.config, processed, lengths, rows, n_anchors,
            header_dim=self._header_dim, num_classes=self._num_classes,
            weight_bytes=self._weight_bytes,
            bank_bytes=n_anchors * (self._header_dim or self.model.config.hidden_size)
            * self.model.config.dtype.itemsize if n_anchors else 0,
        )

    def _book(self, key: str, cost, full_cost, seconds: Optional[float], wall: float) -> None:
        """Book one call of program ``key``: its work ``cost`` (FLOPs,
        bytes) and device ``seconds``; the first call of a key registers
        it with its wall time and ``full_cost``, the work at its full
        shape, and counts as a recompile in a warm scope."""
        programs = self.programs
        if key not in programs:
            programs.note_trace("score", key)
            programs.register(key, scope="score", compile_s=wall, flops=full_cost[0],
                              bytes_accessed=full_cost[1], device=self.device)
        programs.record_invocation(key, seconds, flops=cost[0], bytes_accessed=cost[1])

    def _timed_call(self, key: str, launch, cost, full_cost) -> np.ndarray:
        """``launch()`` (device work returning a tensor) then its host copy,
        with CUDA events around the launches on the card; booked as one
        call of ``key``."""
        t0 = time.perf_counter()
        with self._on_stream():
            if self.device.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = launch()
                end.record()
                host = out.cpu().numpy()  # waits for the launches, and so for end
                seconds = start.elapsed_time(end) / 1e3
            else:
                host = launch().cpu().numpy()
                seconds = None
        self._book(key, cost, full_cost, seconds, time.perf_counter() - t0)
        return host

    def _block_call(self, block: Dict[str, np.ndarray], bank: torch.Tensor, model=None,
                    prefix: str = "score") -> np.ndarray:
        rows, length = block["input_ids"].shape
        lengths = block["attention_mask"].sum(axis=1).tolist()
        n = int(bank.shape[0])
        return self._timed_call(
            shape_key(prefix, (rows, length)), lambda: self._score(block, bank, model),
            self._cost(rows * length, lengths, rows, n),
            self._cost(rows * length, [length] * rows, rows, n),
        )

    def _to_device(self, block: Dict[str, np.ndarray]):
        return (
            torch.from_numpy(block["input_ids"]).to(self.device).long(),
            torch.from_numpy(block["attention_mask"]).to(self.device),
        )

    # -- phase 1: anchor bank ------------------------------------------------

    def encode_anchors(self, anchor_instances: Iterable[Dict]) -> None:
        """Encode anchors in chunks of ``anchor_chunk`` rows padded to
        ``max_length`` and keep the bank on the device."""
        start = time.perf_counter()
        bank, labels, n_anchors = self.encode_bank(anchor_instances)
        self._wait()
        self.anchor_bank, self.anchor_labels, self.n_anchors = bank, labels, n_anchors
        self.stats["anchor_encode_s"] = time.perf_counter() - start
        self.stats["anchor_chunks"] = -(-n_anchors // self.anchor_chunk)
        logger.info("anchor bank: %d anchors, dim %d", n_anchors, bank.shape[1])

    @torch.no_grad()
    def encode_bank(
        self, anchor_instances: Iterable[Dict]
    ) -> Tuple[torch.Tensor, List[str], int]:
        """(bank [A, D] on the device, labels, A), encoded in chunks of
        ``anchor_chunk`` rows padded to ``max_length``: any bank, the
        predictor's own or a candidate's (``bankops``, ``swap_bank``)."""
        instances = list(anchor_instances)
        labels = [inst["meta"]["label"] for inst in instances]
        parts: List[torch.Tensor] = []
        rows, length = self.anchor_chunk, self.encoder.max_length
        key = shape_key("bank", (rows, length))
        on_card = self.device.type == "cuda"
        calls = []  # per chunk: (events or None, cost)
        t0 = time.perf_counter()
        with self._on_stream():
            for start in range(0, len(instances), self.anchor_chunk):
                chunk = instances[start : start + self.anchor_chunk]
                seqs = self.encoder.encode_many([inst["text1"] for inst in chunk])
                block = _pad_block(seqs, self.anchor_chunk, self.encoder.pad_id,
                                   self.encoder.max_length)
                events = None
                if on_card:
                    events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
                    events[0].record()
                parts.append(self.model.encode(*self._to_device(block))[: len(chunk)])
                if on_card:
                    events[1].record()
                cost = self._cost(rows * length, block["attention_mask"].sum(axis=1).tolist(),
                                  rows, 0)
                calls.append((events, cost))
            bank = torch.cat(parts, dim=0)
        self._wait()
        wall = time.perf_counter() - t0
        full = self._cost(rows * length, [length] * rows, rows, 0)
        for events, cost in calls:
            seconds = events[0].elapsed_time(events[1]) / 1e3 if events else None
            self._book(key, cost, full, seconds, wall)
        return bank, labels, bank.shape[0]

    # -- phase 2: streaming scoring ------------------------------------------

    @torch.no_grad()
    def _score(
        self, block: Dict[str, np.ndarray], bank: Optional[torch.Tensor] = None, model=None
    ) -> torch.Tensor:
        with self._on_stream():
            ids, mask = self._to_device(block)
            bank = self.anchor_bank if bank is None else bank
            logits = (model or self.model)(
                {"input_ids": ids, "attention_mask": mask}, anchors=bank,
                anchor_impl=self.anchor_match_impl,
            )
            return anchor_probs(logits)

    # -- serving: one block or one pack per call -----------------------------
    #
    # Both run on whichever thread calls them (the continuous dispatcher's
    # device worker among them), so each carries its own no_grad, and the
    # .cpu() sync releases the GIL while the card works.

    def score_block(self, block: Dict[str, np.ndarray], bank: torch.Tensor) -> np.ndarray:
        """One padded (rows, length) block × bank → probabilities [rows, A]."""
        return self._block_call(block, bank)

    def score_block_int8(self, block: Dict[str, np.ndarray], bank: torch.Tensor) -> np.ndarray:
        """:meth:`score_block` on the int8 tier (``encoder_precision="int8"``)."""
        return self._block_call(block, bank, self._require_int8(), prefix="score_int8")

    def _require_int8(self) -> MemoryModel:
        if self.int8_model is None:
            raise RuntimeError(
                "the int8 tier needs a predictor built with encoder_precision='int8'"
            )
        return self.int8_model

    @torch.no_grad()
    def score_ragged_sample(self, sample: Dict[str, np.ndarray], bank: torch.Tensor) -> np.ndarray:
        """One :func:`~memvul_tpu_torch.data.batching.collate_ragged` pack
        × bank → probabilities [max_rows, A] (dead rows included)."""
        def launch():
            dev = {k: torch.from_numpy(v).to(self.device) for k, v in sample.items()}
            for key in ("input_ids", "position_ids", "row_starts"):
                dev[key] = dev[key].long()
            logits = self.model.score_ragged(dev, bank, impl=self.anchor_match_impl)
            return anchor_probs(logits)

        segments = sample["segment_ids"]
        lengths = np.bincount(segments[segments > 0]).tolist()[1:]
        budget = int(sample["input_ids"].shape[1])
        rows, n = int(sample["row_starts"].shape[0]), int(bank.shape[0])
        cap = self.encoder.max_length
        full = [cap] * (budget // cap) + ([budget % cap] if budget % cap else [])
        return self._timed_call(
            shape_key("ragged", (1, budget)), launch,
            self._cost(budget, lengths, rows, n), self._cost(budget, full, rows, n),
        )

    def stream_shapes(self) -> List[Tuple[int, int]]:
        """The closed (rows, length) set bucketed scoring produces: one per
        bucket at its row count, or (batch_size, max_length)."""
        if self.buckets is None:
            return [(self.batch_size, self.encoder.max_length)]
        sizes = self.bucket_sizes or {b: self.batch_size for b in self.buckets}
        return [(sizes[b], b) for b in self.buckets]

    def ragged_shape(self) -> Tuple[int, int]:
        """(token_budget, max_rows): the one shape every pack has."""
        return (self.token_budget, self.max_rows_per_pack)

    @property
    def uses_ragged_program(self) -> bool:
        """Whether serving packs requests (``"ragged"`` and
        ``"continuous"`` share the packed path and differ only in how the
        service fills packs)."""
        return self.score_impl in ("ragged", "continuous")

    def warmup_bank_shapes(self, bank: torch.Tensor) -> int:
        """Run every serving shape once against ``bank``: one pack on the
        packed path, one block per stream shape otherwise.  The first call
        builds the kernel library and launches each kernel, so the first
        request pays neither.  Returns the number of shapes run."""
        pad = self.encoder.pad_id
        # an intended (re-)warm: its new shapes are no recompiles
        self.programs.mark_warm("score", False)
        if self.uses_ragged_program:
            self.score_ragged_sample(
                collate_ragged([[pad]], self.token_budget, self.max_rows_per_pack, pad), bank
            )
            self.programs.mark_warm("score")
            return 1
        shapes = self.stream_shapes()
        tiers = [self.score_block] + ([self.score_block_int8] if self.int8_model else [])
        for score in tiers:
            for rows, length in shapes:
                score(
                    {"input_ids": np.zeros((rows, length), np.int32),
                     "attention_mask": np.ones((rows, length), np.int32)},
                    bank,
                )
        self.programs.mark_warm("score")
        return len(shapes) * len(tiers)

    def warmup_compile(self) -> int:
        """:meth:`warmup_bank_shapes` against the encoded bank."""
        if self.anchor_bank is None:
            raise RuntimeError("call encode_anchors() first")
        return self.warmup_bank_shapes(self.anchor_bank)

    def score_texts(
        self,
        texts: Sequence[str],
        bank_array: Optional[torch.Tensor] = None,
        n_anchors: Optional[int] = None,
        impl: Optional[str] = None,
    ) -> np.ndarray:
        """Score raw texts against a bank the way the service would: packed
        into ``[1, token_budget]`` rows on the packed path, else grouped
        into bucket blocks (``impl="bucketed"`` forces those, on the
        full-precision model even for ``score_impl="cascade"``).
        ``impl="int8"`` scores the blocks on the int8 tier; ``"cascade"``
        applies the serving rule offline: int8 everywhere, then the rows
        whose best probability lies in ``cascade_band`` (inclusive) rescored
        at full precision.  ``bank_array`` and ``n_anchors`` default to the
        predictor's own bank; the shadow scorer and the promotion gates pass
        a candidate's (warm its shapes first with :meth:`warmup_bank_shapes`).
        Returns ``[len(texts), n_anchors]`` probabilities."""
        if impl not in (None, "bucketed", "int8", "cascade"):
            raise ValueError(f"impl must be None, 'bucketed', 'int8' or 'cascade', got {impl!r}")
        bank = self.anchor_bank if bank_array is None else bank_array
        n = self.n_anchors if n_anchors is None else int(n_anchors)
        if bank is None:
            raise RuntimeError("call encode_anchors() first")
        int8 = self._require_int8() if impl in ("int8", "cascade") else None
        if not texts:
            return np.zeros((0, n), np.float32)
        seqs = self.encoder.encode_many(list(texts))
        if int8 is not None:
            out = self._score_seqs_bucketed(seqs, bank, n, int8)
            if impl == "cascade":
                low, high = self.cascade_band
                best = out.max(axis=1) if n else np.zeros(len(seqs))
                band = [i for i in range(len(seqs)) if low <= best[i] <= high]
                if band:
                    out[band] = self._score_seqs_bucketed([seqs[i] for i in band], bank, n)
            return out
        if impl is not None or not self.uses_ragged_program:
            return self._score_seqs_bucketed(seqs, bank, n)
        out = np.zeros((len(texts), n), np.float32)
        pad = self.encoder.pad_id
        for pack in pack_token_budget([len(s) for s in seqs], self.token_budget, self.max_rows_per_pack):
            sample = collate_ragged([seqs[i] for i in pack], self.token_budget, self.max_rows_per_pack, pad)
            out[pack] = self.score_ragged_sample(sample, bank)[: len(pack), :n]
        return out

    def _score_seqs_bucketed(self, seqs, bank: torch.Tensor, n: int, model=None) -> np.ndarray:
        """Encoded sequences through the bucket blocks (on ``model``, the
        full-precision one by default): grouped by the smallest covering
        length, chunked at its row count, in the service's ``_pad_block``
        layout."""
        out = np.zeros((len(seqs), n), np.float32)
        rows_by_length = {length: rows for rows, length in self.stream_shapes()}
        lengths = sorted(rows_by_length)
        groups: Dict[int, List[int]] = {}
        for i, seq in enumerate(seqs):
            length = next((b for b in lengths if b >= len(seq)), lengths[-1])
            groups.setdefault(length, []).append(i)
        for length in sorted(groups):
            rows = rows_by_length[length]
            indices = groups[length]
            for start in range(0, len(indices), rows):
                chunk = indices[start : start + rows]
                block = _pad_block([seqs[i] for i in chunk], rows, self.encoder.pad_id, length)
                out[chunk] = self._block_call(block, bank, model,
                                              "score" if model is None or model is self.model
                                              else "score_int8")[: len(chunk), :n]
        return out

    def score_instances(
        self,
        instances: Iterable[Dict],
        inflight: int = 2,
        prefetch_depth: int = 4,
        retry_policy: Optional[RetryPolicy] = None,
        with_anchors: bool = False,
    ) -> Iterator[Tuple[np.ndarray, List[Dict]]]:
        """Yields (per-anchor probabilities [b, A], metas) per batch, dead
        rows and padded anchors sliced off.  Up to ``inflight`` batches are
        launched before the oldest is synced to the host (once per batch).

        ``retry_policy`` retries a batch whose launch or host sync fails
        transiently (the policy's classification; launches on the card are
        asynchronous, so a device fault surfaces at the sync, where the
        batch is launched again); anything else propagates.
        ``with_anchors`` stamps each meta with the winning anchor
        (``_anchor``, its id; ``_anchor_index``, its bank index)."""
        if self.anchor_bank is None:
            raise RuntimeError("call encode_anchors() first")
        if self.buckets is not None:
            batches = bucketed_batches_from_instances(
                instances, self.encoder, batch_size=self.bucket_sizes or self.batch_size,
                label_map=LABELS_SIAMESE, buckets=self.buckets,
            )
        else:
            batches = batches_from_instances(
                instances, self.encoder, batch_size=self.batch_size, label_map=LABELS_SIAMESE,
            )
        seconds: Dict[int, float] = {}
        counts: Dict[int, int] = {}
        # per bucket length: live rows (reports) and row slots (with dead rows)
        rows: Dict[int, int] = {}
        slots: Dict[int, int] = {}
        self.stats["bucket_seconds"], self.stats["bucket_batches"] = seconds, counts
        self.stats["bucket_rows"], self.stats["bucket_row_slots"] = rows, slots
        # host seconds: waiting on the feed thread, enqueueing a batch's
        # launches, and blocked in the D2H sync
        host = {"feed_wait_s": 0.0, "launch_s": 0.0, "sync_s": 0.0}
        self.stats.update(host)
        on_card = self.device.type == "cuda"
        pending: deque = deque()
        tel = self.telemetry

        def count_retry(exc, attempt):
            tel.counter("resilience.retries").inc()

        def launch(batch):
            # each batch's device time, by CUDA events around its launches
            # (host time on the CPU, where the forward is synchronous)
            def once():
                # chaos hook: once per batch, inside the retried window
                faults.fault_point("score.batch")
                return self._score(batch["sample1"])

            def score():
                if retry_policy is None:
                    return once()
                return retry_policy.call(once, description="score batch", on_retry=count_retry)

            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                probs = score()
                end.record()
                return probs, batch, (start, end)
            t0 = time.perf_counter()
            probs = score()
            return probs, batch, time.perf_counter() - t0

        def drain():
            probs, batch, timing = pending.popleft()
            t0 = time.perf_counter()
            try:
                arr = probs.cpu().numpy()  # the one host sync of this batch
            except Exception as e:
                if retry_policy is None or not retry_policy.is_transient(exception_text(e)):
                    raise
                logger.warning("batch failed at the host sync (%s); launching it again",
                               exception_text(e)[:200])
                count_retry(e, 1)
                probs, batch, timing = launch(batch)
                arr = probs.cpu().numpy()
            host["sync_s"] += time.perf_counter() - t0
            elapsed = timing[0].elapsed_time(timing[1]) / 1e3 if on_card else timing
            n_slots, length = batch["sample1"]["input_ids"].shape
            metas = batch["meta"]
            block_lengths = batch["sample1"]["attention_mask"].sum(axis=1).tolist()
            self._book(
                shape_key("score", (n_slots, length)),
                self._cost(n_slots * length, block_lengths, n_slots, self.n_anchors),
                self._cost(n_slots * length, [length] * n_slots, n_slots, self.n_anchors),
                elapsed if on_card else None, elapsed,
            )
            seconds[length] = seconds.get(length, 0.0) + elapsed
            counts[length] = counts.get(length, 0) + 1
            rows[length] = rows.get(length, 0) + len(metas)
            slots[length] = slots.get(length, 0) + n_slots
            tel.counter("score.batches").inc()
            tel.counter("score.rows").inc(len(metas))
            sliced = arr[: len(metas), : self.n_anchors]
            if with_anchors:
                for meta, idx in zip(metas, sliced.argmax(axis=-1)):
                    meta["_anchor_index"] = int(idx)
                    meta["_anchor"] = self.anchor_labels[int(idx)]
            return sliced, metas

        feed = iter(prefetch(batches, depth=prefetch_depth))
        while True:
            t0 = time.perf_counter()
            batch = next(feed, None)
            t1 = time.perf_counter()
            host["feed_wait_s"] += t1 - t0
            if batch is None:
                break
            pending.append(launch(batch))
            host["launch_s"] += time.perf_counter() - t1
            if len(pending) > inflight:
                yield drain()
        while pending:
            yield drain()
        self.stats.update(host)
        self.stats["batches"] = sum(counts.values())

    def predict_single(self, text: str) -> Dict:
        """Score one report: per-anchor probabilities, the best score and
        the winning anchor's id and bank index.  Dispatches at the smallest
        stream shape covering the text (over-long texts truncate into the
        largest), so after ``warmup_compile`` it meets no new program."""
        if self.anchor_bank is None:
            raise RuntimeError("call encode_anchors() first")
        seq = self.encoder.encode_many([text])[0]
        shapes = sorted(self.stream_shapes(), key=lambda rl: rl[1])
        rows, length = next(((r, n) for r, n in shapes if n >= len(seq)), shapes[-1])
        block = _pad_block([seq], rows, self.encoder.pad_id, length)
        row = self._block_call(block, self.anchor_bank)[0, : self.n_anchors]
        best = int(np.argmax(row))
        return {
            "predict": {label: float(p) for label, p in zip(self.anchor_labels, row)},
            "score": float(row[best]),
            "anchor": self.anchor_labels[best],
            "anchor_index": best,
        }

    def predict_file(
        self,
        reader: MemoryReader,
        test_path: Union[str, Path],
        out_path: Union[str, Path],
        split: Optional[str] = None,
        inflight: int = 2,
        resume: bool = False,
        quarantine: Union[bool, str, Path, None] = None,
        heartbeat_batches: int = 0,
        retry_policy: Optional[RetryPolicy] = None,
        attribute_anchors: bool = False,
        expected_reports: Optional[int] = None,
    ) -> Dict[str, float]:
        """Stream a corpus file, write the reference-format result lines
        (one JSON list of records per batch, serialised on a writer
        thread), and return the threshold-swept siamese metrics.

        * ``resume`` keeps ``<out>.journal``, an entry per committed output
          line; a restarted run verifies it against the output, cuts any
          torn tail, skips the reports the verified prefix covers and feeds
          its lines back into the metrics, so it ends with the bytes and
          metrics of an uninterrupted run.  A run without ``resume``
          deletes a stale journal.
        * ``quarantine`` (True for ``<out>.deadletter``, or a path)
          dead-letters malformed and over-long records with their reasons.
        * ``heartbeat_batches=N`` logs progress every N batches (rows/s,
          the ETA when ``expected_reports`` is given, the journal's total,
          the quarantine count) and writes it to :attr:`telemetry`'s
          ``HEARTBEAT.json`` when that registry has a run directory.
        * ``retry_policy`` retries transient batch failures
          (:meth:`score_instances`).
        * ``attribute_anchors`` adds the winning anchor's id and bank index
          (``"anchor"``, ``"anchor_index"``) to every output record.

        Counters go to :attr:`telemetry`: ``score.rows``,
        ``score.batches``, ``score.journal_commit_lag_s`` (scored on the
        host → committed in the journal), ``journal.lines_committed``,
        ``journal.rows_committed`` and ``score.dead_letters``."""
        out_path = Path(out_path)
        tel = self.telemetry
        measure = SiameseMeasure()
        n = 0
        journal: Optional[ScoreJournal] = None
        completed: set = set()
        dead: Optional[DeadLetter] = None
        if quarantine:
            dead_path = (Path(str(out_path) + ".deadletter") if isinstance(quarantine, bool)
                         else Path(quarantine))
            dead = DeadLetter(dead_path, registry=tel)
        journal_path = Path(str(out_path) + ".journal")
        if resume:
            journal = ScoreJournal(journal_path, registry=tel)
            kept_n, completed, kept_lines = journal.verified_prefix(out_path)
            # drop the unverified tail so this run scores those rows again
            journal.truncate_to(kept_n, out_path)
            for line in kept_lines:
                for rec in json.loads(line):
                    preds = rec.get("predict") or {}
                    measure.update([max(preds.values()) if preds else 0.0],
                                   [{"label": rec.get("label")}])
                    n += 1
            if kept_n:
                logger.info("resume: %d journaled output lines verified (%d reports); "
                            "skipping them", kept_n, n)
        elif journal_path.exists():
            # this run rewrites the output: a stale journal would poison a
            # later resume
            journal_path.unlink()
        n_resumed = n
        commit_lag = tel.histogram("score.journal_commit_lag_s")
        q: "queue.Queue" = queue.Queue(maxsize=16)
        writer_error: List[BaseException] = []
        failed = threading.Event()

        def _writer() -> None:
            try:
                with open(out_path, "a" if resume else "w") as f:
                    while True:
                        item = q.get()
                        if item is None:
                            return
                        probs, metas, scored_at = item
                        records = [
                            {
                                "Issue_Url": meta.get("Issue_Url"),
                                "label": meta.get("label"),
                                "predict": {
                                    anchor: float(p)
                                    for anchor, p in zip(self.anchor_labels, row)
                                },
                                **({"anchor": meta.get("_anchor"),
                                    "anchor_index": meta.get("_anchor_index")}
                                   if attribute_anchors else {}),
                            }
                            for row, meta in zip(probs, metas)
                        ]
                        text = json.dumps(records)
                        f.write(text + "\n")
                        if journal is not None:
                            # the entry claims the line landed: flush it first
                            f.flush()
                            journal.append(journal.entries_written,
                                           [meta["_row"] for meta in metas], text)
                            commit_lag.observe(time.monotonic() - scored_at)
            except BaseException as e:  # re-raised in the caller below
                writer_error.append(e)
                failed.set()

        def _put(item) -> None:
            while not failed.is_set():
                try:
                    q.put(item, timeout=1.0)
                    return
                except queue.Full:
                    continue

        instances = reader.read(str(test_path), split=split, quarantine=dead)
        if journal is not None:
            instances = _indexed_stream(instances, completed)
        writer = threading.Thread(target=_writer, daemon=True)
        writer.start()
        start = time.perf_counter()
        batches_done = 0
        try:
            for probs, metas in self.score_instances(
                instances, inflight=inflight, retry_policy=retry_policy,
                with_anchors=attribute_anchors,
            ):
                _put((probs, metas, time.monotonic()))
                if failed.is_set():
                    break
                measure.update(probs.max(axis=-1), metas)
                n += len(metas)
                batches_done += 1
                if heartbeat_batches and batches_done % heartbeat_batches == 0:
                    rate = (n - n_resumed) / max(time.perf_counter() - start, 1e-9)
                    eta_s = (max(0.0, (expected_reports - n) / rate)
                             if expected_reports and rate > 0 else None)
                    logger.info(
                        "scoring heartbeat: %d batches this run (journal total %s), "
                        "%d/%d reports, %.0f rows/s, ETA %s, %d quarantined",
                        batches_done, journal.entries_written if journal is not None else "-",
                        n - n_resumed, n, rate,
                        "unknown" if eta_s is None else f"{eta_s:.0f}s",
                        dead.count if dead is not None else 0,
                    )
                    tel.heartbeat(force=True, rows_scored=n, rows_per_sec=round(rate, 1),
                                  eta_s=None if eta_s is None else round(eta_s, 1))
        finally:
            _put(None)
            writer.join()
            if journal is not None:
                journal.close()
            if dead is not None:
                dead.close()
            # after the writer drained: the counters match what is on disk
            tel.heartbeat(force=True, rows_scored=n)
        if writer_error:
            raise writer_error[0]
        elapsed = time.perf_counter() - start
        logger.info("scored %d reports in %.1fs (%.0f reports/s)%s%s", n - n_resumed, elapsed,
                    (n - n_resumed) / max(elapsed, 1e-9),
                    f", {n_resumed} resumed from the journal" if n_resumed else "",
                    f", {dead.count} quarantined" if dead is not None and dead.count else "")
        metrics = measure.compute(reset=True)
        metrics["num_samples"] = n
        metrics["elapsed_s"] = elapsed
        if dead is not None:
            metrics["num_quarantined"] = dead.count
        metrics.update(self.stats)
        metrics["stream_shapes"] = [list(shape) for shape in self.stream_shapes()]
        return metrics


def _indexed_stream(instances: Iterable[Dict], completed: set) -> Iterator[Dict]:
    """Stamp each instance's meta with its stream index (``_row``, what the
    journal records) and drop the rows a verified resume prefix covers.
    The index counts the stream after quarantine, whose decisions are the
    same on every pass over a file, so it is stable across a restart."""
    for i, inst in enumerate(instances):
        if i in completed:
            continue
        inst = dict(inst)
        inst["meta"] = dict(inst.get("meta") or {}, _row=i)
        yield inst


def _int8_twin(model: MemoryModel) -> MemoryModel:
    """``model`` with ``quant="int8"``, sharing its weights (built on the
    meta device, then given the model's own tensors): the int8 codes are
    derived state, cached at its first call."""
    kw = dict(use_header=model.use_header, temperature=model.temperature,
              num_classes=model.pair_kernel.shape[1])
    if model.use_header:
        kw["header_dim"] = model.header.dense.out_features
    with torch.device("meta"):
        twin = MemoryModel(model.config.replace(quant="int8"), **kw)
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin.eval()


def test_siamese(
    model: MemoryModel,
    tokenizer,
    test_file: Union[str, Path],
    golden_file: Union[str, Path],
    out_results: Union[str, Path],
    out_metrics: Optional[Union[str, Path]] = None,
    reader: Optional[MemoryReader] = None,
    batch_size: int = 512,
    max_length: int = 512,
    buckets: Optional[Sequence[int]] = None,
    tokens_per_batch: Optional[int] = None,
    thres: float = 0.5,
    inflight: int = 2,
    anchor_match_impl: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    aot_warmup: bool = True,
    resume: bool = False,
    quarantine: Union[bool, str, Path, None] = None,
    heartbeat_batches: int = 0,
    score_retries: int = 0,
    attribute_anchors: bool = False,
) -> Dict[str, float]:
    """End-to-end evaluation: encode the anchor bank, run every stream
    shape once (``aot_warmup``), score the corpus, then ``cal_metrics``.
    The scoring metrics come back under ``s_`` keys beside the
    ``cal_metrics`` dict.  ``resume``, ``quarantine``,
    ``heartbeat_batches`` and ``attribute_anchors`` go to
    :meth:`SiamesePredictor.predict_file`; ``score_retries`` > 0 retries
    transient batch failures that many times.  Runs on ``device``
    (the card unless the caller asks for the CPU)."""
    from ..build import resolve_device

    device = resolve_device(device)
    model = model.to(device)
    reader = reader or MemoryReader()
    predictor = SiamesePredictor(
        model, tokenizer, batch_size=batch_size, max_length=max_length,
        buckets=buckets, tokens_per_batch=tokens_per_batch,
        anchor_match_impl=anchor_match_impl,
    )
    predictor.encode_anchors(reader.read_anchors(str(golden_file)))
    if aot_warmup:
        t0 = time.perf_counter()
        shapes = predictor.warmup_compile()
        predictor.stats["warmup_s"] = time.perf_counter() - t0
        logger.info("warmup: %d stream shape(s) run in %.1fs", shapes, predictor.stats["warmup_s"])
    eval_metrics = predictor.predict_file(
        reader, test_file, out_results, inflight=inflight, resume=resume,
        quarantine=quarantine, heartbeat_batches=heartbeat_batches,
        retry_policy=RetryPolicy(attempts=score_retries) if score_retries > 0 else None,
        attribute_anchors=attribute_anchors,
    )
    final = cal_metrics(out_results, thres=thres, out_file=out_metrics)
    final.update({f"s_{k}": v for k, v in eval_metrics.items()})
    return final

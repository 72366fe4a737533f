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

PyTorch runs eagerly, so the JAX package's AOT compile, its trace
counter and its program registry have no counterpart here;
:meth:`SiamesePredictor.warmup_bank_shapes` instead runs each shape once,
which builds the kernel library and launches the kernels before the
first request.  Resume/journal/quarantine, meshes and the int8 cascade
belong to later slices.
"""

from __future__ import annotations

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
    ) -> None:
        if score_impl not in ("bucketed", "ragged", "continuous", "cascade"):
            raise ValueError(
                f"score_impl must be 'bucketed', 'ragged', 'continuous' or "
                f"'cascade', got {score_impl!r}"
            )
        if score_impl == "cascade":
            raise NotImplementedError(
                "score_impl='cascade' needs the int8 tier, which is not ported "
                "yet (the int8 slice in ROADMAP.md)"
            )
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
        bank, labels, n_anchors, chunks = self.encode_bank(anchor_instances)
        _sync(self.device)
        self.anchor_bank, self.anchor_labels, self.n_anchors = bank, labels, n_anchors
        self.stats["anchor_encode_s"] = time.perf_counter() - start
        self.stats["anchor_chunks"] = chunks
        logger.info("anchor bank: %d anchors, dim %d", n_anchors, bank.shape[1])

    @torch.no_grad()
    def encode_bank(
        self, anchor_instances: Iterable[Dict]
    ) -> Tuple[torch.Tensor, List[str], int, int]:
        """(bank [A, D] on the device, labels, A, chunks encoded)."""
        instances = list(anchor_instances)
        labels = [inst["meta"]["label"] for inst in instances]
        parts: List[torch.Tensor] = []
        for start in range(0, len(instances), self.anchor_chunk):
            chunk = instances[start : start + self.anchor_chunk]
            seqs = self.encoder.encode_many([inst["text1"] for inst in chunk])
            block = _pad_block(seqs, self.anchor_chunk, self.encoder.pad_id, self.encoder.max_length)
            parts.append(self.model.encode(*self._to_device(block))[: len(chunk)])
        bank = torch.cat(parts, dim=0)
        return bank, labels, bank.shape[0], len(parts)

    # -- phase 2: streaming scoring ------------------------------------------

    @torch.no_grad()
    def _score(self, block: Dict[str, np.ndarray], bank: Optional[torch.Tensor] = None) -> torch.Tensor:
        ids, mask = self._to_device(block)
        bank = self.anchor_bank if bank is None else bank
        logits = self.model(
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
        return self._score(block, bank).cpu().numpy()

    @torch.no_grad()
    def score_ragged_sample(self, sample: Dict[str, np.ndarray], bank: torch.Tensor) -> np.ndarray:
        """One :func:`~memvul_tpu_torch.data.batching.collate_ragged` pack
        × bank → probabilities [max_rows, A] (dead rows included)."""
        dev = {k: torch.from_numpy(v).to(self.device) for k, v in sample.items()}
        for key in ("input_ids", "position_ids", "row_starts"):
            dev[key] = dev[key].long()
        logits = self.model.score_ragged(dev, bank, impl=self.anchor_match_impl)
        return anchor_probs(logits).cpu().numpy()

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
        if self.uses_ragged_program:
            self.score_ragged_sample(
                collate_ragged([[pad]], self.token_budget, self.max_rows_per_pack, pad), bank
            )
            return 1
        shapes = self.stream_shapes()
        for rows, length in shapes:
            self.score_block(
                {"input_ids": np.zeros((rows, length), np.int32),
                 "attention_mask": np.ones((rows, length), np.int32)},
                bank,
            )
        return len(shapes)

    def warmup_compile(self) -> int:
        """:meth:`warmup_bank_shapes` against the encoded bank."""
        if self.anchor_bank is None:
            raise RuntimeError("call encode_anchors() first")
        return self.warmup_bank_shapes(self.anchor_bank)

    def score_texts(self, texts: Sequence[str], impl: Optional[str] = None) -> np.ndarray:
        """Score raw texts against the anchor bank the way the service
        would: packed into ``[1, token_budget]`` rows on the packed path,
        else grouped into bucket blocks (``impl="bucketed"`` forces those).
        Returns ``[len(texts), n_anchors]`` probabilities."""
        if impl not in (None, "bucketed"):
            raise ValueError(f"impl must be None or 'bucketed' (int8 is not ported), got {impl!r}")
        bank, n = self.anchor_bank, self.n_anchors
        if bank is None:
            raise RuntimeError("call encode_anchors() first")
        if not texts:
            return np.zeros((0, n), np.float32)
        seqs = self.encoder.encode_many(list(texts))
        if impl is not None or not self.uses_ragged_program:
            return self._score_seqs_bucketed(seqs, bank, n)
        out = np.zeros((len(texts), n), np.float32)
        pad = self.encoder.pad_id
        for pack in pack_token_budget([len(s) for s in seqs], self.token_budget, self.max_rows_per_pack):
            sample = collate_ragged([seqs[i] for i in pack], self.token_budget, self.max_rows_per_pack, pad)
            out[pack] = self.score_ragged_sample(sample, bank)[: len(pack), :n]
        return out

    def _score_seqs_bucketed(self, seqs, bank: torch.Tensor, n: int) -> np.ndarray:
        """Encoded sequences through the bucket blocks: grouped by the
        smallest covering length, chunked at its row count, in the
        service's ``_pad_block`` layout."""
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
                out[chunk] = self.score_block(block, bank)[: len(chunk), :n]
        return out

    def score_instances(
        self, instances: Iterable[Dict], inflight: int = 2, prefetch_depth: int = 4
    ) -> Iterator[Tuple[np.ndarray, List[Dict]]]:
        """Yields (per-anchor probabilities [b, A], metas) per batch, dead
        rows and padded anchors sliced off.  Up to ``inflight`` batches are
        launched before the oldest is synced to the host (once per batch)."""
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

        def launch(batch):
            # each batch's device time, by CUDA events around its launches
            # (host time on the CPU, where the forward is synchronous)
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                probs = self._score(batch["sample1"])
                end.record()
                return probs, batch, (start, end)
            t0 = time.perf_counter()
            probs = self._score(batch["sample1"])
            return probs, batch, time.perf_counter() - t0

        def drain():
            probs, batch, timing = pending.popleft()
            t0 = time.perf_counter()
            arr = probs.cpu().numpy()  # the one host sync of this batch
            host["sync_s"] += time.perf_counter() - t0
            elapsed = timing[0].elapsed_time(timing[1]) / 1e3 if on_card else timing
            n_slots, length = batch["sample1"]["input_ids"].shape
            metas = batch["meta"]
            seconds[length] = seconds.get(length, 0.0) + elapsed
            counts[length] = counts.get(length, 0) + 1
            rows[length] = rows.get(length, 0) + len(metas)
            slots[length] = slots.get(length, 0) + n_slots
            return arr[: len(metas), : self.n_anchors], metas

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
        the winning anchor's id and bank index.  Uses the smallest bucket
        covering the text (over-long texts truncate into the largest)."""
        if self.anchor_bank is None:
            raise RuntimeError("call encode_anchors() first")
        seq = self.encoder.encode_many([text])[0]
        lengths = sorted(self.buckets) if self.buckets else [self.encoder.max_length]
        length = next((b for b in lengths if b >= len(seq)), lengths[-1])
        row = self._score(_pad_block([seq], 1, self.encoder.pad_id, length))
        row = row.cpu().numpy()[0, : self.n_anchors]
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
    ) -> Dict[str, float]:
        """Stream a corpus file, write the reference-format result lines
        (one JSON list of records per batch, serialised on a writer
        thread), and return the threshold-swept siamese metrics."""
        out_path = Path(out_path)
        measure = SiameseMeasure()
        n = 0
        q: "queue.Queue" = queue.Queue(maxsize=16)
        writer_error: List[BaseException] = []
        failed = threading.Event()

        def _writer() -> None:
            try:
                with open(out_path, "w") as f:
                    while True:
                        item = q.get()
                        if item is None:
                            return
                        probs, metas = item
                        records = [
                            {
                                "Issue_Url": meta.get("Issue_Url"),
                                "label": meta.get("label"),
                                "predict": {
                                    anchor: float(p)
                                    for anchor, p in zip(self.anchor_labels, row)
                                },
                            }
                            for row, meta in zip(probs, metas)
                        ]
                        f.write(json.dumps(records) + "\n")
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

        writer = threading.Thread(target=_writer, daemon=True)
        writer.start()
        start = time.perf_counter()
        try:
            for probs, metas in self.score_instances(
                reader.read(str(test_path), split=split), inflight=inflight
            ):
                _put((probs, metas))
                if failed.is_set():
                    break
                measure.update(probs.max(axis=-1), metas)
                n += len(metas)
        finally:
            _put(None)
            writer.join()
        if writer_error:
            raise writer_error[0]
        elapsed = time.perf_counter() - start
        logger.info("scored %d reports in %.1fs (%.0f reports/s)", n, elapsed, n / max(elapsed, 1e-9))
        metrics = measure.compute(reset=True)
        metrics["num_samples"] = n
        metrics["elapsed_s"] = elapsed
        metrics.update(self.stats)
        return metrics


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
) -> Dict[str, float]:
    """End-to-end evaluation: encode the anchor bank, score the corpus,
    then ``cal_metrics``.  The scoring metrics come back under ``s_`` keys
    beside the ``cal_metrics`` dict.  Runs on ``device`` (the card unless
    the caller asks for the CPU)."""
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
    eval_metrics = predictor.predict_file(reader, test_file, out_results, inflight=inflight)
    final = cal_metrics(out_results, thres=thres, out_file=out_metrics)
    final.update({f"s_{k}": v for k, v in eval_metrics.items()})
    return final

"""Single-model inference, MemVul-m and TextCNN (the JAX package's
``evaluate/predict_single.py``).

Stream the corpus in batches (length buckets, at a constant token budget
with ``tokens_per_batch``, or padded to ``max_length``), each batch one
forward and a softmax, with ``inflight`` batches launched before the
oldest is pulled to the host; write one JSON list of ``{"Issue_Url",
"label", "predict", "prob"}`` records per batch (``predict`` the argmax
label, ``prob`` the positive class's probability) and measure without a
threshold sweep (``model_measure``).

PyTorch runs eagerly, so the JAX package's AOT compile has no
counterpart: :meth:`SinglePredictor.warmup_compile` runs every stream
shape once instead, which builds the kernel library and launches the
kernels before the first batch (``aot_warmup``).
"""

from __future__ import annotations

import json
import logging
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.batching import (
    LABELS_BINARY,
    CachedEncoder,
    batches_from_instances,
    bucket_batch_sizes,
    bucketed_batches_from_instances,
    prefetch,
    validate_buckets,
)
from ..data.readers import SingleReader
from .metrics import model_measure

logger = logging.getLogger(__name__)

POS_INDEX = LABELS_BINARY["pos"]


class SinglePredictor:
    def __init__(
        self,
        model: torch.nn.Module,
        tokenizer,
        batch_size: int = 512,
        max_length: int = 512,
        buckets: Optional[Sequence[int]] = None,
        tokens_per_batch: Optional[int] = None,
        aot_warmup: bool = True,
    ) -> None:
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.batch_size = batch_size
        self.encoder = CachedEncoder(tokenizer, max_length=max_length)
        self.buckets = validate_buckets(buckets, max_length) if buckets else None
        self.bucket_sizes = (
            bucket_batch_sizes(self.buckets, tokens_per_batch, multiple_of=8)
            if self.buckets and tokens_per_batch else None
        )
        # what the last run did: batches and row slots per length, live
        # padded and real tokens, warmup seconds
        self.stats: Dict = {}
        if aot_warmup:
            t0 = time.perf_counter()
            self.warmup_compile()
            self.stats["warmup_s"] = time.perf_counter() - t0

    def stream_shapes(self) -> List[Tuple[int, int]]:
        """The closed (rows, length) set streaming produces: one per
        bucket at its row count, or (batch_size, max_length)."""
        if self.buckets is None:
            return [(self.batch_size, self.encoder.max_length)]
        sizes = self.bucket_sizes or {b: self.batch_size for b in self.buckets}
        return [(sizes[b], b) for b in self.buckets]

    @torch.no_grad()
    def _probs(self, sample: Dict[str, np.ndarray]) -> torch.Tensor:
        ids = torch.from_numpy(sample["input_ids"]).to(self.device).long()
        mask = torch.from_numpy(sample["attention_mask"]).to(self.device)
        logits = self.model({"input_ids": ids, "attention_mask": mask})
        return torch.softmax(logits.to(torch.float32), dim=-1)

    def warmup_compile(self) -> int:
        """Run every stream shape once; returns the number of shapes."""
        self.model.eval()
        shapes = self.stream_shapes()
        for rows, length in shapes:
            self._probs({"input_ids": np.zeros((rows, length), np.int32),
                         "attention_mask": np.ones((rows, length), np.int32)}).cpu()
        return len(shapes)

    def predict_file(
        self,
        reader,
        test_path: Union[str, Path],
        out_path: Union[str, Path],
        split: Optional[str] = None,
        inflight: int = 2,
    ) -> Dict[str, float]:
        """Score a corpus file, write the result lines, return the
        measure with ``num_samples`` and ``elapsed_s``."""
        self.model.eval()
        instances = reader.read(str(test_path), split=split)
        if self.buckets is not None:
            batches = bucketed_batches_from_instances(
                instances, self.encoder, batch_size=self.bucket_sizes or self.batch_size,
                label_map=LABELS_BINARY, buckets=self.buckets,
            )
        else:
            batches = batches_from_instances(
                instances, self.encoder, batch_size=self.batch_size, label_map=LABELS_BINARY,
            )
        labels: List[int] = []
        preds: List[int] = []
        scores: List[float] = []
        counts: Dict[int, int] = {}
        slots: Dict[int, int] = {}
        live = {"padded_tokens": 0, "real_tokens": 0}
        pending: deque = deque()
        start = time.perf_counter()

        def drain(f) -> None:
            probs, batch = pending.popleft()
            probs = probs.cpu().numpy()  # the one host sync of this batch
            metas = batch["meta"]
            records = []
            for row, meta in zip(probs[: len(metas)], metas):
                p_pos = float(row[POS_INDEX])
                positive = int(np.argmax(row)) == POS_INDEX
                records.append({
                    "Issue_Url": meta.get("Issue_Url"),
                    "label": meta.get("label"),
                    "predict": "pos" if positive else "neg",
                    "prob": p_pos,
                })
                labels.append(0 if meta.get("label") == "neg" else 1)
                preds.append(1 if positive else 0)
                scores.append(p_pos)
            f.write(json.dumps(records) + "\n")

        with open(out_path, "w") as f:
            for batch in prefetch(batches):
                rows, length = batch["sample1"]["input_ids"].shape
                mask = batch["sample1"]["attention_mask"][: len(batch["meta"])]
                counts[length] = counts.get(length, 0) + 1
                slots[length] = slots.get(length, 0) + rows
                live["padded_tokens"] += int(mask.size)
                live["real_tokens"] += int(mask.sum())
                pending.append((self._probs(batch["sample1"]), batch))
                if len(pending) > inflight:
                    drain(f)
            while pending:
                drain(f)
        elapsed = time.perf_counter() - start
        n = len(labels)
        logger.info("scored %d reports in %.1fs (%.0f reports/s)", n, elapsed, n / max(elapsed, 1e-9))
        self.stats.update(bucket_batches=counts, bucket_row_slots=slots, batches=sum(counts.values()),
                          stream_shapes=self.stream_shapes(), **live)
        measured = model_measure(labels, preds, scores)
        measured["num_samples"] = n
        measured["elapsed_s"] = elapsed
        return measured


def test_single(
    model: torch.nn.Module,
    tokenizer,
    test_file: Union[str, Path],
    out_results: Union[str, Path],
    out_metrics: Optional[Union[str, Path]] = None,
    reader=None,
    batch_size: int = 512,
    max_length: int = 512,
    buckets: Optional[Sequence[int]] = None,
    tokens_per_batch: Optional[int] = None,
    inflight: int = 2,
    aot_warmup: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Dict:
    """End-to-end evaluation on ``device`` (the card unless the caller
    asks for the CPU): run every stream shape once (``aot_warmup``), score
    the corpus, write the measure to ``out_metrics``.  Returns the measure
    with the predictor's stats beside it."""
    from ..build import resolve_device

    device = resolve_device(device)
    predictor = SinglePredictor(
        model.to(device), tokenizer, batch_size=batch_size, max_length=max_length,
        buckets=buckets, tokens_per_batch=tokens_per_batch, aot_warmup=aot_warmup,
    )
    measured = predictor.predict_file(reader or SingleReader(), test_file, out_results,
                                      inflight=inflight)
    if out_metrics is not None:
        Path(out_metrics).write_text(json.dumps(measured, indent=4))
    return {**measured, **predictor.stats}

"""Shadow scoring: hold a candidate bank against real traffic (the JAX
package's ``bankops/shadow.py``).

A candidate bank (a :class:`~.store.BankStore` version, or any list of
anchor instances) must prove itself on the traffic the active bank serves
before promotion (``bankops/promote.py``).  Two modes, one delta-row
format:

* **online** (:class:`ShadowScorer`) — attached to a live
  :class:`~memvul_tpu_torch.serving.service.ScoringService` or a
  :class:`~memvul_tpu_torch.serving.router.ReplicaRouter` (which fans the
  tap out to every replica).  The shadow tap fires on a batcher thread but
  only enqueues copies of every ``sample_stride``-th served request into a
  bounded queue; this module's own worker thread scores them through the
  predictor's serving impl against the candidate.  The active path is
  untouched: answers with the tap on are bitwise the answers without it; a
  candidate of new geometry is warmed when the scorer attaches, before the
  tap exists; a failing shadow worker only counts ``bank.shadow_errors``
  (the ``bank.shadow`` fault point).
* **offline** (:func:`replay_results`) — replays a recorded
  ``predict_file`` output against the candidate: the same corpus scored
  with the candidate bank and diffed row by row against the recorded
  scores.

Both write one delta row per shadow-scored request to
``shadow_deltas.jsonl`` (``bank.shadow_sampled`` equals the row count)
and return the summary the promotion gate reads: the sample count, the
decision-flip rate at the serving threshold, the mean and largest
absolute score delta, and the anchor changes.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..resilience import faults
from ..telemetry import Registry
from ..telemetry.sinks import JsonlSink
from .drift import update_drift_gauge

logger = logging.getLogger(__name__)

SHADOW_DELTAS_NAME = "shadow_deltas.jsonl"


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """Shadow knobs (the JAX package's defaults)."""

    sample_stride: int = 1     # shadow-score every Nth served request
    max_queue: int = 512       # bounded sample queue; overflow drops and counts
    threshold: float = 0.5     # serving decision threshold (flip detection)
    drift_every: int = 50      # update the drift gauge every N samples

    @classmethod
    def from_bankops(cls, bank_cfg: Dict[str, Any]) -> "ShadowConfig":
        """The ``bankops`` section's ``shadow_sample_stride``,
        ``shadow_max_queue`` and ``shadow_threshold``."""
        return cls(sample_stride=int(bank_cfg["shadow_sample_stride"]),
                   max_queue=int(bank_cfg["shadow_max_queue"]),
                   threshold=float(bank_cfg["shadow_threshold"]))


def score_texts(predictor, texts: Sequence[str], bank_array, n_anchors: int) -> np.ndarray:
    """``texts`` against an explicit bank through the predictor's serving
    impl (bucket blocks on a bucketed predictor, ``[1, token_budget]``
    packs through K3 on a ragged one; :meth:`SiamesePredictor.score_texts`
    routes), so a shadow score is what the candidate bank would have
    served.  Returns ``[len(texts), n_anchors]`` probabilities.  Callers
    warm a new-geometry bank with ``warmup_bank_shapes`` first."""
    if not texts:
        return np.zeros((0, n_anchors), np.float32)
    return predictor.score_texts(texts, bank_array, n_anchors)


def _delta_row(index: int, active_score: float, active_anchor: Optional[str], active_version: Any,
               shadow_row: np.ndarray, labels: Sequence[str], candidate_version: Any,
               threshold: float) -> Dict[str, Any]:
    best = int(np.argmax(shadow_row))
    shadow_score = float(shadow_row[best])
    return {
        "i": index,
        "active_version": active_version,
        "candidate_version": candidate_version,
        "active_score": float(active_score),
        "shadow_score": shadow_score,
        "delta": shadow_score - float(active_score),
        "active_anchor": active_anchor,
        "shadow_anchor": labels[best],
        "flip": (float(active_score) >= threshold) != (shadow_score >= threshold),
    }


class _DeltaStats:
    """The running aggregate of emitted delta rows (what the gate reads)."""

    def __init__(self) -> None:
        self.sampled = 0
        self.flips = 0
        self.anchor_changes = 0
        self.abs_delta_sum = 0.0
        self.abs_delta_max = 0.0

    def update(self, row: Dict[str, Any]) -> None:
        self.sampled += 1
        self.flips += int(row["flip"])
        self.anchor_changes += int(row["active_anchor"] != row["shadow_anchor"])
        a = abs(row["delta"])
        self.abs_delta_sum += a
        self.abs_delta_max = max(self.abs_delta_max, a)

    def summary(self) -> Dict[str, Any]:
        n = self.sampled
        return {
            "sampled": n,
            "flips": self.flips,
            "flip_rate": self.flips / n if n else 0.0,
            "anchor_changes": self.anchor_changes,
            "mean_abs_delta": self.abs_delta_sum / n if n else 0.0,
            "max_abs_delta": self.abs_delta_max,
        }


class ShadowScorer:
    """Online shadow: score sampled served requests against a candidate
    bank, off the active path.  ``target`` is a ``ScoringService`` or a
    ``ReplicaRouter``; the candidate is encoded, and warmed if its geometry
    differs from the active bank's, before the tap is installed.
    ``config`` defaults to the target's ``shadow_config`` (what
    ``build.serve_from_archive`` reads from the ``bankops`` section), else
    :class:`ShadowConfig`'s defaults; ``registry`` to the target's."""

    def __init__(
        self,
        target,
        candidate_instances: Iterable[Dict],
        out_dir: Optional[Union[str, Path]] = None,
        config: Optional[ShadowConfig] = None,
        registry: Optional[Registry] = None,
        candidate_version: Optional[str] = None,
        baseline: Optional[Dict[str, float]] = None,
    ) -> None:
        self.config = config or getattr(target, "shadow_config", None) or ShadowConfig()
        if self.config.sample_stride < 1:
            raise ValueError("sample_stride must be >= 1")
        self._tel = registry if registry is not None else target.registry
        self._target = target
        self._baseline = baseline
        # a fleet's replicas share one model: the first one's predictor
        # scores the shadow (on its own stream on the card)
        service = target.replicas[0].service if hasattr(target, "replicas") else target
        self.predictor = service.predictor
        self.candidate_version = candidate_version
        bank, labels, n_anchors = self.predictor.encode_bank(list(candidate_instances))
        if tuple(bank.shape) != tuple(service.bank_snapshot().array.shape):
            # a new geometry: run its shapes now, before the tap exists, so
            # the batcher never pays a first launch on our account
            self.predictor.warmup_bank_shapes(bank)
        self._bank = bank
        self._labels: Tuple[str, ...] = tuple(labels)
        self._n_anchors = n_anchors
        self._sink = JsonlSink(Path(out_dir) / SHADOW_DELTAS_NAME) if out_dir is not None else None
        self._stats = _DeltaStats()
        self._queue: "collections.deque" = collections.deque()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._seen = 0  # served requests the tap has seen (stride sampling)
        self._thread = threading.Thread(target=self._worker, name="memvul-bank-shadow",
                                        daemon=True)
        self._thread.start()
        target.set_shadow_tap(self._tap)

    # -- tap (batcher thread: enqueue only, never score) -----------------------

    def _tap(self, texts: List[str], probs: np.ndarray, bank) -> None:
        # behind a router N batcher threads call this: the counter and the
        # queue are guarded together
        stride = self.config.sample_stride
        with self._cond:
            appended = False
            for text, row in zip(texts, probs):
                self._seen += 1
                if (self._seen - 1) % stride:
                    continue
                if len(self._queue) >= self.config.max_queue:
                    self._tel.counter("bank.shadow_dropped").inc()
                    continue
                best = int(np.argmax(row))
                self._queue.append((text, float(row[best]), bank.labels[best], bank.version))
                appended = True
            if appended:
                self._cond.notify()

    # -- worker (shadow thread: scoring and delta rows) ------------------------

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop.is_set():
                    self._cond.wait(0.05)
                if not self._queue and self._stop.is_set():
                    return
                batch = []
                while self._queue and len(batch) < 64:
                    batch.append(self._queue.popleft())
            try:
                # chaos hook: a failing shadow scorer surfaces only here
                faults.fault_point("bank.shadow")
                rows = score_texts(self.predictor, [text for text, _, _, _ in batch], self._bank,
                                   self._n_anchors)
            except Exception as e:
                self._tel.counter("bank.shadow_errors").inc(len(batch))
                logger.warning("shadow scoring failed for %d sample(s) (active path "
                               "unaffected): %s", len(batch), str(e)[:200])
                continue
            for (_, a_score, a_anchor, a_version), row in zip(batch, rows):
                record = _delta_row(self._stats.sampled, a_score, a_anchor, a_version, row,
                                    self._labels, self.candidate_version, self.config.threshold)
                self._stats.update(record)
                self._tel.counter("bank.shadow_sampled").inc()
                if record["flip"]:
                    self._tel.counter("bank.shadow_flips").inc()
                self._tel.histogram("bank.shadow_abs_delta").observe(abs(record["delta"]))
                if self._sink is not None:
                    self._sink.emit(record)
            if (self._baseline and self._stats.sampled
                    and self._stats.sampled % max(1, self.config.drift_every) == 0):
                update_drift_gauge(self._tel, self._baseline)

    # -- lifecycle -------------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        out = self._stats.summary()
        out.update(
            candidate_version=self.candidate_version,
            dropped=self._tel.counter("bank.shadow_dropped").value,
            errors=self._tel.counter("bank.shadow_errors").value,
        )
        return out

    def stop(self, timeout: float = 10.0) -> Dict[str, Any]:
        """Detach the tap, drain the sample queue, stop the worker and close
        the delta sink.  Returns the final summary."""
        self._target.clear_shadow_tap()
        self._stop.set()
        with self._cond:
            self._cond.notify()
        self._thread.join(timeout)
        if self._sink is not None:
            self._sink.close()
        summary = self.summary()
        self._tel.event("shadow_stop", **{k: v for k, v in summary.items()
                                          if not isinstance(v, dict)})
        return summary


def replay_results(
    predictor,
    candidate_instances: Iterable[Dict],
    reader,
    corpus_path: Union[str, Path],
    results_path: Union[str, Path],
    out_dir: Optional[Union[str, Path]] = None,
    split: Optional[str] = None,
    threshold: float = 0.5,
    candidate_version: Optional[str] = None,
    batch: int = 64,
    registry: Optional[Registry] = None,
) -> Dict[str, Any]:
    """Offline shadow: diff a candidate bank against a recorded
    ``predict_file`` run.  Streams ``corpus_path`` through ``reader``,
    scores every report against the candidate and joins it with its
    recorded score in ``results_path`` — by ``Issue_Url`` when every
    recorded row carries one (a bucketed run writes rows in bucket order),
    else by position (repeated urls take their records in recorded order).
    Writes the same ``shadow_deltas.jsonl`` rows as the online scorer and
    returns the same summary."""
    tel = registry if registry is not None else Registry()
    recorded: List[Dict[str, Any]] = []
    for line in Path(results_path).read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if line:
            recorded.extend(json.loads(line))
    by_url: Optional[Dict[Any, List[Dict[str, Any]]]] = None
    if recorded and all(rec.get("Issue_Url") for rec in recorded):
        by_url = {}
        for rec in recorded:
            by_url.setdefault(rec["Issue_Url"], []).append(rec)
    bank, labels, n_anchors = predictor.encode_bank(list(candidate_instances))
    predictor.warmup_bank_shapes(bank)
    sink = JsonlSink(Path(out_dir) / SHADOW_DELTAS_NAME) if out_dir is not None else None
    stats = _DeltaStats()
    skew = 0
    pending: List[Tuple[int, str, Dict[str, Any]]] = []

    def flush() -> None:
        rows = score_texts(predictor, [t for _, t, _ in pending], bank, n_anchors)
        for (index, _, rec), row in zip(pending, rows):
            preds = rec.get("predict") or {}
            active_score = max(preds.values()) if preds else 0.0
            active_anchor = max(preds, key=preds.get) if preds else None
            record = _delta_row(index, active_score, active_anchor, "recorded", row, labels,
                                candidate_version, threshold)
            stats.update(record)
            tel.counter("bank.shadow_sampled").inc()
            if record["flip"]:
                tel.counter("bank.shadow_flips").inc()
            if sink is not None:
                sink.emit(record)
        pending.clear()

    try:
        for i, inst in enumerate(reader.read(str(corpus_path), split=split)):
            if by_url is not None:
                queue = by_url.get((inst.get("meta") or {}).get("Issue_Url"))
                if not queue:
                    skew += 1
                    continue
                rec = queue.pop(0)
            elif i < len(recorded):
                rec = recorded[i]
            else:
                skew += 1
                continue
            pending.append((i, inst["text1"], rec))
            if len(pending) >= batch:
                flush()
        if pending:
            flush()
    finally:
        if sink is not None:
            sink.close()
    summary = stats.summary()
    summary.update(candidate_version=candidate_version, recorded_rows=len(recorded),
                   corpus_rows_unmatched=skew, mode="replay")
    if skew:
        logger.warning("replay: the corpus has %d row(s) the recorded results lack: the run "
                       "replayed was cut short or the corpus changed", skew)
    return summary

"""Counters, gauges and histograms (the part of the JAX package's
``telemetry/registry.py`` that the serving path and the corpus pass book).

Each :class:`~memvul_tpu_torch.serving.service.ScoringService` owns one
:class:`Registry`; it books the JAX package's names (``serve.requests``,
``serve.served``, ``serve.tokens_real`` / ``serve.tokens_padded``,
``serve.latency_s``, ``serve.cascade_rescored`` …).  Each
:class:`~memvul_tpu_torch.evaluate.predict_memory.SiamesePredictor` owns
another for its corpus passes (``score.rows``, ``score.batches``,
``score.journal_commit_lag_s``, ``journal.rows_committed``,
``score.dead_letters``, ``resilience.retries``).  Sinks (``events.jsonl``, ``HEARTBEAT.json``), spans,
the time-series store and the roofline gauges wait for the ops-plane slice
(ROADMAP.md).
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, List, Optional


class Counter:
    """Monotonic event count (thread-safe)."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Streaming count/sum/min/max and a bounded reservoir sample for
    percentiles."""

    def __init__(self, cap: int = 4096) -> None:
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._sample: List[float] = []
        self._cap = cap
        self._rng = random.Random(0x5EED)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            if len(self._sample) < self._cap:
                self._sample.append(value)
            else:
                j = self._rng.randrange(self.count)  # keep each with p = cap / n
                if j < self._cap:
                    self._sample[j] = value

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            ordered = sorted(self._sample)
        if not ordered:
            return None
        return ordered[int(round((len(ordered) - 1) * q / 100.0))]

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {}
        out = {"count": float(self.count), "total": self.total,
               "mean": self.total / self.count, "min": self.min, "max": self.max}
        for q in (50, 95, 99):
            out[f"p{q}"] = self.percentile(q)
        return out


class Registry:
    """Named counters, gauges and histograms, created on first use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table: Dict[str, Any], name: str, kind):
        with self._lock:
            item = table.get(name)
            if item is None:
                item = table[name] = kind()
            return item

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items()) if g.value is not None},
            "histograms": {k: h.summary() for k, h in sorted(histograms.items())},
        }

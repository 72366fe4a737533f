"""Counters, gauges and histograms (the part of the JAX package's
``telemetry/registry.py`` that the serving path and the corpus pass book).

Each :class:`~memvul_tpu_torch.serving.service.ScoringService` owns one
:class:`Registry`; it books the JAX package's names (``serve.requests``,
``serve.served``, ``serve.tokens_real`` / ``serve.tokens_padded``,
``serve.latency_s``, ``serve.cascade_rescored`` …).  Each
:class:`~memvul_tpu_torch.evaluate.predict_memory.SiamesePredictor` owns
another for its corpus passes (``score.rows``, ``score.batches``,
``score.journal_commit_lag_s``, ``journal.rows_committed``,
``score.dead_letters``, ``resilience.retries``).

A registry given a ``run_dir`` also writes that run's sinks
(:mod:`.sinks`): :meth:`Registry.event` appends to ``events.jsonl``,
:meth:`Registry.heartbeat` rewrites ``HEARTBEAT.json`` and
:meth:`Registry.close` rolls the snapshot up into ``telemetry.json``.  The
sharded corpus scorer's coordinator and each of its workers keep one.

The serving plane's fleet adds the process-wide registry
(:func:`get_registry`, :func:`configure`, :func:`reset`: the router's
``router.*`` counters and the SLO monitor's ``slo.*`` gauges live there,
each replica keeps a registry of its own), the liveness clock
(:meth:`Registry.progress`, :meth:`Registry.heartbeat_age_s`, which the
replica health check reads) and timed spans (:meth:`Registry.span`).
Unlike the JAX package's, the default process-wide registry counts in
memory (no sinks) instead of discarding, so ``router.*`` is readable
without a :func:`configure`.

The ops plane: the program registry and its ``program.*`` rows
(:mod:`.programs`), the metrics history (:mod:`.timeseries`), the alert
rules (:mod:`.alerts`) and the live exposition server of a run
(:mod:`.live`, ``telemetry.metrics_port``).
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Union

from .sinks import HeartbeatFile, JsonlSink, SummaryFile


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
    """Named counters, gauges and histograms, created on first use; with a
    ``run_dir``, also the run's event stream, heartbeat and summary files
    (without one those calls do nothing)."""

    def __init__(
        self,
        run_dir: Optional[Union[str, Path]] = None,
        heartbeat_every_s: float = 30.0,
        events: bool = True,
    ) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self.run_dir = Path(run_dir) if run_dir is not None else None
        self.heartbeat_every_s = float(heartbeat_every_s)
        self.started_monotonic = time.monotonic()
        self.started_wall = time.time()
        self.last_progress_monotonic = self.started_monotonic
        self.last_progress_wall = self.started_wall
        self._last_heartbeat = float("-inf")
        self._closed = False
        self._events: Optional[JsonlSink] = None
        self._heartbeat_file: Optional[HeartbeatFile] = None
        self._summary_file: Optional[SummaryFile] = None
        if self.run_dir is not None:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            if events:
                self._events = JsonlSink(self.run_dir / "events.jsonl")
            self._heartbeat_file = HeartbeatFile(self.run_dir / "HEARTBEAT.json")
            self._summary_file = SummaryFile(self.run_dir / "telemetry.json")
            self.event("run_start", pid=os.getpid())

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

    # -- run sinks (no-ops without a run_dir) --------------------------------

    def event(self, kind: str, **fields: Any) -> None:
        """Append one record to ``events.jsonl``."""
        if self._events is None or self._closed:
            return
        record: Dict[str, Any] = {
            "t": round(time.time(), 3),
            "mono": round(time.monotonic() - self.started_monotonic, 6),
            "kind": kind,
        }
        record.update(fields)
        self._events.emit(record)

    def progress(self) -> None:
        """Mark forward progress (two clock reads, no sink): what
        :meth:`heartbeat_age_s` measures from."""
        self.last_progress_monotonic = time.monotonic()
        self.last_progress_wall = time.time()

    def heartbeat_age_s(self) -> float:
        """Seconds since the last recorded progress."""
        return time.monotonic() - self.last_progress_monotonic

    @contextlib.contextmanager
    def span(self, name: str, **fields: Any) -> Iterator[None]:
        """A timed scope: ``span.<name>`` timing stats and a ``span`` event."""
        self.progress()
        start = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - start
            self.histogram(f"span.{name}").observe(dur)
            self.event("span", name=name, dur_s=round(dur, 6), **fields)
            self.heartbeat()

    def heartbeat(self, force: bool = False, **extra: Any) -> None:
        """Rewrite ``HEARTBEAT.json`` (at most every ``heartbeat_every_s``
        unless ``force``) with the wall time, the counters and ``extra``.
        Callers call it at progress milestones, so it also marks progress."""
        self.progress()
        if self._heartbeat_file is None or self._closed:
            return
        now = time.monotonic()
        if not force and now - self._last_heartbeat < self.heartbeat_every_s:
            return
        self._last_heartbeat = now
        payload: Dict[str, Any] = {
            "pid": os.getpid(),
            "written_wall": time.time(),
            "uptime_s": round(now - self.started_monotonic, 3),
            "last_progress_wall": self.last_progress_wall,
            "counters": self.snapshot()["counters"],
        }
        payload.update(extra)
        self._heartbeat_file.write(payload)

    def write_summary(self, **extra: Any) -> None:
        """Roll the snapshot up into ``telemetry.json``."""
        if self._summary_file is None:
            return
        payload: Dict[str, Any] = {
            "run_dir": str(self.run_dir),
            "started_wall": self.started_wall,
            "written_wall": time.time(),
            "uptime_s": round(time.monotonic() - self.started_monotonic, 3),
        }
        payload.update(self.snapshot())
        payload.update(extra)
        self._summary_file.write(payload)

    def close(self) -> None:
        """The ``run_end`` event, a last heartbeat and the summary.
        Idempotent; the sinks stay quiet afterwards (the counters stay
        readable)."""
        if self._closed:
            return
        self.event("run_end")
        self.heartbeat(force=True)
        self.write_summary()
        self._closed = True
        if self._events is not None:
            self._events.close()


# -- the process-wide registry -------------------------------------------------

_default = Registry()
_current: Registry = _default


def get_registry() -> Registry:
    """The process-wide registry: the router's ``router.*`` counters, the
    SLO monitor's ``slo.*`` gauges, a tenant manager's and a shadow
    scorer's on a fleet.  Until :func:`configure` runs it is an in-memory
    registry without sinks."""
    return _current


def configure(
    run_dir: Optional[Union[str, Path]] = None,
    *,
    events: bool = True,
    heartbeat_every_s: float = 30.0,
) -> Registry:
    """Install a fresh process-wide registry (closing a configured one
    before it) and return it; with ``run_dir`` it writes that run's sinks."""
    global _current
    if _current is not _default:
        _current.close()
    _current = Registry(run_dir=run_dir, heartbeat_every_s=heartbeat_every_s, events=events)
    return _current


def reset() -> None:
    """Close a configured registry and install a fresh in-memory default
    (tests: a clean slate of counters)."""
    global _current, _default
    if _current is not _default:
        _current.close()
    _default = _current = Registry()


from .programs import ProgramRegistry, get_program_registry, write_programs  # noqa: E402,F401
from .timeseries import MetricsSampler, TimeSeriesStore  # noqa: E402,F401
from .alerts import AlertEngine, AlertRule, default_rules  # noqa: E402,F401
from .live import start_metrics_server  # noqa: E402,F401

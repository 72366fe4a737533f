"""The bounded in-process metrics history (the JAX package's
``telemetry/timeseries.py``, same semantics: the same parts observed at
the same fake clock give the same history).

* :class:`TimeSeriesStore` keeps one ring of ``(wall_ts, value)`` points
  per ``(labels, metric)``.  Gauges are stored as they are; counters as
  per-second rates under ``<name>.rate``; histogram summaries as their
  ``mean``, ``p50`` and ``p95`` series.  ``resolution_s`` coalesces points
  closer than one bucket and ``retention_s`` bounds each ring.
* :class:`MetricsSampler` is a daemon thread that samples one target at a
  fixed cadence into one store: a serving target's ``metrics_snapshots()``
  (the router's per-``replica`` parts and the balancer's per-``host``
  parts are labelled as a ``/metrics`` scrape labels them), a callable
  returning parts (``telemetry.live.live_parts``) or a bare registry.

Served as ``GET /metricsz?window=&metric=`` by the serving front end and
the live exposition server, read by the alert rules (``alerts.py``) and
dumped into incident bundles (``serving/incident.py``).  Nothing here is
built while ``telemetry.tsdb_cadence_s`` is 0; a running sampler books its
own cost (``tsdb.samples``, ``tsdb.sample_errors``, ``tsdb.series``,
``tsdb.sample_s``).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from . import get_registry

logger = logging.getLogger(__name__)

# (sorted (key, value) label pairs, metric name) — one ring per pair
_SeriesKey = Tuple[Tuple[Tuple[str, str], ...], str]

DEFAULT_RESOLUTION_S = 1.0
DEFAULT_RETENTION_S = 600.0


def series_name(metric: str, label_key: Tuple[Tuple[str, str], ...]) -> str:
    """The flat Prometheus-style name a labeled series renders under in
    ``/metricsz`` JSON, e.g. ``serve.requests.rate{replica="replica-0"}``."""
    if not label_key:
        return metric
    inner = ",".join(f'{k}="{v}"' for k, v in label_key)
    return f"{metric}{{{inner}}}"


class TimeSeriesStore:
    """Thread-safe bounded rings of metric history.

    ``observe(parts)`` ingests one multi-part snapshot (the
    ``SnapshotPart`` shape ``telemetry.exposition`` renders); readers
    (``history``/``window``/``stats``) only copy under the lock, so any
    handler thread may read."""

    def __init__(
        self,
        resolution_s: float = DEFAULT_RESOLUTION_S,
        retention_s: float = DEFAULT_RETENTION_S,
    ) -> None:
        resolution_s = float(resolution_s)
        retention_s = float(retention_s)
        if resolution_s <= 0:
            raise ValueError(
                f"tsdb resolution_s must be > 0, got {resolution_s!r}"
            )
        if retention_s < resolution_s:
            raise ValueError(
                "tsdb retention_s must be >= resolution_s, got "
                f"{retention_s!r} < {resolution_s!r}"
            )
        self.resolution_s = resolution_s
        self.retention_s = retention_s
        self._maxlen = max(2, int(round(retention_s / resolution_s)))
        self._lock = threading.Lock()
        self._series: Dict[_SeriesKey, "collections.deque"] = {}
        # last raw counter totals, for the rate derivation
        self._prev_counters: Dict[_SeriesKey, Tuple[float, float]] = {}
        self._samples = 0

    # -- ingest ----------------------------------------------------------------

    def observe(
        self,
        parts: Sequence[Tuple[Mapping[str, str], Mapping[str, Any]]],
        now: Optional[float] = None,
    ) -> None:
        """Ingest one sample: every part's counters (as rates), gauges,
        and histogram summaries, labeled like the exposition would."""
        now = time.time() if now is None else float(now)
        with self._lock:
            self._samples += 1
            for labels, snapshot in parts:
                self._observe_part(dict(labels or {}), snapshot or {}, now)

    def _observe_part(
        self, labels: Dict[str, str], snapshot: Mapping[str, Any], now: float
    ) -> None:
        label_key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        for name, value in (snapshot.get("counters") or {}).items():
            try:
                total = float(value)
            except (TypeError, ValueError):
                continue
            key = (label_key, str(name))
            prev = self._prev_counters.get(key)
            self._prev_counters[key] = (now, total)
            if prev is None or now <= prev[0]:
                continue
            rate = max(0.0, total - prev[1]) / (now - prev[0])
            self._append(label_key, f"{name}.rate", now, rate)
        for name, value in (snapshot.get("gauges") or {}).items():
            try:
                self._append(label_key, str(name), now, float(value))
            except (TypeError, ValueError):
                continue
        for name, summary in (snapshot.get("histograms") or {}).items():
            if not isinstance(summary, Mapping):
                continue
            for field in ("mean", "p50", "p95"):
                value = summary.get(field)
                if value is None:
                    continue
                try:
                    self._append(
                        label_key, f"{name}.{field}", now, float(value)
                    )
                except (TypeError, ValueError):
                    continue

    def _append(
        self,
        label_key: Tuple[Tuple[str, str], ...],
        metric: str,
        now: float,
        value: float,
    ) -> None:
        key = (label_key, metric)
        ring = self._series.get(key)
        if ring is None:
            ring = self._series[key] = collections.deque(maxlen=self._maxlen)
        if ring and now - ring[-1][0] < self.resolution_s:
            # within one resolution bucket: keep the newest reading at
            # the bucket's original timestamp (rings stay retention-bounded)
            ring[-1] = (ring[-1][0], value)
        else:
            ring.append((now, value))

    # -- read surfaces ---------------------------------------------------------

    def history(
        self,
        window_s: Optional[float] = None,
        metric: Optional[str] = None,
        now: Optional[float] = None,
    ) -> Dict[str, List[List[float]]]:
        """``{series_name: [[ts, value], ...]}`` — the ``/metricsz``
        body.  ``window_s`` keeps only points newer than ``now -
        window_s``; ``metric`` filters by exact name or prefix (so
        ``?metric=serve.`` selects the whole family)."""
        now = time.time() if now is None else float(now)
        cutoff = None if window_s is None else now - float(window_s)
        out: Dict[str, List[List[float]]] = {}
        with self._lock:
            items = sorted(self._series.items(), key=lambda kv: (kv[0][1], kv[0][0]))
            for (label_key, name), ring in items:
                if metric and not (name == metric or name.startswith(metric)):
                    continue
                points = [
                    [ts, value]
                    for ts, value in ring
                    if cutoff is None or ts >= cutoff
                ]
                if points:
                    out[series_name(name, label_key)] = points
        return out

    def window(
        self,
        metrics: Sequence[str],
        window_s: float,
        now: Optional[float] = None,
    ) -> Dict[str, List[List[float]]]:
        """The justification slice an autoscaler decision carries: the
        named metrics' recent points (all label sets), compact."""
        now = time.time() if now is None else float(now)
        cutoff = now - float(window_s)
        wanted = set(metrics)
        out: Dict[str, List[List[float]]] = {}
        with self._lock:
            for (label_key, name), ring in self._series.items():
                if name not in wanted:
                    continue
                points = [[ts, value] for ts, value in ring if ts >= cutoff]
                if points:
                    out[series_name(name, label_key)] = points
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "series": len(self._series),
                "samples": self._samples,
                "resolution_s": self.resolution_s,
                "retention_s": self.retention_s,
            }

    @property
    def series_count(self) -> int:
        with self._lock:
            return len(self._series)


class MetricsSampler:
    """Daemon-thread sampler: one target, one store, one cadence.

    ``target`` is sampled via its ``metrics_snapshots()`` when it has
    one (service, router, balancer: per-member labels come free), a
    parts-returning callable (``telemetry.live.live_parts``), or a bare
    registry's ``snapshot()``.  ``start=False`` skips the thread so
    tests drive :meth:`sample` deterministically."""

    def __init__(
        self,
        target: Any,
        store: Optional[TimeSeriesStore] = None,
        cadence_s: float = 1.0,
        registry=None,
        start: bool = True,
    ) -> None:
        cadence_s = float(cadence_s)
        if cadence_s <= 0:
            # cadence 0 means "off", and off means not constructed: the
            # wiring sites (build.serve_from_archive,
            # serving.incident.attach_flight_recorder) own that gate
            raise ValueError(
                f"sampler cadence_s must be > 0, got {cadence_s!r}"
            )
        self.target = target
        self.store = store if store is not None else TimeSeriesStore()
        self.cadence_s = cadence_s
        self._tel = registry if registry is not None else get_registry()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="memvul-tsdb-sampler", daemon=True
            )
            self._thread.start()

    # -- one sample ------------------------------------------------------------

    def _parts(self) -> Sequence[Tuple[Mapping[str, str], Mapping[str, Any]]]:
        snapshots = getattr(self.target, "metrics_snapshots", None)
        if snapshots is not None:
            return snapshots()
        if callable(self.target):  # live_parts-style provider
            return self.target()
        return [({}, self.target.snapshot())]

    def sample(self, now: Optional[float] = None) -> None:
        """Take one sample (the loop body; tests call it directly).  A
        failing target read is counted, never raised — a half-dead
        replica mid-sweep must not kill the history of its death."""
        t0 = time.perf_counter()
        try:
            parts = self._parts()
            self.store.observe(parts, now=now)
        except Exception:
            self._tel.counter("tsdb.sample_errors").inc()
            logger.exception("tsdb sample failed")
            return
        self._tel.counter("tsdb.samples").inc()
        self._tel.gauge("tsdb.series").set(self.store.series_count)
        self._tel.histogram("tsdb.sample_s").observe(time.perf_counter() - t0)

    def _loop(self) -> None:
        while not self._stop.wait(self.cadence_s):
            self.sample()

    # -- read surfaces ---------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The ``/metricsz`` envelope (history attached by the handler)."""
        return {
            "enabled": True,
            "cadence_s": self.cadence_s,
            **self.store.stats(),
        }

    def history(
        self,
        window_s: Optional[float] = None,
        metric: Optional[str] = None,
    ) -> Dict[str, List[List[float]]]:
        return self.store.history(window_s=window_s, metric=metric)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

"""The incident flight recorder (the JAX package's
``serving/incident.py``): snapshot the state around an incident, off the
request path.

When an alert fires, a host dies or is quarantined, or the autoscaler
refuses a spawn, the state that explains it (the metrics history window,
the ``/tracez`` ring, the program registry, the autoscaler's decisions)
lives in memory and dies with the process.  :class:`IncidentRecorder`
freezes it into a bounded ``<run_dir>/incidents/<ts>-<trigger>/`` bundle:

* ``manifest.json`` — trigger, detail, the alerts, the health summary, the
  autoscaler's status and its recent decisions;
* ``metrics.json`` — the metrics history around the event;
* ``traces.json`` — the request trace ring;
* ``programs.json`` — the program registry's rows.

:meth:`IncidentRecorder.trigger` is a bounded-queue put from whichever
thread saw the problem; a worker thread of its own writes the bundle.  A
full queue or a trigger inside ``min_interval_s`` of the last bundle is
dropped (``incident.suppressed``).  The ``incident.dump`` fault point
fires in the worker, so a failing dump is counted
(``incident.dump_errors``) and never reaches a request.  The newest
``max_bundles`` bundles are kept; every file is written atomically.

:func:`attach_flight_recorder` is the one gate: with ``cadence_s <= 0`` it
builds nothing.
"""

from __future__ import annotations

import json
import logging
import queue
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

from .. import telemetry
from ..telemetry.alerts import AlertEngine, AlertRule
from ..telemetry.timeseries import MetricsSampler, TimeSeriesStore

logger = logging.getLogger(__name__)

_TRIGGER_SAFE_RE = re.compile(r"[^A-Za-z0-9_-]+")

BUNDLE_FILES = ("manifest.json", "metrics.json", "traces.json", "programs.json")


def _collect(out: Dict[str, Any], key: str, fn) -> None:
    # a half-dead target mid-incident must still yield a bundle: every
    # section degrades to an error string instead of aborting the dump
    try:
        out[key] = fn()
    except Exception as exc:
        out[key] = {"error": f"{type(exc).__name__}: {exc}"}


class IncidentRecorder:
    """Bounded, rate-limited, off-path bundle dumper.

    ``target`` is the serving object (service / router / balancer) the
    bundle snapshots; ``store``/``engine``/``autoscaler`` enrich the
    bundle when present.  ``start=False`` skips the worker thread so
    tests drive :meth:`drain` deterministically."""

    def __init__(
        self,
        target: Any,
        run_dir: Union[str, Path],
        store: Optional[TimeSeriesStore] = None,
        engine: Optional[AlertEngine] = None,
        autoscaler: Any = None,
        registry=None,
        min_interval_s: float = 30.0,
        max_bundles: int = 8,
        window_s: float = 120.0,
        queue_size: int = 8,
        start: bool = True,
    ) -> None:
        if max_bundles < 1:
            raise ValueError(f"max_bundles must be >= 1, got {max_bundles!r}")
        self.target = target
        self.incidents_dir = Path(run_dir) / "incidents"
        self.store = store
        self.engine = engine
        self.autoscaler = autoscaler
        self.min_interval_s = float(min_interval_s)
        self.max_bundles = int(max_bundles)
        self.window_s = float(window_s)
        self._tel = registry if registry is not None else telemetry.get_registry()
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, int(queue_size)))
        self._lock = threading.Lock()
        self._last_dump_wall: Optional[float] = None
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="memvul-incident-recorder", daemon=True
            )
            self._thread.start()

    # -- trigger side (hot path) -----------------------------------------------

    def trigger(self, kind: str, detail: Optional[Dict[str, Any]] = None) -> bool:
        """Request a bundle.  Never blocks, never raises: a full queue
        increments ``incident.suppressed`` and returns False."""
        try:
            self._queue.put_nowait((str(kind), dict(detail or {}), time.time()))
            return True
        except queue.Full:
            self._tel.counter("incident.suppressed").inc()
            return False

    def on_alert(self, record: Dict[str, Any]) -> None:
        """AlertEngine listener adapter: an alert FIRE edge is a trigger."""
        self.trigger(f"alert-{record.get('rule', 'unknown')}", record)

    # -- worker side -----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            self._handle(*item)

    def drain(self) -> int:
        """Process every queued trigger synchronously (tests; shutdown)."""
        handled = 0
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return handled
            self._handle(*item)
            handled += 1

    def _handle(self, kind: str, detail: Dict[str, Any], wall: float) -> None:
        with self._lock:
            last = self._last_dump_wall
            if last is not None and wall - last < self.min_interval_s:
                self._tel.counter("incident.suppressed").inc()
                return
            self._last_dump_wall = wall
        try:
            from ..resilience import faults

            faults.fault_point("incident.dump")
            bundle = self._dump(kind, detail, wall)
        except Exception:
            self._tel.counter("incident.dump_errors").inc()
            logger.exception("incident dump failed (trigger=%s)", kind)
            return
        self._tel.counter("incident.dumps").inc()
        self._tel.event("incident", trigger=kind, bundle=bundle.name)
        logger.warning("incident bundle written: %s (trigger=%s)", bundle, kind)

    def _dump(self, kind: str, detail: Dict[str, Any], wall: float) -> Path:
        from ..resilience.io import atomic_write_text

        safe = _TRIGGER_SAFE_RE.sub("-", kind).strip("-") or "incident"
        with self._lock:
            self._seq += 1
            seq = self._seq
        bundle = self.incidents_dir / f"{int(wall)}-{safe}"
        if bundle.exists():
            bundle = self.incidents_dir / f"{int(wall)}-{safe}.{seq}"
        bundle.mkdir(parents=True, exist_ok=True)

        manifest: Dict[str, Any] = {
            "schema": 1,
            "trigger": kind,
            "detail": detail,
            "wall": wall,
            "window_s": self.window_s,
        }
        if self.engine is not None:
            _collect(manifest, "alerts", self.engine.status)
        health = getattr(self.target, "health_summary", None)
        if health is not None:
            _collect(manifest, "health", health)
        if self.autoscaler is not None:
            _collect(manifest, "autoscaler", self.autoscaler.status)
            _collect(
                manifest,
                "autoscaler_decisions",
                lambda: list(self.autoscaler.history)[-16:],
            )
        atomic_write_text(
            bundle / "manifest.json",
            json.dumps(manifest, indent=2, sort_keys=True, default=str),
        )

        metrics: Dict[str, Any] = {}
        if self.store is not None:
            _collect(metrics, "history", lambda: self.store.history(self.window_s))
            _collect(metrics, "stats", self.store.stats)
        atomic_write_text(
            bundle / "metrics.json",
            json.dumps(metrics, sort_keys=True, default=str),
        )

        traces: Any = []
        recent = getattr(self.target, "recent_traces", None)
        if recent is not None:
            holder: Dict[str, Any] = {}
            _collect(holder, "traces", recent)
            traces = holder["traces"]
        atomic_write_text(
            bundle / "traces.json", json.dumps(traces, default=str)
        )

        programs: Any = []
        progs = getattr(self.target, "programs_snapshot", None)
        if progs is not None:
            holder = {}
            _collect(holder, "programs", progs)
            programs = holder["programs"]
        atomic_write_text(
            bundle / "programs.json", json.dumps(programs, default=str)
        )

        self._prune()
        return bundle

    def _prune(self) -> None:
        try:
            bundles = sorted(
                (p for p in self.incidents_dir.iterdir() if p.is_dir()),
                key=lambda p: p.name,
            )
        except OSError:
            return
        for stale in bundles[: max(0, len(bundles) - self.max_bundles)]:
            shutil.rmtree(stale, ignore_errors=True)

    # -- read surface ----------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        bundles = []
        if self.incidents_dir.is_dir():
            bundles = sorted(
                p.name for p in self.incidents_dir.iterdir() if p.is_dir()
            )
        return {
            "enabled": True,
            "dir": str(self.incidents_dir),
            "min_interval_s": self.min_interval_s,
            "max_bundles": self.max_bundles,
            "window_s": self.window_s,
            "bundles": bundles,
        }

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)


def attach_flight_recorder(
    target: Any,
    run_dir: Optional[Union[str, Path]] = None,
    registry=None,
    cadence_s: float = 0.0,
    resolution_s: float = 1.0,
    retention_s: float = 600.0,
    alert_interval_s: float = 5.0,
    min_interval_s: float = 30.0,
    max_bundles: int = 8,
    window_s: float = 120.0,
    rules: Optional[Sequence[AlertRule]] = None,
) -> Any:
    """Wire sampler + alert engine (+ recorder when ``run_dir`` is set)
    onto a serving target.  The single on/off gate for the whole
    history plane: ``cadence_s <= 0`` returns the target untouched —
    nothing constructed, nothing emitted (the ``metrics_port``
    default-off discipline).  Sets ``target.metrics_sampler``,
    ``target.alert_engine``, ``target.incident_recorder`` attributes
    the frontend, report, and shutdown paths discover via getattr."""
    if cadence_s is None or float(cadence_s) <= 0:
        return target
    registry = registry if registry is not None else telemetry.get_registry()
    store = TimeSeriesStore(resolution_s=resolution_s, retention_s=retention_s)
    sampler = MetricsSampler(
        target, store=store, cadence_s=float(cadence_s), registry=registry
    )
    engine = AlertEngine(
        store, registry=registry, rules=rules, interval_s=alert_interval_s
    )
    target.metrics_sampler = sampler
    target.alert_engine = engine
    autoscaler = getattr(target, "autoscaler", None)
    if autoscaler is not None:
        # decisions now carry the metric window that justified them
        autoscaler.metrics_store = store
    if run_dir is not None:
        recorder = IncidentRecorder(
            target,
            run_dir,
            store=store,
            engine=engine,
            autoscaler=autoscaler,
            registry=registry,
            min_interval_s=min_interval_s,
            max_bundles=max_bundles,
            window_s=window_s,
        )
        target.incident_recorder = recorder
        engine.add_listener(recorder.on_alert)
        if autoscaler is not None:
            autoscaler.incident_recorder = recorder
    return target

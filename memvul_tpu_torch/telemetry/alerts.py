"""Declarative alert rules over the in-process metrics history (the JAX
package's ``telemetry/alerts.py``: the same five rule kinds, the same six
shipped rules, the same edges on the same history).

Rules are small records evaluated over
:class:`~memvul_tpu_torch.telemetry.timeseries.TimeSeriesStore` windows by
an :class:`AlertEngine`, which tracks each rule's firing state and at each
edge emits:

* ``alert_fired`` / ``alert_resolved`` events (the rule, the observed
  value and the series that tripped it);
* ``alert.fired`` / ``alert.resolved`` counters and the ``alert.firing``
  gauge (rules firing now);
* a call to each registered listener on a fire edge: the incident flight
  recorder (``serving/incident.py``) subscribes, so an alert writes a
  bundle.

Rule kinds (``AlertRule.kind``), over the trailing ``window_s``:

=============  ==============================================================
kind           fires when
=============  ==============================================================
``threshold``  the newest in-window value of any ``metric`` series is
               ``> threshold`` (gauges; e.g. ``slo.burn_rate_fast``)
``rate``       the mean of the in-window ``<metric>.rate`` samples is
               ``> threshold``
``absence``    the store's newest sample, of any series, is older than
               ``window_s`` (the sampler or the whole process stalled)
``growth``     the newest value of ``metric`` grew more than ``threshold``
               (a fraction) over the oldest in-window value (a leak)
``recompile``  any in-window ``<metric>.rate`` sample is positive
=============  ==============================================================

The shipped rules (:func:`default_rules`) watch the serve error rate,
dead-letter streaks, a stalled sampler, device-memory growth, recompiles
after warmup and the SLO fast burn.  ``recompile_after_warm`` watches
``program.recompiles``, the port's program registry
(``telemetry/programs.py``: a shape met for the first time after its scope
was warmed), where the JAX package watches ``xla.recompiles``.  The engine
is built only when ``telemetry.tsdb_cadence_s`` > 0.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import get_registry
from .timeseries import TimeSeriesStore

logger = logging.getLogger(__name__)

KIND_THRESHOLD = "threshold"
KIND_RATE = "rate"
KIND_ABSENCE = "absence"
KIND_GROWTH = "growth"
KIND_RECOMPILE = "recompile"
_KINDS = (KIND_THRESHOLD, KIND_RATE, KIND_ABSENCE, KIND_GROWTH, KIND_RECOMPILE)


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule; see the kind table in the module docstring."""

    name: str
    kind: str
    metric: str = ""
    threshold: float = 0.0
    window_s: float = 60.0
    description: str = ""

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("alert rule needs a name")
        if self.kind not in _KINDS:
            raise ValueError(
                f"alert rule {self.name!r}: unknown kind {self.kind!r} "
                f"(want one of {_KINDS})"
            )
        if self.kind != KIND_ABSENCE and not self.metric:
            raise ValueError(f"alert rule {self.name!r}: needs a metric")
        if self.window_s <= 0:
            raise ValueError(f"alert rule {self.name!r}: window_s must be > 0")

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def default_rules() -> Tuple[AlertRule, ...]:
    """The shipped rule set: the serving tier's known failure shapes."""
    return (
        AlertRule(
            "serve_error_rate", KIND_RATE, "serve.errors",
            threshold=0.0, window_s=60.0,
            description="dead-lettered batches are resolving client "
                        "requests as errors",
        ),
        AlertRule(
            "dead_letter_streak", KIND_RATE, "serve.dead_letters",
            threshold=0.0, window_s=60.0,
            description="micro-batches are dead-lettering after retries",
        ),
        AlertRule(
            "heartbeat_stalled", KIND_ABSENCE,
            window_s=30.0,
            description="no new metric samples — the sampler (or the "
                        "whole process) has stalled",
        ),
        AlertRule(
            "hbm_growth", KIND_GROWTH, "serve.hbm_in_use_bytes",
            threshold=0.2, window_s=300.0,
            description="live HBM grew >20% over the window (leak shape)",
        ),
        AlertRule(
            "recompile_after_warm", KIND_RECOMPILE, "program.recompiles",
            threshold=0.0, window_s=300.0,
            description="a warm scope met a new shape: a mid-serve "
                        "build and warm, a latency cliff",
        ),
        AlertRule(
            "slo_fast_burn", KIND_THRESHOLD, "slo.burn_rate_fast",
            threshold=1.0, window_s=60.0,
            description="fast-window error-budget burn rate over 1",
        ),
    )


class AlertEngine:
    """Evaluate rules over a store on a fixed interval; track edges.

    Reads snapshots only (``status()`` is safe from any handler thread);
    all its work is building dicts.
    ``start=False`` skips the thread so tests drive :meth:`tick`."""

    def __init__(
        self,
        store: TimeSeriesStore,
        registry=None,
        rules: Optional[Sequence[AlertRule]] = None,
        interval_s: float = 5.0,
        start: bool = True,
    ) -> None:
        self.store = store
        self.rules: Tuple[AlertRule, ...] = tuple(
            rules if rules is not None else default_rules()
        )
        names = [rule.name for rule in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names in {names}")
        self.interval_s = float(interval_s)
        self._tel = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._firing: Dict[str, Dict[str, Any]] = {}
        self._listeners: List[Callable[[Dict[str, Any]], None]] = []
        # grace anchor: before the first sample lands, "newest sample"
        # for the absence rule is the engine's own birth, not -inf
        self._started_wall = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="memvul-alert-engine", daemon=True
            )
            self._thread.start()

    # -- listeners -------------------------------------------------------------

    def add_listener(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """``fn(record)`` runs on the engine thread at each FIRE edge
        (not resolves).  Must be cheap and non-blocking — the incident
        recorder's ``trigger`` is a bounded-queue put.  A raising
        listener is swallowed and logged, never kills the engine."""
        with self._lock:
            self._listeners.append(fn)

    # -- evaluation ------------------------------------------------------------

    def _evaluate(
        self, rule: AlertRule, now: float
    ) -> Tuple[bool, Optional[float], Optional[str]]:
        """(firing, observed value, offending series name)."""
        if rule.kind == KIND_ABSENCE:
            newest = self._started_wall
            history = self.store.history(now=now)
            for points in history.values():
                newest = max(newest, points[-1][0])
            age = now - newest
            return age > rule.window_s, age, None
        metric = (
            f"{rule.metric}.rate"
            if rule.kind in (KIND_RATE, KIND_RECOMPILE)
            else rule.metric
        )
        history = self.store.history(
            window_s=rule.window_s, metric=metric, now=now
        )
        worst: Tuple[bool, Optional[float], Optional[str]] = (False, None, None)
        for name, points in history.items():
            base = name.partition("{")[0]
            if base != metric:
                continue  # prefix match pulled in a sibling series
            if rule.kind == KIND_THRESHOLD:
                value = points[-1][1]
                fired = value > rule.threshold
            elif rule.kind == KIND_RATE:
                value = sum(p[1] for p in points) / len(points)
                fired = value > rule.threshold
            elif rule.kind == KIND_RECOMPILE:
                value = max(p[1] for p in points)
                fired = value > 0.0
            else:  # KIND_GROWTH
                oldest, newest = points[0][1], points[-1][1]
                if oldest <= 0:
                    continue
                value = (newest - oldest) / oldest
                fired = value > rule.threshold
            if worst[1] is None or (value is not None and value > worst[1]):
                worst = (fired, value, name)
            if fired:
                return True, value, name
        return worst

    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation pass over every rule; returns :meth:`status`.
        Wall-clock based (the store's timestamps are wall time)."""
        now = time.time() if now is None else float(now)
        fired_records: List[Dict[str, Any]] = []
        with self._lock:
            listeners = list(self._listeners)
            for rule in self.rules:
                try:
                    firing, value, series = self._evaluate(rule, now)
                except Exception:  # pragma: no cover - a bad series must
                    logger.exception(  # not kill the engine
                        "alert rule %s evaluation failed", rule.name
                    )
                    continue
                active = self._firing.get(rule.name)
                if firing and active is None:
                    record = {
                        "rule": rule.name,
                        # "rule_kind", not "kind": the record doubles as
                        # the alert_fired event payload, and "kind" is
                        # the event stream's own discriminator
                        "rule_kind": rule.kind,
                        "metric": rule.metric,
                        "threshold": rule.threshold,
                        "window_s": rule.window_s,
                        "value": value,
                        "series": series,
                        "fired_wall": now,
                        "description": rule.description,
                    }
                    self._firing[rule.name] = record
                    fired_records.append(dict(record))
                elif firing and active is not None:
                    active["value"] = value
                    active["series"] = series
                elif not firing and active is not None:
                    resolved = self._firing.pop(rule.name)
                    self._tel.counter("alert.resolved").inc()
                    self._tel.event(
                        "alert_resolved",
                        rule=rule.name,
                        duration_s=round(now - resolved["fired_wall"], 3),
                        value=value,
                    )
            firing_count = len(self._firing)
        for record in fired_records:
            self._tel.counter("alert.fired").inc()
            self._tel.event("alert_fired", **record)
            logger.warning(
                "ALERT %s fired: value=%s series=%s (%s)",
                record["rule"], record["value"], record["series"],
                record["description"],
            )
            for fn in listeners:
                try:
                    fn(record)
                except Exception:  # pragma: no cover - defensive
                    logger.exception("alert listener failed")
        self._tel.gauge("alert.firing").set(firing_count)
        return self.status()

    # -- read surface ----------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The ``GET /alertz`` body: every rule with its firing state,
        plus the currently-firing records — a snapshot read."""
        with self._lock:
            firing = [dict(record) for record in self._firing.values()]
            rules = [
                {**rule.as_dict(), "firing": rule.name in self._firing}
                for rule in self.rules
            ]
        return {
            "enabled": True,
            "interval_s": self.interval_s,
            "firing": firing,
            "rules": rules,
        }

    def _loop(self) -> None:
        while not self._stop.wait(max(0.05, self.interval_s)):
            try:
                self.tick()
            except Exception:  # pragma: no cover - the engine outlives
                logger.exception("alert tick failed")  # one bad pass

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

"""Sliding-window SLO evaluation and the scaling signal (the JAX
package's ``serving/slo.py``).

:class:`SLOMonitor` samples a serving target's registries (through the
``metrics_snapshots()`` fan-out ``GET /metrics`` uses) on a cadence, keeps
a bounded ring of samples and evaluates two windows over their deltas:

* **availability**: served / requests over the window (1.0 with no
  traffic);
* **latency attainment**: the share of the window's samples whose live
  ``serve.latency_s`` p95 met the objective;
* **burn rate**: ``(1 - availability) / (1 - objective)`` per window; a
  fast and a slow window give the multi-window burn-rate alert shape;
* **scale_hint**: ``"up"`` on budget burn, backlog, overflow shedding or
  a latency breach; ``"down"`` only when both windows are quiet, the
  backlog is empty and batch occupancy says the fleet is underfilled;
  ``"hold"`` otherwise.

It publishes ``slo.*`` gauges in its registry, the ``slo`` block of
``GET /healthz`` and the ``slo`` record of ``run_slo_harness``.  The
monitor only reads snapshots; it never touches routing or admission.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ..telemetry import get_registry

logger = logging.getLogger(__name__)

# machine-readable hints, and their numeric gauge encoding (the gauge
# lets a scrape-only consumer alert on sign alone)
SCALE_UP = "up"
SCALE_HOLD = "hold"
SCALE_DOWN = "down"
_HINT_GAUGE = {SCALE_DOWN: -1.0, SCALE_HOLD: 0.0, SCALE_UP: 1.0}


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Objectives + window geometry; the ``slo_*`` keys of
    ``config.SERVING_DEFAULTS`` are the JSON-facing view."""

    availability_objective: float = 0.999  # served/requests target
    latency_p95_ms: float = 1000.0         # p95 objective for serve.latency_s
    fast_window_s: float = 60.0            # spike-catcher window
    window_s: float = 300.0                # confirmation (slow) window
    interval_s: float = 5.0                # sampling cadence
    # scale_hint thresholds (not config-exposed: the objective and the
    # windows are the policy surface; these are the standard shapes)
    up_burn_rate: float = 1.0       # fast burn ≥ this → "up"
    down_burn_rate: float = 0.25    # both burns ≤ this to allow "down"
    up_backlog_frac: float = 0.5    # queue_depth / capacity → "up"
    down_backlog_frac: float = 0.05
    down_utilization: float = 0.25  # windowed batch occupancy ceiling
    up_attainment: float = 0.5      # fast latency attainment < this → "up"

    def __post_init__(self) -> None:
        if not (0.0 < self.availability_objective < 1.0):
            raise ValueError(
                "availability_objective must be in (0, 1), got "
                f"{self.availability_objective!r}"
            )
        if self.fast_window_s > self.window_s:
            raise ValueError(
                "fast_window_s must not exceed window_s "
                f"({self.fast_window_s} > {self.window_s})"
            )


# the counters a sample accumulates fleet-wide (summed over parts)
_SAMPLE_COUNTERS = (
    "serve.requests", "serve.served", "serve.shed", "serve.errors",
    "serve.shed_overflow", "serve.shed_deadline",
)


class SLOMonitor:
    """Watch one serving target (a ``ScoringService`` or a
    ``ReplicaRouter``) against :class:`SLOConfig` objectives.
    ``start=False`` skips the worker thread: callers drive :meth:`tick`,
    with explicit ``now`` values for deterministic windows.  ``registry``
    receives the ``slo.*`` gauges (default: the process-wide registry,
    where a router's ``router.*`` lives too)."""

    def __init__(
        self,
        target,
        registry=None,
        config: Optional[SLOConfig] = None,
        capacity: Optional[int] = None,
        start: bool = True,
    ) -> None:
        self.target = target
        self.config = config or SLOConfig()
        self._tel = registry if registry is not None else get_registry()
        self.capacity = int(capacity) if capacity else _infer_capacity(target)
        self._samples: "collections.deque[Dict[str, Any]]" = collections.deque()
        self._lock = threading.Lock()
        self._status: Dict[str, Any] = self._empty_status()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="memvul-slo-monitor", daemon=True
            )
            self._thread.start()

    # -- public surface --------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The latest evaluation (a copy): the ``/healthz`` ``slo`` block
        and the harness record's field."""
        with self._lock:
            return dict(self._status)

    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Take one sample and re-evaluate both windows.  ``now`` is a
        monotonic timestamp override for deterministic tests."""
        now = time.monotonic() if now is None else float(now)
        sample = self._collect(now)
        horizon = now - self.config.window_s - 2 * max(
            self.config.interval_s, 1e-3
        )
        with self._lock:
            self._samples.append(sample)
            while self._samples and self._samples[0]["t"] < horizon:
                self._samples.popleft()
            samples = list(self._samples)
        status = self._evaluate(samples, now)
        self._publish(status)
        with self._lock:
            self._status = status
        return status

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    # -- sampling --------------------------------------------------------------

    def _collect(self, now: float) -> Dict[str, Any]:
        counters = {name: 0 for name in _SAMPLE_COUNTERS}
        p95_s: Optional[float] = None
        occ_count = 0.0
        occ_total = 0.0
        for _labels, snapshot in self.target.metrics_snapshots():
            snap_counters = snapshot.get("counters") or {}
            for name in _SAMPLE_COUNTERS:
                counters[name] += int(snap_counters.get(name, 0))
            hists = snapshot.get("histograms") or {}
            latency = hists.get("serve.latency_s") or {}
            if latency.get("p95") is not None:
                p95_s = max(p95_s or 0.0, float(latency["p95"]))
            occupancy = hists.get("serve.batch_occupancy") or {}
            occ_count += float(occupancy.get("count", 0.0))
            occ_total += float(occupancy.get("total", 0.0))
        return {
            "t": now,
            "counters": counters,
            "p95_s": p95_s,
            "occ_count": occ_count,
            "occ_total": occ_total,
            "queue_depth": int(getattr(self.target, "queue_depth", 0)),
        }

    # -- evaluation ------------------------------------------------------------

    def _empty_status(self) -> Dict[str, Any]:
        cfg = self.config
        return {
            "objectives": {
                "availability": cfg.availability_objective,
                "latency_p95_ms": cfg.latency_p95_ms,
            },
            "window_s": cfg.window_s,
            "fast_window_s": cfg.fast_window_s,
            "samples": 0,
            "availability": 1.0,
            "availability_fast": 1.0,
            "latency_attainment": 1.0,
            "latency_p95_ms": None,
            "burn_rate_fast": 0.0,
            "burn_rate_slow": 0.0,
            "error_budget_remaining": 1.0,
            "backlog": 0,
            "backlog_frac": 0.0,
            "utilization": None,
            "scale_hint": SCALE_HOLD,
        }

    def _window(
        self, samples: List[Dict[str, Any]], now: float, window_s: float
    ) -> Dict[str, Any]:
        """Delta stats between the oldest in-window sample and the
        newest one."""
        inside = [s for s in samples if s["t"] >= now - window_s]
        if len(inside) < 2:
            return {
                "n": len(inside), "requests": 0, "served": 0, "errors": 0,
                "shed_overflow": 0, "availability": 1.0, "attainment": 1.0,
                "occupancy": None,
            }
        base, cur = inside[0], inside[-1]

        def delta(name: str) -> int:
            return max(0, cur["counters"][name] - base["counters"][name])

        requests = delta("serve.requests")
        served = delta("serve.served")
        # a request in flight at the window edge is admitted before the
        # base sample but resolves inside the window, so served_Δ can
        # exceed requests_Δ — that is health, not >100% availability
        availability = min(1.0, served / requests) if requests else 1.0
        objective_s = self.config.latency_p95_ms / 1000.0
        attained = [
            s["p95_s"] is None or s["p95_s"] <= objective_s for s in inside
        ]
        occ_count = cur["occ_count"] - base["occ_count"]
        occ_total = cur["occ_total"] - base["occ_total"]
        return {
            "n": len(inside),
            "requests": requests,
            "served": served,
            "errors": delta("serve.errors"),
            "shed_overflow": delta("serve.shed_overflow"),
            "availability": availability,
            "attainment": sum(attained) / len(attained),
            "occupancy": (occ_total / occ_count) if occ_count > 0 else None,
        }

    def _burn(self, availability: float) -> float:
        budget = max(1e-9, 1.0 - self.config.availability_objective)
        return max(0.0, 1.0 - availability) / budget

    def _evaluate(
        self, samples: List[Dict[str, Any]], now: float
    ) -> Dict[str, Any]:
        cfg = self.config
        fast = self._window(samples, now, cfg.fast_window_s)
        slow = self._window(samples, now, cfg.window_s)
        burn_fast = self._burn(fast["availability"])
        burn_slow = self._burn(slow["availability"])
        latest = samples[-1]
        backlog = latest["queue_depth"]
        backlog_frac = backlog / max(1, self.capacity)
        utilization = fast["occupancy"]
        # a latency breach is judged on the LIVE p95, not the windowed
        # attainment average — the spike should flip the hint the tick
        # it appears, not after it has dragged the average down
        breach = (
            latest["p95_s"] is not None
            and latest["p95_s"] > cfg.latency_p95_ms / 1000.0
            and fast["requests"] > 0
        )
        if (
            burn_fast >= cfg.up_burn_rate
            or backlog_frac >= cfg.up_backlog_frac
            or fast["shed_overflow"] > 0
            or fast["attainment"] < cfg.up_attainment
            or breach
        ):
            hint = SCALE_UP
        elif (
            fast["n"] >= 2
            and burn_fast <= cfg.down_burn_rate
            and burn_slow <= cfg.down_burn_rate
            and backlog_frac <= cfg.down_backlog_frac
            and fast["attainment"] >= 1.0
            and (utilization is None or utilization <= cfg.down_utilization)
        ):
            hint = SCALE_DOWN
        else:
            hint = SCALE_HOLD
        status = self._empty_status()
        status.update({
            "samples": len(samples),
            "availability": slow["availability"],
            "availability_fast": fast["availability"],
            "latency_attainment": slow["attainment"],
            "latency_p95_ms": (
                latest["p95_s"] * 1000.0
                if latest["p95_s"] is not None else None
            ),
            "burn_rate_fast": burn_fast,
            "burn_rate_slow": burn_slow,
            "error_budget_remaining": max(0.0, min(1.0, 1.0 - burn_slow)),
            "backlog": backlog,
            "backlog_frac": backlog_frac,
            "utilization": utilization,
            "scale_hint": hint,
        })
        return status

    def _publish(self, status: Dict[str, Any]) -> None:
        tel = self._tel
        tel.gauge("slo.availability").set(status["availability"])
        tel.gauge("slo.latency_attainment").set(status["latency_attainment"])
        tel.gauge("slo.burn_rate_fast").set(status["burn_rate_fast"])
        tel.gauge("slo.burn_rate_slow").set(status["burn_rate_slow"])
        tel.gauge("slo.error_budget_remaining").set(
            status["error_budget_remaining"]
        )
        tel.gauge("slo.scale_hint").set(_HINT_GAUGE[status["scale_hint"]])

    # -- worker ----------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(max(0.05, self.config.interval_s)):
            try:
                self.tick()
            except Exception:  # pragma: no cover - the monitor outlives a
                # bad sample (a replica dying mid-read)
                logger.exception("slo monitor tick failed")


def _infer_capacity(target) -> int:
    """Fleet queue capacity (the backlog normalizer): Σ max_queue over the
    replicas, or the single service's max_queue; 256 when the target
    exposes neither."""
    replicas = getattr(target, "replicas", None)
    if replicas:
        total = 0
        for replica in replicas:
            service_cfg = getattr(
                getattr(replica, "service", None), "config", None
            )
            total += int(getattr(service_cfg, "max_queue", 0) or 0)
        if total > 0:
            return total
    service_cfg = getattr(target, "config", None)
    capacity = int(getattr(service_cfg, "max_queue", 0) or 0)
    return capacity if capacity > 0 else 256

"""Live replica autoscaling from the SLO monitor's ``scale_hint`` (the
JAX package's ``serving/autoscaler.py``: the same decisions for the same
sequence of hints on the same clock).

:class:`Autoscaler` watches the hint and grows or shrinks a live
:class:`~memvul_tpu_torch.serving.router.ReplicaRouter` without dropping a
request:

* **scale-up** — spawn, warm, admit: a worker thread builds a
  :class:`~memvul_tpu_torch.serving.replica.Replica` through the replica
  factory ``build.serve_from_archive`` uses (on ``cuda:{i % cards}``; on
  one card it shares the weights and gets a CUDA stream of its own; the
  bank encode and the warm pack run inside the factory, before
  admission), installs the fleet's current banks (``router._sync_bank``)
  and admits it (:meth:`ReplicaRouter.admit_replica`).  A failed spawn is
  retried through the shared
  :class:`~memvul_tpu_torch.resilience.retry.RetryPolicy`, then refused
  with a machine-readable record (``scaler.spawn_failures``,
  ``last_refusal``); the fleet keeps its size.  The ``scaler.spawn`` fault
  point fires inside the retried window;
* **scale-down** — stop routing, drain, retire: the newest member's
  admission gate closes, the worker waits for its queue and its owed
  requests to empty, the router drops it (re-enqueueing anything still
  charged to it, :meth:`ReplicaRouter.retire_replica`) and it retires
  (:meth:`Replica.retire`).  The invariant ``served + shed + errors ==
  requests`` holds over the retired members too;
* **stability** — min/max bounds, per-direction cooldowns, hysteresis
  (``up_consecutive``/``down_consecutive`` agreeing ticks) and one scale
  operation in flight at a time.

The class only decides: it reads ``status()`` dicts, counts streaks and
starts a worker.  The heavy work (a replica's build and warmup, a bank
install, the drain wait) runs in the module-level workers
:func:`_spawn_replica` and :func:`_retire_replica` on threads of their own,
never on the decision path or a batcher.

Metrics (``scaler.*``): the ``scaler.replicas`` and ``scaler.hint``
gauges, the ``scaler.scale_events`` / ``scale_ups`` / ``scale_downs`` /
``spawn_failures`` counters.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..resilience import faults
from ..telemetry import get_registry
from .replica import Replica
from .router import ReplicaRouter, _sync_bank
from .slo import SCALE_DOWN, SCALE_HOLD, SCALE_UP, _HINT_GAUGE

logger = logging.getLogger(__name__)

# the metric window attached to each decision when the metrics history is
# on (serving/incident.py sets ``metrics_store``): the series that justify
# a hint (burn rates, replica count, queue depth)
_DECISION_METRICS = (
    "slo.burn_rate_fast",
    "slo.burn_rate_slow",
    "scaler.replicas",
    "serve.queue_depth",
)
_DECISION_WINDOW_S = 60.0


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Bounds and stability knobs; the ``autoscale_*`` keys of
    ``config.SERVING_DEFAULTS`` are the JSON-facing view."""

    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 1.0        # hint-sampling cadence
    up_cooldown_s: float = 5.0     # quiet time after a scale-up (or refusal)
    down_cooldown_s: float = 30.0  # quiet time after a scale-down
    up_consecutive: int = 2        # agreeing "up" ticks before acting
    down_consecutive: int = 4      # agreeing "down" ticks before acting
    drain_timeout_s: float = 10.0  # retire: in-flight completion bound
    history: int = 512             # the replica-count trajectory's ring

    @classmethod
    def from_serving(cls, serve_cfg: Dict[str, Any]) -> "AutoscalerConfig":
        """The knobs of a merged ``serving`` section (``config.serving_config``)."""
        return cls(
            min_replicas=int(serve_cfg["autoscale_min_replicas"]),
            max_replicas=int(serve_cfg["autoscale_max_replicas"]),
            interval_s=float(serve_cfg["autoscale_interval_s"]),
            up_cooldown_s=float(serve_cfg["autoscale_up_cooldown_s"]),
            down_cooldown_s=float(serve_cfg["autoscale_down_cooldown_s"]),
            up_consecutive=int(serve_cfg["autoscale_up_consecutive"]),
            down_consecutive=int(serve_cfg["autoscale_down_consecutive"]),
            drain_timeout_s=float(serve_cfg["autoscale_drain_timeout_s"]),
        )

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                "max_replicas must be >= min_replicas "
                f"({self.max_replicas} < {self.min_replicas})"
            )
        if self.up_consecutive < 1 or self.down_consecutive < 1:
            raise ValueError("hysteresis streaks must be >= 1")


class Autoscaler:
    """Grow/shrink a router's replica count from the SLO scale_hint.

    ``replica_factory(index)`` returns a *service factory* (the
    ``registry -> ScoringService`` closure a :class:`Replica` is built
    over): ``build.serve_from_archive`` passes its ``make_factory``, so a
    spawned replica takes the placement and warmup path of a restarted
    one.  ``slo_monitor`` is the
    hint source (its own thread keeps ``status()`` fresh);
    ``start=False`` skips the control thread so tests
    drive :meth:`tick` deterministically."""

    def __init__(
        self,
        router: ReplicaRouter,
        replica_factory: Callable[[int], Callable],
        slo_monitor,
        config: Optional[AutoscalerConfig] = None,
        registry=None,
        retry_policy=None,
        run_dir=None,
        start: bool = True,
    ) -> None:
        self.router = router
        self.replica_factory = replica_factory
        self.slo_monitor = slo_monitor
        self.config = config or AutoscalerConfig()
        self.retry_policy = retry_policy
        self.run_dir = run_dir
        self._tel = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._scaling = False          # one scale operation in flight
        self._streak_hint = SCALE_HOLD
        self._streak = 0
        self._last_up = -float("inf")   # monotonic stamps for cooldowns
        self._last_down = -float("inf")
        self._started = time.monotonic()
        self._next_index = itertools.count(
            max(r.index for r in router._members()) + 1
        )
        self.last_refusal: Optional[Dict[str, Any]] = None
        self.history: List[Dict[str, Any]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tel.gauge("scaler.replicas").set(len(router._members()))
        self._tel.event(
            "scaler_start",
            min=self.config.min_replicas, max=self.config.max_replicas,
        )
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="memvul-autoscaler", daemon=True
            )
            self._thread.start()

    # -- public surface --------------------------------------------------------

    @property
    def replicas(self) -> int:
        return len(self.router._members())

    def status(self) -> Dict[str, Any]:
        """Machine-readable controller state — the ``autoscaler`` block
        ``GET /healthz`` carries (a snapshot read)."""
        now = time.monotonic()
        cfg = self.config
        with self._lock:
            return {
                "replicas": self.replicas,
                "min_replicas": cfg.min_replicas,
                "max_replicas": cfg.max_replicas,
                "hint": self._streak_hint,
                "streak": self._streak,
                "scaling": self._scaling,
                "cooldown_remaining_s": {
                    "up": round(
                        max(0.0, self._last_up + cfg.up_cooldown_s - now), 3
                    ),
                    "down": round(
                        max(
                            0.0, self._last_down + cfg.down_cooldown_s - now
                        ), 3
                    ),
                },
                "last_refusal": self.last_refusal,
            }

    def tick(self, now: Optional[float] = None, sync: bool = False) -> Optional[str]:
        """One control decision: read the hint, update the hysteresis
        streak, and — bounds, cooldowns, and streak permitting — start a
        scale operation.  Returns the action taken (``"up"``/``"down"``)
        or None.  ``now`` overrides the monotonic clock and ``sync``
        runs the worker inline, both for deterministic tests."""
        now = time.monotonic() if now is None else float(now)
        hint = str(self.slo_monitor.status().get("scale_hint", SCALE_HOLD))
        self._tel.gauge("scaler.hint").set(_HINT_GAUGE.get(hint, 0.0))
        action = self._decide(hint, now)
        self._observe(hint, action, now)
        if action == SCALE_UP:
            self._launch(_spawn_replica, sync)
        elif action == SCALE_DOWN:
            self._launch(_retire_replica, sync)
        return action

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    # -- decision --------------------------------------------------------------

    def _decide(self, hint: str, now: float) -> Optional[str]:
        """Pure policy: hysteresis streaks, per-direction cooldowns,
        bounds and the one-in-flight gate.  Nothing here blocks, scores
        or warms."""
        cfg = self.config
        with self._lock:
            if hint != self._streak_hint:
                self._streak_hint = hint
                self._streak = 0
            self._streak += 1
            if self._scaling or hint == SCALE_HOLD:
                return None
            count = self.replicas
            if hint == SCALE_UP:
                if self._streak < cfg.up_consecutive:
                    return None
                if count >= cfg.max_replicas:
                    return None
                if now - self._last_up < cfg.up_cooldown_s:
                    return None
                self._last_up = now
                self._scaling = True
                return SCALE_UP
            if hint == SCALE_DOWN:
                if self._streak < cfg.down_consecutive:
                    return None
                if count <= cfg.min_replicas:
                    return None
                if now - self._last_down < cfg.down_cooldown_s:
                    return None
                self._last_down = now
                self._scaling = True
                return SCALE_DOWN
            return None

    def _observe(self, hint: str, action: Optional[str], now: float) -> None:
        """Append one trajectory point (the replica count against time,
        a bounded ring) and emit it as a
        ``scaler_decision`` event so post-mortems survive the process
        (the in-memory deque dies with it).  When the history plane is
        on (``metrics_store`` set by serving/incident.py), the stored
        point also carries the metric window that justified it."""
        slo = self.slo_monitor.status()
        point = {
            "t_s": round(now - self._started, 3),
            "replicas": self.replicas,
            "hint": hint,
            "action": action,
            "burn_rate_fast": slo.get("burn_rate_fast"),
            "backlog": slo.get("backlog"),
        }
        self._tel.event("scaler_decision", **point)
        store = getattr(self, "metrics_store", None)
        if store is not None:
            try:
                point = dict(point)
                point["window"] = store.window(
                    _DECISION_METRICS, _DECISION_WINDOW_S
                )
            except Exception:  # pragma: no cover - a torn store read
                pass  # must not cost a control decision
        with self._lock:
            self.history.append(point)
            if len(self.history) > self.config.history:
                del self.history[: -self.config.history]

    def _launch(self, worker, sync: bool) -> None:
        """Hand the heavy work to a module-level worker: inline when a
        test asks for determinism, else on a thread of its own (the split
        the router's monitor keeps for recoveries)."""
        if sync:
            worker(self)
            return
        threading.Thread(
            target=worker, args=(self,),
            name="memvul-autoscaler-worker", daemon=True,
        ).start()

    # -- worker ----------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(max(0.05, self.config.interval_s)):
            try:
                self.tick()
            except Exception:  # pragma: no cover - the controller must
                # outlive one bad sample (a replica dying mid-read)
                logger.exception("autoscaler tick failed")


def _spawn_replica(scaler: Autoscaler) -> None:
    """Scale-up worker: build a replica through the factory (placement,
    the anchor encode and the warm pack: the path a restart takes), sync
    the fleet's current banks, admit it.  A failure
    burns the shared RetryPolicy's attempts and is then refused with a
    machine-readable record; the fleet keeps serving at its current
    size."""
    tel = scaler._tel
    router = scaler.router
    index = next(scaler._next_index)
    name = f"replica-{index}"
    try:
        def build() -> Replica:
            # the scaler.spawn chaos point: fires inside the retried
            # window, like serve.batch
            faults.fault_point("scaler.spawn")
            return Replica(
                index,
                scaler.replica_factory(index),
                run_dir=scaler.run_dir,
            )

        try:
            if scaler.retry_policy is not None:
                replica = scaler.retry_policy.call(
                    build, description=f"spawn {name}"
                )
            else:
                replica = build()
        except Exception as e:  # noqa: BLE001 - any predictor or device
            # failure refuses the spawn and never stops the controller
            refusal = {
                "error": "spawn_failed",
                "replica": name,
                "attempts": (
                    scaler.retry_policy.attempts
                    if scaler.retry_policy is not None else 1
                ),
                "reason": f"{type(e).__name__}: {e}"[:200],
            }
            with scaler._lock:
                scaler.last_refusal = refusal
            tel.counter("scaler.spawn_failures").inc()
            tel.event("scaler_spawn_refused", **refusal)
            logger.error("spawn %s refused: %s", name, refusal["reason"])
            recorder = getattr(scaler, "incident_recorder", None)
            if recorder is not None:  # refusals are incident triggers
                recorder.trigger("scaler_spawn_refused", refusal)
            return
        _sync_bank(router, replica)
        router.admit_replica(replica)
        count = len(router._members())
        tel.counter("scaler.scale_events").inc()
        tel.counter("scaler.scale_ups").inc()
        tel.gauge("scaler.replicas").set(count)
        tel.event("scaler_scale_up", replica=replica.name, replicas=count)
        logger.info("scaled up: %s admitted (%d replicas)", replica.name, count)
    finally:
        with scaler._lock:
            scaler._scaling = False


def _retire_replica(
    scaler: Autoscaler, poll_interval_s: float = 0.01
) -> None:
    """Scale-down worker: stop-route → drain in-flight → retire.  The
    victim is the newest healthy member (LIFO keeps the original fleet
    stable); its gate closes first, the worker waits for its private
    queue to empty (every in-flight request completes normally), then
    membership is dropped (anything still charged re-enqueues onto
    survivors) and the replica retires with its counters intact."""
    tel = scaler._tel
    router = scaler.router
    cfg = scaler.config
    try:
        members = router._members()
        if len(members) <= cfg.min_replicas:
            return
        victim = members[-1]
        victim.accepting.clear()
        tel.event("scaler_retire_begin", replica=victim.name)
        deadline = time.monotonic() + cfg.drain_timeout_s
        while time.monotonic() < deadline:
            with router._lock:
                owed = len(router._outstanding.get(victim.name, {}))
            if owed == 0 and victim.queue_depth == 0:
                break
            time.sleep(poll_interval_s)
        try:
            router.retire_replica(victim)
        except ValueError:
            # raced a concurrent recovery/drain that already removed it
            victim.accepting.set()
            return
        victim.retire(timeout=cfg.drain_timeout_s)
        count = len(router._members())
        tel.counter("scaler.scale_events").inc()
        tel.counter("scaler.scale_downs").inc()
        tel.gauge("scaler.replicas").set(count)
        tel.event("scaler_scale_down", replica=victim.name, replicas=count)
        logger.info(
            "scaled down: %s retired (%d replicas)", victim.name, count
        )
    finally:
        with scaler._lock:
            scaler._scaling = False

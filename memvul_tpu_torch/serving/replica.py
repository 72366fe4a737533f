"""One serving replica: a :class:`ScoringService` plus its own health (the
JAX package's ``serving/replica.py``).

A fleet runs N scoring services behind a
:class:`~memvul_tpu_torch.serving.router.ReplicaRouter`, each on
``cuda:{i % device_count}`` (several share a card when there are more
replicas than cards, each on a CUDA stream of its own).  A replica owns
what makes one service observable and replaceable on its own:

* **its own registry**: its counters, events and ``HEARTBEAT.json`` land
  in ``<run_dir>/replica-<i>/``.  The registry survives restarts, so the
  counters accumulate over a replica's lives and the fleet-wide
  ``served + shed + errors == requests`` stays exact through a death;
* **a service factory** (``factory(registry)``) that rebuilds the
  service, predictor, anchor encode and warmup included, so a failed
  replica is restarted, not only evicted;
* **health**: :meth:`check_health` reads the registry's liveness clock
  (the batcher ticks it when idle too) and counter deltas: a dead batcher
  is ``DEAD``; a stalled heartbeat or a streak of dead-lettered batches
  with no success between is ``UNHEALTHY``; anything else ``HEALTHY``;
* **the ``replica.kill`` fault point** (and ``replica.kill.<name>``),
  fired on the submit path, hard-kills the replica the way a killed worker
  process dies: nothing resolves, and only the supervisor's sweep
  (:meth:`sweep_unresolved`) books the dangling requests
  (``serve.errors`` and ``serve.errors_lost``).

A Python-level kill restarts cleanly.  A real CUDA fault is sticky for
the process, so on one card it takes down every replica there.

The heavy operations (a restart's encode and warmup, a bank install) run
on the thread that calls them: the router's monitor and control paths,
never request routing.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

from ..resilience import faults
from ..telemetry import Registry
from .service import ScoreFuture, ScoringService, _Request

logger = logging.getLogger(__name__)

# replica lifecycle states (strings so they serialize straight into
# telemetry events and the /healthz body)
REPLICA_STARTING = "starting"
REPLICA_HEALTHY = "healthy"
REPLICA_UNHEALTHY = "unhealthy"
REPLICA_SWAPPING = "swapping"   # readmission-gated during a rolling swap
REPLICA_DEAD = "dead"
REPLICA_RETIRED = "retired"     # scale-down terminal: drained + closed,
                                # counters kept for the fleet invariant


class ReplicaDead(RuntimeError):
    """Raised by :meth:`Replica.submit` when the replica cannot accept —
    the router's signal to pick another queue immediately."""


class Replica:
    """One scoring service and its registry, factory and health state.
    ``service_factory(registry)`` returns a started :class:`ScoringService`
    reporting into ``registry``; it runs at construction and at every
    restart."""

    def __init__(
        self,
        index: int,
        service_factory: Callable[[Registry], ScoringService],
        run_dir: Optional[Union[str, Path]] = None,
        device: Any = None,
        telemetry_enabled: bool = True,
        heartbeat_every_s: float = 5.0,
    ) -> None:
        """``run_dir`` (with ``telemetry_enabled``) gives the replica's
        registry its sinks in ``<run_dir>/replica-<index>/``."""
        self.index = int(index)
        self.name = f"replica-{self.index}"
        self.device = device
        self._factory = service_factory
        self.restart_count = 0
        self.state = REPLICA_STARTING
        self._state_lock = threading.Lock()
        self._restart_lock = threading.Lock()
        # router readmission gate: cleared while a rolling swap drains
        # this replica; the router routes only to set+healthy replicas
        self.accepting = threading.Event()
        # counter snapshots for the consecutive-batch-error streak
        self._last_dead_letters = 0
        self._last_batches = 0
        self._err_streak = 0
        self.registry = Registry(
            run_dir=Path(run_dir) / self.name if run_dir and telemetry_enabled else None,
            heartbeat_every_s=heartbeat_every_s,
        )
        # shadow tap (bankops/shadow.py): kept here so a restart's fresh
        # service re-attaches it — a replica death must not silently end
        # a shadow evaluation
        self._shadow_tap = None
        self.service = service_factory(self.registry)
        self.state = REPLICA_HEALTHY
        self.accepting.set()
        self.registry.event("replica_start", replica=self.name)

    # -- request path ----------------------------------------------------------

    def submit(
        self,
        text: str,
        deadline_ms: Optional[float] = None,
        trace_id: Optional[str] = None,
        hops: int = 0,
        tenant: Optional[str] = None,
    ) -> ScoreFuture:
        """Enqueue on this replica's service.  Raises :class:`ReplicaDead`
        when the replica is dead, and when the ``replica.kill`` fault point
        fires, which hard-kills it first, so the caller re-routes away from
        a really dead replica.  ``trace_id`` and ``hops`` carry a router's
        journey across re-routes."""
        if self.state == REPLICA_DEAD:
            raise ReplicaDead(f"{self.name} is dead")
        try:
            faults.fault_point(f"replica.kill.{self.name}")
            faults.fault_point("replica.kill")
        except Exception as e:
            self.kill(reason=f"injected: {e}")
            raise ReplicaDead(f"{self.name} killed by fault injection") from e
        return self.service.submit(
            text, deadline_ms=deadline_ms, trace_id=trace_id, hops=hops,
            tenant=tenant,
        )

    @property
    def queue_depth(self) -> int:
        if self.state == REPLICA_DEAD:
            return 0
        return self.service.queue_depth

    @property
    def bank_version(self) -> int:
        return self.service.bank_version

    def heartbeat_age_s(self) -> float:
        return self.registry.heartbeat_age_s()

    # -- shadow tap ------------------------------------------------------------

    def set_shadow_tap(self, tap) -> None:
        self._shadow_tap = tap
        self.service.set_shadow_tap(tap)

    def clear_shadow_tap(self) -> None:
        self._shadow_tap = None
        self.service.clear_shadow_tap()

    # -- death / sweep ---------------------------------------------------------

    def kill(self, reason: str = "killed") -> None:
        """Hard-kill (SIGKILL semantics): the service stops resolving,
        nothing is drained, the state flips to DEAD.  Idempotent."""
        with self._state_lock:
            if self.state == REPLICA_DEAD:
                return
            self.state = REPLICA_DEAD
        self.accepting.clear()
        self.service.hard_kill()
        self.registry.counter("replica.kills").inc()
        self.registry.event("replica_killed", replica=self.name, reason=reason)
        logger.warning("%s hard-killed: %s", self.name, reason)

    def sweep_unresolved(self) -> List[_Request]:
        """Collect the killed service's dangling requests and book them:
        each was counted in ``serve.requests`` at submit and will never
        resolve here, so the sweep counts it in ``serve.errors`` (and
        ``serve.errors_lost``) and the fleet invariant survives the death.
        Returns the swept requests (the router re-enqueues its own records
        of them)."""
        pending = self.service.take_unresolved()
        if pending:
            self.registry.counter("serve.errors").inc(len(pending))
            self.registry.counter("serve.errors_lost").inc(len(pending))
            for request in pending:
                self.service._tenant_count(request.tenant, "errors")
            self.registry.event(
                "replica_swept", replica=self.name, lost=len(pending)
            )
        return pending

    # -- health ----------------------------------------------------------------

    def check_health(
        self, heartbeat_timeout_s: float, max_batch_errors: int
    ) -> str:
        """Classify this replica from its own telemetry (the router's
        monitor calls this every interval): the batcher gone without a
        drain → ``DEAD``; a heartbeat older than ``heartbeat_timeout_s``
        (an idle batcher ticks too, so only a wedged one ages) or
        ``max_batch_errors`` dead-lettered batches since the last
        successful one → ``UNHEALTHY``; else ``HEALTHY``."""
        with self._state_lock:
            if self.state == REPLICA_DEAD:
                return self.state
            if self.state == REPLICA_SWAPPING:
                return self.state  # the swap owns this replica right now
            if not self.service.batcher_alive and not self.service.draining:
                self.state = REPLICA_DEAD
                self.accepting.clear()
                self.registry.event(
                    "replica_dead", replica=self.name, reason="batcher exited"
                )
                return self.state
            batches = self.registry.counter("serve.batches").value
            dead_letters = self.registry.counter("serve.dead_letters").value
            if batches > self._last_batches:
                self._err_streak = 0
            self._err_streak += dead_letters - self._last_dead_letters
            self._last_batches = batches
            self._last_dead_letters = dead_letters
            stalled = self.heartbeat_age_s() > heartbeat_timeout_s
            erroring = self._err_streak >= max(1, max_batch_errors)
            new_state = (
                REPLICA_UNHEALTHY if (stalled or erroring) else REPLICA_HEALTHY
            )
            if new_state != self.state:
                self.registry.event(
                    "replica_state", replica=self.name,
                    state=new_state, was=self.state,
                    heartbeat_age_s=round(self.heartbeat_age_s(), 3),
                    err_streak=self._err_streak,
                )
                self.state = new_state
            return self.state

    # -- restart / bank install ------------------------------------------------

    def restart(self, drain_timeout_s: float = 5.0) -> None:
        """Replace the service with a new one (drain, build, readmit).  An
        unhealthy replica drains first (its queued requests resolve
        ``"drain"`` and the router re-enqueues them); a drain that cannot
        finish falls back to a hard kill and a sweep.  The old service's
        tensors are left to its own threads, which free them only after
        their device calls return; the factory builds a new predictor.
        The registry, and every counter, carries over."""
        with self._restart_lock:
            old = self.service
            if not old.killed:
                old.drain(timeout=drain_timeout_s)
                if old.batcher_alive:
                    old.hard_kill()
            if old.killed:
                # account anything the dead/wedged batcher abandoned
                self.sweep_unresolved()
            self.service = self._factory(self.registry)
            if self._shadow_tap is not None:
                self.service.set_shadow_tap(self._shadow_tap)
            self.restart_count += 1
            self._err_streak = 0
            self._last_batches = self.registry.counter("serve.batches").value
            self._last_dead_letters = self.registry.counter(
                "serve.dead_letters"
            ).value
            with self._state_lock:
                self.state = REPLICA_HEALTHY
            self.accepting.set()
            self.registry.counter("replica.restarts").inc()
            self.registry.event(
                "replica_restart", replica=self.name, n=self.restart_count
            )
            logger.info("%s restarted (restart #%d)", self.name, self.restart_count)

    def install_bank(
        self,
        anchor_instances: Iterable[Dict],
        version: Optional[int] = None,
        source: str = "rolling_swap",
        store_version: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> int:
        """Encode, warm and install a bank on this replica's service at an
        explicit fleet version (the rolling swap's step;
        ``ScoringService.swap_bank``).  ``tenant`` targets a named
        tenant's slot."""
        return self.service.swap_bank(
            anchor_instances, version=version,
            source=source, store_version=store_version, tenant=tenant,
        )

    # -- shutdown --------------------------------------------------------------

    def retire(self, timeout: float = 30.0) -> None:
        """The terminal state of a removed replica: the caller has stopped
        routing to it and waited for its queue to empty, so the drain is
        normally instant (anything still queued resolves ``"drain"`` and
        the router re-enqueues it).  The registry closes but keeps its
        counters readable: the fleet invariant sums retired members too."""
        self.accepting.clear()
        if self.state != REPLICA_DEAD:
            self.service.drain(timeout=timeout)
        else:
            # a retire that raced a death still accounts the casualties
            self.sweep_unresolved()
        with self._state_lock:
            self.state = REPLICA_RETIRED
        self.registry.counter("replica.retires").inc()
        self.registry.event("replica_retired", replica=self.name)
        self.registry.close()
        logger.info("%s retired", self.name)

    def close(self, timeout: float = 30.0) -> None:
        """Drain the service (unless already dead) and close this
        replica's telemetry sinks."""
        if self.state != REPLICA_DEAD:
            self.service.drain(timeout=timeout)
        self.registry.close()

    def summary(self) -> Dict[str, Any]:
        """One ``/healthz`` row: state, backlog, liveness, restarts and
        the bank's provenance (source and store version)."""
        bank = self.service.bank_snapshot()
        return {
            "name": self.name,
            "state": self.state,
            "accepting": self.accepting.is_set(),
            "queue_depth": self.queue_depth,
            "heartbeat_age_s": round(self.heartbeat_age_s(), 3),
            "restarts": self.restart_count,
            "bank_version": bank.version,
            "bank_source": bank.source,
            "bank_store_version": bank.store_version,
        }

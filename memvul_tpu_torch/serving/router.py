"""The replica router: the fleet tier of the serving plane (the JAX
package's ``serving/router.py``).

N scoring services (``serving/replica.py``) run behind this router, which
owns what a single service never had to solve:

* **load balancing**: a routing decision reads the replicas' live queue
  depths and picks the least-loaded healthy, accepting replica,
  preferring those that serve the request's pinned bank version.  That
  is all a routing decision does: no scoring, encoding or sleeping
  happens in this class; the heavy work runs on a replica's threads or on
  the control plane (:func:`_recover_replica`, :func:`rolling_swap`);
* **health-gated membership**: a monitor thread runs each replica's
  :meth:`~memvul_tpu_torch.serving.replica.Replica.check_health` (missed
  heartbeats, dead-lettered batches, a dead batcher), evicts a failing
  replica, drains and restarts it through the shared
  :class:`~memvul_tpu_torch.resilience.retry.RetryPolicy`, and
  re-enqueues what a dead replica owed onto a survivor, keeping its trace
  id and counting the hop: a client sees a retry, never a hang;
* **rolling bank swaps**: :func:`rolling_swap` pins each request at
  admission to the fleet's bank version and swaps the replicas one at a
  time (stop routing, drain its queue, encode and warm and install at the
  new version, readmit); the fleet version advances only once every
  replica serves it, so each response carries exactly one bank version,
  and a restarted replica re-installs the fleet's bank before readmission;
* **shadow fan-out**: :meth:`ReplicaRouter.set_shadow_tap` hands one tap
  to every replica, which re-attaches it across restarts.

The router's ``router.*`` counters live in the process-wide registry
(``telemetry.get_registry``); each replica's ``serve.*`` counters live in
its own, and the fleet invariant ``Σ served + Σ shed + Σ errors ==
Σ requests`` sums over the replicas' registries.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

from ..telemetry import get_registry
from .replica import (
    REPLICA_DEAD,
    REPLICA_HEALTHY,
    REPLICA_SWAPPING,
    REPLICA_UNHEALTHY,
    Replica,
    ReplicaDead,
)
from .service import (
    STATUS_DEADLINE,
    STATUS_DRAIN,
    STATUS_ERROR,
    STATUS_OK,
    ScoreFuture,
    stop_attached,
)
from .tenancy import DEFAULT_TENANT

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Fleet-management knobs; defaults mirror ``config.SERVING_DEFAULTS``
    (the JSON-facing view)."""

    heartbeat_timeout_s: float = 10.0  # missed-heartbeat eviction threshold
    max_batch_errors: int = 3     # consecutive dead-letters before eviction
    monitor_interval_s: float = 0.25  # health-check cadence
    max_reroutes: int = 2         # re-enqueue attempts after replica failures
    auto_restart: bool = True     # restart evicted/dead replicas
    restart_drain_timeout_s: float = 5.0


@dataclasses.dataclass
class _RoutedRequest:
    """The router's own record of one client request — it outlives any
    single replica's ``_Request`` so a death can re-enqueue it."""

    rid: int
    text: str
    deadline_ms: Optional[float]
    deadline_monotonic: Optional[float]
    future: ScoreFuture
    pinned_version: int
    tenant: Optional[str] = None
    attempts: int = 0


class ReplicaRouter:
    """Load-balancing dispatch over a fleet of :class:`Replica` objects.
    Its surface is :class:`ScoringService`'s (``submit``, ``queue_depth``,
    ``bank_version``, ``draining``, ``health_summary``,
    ``metrics_snapshots``, ``programs_snapshot``, ``recent_traces``,
    ``request_drain``, ``drain``), so the front end and the clients serve
    either.  The autoscaler grows and shrinks it
    (:meth:`admit_replica`, :meth:`retire_replica`)."""

    def __init__(
        self,
        replicas: Sequence[Replica],
        config: Optional[RouterConfig] = None,
        retry_policy=None,
        registry=None,
    ) -> None:
        if not replicas:
            raise ValueError("a router needs at least one replica")
        self.replicas: List[Replica] = list(replicas)
        # scaled-down members (serving/autoscaler.py), kept for the fleet
        # invariant, which sums over them too
        self.retired_replicas: List[Replica] = []
        self.config = config or RouterConfig()
        self.retry_policy = retry_policy
        self._tel = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._rid = itertools.count(1)
        self._rr = itertools.count()  # round-robin tie-break cursor
        # per-replica map of routed requests awaiting their inner future
        self._outstanding: Dict[str, Dict[int, _RoutedRequest]] = {
            r.name: {} for r in self.replicas
        }
        self._draining = threading.Event()
        self._swap_lock = threading.Lock()  # one rolling swap at a time
        self._active_version = max(r.bank_version for r in self.replicas)
        # the fleet's current bank content, for re-install on restart
        # (None = the factory-built bank is still current), plus its
        # provenance so a restart re-stamps the same source/store id
        self._bank_instances: Optional[List[Dict]] = None
        self._bank_source: str = "rolling_swap"
        self._bank_store_version: Optional[str] = None
        # each named tenant's fleet bank, provenance and version, for the
        # re-install on restart: a rebuilt replica carries only the
        # factory's default bank
        self._tenant_banks: Dict[str, tuple] = {}
        self._shadow_tap = None
        self._default_deadline_ms = self.replicas[0].service.default_deadline_ms
        self._recovering: Dict[str, bool] = {}
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="memvul-router-monitor", daemon=True
        )
        self._monitor.start()
        self._tel.gauge("router.replicas").set(len(self.replicas))
        self._tel.gauge("router.bank_version").set(self._active_version)
        self._tel.event("router_start", replicas=len(self.replicas))

    # -- ScoringService-compatible surface ------------------------------------

    @property
    def registry(self):
        """The router's registry (``router.*``)."""
        return self._tel

    def _members(self) -> List[Replica]:
        """A point-in-time copy of the membership."""
        with self._lock:
            return list(self.replicas)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @property
    def queue_depth(self) -> int:
        return sum(r.queue_depth for r in self._members())

    @property
    def bank_version(self) -> int:
        return self._active_version

    @property
    def default_deadline_ms(self) -> float:
        return self._default_deadline_ms

    # -- shadow tap (bankops/shadow.py) ---------------------------------------

    def set_shadow_tap(self, tap) -> None:
        """Fan one shadow tap out to every replica (each replica
        re-attaches it across its own restarts)."""
        self._shadow_tap = tap
        for replica in self._members():
            replica.set_shadow_tap(tap)

    def clear_shadow_tap(self) -> None:
        self._shadow_tap = None
        for replica in self._members():
            replica.clear_shadow_tap()

    def health_summary(self) -> Dict[str, Any]:
        """The /healthz body for a fleet: drain state, total backlog,
        active bank version, and the per-replica health rows — an
        external probe can tell "degraded fleet" (some unhealthy
        members) from "healthy"."""
        draining = self._draining.is_set()
        members = [r.summary() for r in self._members()]
        healthy = sum(1 for m in members if m["state"] == REPLICA_HEALTHY)
        if draining:
            status = "draining"
        elif healthy == len(members):
            status = "ok"
        elif healthy > 0:
            status = "degraded"
        else:
            status = "unavailable"
        return {
            "status": status,
            "draining": draining,
            "queue_depth": self.queue_depth,
            "bank_version": self._active_version,
            "replicas": {
                "total": len(members),
                "healthy": healthy,
                "members": members,
            },
        }

    # -- live exposition (GET /metrics, /tracez) --------------------------------

    def metrics_snapshots(self) -> List:
        """Snapshot parts for ``telemetry.exposition``: the router's own
        registry (``router.*``) unlabeled, and every replica's under a
        ``replica`` label, its program registry's ``program.*`` rows as a
        second part under the same label.  Registry reads only."""
        parts: List = [({}, self._tel.snapshot())]
        for replica in self._members():
            parts.append(({"replica": replica.name}, replica.registry.snapshot()))
            service = replica.service
            if service is not None:
                programs = getattr(service.predictor, "programs", None)
                part = programs.metrics_part() if programs is not None else {}
                if part:
                    parts.append(({"replica": replica.name}, part))
        return parts

    def programs_snapshot(self) -> List[Dict[str, Any]]:
        """Fleet ``/programz``: every replica's programs stamped with the
        replica's name, merged newest first (``compiled_wall`` orders
        them)."""
        rows: List[Dict[str, Any]] = []
        for replica in self._members():
            service = replica.service
            if service is None:
                continue
            for row in service.programs_snapshot():
                row = dict(row)
                row["replica"] = replica.name
                rows.append(row)
        rows.sort(key=lambda r: -(r.get("compiled_wall") or 0.0))
        return rows

    def recent_traces(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Fleet ``/tracez``: every replica's completed traces, newest
        first (one process's monotonic clock orders them all)."""
        records: List[Dict[str, Any]] = []
        for replica in self._members():
            records.extend(replica.service.recent_traces())
        records.sort(
            key=lambda r: -(r.get("waypoints", {}).get("resolved") or 0.0)
        )
        return records[: int(limit)] if limit else records

    # -- dispatch --------------------------------------------------------------

    def submit(
        self,
        text: str,
        deadline_ms: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> ScoreFuture:
        """Route one request: pin it to the fleet's active bank version,
        pick the least-loaded healthy replica, relay its response.  The
        returned future ALWAYS resolves — via the replica, via a
        re-route after a replica death, or via the router's own
        deadline/drain/exhaustion terminal statuses."""
        future = ScoreFuture()
        self._tel.counter("router.requests").inc()
        if self._draining.is_set():
            self._tel.counter("router.shed_drain").inc()
            future.resolve({"status": STATUS_DRAIN})
            return future
        now = time.monotonic()
        effective_ms = (
            self._default_deadline_ms if deadline_ms is None else deadline_ms
        )
        request = _RoutedRequest(
            rid=next(self._rid),
            text=text,
            deadline_ms=deadline_ms,
            deadline_monotonic=(
                now + effective_ms / 1000.0 if effective_ms > 0 else None
            ),
            future=future,
            pinned_version=self._active_version,
            tenant=tenant,
        )
        self._route(request)
        return future

    def _pick(self, request: _RoutedRequest) -> Optional[Replica]:
        """The routing decision: among healthy, accepting replicas (those
        serving the request's pinned bank version first), the smallest
        live queue, round-robin on ties.  Selection only."""
        candidates = [
            r for r in self._members()
            if r.state == REPLICA_HEALTHY and r.accepting.is_set()
        ]
        if not candidates:
            return None
        pinned = [
            r for r in candidates if r.bank_version == request.pinned_version
        ]
        pool = pinned or candidates
        offset = next(self._rr)
        return min(
            enumerate(pool),
            key=lambda ir: (ir[1].queue_depth, (ir[0] + offset) % len(pool)),
        )[1]

    def _route(self, request: _RoutedRequest) -> None:
        replica = self._pick(request)
        if replica is None:
            self._tel.counter("router.unroutable").inc()
            request.future.resolve({
                "status": STATUS_ERROR,
                "reason": "no healthy replica to route to",
            })
            return
        with self._lock:
            self._outstanding.setdefault(replica.name, {})[request.rid] = request
        try:
            # the router owns the journey id: a rerouted request keeps its
            # trace id and its hop count grows
            inner = replica.submit(
                request.text, deadline_ms=self._remaining_ms(request),
                trace_id=f"r-{request.rid}", hops=request.attempts,
                tenant=request.tenant,
            )
        except ReplicaDead:
            with self._lock:
                self._outstanding.get(replica.name, {}).pop(request.rid, None)
            self._reroute(request, reason=f"{replica.name} died at submit")
            return
        self._tel.counter("router.routed").inc()
        inner.add_done_callback(
            lambda response, request=request, replica=replica: self._on_inner(
                request, replica, response
            )
        )

    def _remaining_ms(self, request: _RoutedRequest) -> Optional[float]:
        """The deadline budget left for a (re-)submission.  Explicit 0
        and unlimited requests stay unlimited; everything else hands the
        replica the original absolute deadline, not a fresh window."""
        if request.deadline_monotonic is None:
            # deadline_ms was 0/negative (explicitly unlimited) or the
            # default resolved to unlimited — keep it that way
            return request.deadline_ms if request.deadline_ms is not None else None
        return max(
            1e-3, (request.deadline_monotonic - time.monotonic()) * 1000.0
        )

    def _on_inner(
        self, request: _RoutedRequest, replica: Replica, response: Dict[str, Any]
    ) -> None:
        """Relay a replica's resolution to the client future.  A
        ``"drain"`` from a replica that is restarting (fleet not
        draining) is the replica's problem, not the client's — it
        re-routes instead of surfacing."""
        with self._lock:
            self._outstanding.get(replica.name, {}).pop(request.rid, None)
        status = response.get("status")
        if status == STATUS_DRAIN and not self._draining.is_set():
            self._reroute(request, reason=f"{replica.name} drained")
            return
        out = dict(response)
        out["replica"] = replica.name
        if request.attempts:
            # how many replica deaths this journey survived — the SLO
            # harness and the trace records split outcomes on it
            out["reroutes"] = request.attempts
        if request.future.resolve(out) and status == STATUS_OK:
            self._tel.counter("router.served").inc()

    def _reroute(self, request: _RoutedRequest, reason: str) -> None:
        """Re-enqueue a request its replica never answered.  Terminal
        statuses when re-routing is pointless: past its deadline →
        ``"deadline"``; out of attempts / fleet draining → ``"error"``
        with the cause.  Counted per cause so the SLO harness can split
        them."""
        if request.future.done():
            return
        if (
            request.deadline_monotonic is not None
            and time.monotonic() > request.deadline_monotonic
        ):
            self._tel.counter("router.reroute_deadline").inc()
            request.future.resolve({
                "status": STATUS_DEADLINE, "reroutes": request.attempts,
            })
            return
        request.attempts += 1
        if request.attempts > self.config.max_reroutes or self._draining.is_set():
            self._tel.counter("router.reroute_exhausted").inc()
            request.future.resolve({
                "status": STATUS_ERROR,
                "reason": f"re-route attempts exhausted ({reason})",
                "reroutes": request.attempts,
            })
            return
        self._tel.counter("router.reroutes").inc()
        self._route(request)

    # -- fleet health (monitor thread) -----------------------------------------

    def _monitor_loop(self) -> None:
        cfg = self.config
        while not self._draining.wait(cfg.monitor_interval_s):
            for replica in self._members():
                state = replica.check_health(
                    cfg.heartbeat_timeout_s, cfg.max_batch_errors
                )
                if state == REPLICA_SWAPPING:
                    continue  # the rolling swap owns it
                if state == REPLICA_DEAD:
                    self._recover(replica, dead=True)
                elif state == REPLICA_UNHEALTHY and cfg.auto_restart:
                    self._recover(replica, dead=False)

    def _recover(self, replica: Replica, dead: bool) -> None:
        """Evict + re-enqueue + (optionally) restart one failed replica.
        Runs on a dedicated thread per incident so one slow restart
        never blinds the monitor to the rest of the fleet."""
        with self._lock:
            if self._recovering.get(replica.name):
                return
            self._recovering[replica.name] = True
        if dead:
            self._tel.counter("router.replica_deaths").inc()
            self._tel.event("replica_dead", replica=replica.name)
            recorder = getattr(self, "incident_recorder", None)
            if recorder is not None:  # a bounded-queue put, never blocks
                recorder.trigger("replica_dead", {"replica": replica.name})
        thread = threading.Thread(
            target=_recover_replica,
            args=(self, replica, dead),
            name=f"memvul-router-recover-{replica.name}",
            daemon=True,
        )
        thread.start()

    def _reclaim(self, replica: Replica, reason: str) -> None:
        """Take every routed request still charged to ``replica`` and
        re-enqueue the unresolved ones (resolved ones were popped by
        their callbacks; ``ScoreFuture``'s first-resolution-wins makes
        the race benign)."""
        with self._lock:
            taken = self._outstanding.get(replica.name, {})
            self._outstanding[replica.name] = {}
        for request in taken.values():
            if not request.future.done():
                self._reroute(request, reason=reason)

    # -- live membership (serving/autoscaler.py) -------------------------------

    def admit_replica(self, replica: Replica) -> None:
        """Add a warmed replica to the routing set.  Membership
        bookkeeping only: the spawn's build, warmup and bank sync already
        ran on the autoscaler's worker thread."""
        if self._draining.is_set():
            raise RuntimeError("cannot admit a replica into a draining fleet")
        if self._shadow_tap is not None:
            replica.set_shadow_tap(self._shadow_tap)
        with self._lock:
            if any(r.name == replica.name for r in self.replicas):
                raise ValueError(f"{replica.name} is already a member")
            self.replicas.append(replica)
            self._outstanding.setdefault(replica.name, {})
            count = len(self.replicas)
        self._tel.gauge("router.replicas").set(count)
        self._tel.counter("router.replica_admits").inc()
        self._tel.event("replica_admit", replica=replica.name, replicas=count)

    def retire_replica(self, replica: Replica) -> None:
        """Remove a drained replica from the routing set and re-enqueue
        anything still charged to it (a retire never loses a request: the
        invariant sums over ``retired_replicas`` too).  The caller stops
        routing to it and drains it first (serving/autoscaler.py)."""
        with self._lock:
            if len(self.replicas) <= 1:
                raise ValueError("cannot retire the last replica")
            try:
                self.replicas.remove(replica)
            except ValueError:
                raise ValueError(f"{replica.name} is not a member") from None
            taken = self._outstanding.pop(replica.name, {})
            self.retired_replicas.append(replica)
            count = len(self.replicas)
        for request in taken.values():
            if not request.future.done():
                self._reroute(request, reason=f"{replica.name} retired")
        self._tel.gauge("router.replicas").set(count)
        self._tel.counter("router.replica_retires").inc()
        self._tel.event("replica_retire", replica=replica.name, replicas=count)

    # -- shutdown --------------------------------------------------------------

    def request_drain(self) -> None:
        """Begin fleet drain (async-signal-safe: sets a flag)."""
        self._draining.set()

    def drain(self, timeout: Optional[float] = 30.0) -> None:
        """Graceful fleet shutdown: stop the monitors, drain every replica
        (their queued requests resolve ``"drain"`` and, the fleet
        draining, reach the clients), close their registries, resolve any
        stragglers.  Idempotent."""
        self.request_drain()
        self._monitor.join(timeout)
        stop_attached(self)
        for replica in self._members():
            replica.close(timeout=timeout or 30.0)
        with self._lock:
            leftovers = [
                request
                for per_replica in self._outstanding.values()
                for request in per_replica.values()
            ]
            for per_replica in self._outstanding.values():
                per_replica.clear()
        for request in leftovers:
            request.future.resolve({"status": STATUS_DRAIN})
        self._tel.event("router_drained")



def _recover_replica(router: ReplicaRouter, replica: Replica, dead: bool) -> None:
    """Control-plane recovery of one failed replica: sweep and re-enqueue
    what it owed, then (with ``auto_restart``) restart it through the
    shared :class:`RetryPolicy` and re-install the fleet's bank before
    readmission.  Outside the router class: a restart encodes and warms,
    which routing never does; the monitor only starts this worker."""
    tel = router._tel
    cfg = router.config
    try:
        if dead:
            # account the abandoned requests on the replica's own
            # registry (serve.errors / serve.errors_lost) so the
            # fleet-wide counter invariant survives the death
            replica.sweep_unresolved()
        router._reclaim(
            replica,
            reason=f"{replica.name} {'died' if dead else 'went unhealthy'}",
        )
        if not cfg.auto_restart or router._draining.is_set():
            return
        try:
            restart = lambda: replica.restart(
                drain_timeout_s=cfg.restart_drain_timeout_s
            )
            if router.retry_policy is not None:
                router.retry_policy.call(
                    restart, description=f"restart {replica.name}"
                )
            else:
                restart()
        except Exception as e:  # noqa: BLE001 - a replica restart may fail
            # for any predictor/device reason; the fleet must keep serving
            replica.kill(reason=f"restart failed: {e}")
            replica.sweep_unresolved()
            tel.counter("router.restart_failures").inc()
            tel.event(
                "replica_restart_failed",
                replica=replica.name,
                reason=str(e)[:200],
            )
            logger.error("%s restart failed: %s", replica.name, e)
            return
        # the rebuilt service carries the factory-built bank; sync it to
        # the fleet's current rollout BEFORE readmission — a death
        # mid-rollout cannot resurrect the old bank
        _sync_bank(router, replica)
        tel.counter("router.replica_restarts").inc()
        tel.event(
            "replica_restart", replica=replica.name, n=replica.restart_count
        )
    finally:
        with router._lock:
            router._recovering[replica.name] = False


def _sync_bank(router: ReplicaRouter, replica: Replica) -> None:
    """Install the fleet's current banks (the default's and every named
    tenant's) on a rebuilt replica before it is readmitted, under the swap
    lock so the install serializes with a rolling swap."""
    with router._swap_lock:
        if (
            router._bank_instances is not None
            and replica.bank_version != router._active_version
        ):
            replica.accepting.clear()
            replica.install_bank(
                router._bank_instances, version=router._active_version,
                source=router._bank_source,
                store_version=router._bank_store_version,
            )
            replica.accepting.set()
        # the factory builds only the default bank: re-roll every named one
        for tenant, (instances, source, store_version, version) in (
            router._tenant_banks.items()
        ):
            replica.accepting.clear()
            replica.install_bank(
                instances, version=version,
                source=source, store_version=store_version, tenant=tenant,
            )
            replica.accepting.set()


def rolling_swap(
    router: ReplicaRouter,
    anchor_instances: Iterable[Dict],
    drain_timeout_s: float = 30.0,
    poll_interval_s: float = 0.01,
    source: str = "rolling_swap",
    store_version: Optional[str] = None,
    tenant: Optional[str] = None,
) -> int:
    """Roll a new anchor bank across the fleet, one replica at a time.

    Per replica: **stop routing** to it (readmission gate), **drain**
    its private queue (in-flight work finishes on the old snapshot),
    **install** the new bank at the next fleet version (encode + AOT
    pre-warm happen inside ``swap_bank``, off every other replica's
    request path), then **readmit** it.  The fleet's active version —
    which new admissions pin to — advances only after every live
    replica serves the new bank, so no client ever observes a torn
    rollout: responses during the roll are each stamped with exactly
    one version, and once the fleet version advances, new requests
    prefer new-bank replicas.

    Control-plane code: it runs in the caller's thread, outside the
    router class.  Returns the new fleet version.

    ``tenant`` scopes the roll to one named tenant's bank: the same
    per-replica stop, drain, install and readmit, but the fleet's default
    version, which admissions pin to, is untouched, so a tenant rollout
    never tears another tenant's responses.  The tenant's fleet version
    advances on its own and is recorded for the re-install on restart
    (``_sync_bank``).
    """
    instances = list(anchor_instances)
    tel = router._tel
    named = tenant is not None and tenant != DEFAULT_TENANT
    with router._swap_lock:
        if named:
            prior = router._tenant_banks.get(tenant)
            target = prior[3] + 1 if prior is not None else 1
        else:
            target = router._active_version + 1
        tel.event(
            "rolling_swap_start", version=target,
            replicas=len(router.replicas),
            tenant=tenant if named else DEFAULT_TENANT,
        )
        with tel.span("router.rolling_swap", version=target):
            for replica in router._members():
                if replica.state == REPLICA_DEAD:
                    # its restart re-installs the fleet bank before readmission
                    continue
                with replica._state_lock:
                    previous_state = replica.state
                    replica.state = REPLICA_SWAPPING
                replica.accepting.clear()
                tel.event("replica_swap_begin", replica=replica.name)
                deadline = time.monotonic() + drain_timeout_s
                while (
                    replica.service.queue_depth > 0
                    and time.monotonic() < deadline
                ):
                    time.sleep(poll_interval_s)
                replica.install_bank(
                    instances, version=target,
                    source=source, store_version=store_version,
                    tenant=tenant if named else None,
                )
                with replica._state_lock:
                    # a replica killed during its install stays dead: its
                    # recovery restarts it and re-installs the fleet bank
                    alive = replica.state != REPLICA_DEAD
                    if alive:
                        replica.state = previous_state
                if alive:
                    replica.accepting.set()
                tel.event(
                    "replica_swap_done", replica=replica.name, version=target,
                    alive=alive,
                )
        if named:
            router._tenant_banks[tenant] = (
                instances, source, store_version, target
            )
        else:
            router._bank_instances = instances
            router._bank_source = source
            router._bank_store_version = store_version
            router._active_version = target
    tel.counter("router.bank_swaps").inc()
    if named:
        tel.gauge(f"bank.{tenant}.version").set(target)
    else:
        tel.gauge("router.bank_version").set(target)
    tel.event(
        "rolling_swap_done", version=target,
        tenant=tenant if named else DEFAULT_TENANT,
    )
    logger.info(
        "rolling swap complete: %s at bank v%d (%d replicas)",
        f"tenant {tenant}" if named else "fleet", target,
        len(router.replicas),
    )
    return target

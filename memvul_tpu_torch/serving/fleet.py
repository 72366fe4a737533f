"""Cross-host fleet supervision: a balancer over serving hosts (the JAX
package's ``serving/fleet.py``).

A :class:`~memvul_tpu_torch.serving.router.ReplicaRouter` ends its blast
radius at one process.  This module lifts the sharded scorer's supervision
(heartbeat-age stall detection, backoff restarts through the shared
:class:`~memvul_tpu_torch.resilience.retry.RetryPolicy`, quarantine with a
machine-readable refusal) from shard workers to whole serving hosts:

* :class:`HostBalancer` — spreads load across hosts (least queued,
  round-robin on ties), merges ``/healthz``, ``/metrics``, ``/tracez`` and
  ``/programz`` across them, and routes around dead or stalled hosts.  A
  request a lost host owed goes to a survivor with its **original absolute
  deadline**, so the invariant ``Σ served + shed + errors == Σ requests``
  holds summed over every host's replicas, live and retired;
* :class:`LocalHost` — an in-process host over a serving target (a router
  or a service) built by a factory; its submit path carries the
  ``host.kill`` / ``host.stall`` fault points;
* :class:`ProcessHost` — a host in a process of its own, driven over HTTP:
  ``python -m memvul_tpu_torch serve ... --port 0`` on the other end, its
  ``{"serving": url}`` banner read at start, its health sampled from
  ``/healthz``, killed with ``killpg``.  :func:`start_process_hosts`
  starts several at once (each start loads the archive, encodes the bank
  and warms, on the card about 20 s).

:func:`enumerate_hosts` resolves an explicit ``host[:port]`` list or
``MEMVUL_FLEET_HOSTS``, and expands ``MEMVUL_FLEET_HOST_TEMPLATE`` over the
``torch.distributed`` world only when a process group is initialized.

The balancer's routing methods read cached state and pick; every blocking
operation (kills, restart backoff, drains) runs in the module-level
recovery workers on threads of their own.

Metrics (``fleet.*``): the ``fleet.hosts`` / ``fleet.hosts_alive`` gauges,
per-host ``fleet.heartbeat_age_s.<host>`` gauges, and the request-path
counters one level above ``router.*`` (``fleet.requests`` …
``fleet.quarantined``).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import os
import subprocess
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..parallel import multihost
from ..resilience import faults
from ..telemetry import get_registry
from .client import HTTPClient
from .service import (
    STATUS_DEADLINE,
    STATUS_DRAIN,
    STATUS_ERROR,
    STATUS_OK,
    ScoreFuture,
    stop_attached,
)

logger = logging.getLogger(__name__)

HOST_STARTING = "starting"
HOST_HEALTHY = "healthy"
HOST_UNHEALTHY = "unhealthy"
HOST_DEAD = "dead"
HOST_QUARANTINED = "quarantined"  # terminal: out of restart budget


class HostDead(RuntimeError):
    """Raised by a host's submit when the host cannot take requests."""


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Host-supervision knobs; the ``fleet_*`` keys of
    ``config.SERVING_DEFAULTS`` are the JSON-facing view."""

    heartbeat_timeout_s: float = 10.0  # stall eviction threshold
    monitor_interval_s: float = 0.25   # health-check cadence
    max_reroutes: int = 2              # re-enqueue attempts per request
    auto_restart: bool = True
    max_restarts: int = 2              # per host, then quarantine
    restart_backoff_s: float = 0.5     # exponential base between attempts

    @classmethod
    def from_serving(cls, serve_cfg: Dict[str, Any]) -> "FleetConfig":
        """The knobs of a merged ``serving`` section (``config.serving_config``)."""
        return cls(
            heartbeat_timeout_s=float(serve_cfg["fleet_heartbeat_timeout_s"]),
            monitor_interval_s=float(serve_cfg["fleet_monitor_interval_s"]),
            max_reroutes=int(serve_cfg["fleet_max_reroutes"]),
            max_restarts=int(serve_cfg["fleet_max_restarts"]),
        )


@dataclasses.dataclass
class _FleetRequest:
    """The balancer's record of one client request — it outlives any
    single host, so a host death can re-enqueue it with the original
    absolute deadline."""

    rid: int
    text: str
    deadline_ms: Optional[float]
    deadline_monotonic: Optional[float]
    future: ScoreFuture
    attempts: int = 0
    tenant: Optional[str] = None


class LocalHost:
    """One in-process serving host.

    ``target_factory()`` builds the host's serving target — a
    :class:`ReplicaRouter` or bare :class:`ScoringService` — and is
    re-invoked on :meth:`restart`, so a restarted host comes back the
    way a fresh one starts (bank encode and warmup included).  The submit path
    carries the ``host.kill``/``host.stall`` chaos points: a kill takes
    every replica down with SIGKILL semantics (nothing resolves; the
    balancer must sweep + re-route), a stall wedges the host alive —
    accepting, no progress, futures parked, heartbeat frozen — so the
    balancer's heartbeat-age detector is the only thing that can catch
    it.
    """

    def __init__(self, index: int, target_factory: Callable[[], Any]) -> None:
        self.index = int(index)
        self.name = f"host-{self.index}"
        self._factory = target_factory
        self.state = HOST_STARTING
        self.accepting = threading.Event()
        self.restart_count = 0
        self._state_lock = threading.Lock()
        self._stalled_at: Optional[float] = None
        # futures accepted while stalled: parked, never resolved by the
        # target (they never reach it) — the balancer re-routes from its
        # own records once the stall detector fires
        self._wedged: List[ScoreFuture] = []
        self.target = target_factory()
        self.state = HOST_HEALTHY
        self.accepting.set()

    # -- request path ----------------------------------------------------------

    def submit(
        self,
        text: str,
        deadline_ms: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> ScoreFuture:
        if self.state in (HOST_DEAD, HOST_QUARANTINED):
            raise HostDead(f"{self.name} is {self.state}")
        try:
            faults.fault_point(f"host.kill.{self.name}")
            faults.fault_point("host.kill")
        except Exception as e:
            self.kill(reason=f"injected: {e}")
            raise HostDead(f"{self.name} killed by fault injection") from e
        try:
            faults.fault_point(f"host.stall.{self.name}")
            faults.fault_point("host.stall")
        except Exception:
            self._stall()
        if self._stalled_at is not None:
            future = ScoreFuture()
            self._wedged.append(future)
            return future
        if tenant is None:
            return self.target.submit(text, deadline_ms=deadline_ms)
        return self.target.submit(text, deadline_ms=deadline_ms, tenant=tenant)

    def _stall(self) -> None:
        """Wedge: stay alive and accepting, make no progress.  The
        heartbeat freezes here, so its age grows until the balancer's
        stall detector trips."""
        if self._stalled_at is None:
            self._stalled_at = time.monotonic()
            logger.warning("%s stalled (injected)", self.name)

    @property
    def alive(self) -> bool:
        return self.state in (HOST_STARTING, HOST_HEALTHY, HOST_UNHEALTHY)

    @property
    def queue_depth(self) -> int:
        if not self.alive:
            return 0
        return self.target.queue_depth

    @property
    def default_deadline_ms(self) -> float:
        return self.target.default_deadline_ms

    def heartbeat_age_s(self) -> float:
        """The host-level stall clock: a stalled host's age grows from
        the stall instant; a live router host reports its freshest
        replica (one live replica means the host process breathes)."""
        if self._stalled_at is not None:
            return max(0.0, time.monotonic() - self._stalled_at)
        replicas = getattr(self.target, "replicas", None)
        if replicas:
            return min(r.heartbeat_age_s() for r in replicas)
        return 0.0

    def check_health(self, heartbeat_timeout_s: float) -> bool:
        """Monitor-loop probe: False once the host is dead or its
        heartbeat age crosses the stall threshold."""
        if not self.alive:
            return False
        return self.heartbeat_age_s() <= heartbeat_timeout_s

    # -- lifecycle -------------------------------------------------------------

    def kill(self, reason: str = "killed") -> None:
        """Whole-host SIGKILL semantics: every replica dies mid-flight
        and their unresolved requests are swept into ``serve.errors`` —
        the per-replica counters stay summable, so the cross-host
        invariant still balances after the host is gone."""
        with self._state_lock:
            if self.state in (HOST_DEAD, HOST_QUARANTINED):
                return
            self.state = HOST_DEAD
        self.accepting.clear()
        replicas = getattr(self.target, "replicas", None)
        if replicas is not None:
            for replica in list(replicas):
                replica.kill(reason=f"{self.name}: {reason}")
                replica.sweep_unresolved()
        else:
            self.target.hard_kill()
            self.target.take_unresolved()
        logger.error("%s dead: %s", self.name, reason)

    def restart(self) -> None:
        """Rebuild the target through the factory — the same cold-start
        path as construction.  Raises whatever the factory raises (the
        balancer's RetryPolicy owns the retries)."""
        self.restart_count += 1
        self._stalled_at = None
        self._wedged = []
        self.target = self._factory()
        with self._state_lock:
            self.state = HOST_HEALTHY
        self.accepting.set()
        logger.info("%s restarted (attempt %d)", self.name, self.restart_count)

    def quarantine(self) -> None:
        with self._state_lock:
            self.state = HOST_QUARANTINED
        self.accepting.clear()

    def request_drain(self) -> None:
        if self.alive:
            self.target.request_drain()

    def drain(self, timeout: Optional[float] = 30.0) -> None:
        if self.alive:
            self.target.drain(timeout=timeout)

    # -- merged-endpoint fan-in ------------------------------------------------

    def health_summary(self) -> Dict[str, Any]:
        row: Dict[str, Any] = {
            "host": self.name,
            "state": self.state,
            "restarts": self.restart_count,
            "heartbeat_age_s": round(self.heartbeat_age_s(), 3),
        }
        if self.alive and self._stalled_at is None:
            row["target"] = self.target.health_summary()
        return row

    def metrics_snapshots(self) -> List:
        """The target's snapshot parts, each stamped with this host's
        label — a fleet scrape separates hosts the way a router scrape
        separates replicas."""
        if not self.alive:
            return []
        parts = []
        for labels, snap in self.target.metrics_snapshots():
            parts.append(({"host": self.name, **dict(labels)}, snap))
        return parts

    def recent_traces(self) -> List[Dict[str, Any]]:
        if not self.alive or self._stalled_at is not None:
            return []
        return self.target.recent_traces()

    def programs_snapshot(self) -> List[Dict[str, Any]]:
        if not self.alive or self._stalled_at is not None:
            return []
        rows = []
        for row in self.target.programs_snapshot():
            row = dict(row)
            row["host"] = self.name
            rows.append(row)
        return rows

    def members(self) -> List:
        """Every replica this host has ever admitted (live + retired) —
        the unit of the cross-host counter invariant."""
        replicas = list(getattr(self.target, "replicas", ()) or ())
        replicas.extend(getattr(self.target, "retired_replicas", ()) or ())
        return replicas


class ProcessHost:
    """A serving host in a process of its own, driven over HTTP.

    ``argv`` launches ``python -m memvul_tpu_torch serve ... --port 0`` (or
    any program printing the same one-line ``{"serving": url, ...}`` JSON
    banner on stdout) in a session of its own, so one ``killpg`` takes the
    whole host; the banner is awaited for at most ``startup_timeout_s``.
    The health and queue view is sampled from ``/healthz`` by
    :meth:`check_health` (the monitor's cadence), so the balancer's
    routing reads only the cached sample, never a socket.  ``url=``
    attaches to a host that is already running (``serve --hosts``);
    ``log_path`` receives the host's stderr."""

    def __init__(
        self,
        index: int,
        argv: Optional[Sequence[str]] = None,
        url: Optional[str] = None,
        startup_timeout_s: float = 120.0,
        request_timeout_s: float = 60.0,
        log_path: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
    ) -> None:
        if (argv is None) == (url is None):
            raise ValueError("ProcessHost needs exactly one of argv= or url=")
        self.index = int(index)
        self.name = f"host-{self.index}"
        self.argv = list(argv) if argv is not None else None
        self.proc: Optional[subprocess.Popen] = None
        self.state = HOST_STARTING
        self.accepting = threading.Event()
        self.restart_count = 0
        self.start_seconds: List[float] = []  # each launch's start, to the banner
        self._state_lock = threading.Lock()
        self._request_timeout_s = request_timeout_s
        self._startup_timeout_s = startup_timeout_s
        self._log_path = log_path
        self._env = env
        self._last_progress = time.monotonic()
        self._cached_health: Dict[str, Any] = {}
        if url is not None:
            self.base_url = url.rstrip("/")
            self.client = HTTPClient(self.base_url, timeout_s=request_timeout_s)
            self.state = HOST_HEALTHY
            self.accepting.set()
        else:
            self._launch()

    def _launch(self) -> None:
        assert self.argv is not None
        t0 = time.monotonic()
        stderr = subprocess.DEVNULL
        if self._log_path:
            # the child's stderr log, not a committed artifact: the child
            # appends to it directly and no reader parses it
            stderr = open(self._log_path, "ab")  # lint: disable=MV103
        try:
            self.proc = subprocess.Popen(
                self.argv,
                stdout=subprocess.PIPE,
                stderr=stderr,
                text=True,
                env=self._env,
                start_new_session=True,  # one killpg takes the whole host
            )
        finally:
            if stderr is not subprocess.DEVNULL:
                stderr.close()
        banner = _read_banner(self.proc, self._startup_timeout_s)
        if banner is None:
            from ..distributed.coordinator import _kill_process_group

            _kill_process_group(self.proc, grace=0)
            raise HostDead(
                f"{self.name} printed no serving banner within {self._startup_timeout_s:g}s"
            )
        self.base_url = str(banner["serving"]).rstrip("/")
        self.client = HTTPClient(self.base_url, timeout_s=self._request_timeout_s)
        self._cached_health = {}
        self._last_progress = time.monotonic()
        self.start_seconds.append(self._last_progress - t0)
        with self._state_lock:
            self.state = HOST_HEALTHY
        self.accepting.set()

    # -- request path ----------------------------------------------------------

    def submit(
        self, text: str, deadline_ms: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> ScoreFuture:
        if self.state in (HOST_DEAD, HOST_QUARANTINED):
            raise HostDead(f"{self.name} is {self.state}")
        future = ScoreFuture()

        def relay() -> None:
            try:
                future.resolve(self.client.score(text, deadline_ms=deadline_ms, tenant=tenant))
            except Exception as e:  # noqa: BLE001 - connection refusals
                # resolve as an error; the balancer re-routes on it
                future.resolve({
                    "status": STATUS_ERROR,
                    "reason": f"host_unreachable: {type(e).__name__}: {e}",
                })

        threading.Thread(
            target=relay, name=f"memvul-{self.name}-relay", daemon=True
        ).start()
        return future

    @property
    def alive(self) -> bool:
        if self.proc is not None and self.proc.poll() is not None:
            return False
        return self.state in (HOST_STARTING, HOST_HEALTHY, HOST_UNHEALTHY)

    @property
    def queue_depth(self) -> int:
        return int(self._cached_health.get("queue_depth", 0) or 0)

    @property
    def default_deadline_ms(self) -> float:
        return float(self._cached_health.get("default_deadline_ms", 0.0) or 0.0)

    def heartbeat_age_s(self) -> float:
        return max(0.0, time.monotonic() - self._last_progress)

    def check_health(self, heartbeat_timeout_s: float) -> bool:
        """Poll ``/healthz`` (monitor thread only) and refresh the
        cached sample the routing methods read.  A reachable, responsive
        host is progress; a dead socket or wedged server lets the
        heartbeat age grow until the stall threshold trips."""
        if not self.alive:
            return False
        try:
            body = self.client._request(
                urllib.request.Request(self.base_url + "/healthz", method="GET"),
                timeout_s=min(heartbeat_timeout_s, 5.0),
            )
        except Exception:  # noqa: BLE001 - connection refused == no progress
            body = None
        if body and "status" in body and body.get("status") != "error":
            self._cached_health = body
            self._last_progress = time.monotonic()
        return self.heartbeat_age_s() <= heartbeat_timeout_s

    # -- lifecycle -------------------------------------------------------------

    def kill(self, reason: str = "killed") -> None:
        with self._state_lock:
            if self.state in (HOST_DEAD, HOST_QUARANTINED):
                return
            self.state = HOST_DEAD
        self.accepting.clear()
        if self.proc is not None and self.proc.poll() is None:
            from ..distributed.coordinator import _kill_process_group

            _kill_process_group(self.proc)
        elif self.proc is not None:
            self.proc.wait(timeout=10)
        logger.error("%s dead: %s", self.name, reason)

    def restart(self) -> None:
        if self.argv is None:
            raise HostDead(f"{self.name} is attach-only (url=): cannot relaunch")
        self.restart_count += 1
        self._launch()
        logger.info("%s restarted (attempt %d)", self.name, self.restart_count)

    def quarantine(self) -> None:
        with self._state_lock:
            self.state = HOST_QUARANTINED
        self.accepting.clear()

    def request_drain(self) -> None:
        return None  # the host process owns its own drain (SIGTERM path)

    def drain(self, timeout: Optional[float] = 30.0) -> None:
        return None

    def stop(self, timeout: float = 60.0) -> None:
        """End a launched host: SIGTERM its session (the serve process
        drains), then SIGKILL after ``timeout``.  Attach-only hosts are
        left running."""
        if self.proc is None or self.proc.poll() is not None:
            return
        from ..distributed.coordinator import _kill_process_group

        _kill_process_group(self.proc, grace=timeout)

    # -- merged-endpoint fan-in ------------------------------------------------

    def health_summary(self) -> Dict[str, Any]:
        row: Dict[str, Any] = {
            "host": self.name,
            "state": self.state,
            "restarts": self.restart_count,
            "heartbeat_age_s": round(self.heartbeat_age_s(), 3),
            "url": getattr(self, "base_url", None),
        }
        if self._cached_health:
            row["target"] = self._cached_health
        return row

    def metrics_snapshots(self) -> List:
        """A coarse host-label part from the cached ``/healthz`` sample
        (queue depth + liveness) — the full per-replica parts live on
        the host's own ``/metrics``, which a scraper reaches directly;
        the merged view answers "is the fleet moving", not "what is
        replica 3 doing"."""
        return [(
            {"host": self.name},
            {"counters": {}, "gauges": {
                "host.up": 1.0 if self.alive else 0.0,
                "host.queue_depth": float(self.queue_depth),
            }, "histograms": {}},
        )]

    def recent_traces(self) -> List[Dict[str, Any]]:
        return []

    def programs_snapshot(self) -> List[Dict[str, Any]]:
        """The host's ``GET /programz`` rows, each stamped with this
        host's name (monitor-independent: a socket read, for the merged
        view and the incident bundle only)."""
        body = self.programz()
        rows = []
        for row in body.get("programs", []):
            row = dict(row)
            row["host"] = self.name
            rows.append(row)
        return rows

    def programz(self, timeout_s: float = 10.0) -> Dict[str, Any]:
        """The host's whole ``GET /programz`` body (rows, roofline and the
        kernels' launch counts); ``{}`` when the host does not answer."""
        if not self.alive or getattr(self, "base_url", None) is None:
            return {}
        try:
            return self.client._request(
                urllib.request.Request(self.base_url + "/programz", method="GET"),
                timeout_s=timeout_s,
            )
        except Exception:  # noqa: BLE001 - a dead host answers nothing
            return {}

    def members(self) -> List:
        return []


class HostBalancer:
    """Load-balancing dispatch over a fleet of hosts.

    The public surface mirrors :class:`ScoringService` — ``submit`` /
    ``queue_depth`` / ``draining`` / ``health_summary`` /
    ``metrics_snapshots`` / ``recent_traces`` / ``programs_snapshot`` /
    ``request_drain`` / ``drain`` — so serving/frontend.py serves a
    whole fleet through the same handlers that serve one replica.
    """

    def __init__(
        self,
        hosts: Sequence,
        config: Optional[FleetConfig] = None,
        retry_policy=None,
        registry=None,
    ) -> None:
        if not hosts:
            raise ValueError("a balancer needs at least one host")
        self.hosts = list(hosts)
        self.config = config or FleetConfig()
        self.retry_policy = retry_policy
        self._tel = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._rid = itertools.count(1)
        self._rr = itertools.count()
        self._outstanding: Dict[str, Dict[int, _FleetRequest]] = {
            h.name: {} for h in self.hosts
        }
        self._draining = threading.Event()
        self._recovering: Dict[str, bool] = {}
        self._default_deadline_ms = self.hosts[0].default_deadline_ms
        self._stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="memvul-fleet-monitor", daemon=True
        )
        self._monitor.start()
        self._tel.gauge("fleet.hosts").set(len(self.hosts))
        self._tel.gauge("fleet.hosts_alive").set(
            sum(1 for h in self.hosts if h.alive)
        )
        self._tel.event("fleet_start", hosts=len(self.hosts))

    # -- ScoringService-compatible surface ------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @property
    def queue_depth(self) -> int:
        return sum(h.queue_depth for h in self.hosts if h.alive)

    @property
    def default_deadline_ms(self) -> float:
        return self._default_deadline_ms

    def health_summary(self) -> Dict[str, Any]:
        """The merged fleet ``/healthz``: per-host rows plus the
        roll-up an external probe routes on — ``ok`` / ``degraded`` /
        ``unavailable`` with the quarantined hosts named, so a refusal
        is explicable from the probe body alone."""
        draining = self._draining.is_set()
        members = [h.health_summary() for h in self.hosts]
        alive = sum(1 for h in self.hosts if h.alive)
        quarantined = [
            h.name for h in self.hosts if h.state == HOST_QUARANTINED
        ]
        if draining:
            status = "draining"
        elif alive == len(self.hosts):
            status = "ok"
        elif alive > 0:
            status = "degraded"
        else:
            status = "unavailable"
        return {
            "status": status,
            "draining": draining,
            "queue_depth": self.queue_depth,
            "hosts": {
                "total": len(self.hosts),
                "alive": alive,
                "quarantined": quarantined,
                "members": members,
            },
        }

    def metrics_snapshots(self) -> List:
        """Fleet ``/metrics``: the balancer's own registry (``fleet.*``)
        unlabeled, plus every live host's parts under its ``host``
        label: snapshot reads only."""
        parts: List = [({}, self._tel.snapshot())]
        for host in self.hosts:
            parts.extend(host.metrics_snapshots())
        return parts

    def recent_traces(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        records: List[Dict[str, Any]] = []
        for host in self.hosts:
            records.extend(host.recent_traces())
        records.sort(
            key=lambda r: -(r.get("waypoints", {}).get("resolved") or 0.0)
        )
        return records[: int(limit)] if limit else records

    def programs_snapshot(self) -> List[Dict[str, Any]]:
        rows: List[Dict[str, Any]] = []
        for host in self.hosts:
            rows.extend(host.programs_snapshot())
        rows.sort(key=lambda r: -(r.get("compiled_wall") or 0.0))
        return rows

    def members(self) -> List:
        """Every replica across every host, live and retired — what the
        cross-host invariant sums over (loadgen.fleet_snapshot)."""
        out: List = []
        for host in self.hosts:
            out.extend(host.members())
        return out

    # -- dispatch --------------------------------------------------------------

    def submit(
        self, text: str, deadline_ms: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> ScoreFuture:
        """Route one request to the least-loaded live host and relay its
        response (``tenant`` travels with it).  The returned future ALWAYS
        resolves — via the host, via a re-route after a host death, or via
        the balancer's own deadline/drain/exhaustion terminal statuses."""
        future = ScoreFuture()
        self._tel.counter("fleet.requests").inc()
        if self._draining.is_set():
            self._tel.counter("fleet.shed_drain").inc()
            future.resolve({"status": STATUS_DRAIN})
            return future
        now = time.monotonic()
        effective_ms = (
            self._default_deadline_ms if deadline_ms is None else deadline_ms
        )
        request = _FleetRequest(
            rid=next(self._rid),
            text=text,
            deadline_ms=deadline_ms,
            deadline_monotonic=(
                now + effective_ms / 1000.0 if effective_ms > 0 else None
            ),
            future=future,
            tenant=tenant,
        )
        self._route(request)
        return future

    def _pick(self, request: _FleetRequest):
        """The host-routing decision: among alive, accepting hosts, the
        smallest combined load (host queue + this balancer's in-flight
        charges), round-robin on ties.  Selection only: nothing here
        blocks, polls or scores."""
        candidates = [
            h for h in self.hosts if h.alive and h.accepting.is_set()
        ]
        if not candidates:
            return None
        with self._lock:
            charged = {
                h.name: len(self._outstanding.get(h.name, {}))
                for h in candidates
            }
        offset = next(self._rr)
        return min(
            enumerate(candidates),
            key=lambda ih: (
                ih[1].queue_depth + charged[ih[1].name],
                (ih[0] + offset) % len(candidates),
            ),
        )[1]

    def _route(self, request: _FleetRequest) -> None:
        host = self._pick(request)
        if host is None:
            self._tel.counter("fleet.unroutable").inc()
            request.future.resolve(self._refusal("no live host to route to"))
            return
        with self._lock:
            self._outstanding.setdefault(host.name, {})[request.rid] = request
        try:
            inner = host.submit(
                request.text, deadline_ms=self._remaining_ms(request),
                tenant=request.tenant,
            )
        except HostDead:
            with self._lock:
                self._outstanding.get(host.name, {}).pop(request.rid, None)
            self._reroute(request, reason=f"{host.name} died at submit")
            return
        self._tel.counter("fleet.routed").inc()
        inner.add_done_callback(
            lambda response, request=request, host=host: self._on_inner(
                request, host, response
            )
        )

    def _remaining_ms(self, request: _FleetRequest) -> Optional[float]:
        """Deadline budget left for a (re-)submission: the original
        absolute deadline, never a fresh window (the router's
        ``_remaining_ms`` discipline, one level up)."""
        if request.deadline_monotonic is None:
            return request.deadline_ms if request.deadline_ms is not None else None
        return max(
            1e-3, (request.deadline_monotonic - time.monotonic()) * 1000.0
        )

    def _on_inner(self, request: _FleetRequest, host, response: Dict[str, Any]) -> None:
        with self._lock:
            self._outstanding.get(host.name, {}).pop(request.rid, None)
        status = response.get("status")
        reason = str(response.get("reason", ""))
        if status == STATUS_DRAIN and not self._draining.is_set():
            # the host is restarting/draining, the fleet is not — the
            # client keeps its budget on a survivor
            self._reroute(request, reason=f"{host.name} drained")
            return
        if status == STATUS_ERROR and reason.startswith("host_unreachable"):
            self._reroute(request, reason=f"{host.name} unreachable")
            return
        out = dict(response)
        out["host"] = host.name
        if request.attempts:
            out["host_reroutes"] = request.attempts
        if request.future.resolve(out) and status == STATUS_OK:
            self._tel.counter("fleet.served").inc()

    def _reroute(self, request: _FleetRequest, reason: str) -> None:
        """Re-enqueue a request its host never answered.  Terminal
        statuses when re-routing is pointless: past its original
        deadline → ``"deadline"``; out of attempts / fleet draining →
        a machine-readable refusal.  Counted per cause."""
        if request.future.done():
            return
        if (
            request.deadline_monotonic is not None
            and time.monotonic() > request.deadline_monotonic
        ):
            self._tel.counter("fleet.reroute_deadline").inc()
            request.future.resolve({
                "status": STATUS_DEADLINE,
                "reason": f"deadline expired after {reason}",
            })
            return
        if request.attempts >= self.config.max_reroutes or self._draining.is_set():
            self._tel.counter("fleet.reroute_exhausted").inc()
            request.future.resolve(
                self._refusal(f"reroutes exhausted after {reason}")
            )
            return
        request.attempts += 1
        self._tel.counter("fleet.reroutes").inc()
        self._route(request)

    def _refusal(self, reason: str) -> Dict[str, Any]:
        """The machine-readable refusal body (the sharded scorer's
        quarantine payload, lifted to serving): which hosts are quarantined, which
        are alive, why this request could not be placed."""
        return {
            "status": STATUS_ERROR,
            "reason": reason,
            "refusal": {
                "error": "fleet_unavailable",
                "hosts_alive": sum(1 for h in self.hosts if h.alive),
                "hosts_total": len(self.hosts),
                "quarantined": [
                    h.name for h in self.hosts
                    if h.state == HOST_QUARANTINED
                ],
            },
        }

    # -- supervision -----------------------------------------------------------

    def _monitor_loop(self) -> None:
        interval = max(0.05, self.config.monitor_interval_s)
        while not self._stop.wait(interval):
            if self._draining.is_set():
                return
            alive = 0
            for host in self.hosts:
                if host.state == HOST_QUARANTINED:
                    continue
                self._tel.gauge(
                    f"fleet.heartbeat_age_s.{host.name}"
                ).set(round(host.heartbeat_age_s(), 3))
                healthy = host.check_health(self.config.heartbeat_timeout_s)
                if host.alive:
                    alive += 1
                if not healthy:
                    self._spawn_recovery(host)
            self._tel.gauge("fleet.hosts_alive").set(alive)

    def _spawn_recovery(self, host) -> None:
        """One recovery incident per host at a time — the kill/reclaim/
        backoff/restart sequence blocks, so it runs on its own thread
        (the router's ``_recover`` split, one level up)."""
        with self._lock:
            if self._recovering.get(host.name):
                return
            self._recovering[host.name] = True
        threading.Thread(
            target=_recover_host, args=(self, host),
            name=f"memvul-fleet-recover-{host.name}", daemon=True,
        ).start()

    def _reclaim(self, host, reason: str) -> None:
        """Pull every request charged to a lost host and re-enqueue it
        onto survivors — original absolute deadlines intact."""
        with self._lock:
            taken = self._outstanding.get(host.name, {})
            requests, taken_ids = list(taken.values()), list(taken.keys())
            for rid in taken_ids:
                taken.pop(rid, None)
        for request in requests:
            if not request.future.done():
                self._reroute(request, reason=reason)

    # -- shutdown --------------------------------------------------------------

    def request_drain(self) -> None:
        self._draining.set()
        for host in self.hosts:
            if host.alive:
                host.request_drain()
        self._tel.event("fleet_drain_requested")

    def drain(self, timeout: Optional[float] = 30.0) -> None:
        self._draining.set()
        self._stop.set()
        stop_attached(self)
        for host in self.hosts:
            if host.alive:
                host.drain(timeout=timeout)
        self._reap_all("fleet drained")
        self._tel.event("fleet_drained")

    def _reap_all(self, reason: str) -> None:
        with self._lock:
            requests = [
                r for owed in self._outstanding.values() for r in owed.values()
            ]
            for owed in self._outstanding.values():
                owed.clear()
        for request in requests:
            if not request.future.done():
                self._tel.counter("fleet.reroute_exhausted").inc()
                request.future.resolve(self._refusal(reason))


def _recover_host(balancer: HostBalancer, host) -> None:
    """Per-incident recovery worker: confirm the kill (sweeping every
    replica's unresolved requests into the counters), re-enqueue owed
    requests onto survivors, then buy the host back through the shared
    RetryPolicy's exponential backoff — or quarantine it with a
    machine-readable event once the restart budget is spent."""
    tel = balancer._tel
    cfg = balancer.config
    try:
        # the host may already be dead (a fault on its own submit path
        # killed it before the monitor noticed) — the incident still
        # counts exactly once: the _recovering guard serializes it
        host.kill(reason="fleet monitor: dead or stalled")
        tel.counter("fleet.host_deaths").inc()
        tel.event("fleet_host_dead", host=host.name)
        recorder = getattr(balancer, "incident_recorder", None)
        if recorder is not None:  # non-blocking bounded-queue put
            recorder.trigger("host_dead", {"host": host.name})
        balancer._reclaim(host, reason=f"{host.name} lost")
        if (
            not cfg.auto_restart
            or host.restart_count >= cfg.max_restarts
        ):
            _quarantine_host(balancer, host, "restart budget exhausted")
            return
        try:
            if balancer.retry_policy is not None:
                balancer.retry_policy.call(
                    host.restart, description=f"restart {host.name}"
                )
            else:
                host.restart()
        except Exception as e:  # noqa: BLE001 - a host that cannot come
            # back is quarantined, never retried forever
            tel.counter("fleet.restart_failures").inc()
            _quarantine_host(
                balancer, host, f"restart failed: {type(e).__name__}: {e}"
            )
            return
        tel.counter("fleet.host_restarts").inc()
        tel.event("fleet_host_restarted", host=host.name)
    finally:
        with balancer._lock:
            balancer._recovering[host.name] = False


def _quarantine_host(balancer: HostBalancer, host, reason: str) -> None:
    host.quarantine()
    balancer._tel.counter("fleet.quarantined").inc()
    balancer._tel.event(
        "fleet_host_quarantined",
        host=host.name, restarts=host.restart_count, reason=reason[:200],
    )
    logger.error("%s quarantined: %s", host.name, reason)
    recorder = getattr(balancer, "incident_recorder", None)
    if recorder is not None:  # non-blocking bounded-queue put
        recorder.trigger(
            "host_quarantined", {"host": host.name, "reason": reason[:200]}
        )


def _read_banner(proc: subprocess.Popen, timeout_s: float) -> Optional[Dict[str, Any]]:
    """The first JSON line of ``proc``'s stdout carrying ``"serving"``,
    read on a helper thread and awaited for at most ``timeout_s``; None on
    a timeout or an exit without one."""
    found: Dict[str, Any] = {}
    done = threading.Event()

    def read() -> None:
        assert proc.stdout is not None
        for line in proc.stdout:
            try:
                payload = json.loads(line)
            except ValueError:
                continue
            if isinstance(payload, dict) and "serving" in payload:
                found.update(payload)
                break
        done.set()

    threading.Thread(target=read, name="memvul-host-banner", daemon=True).start()
    done.wait(timeout_s)
    return found or None


def start_process_hosts(argvs: Sequence[Sequence[str]], **kwargs) -> List[ProcessHost]:
    """Start one :class:`ProcessHost` per argv, all at once (their starts
    overlap), as ``host-0`` … ``host-<n-1>``.  A host that fails to start
    stops the others and raises."""
    hosts: List[Optional[ProcessHost]] = [None] * len(argvs)
    errors: List[BaseException] = []

    def start(i: int) -> None:
        try:
            hosts[i] = ProcessHost(i, argv=argvs[i], **kwargs)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=start, args=(i,), daemon=True) for i in range(len(argvs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for host in hosts:
            if host is not None:
                host.stop(timeout=5.0)
        raise errors[0]
    return [h for h in hosts if h is not None]


def enumerate_hosts(
    spec: Optional[str] = None, default_port: int = 8341
) -> List[str]:
    """Resolve the fleet's host URLs.

    Precedence: an explicit ``spec`` (comma-separated ``host[:port]`` or
    full ``http://`` URLs, the ``serve --hosts`` argument), then the
    ``MEMVUL_FLEET_HOSTS`` environment variable, then
    ``MEMVUL_FLEET_HOST_TEMPLATE`` (a ``{i}``-indexed URL pattern, e.g.
    ``http://serve-{i}.svc:8341``) expanded to one host per process of a
    world that ``parallel/multihost.py``'s ``initialize`` joined (as the
    JAX package reads its ``multihost`` state); the worlds ``--mesh``
    starts never turn into a host list.  With none of them: ``[]``.
    """
    raw = spec if spec else os.environ.get("MEMVUL_FLEET_HOSTS", "")
    if not raw:
        template = os.environ.get("MEMVUL_FLEET_HOST_TEMPLATE", "")
        if template and multihost._initialized:
            raw = ",".join(
                template.replace("{i}", str(i))
                for i in range(multihost.process_count())
            )
    out: List[str] = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "://" not in part:
            if ":" not in part:
                part = f"{part}:{default_port}"
            part = f"http://{part}"
        out.append(part.rstrip("/"))
    return out

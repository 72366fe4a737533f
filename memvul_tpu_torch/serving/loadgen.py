"""Load generation and the SLO harness for the serving tier (the JAX
package's ``serving/loadgen.py``).

Seeded arrival patterns (two runs of one config submit the same
schedule):

* ``closed``: N client threads in submit-then-wait lockstep;
* ``poisson``: open loop, exponential inter-arrivals at a target rate;
* ``burst``: whole bursts at once, separated by idle gaps;
* ``diurnal``: a sinusoidal rate between a floor and the peak;
* ``slowloris``: poisson plus a share of deadline abusers (near-zero
  deadlines: admitted, queued, then shed);
* ``dedup``: poisson arrivals whose texts are seeded Zipf-like repeats
  over a small pool (``dedup_unique``, skew ``dedup_alpha``), optionally
  behind a shared ``template_prefix``: what the admission cache and
  ``serving.prefix_share`` are for.

The report sums outcomes per cause (ok / shed / deadline / drain / error /
hang); ``hang``, a future that never resolved inside the collection
timeout, must be zero.  :func:`run_slo_harness` adds the fleet view
(per-replica counters from each replica's own registry, the router's
counters, the fleet invariant, the cache's hit rate, the SLO block), so
one JSON record answers both "how fast" and "did anything leak".
"""

from __future__ import annotations

import dataclasses
import logging
import math
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

PATTERNS = ("closed", "poisson", "burst", "diurnal", "slowloris", "dedup")


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """One load scenario.  All randomness comes from ``seed``."""

    pattern: str = "closed"
    requests: int = 256
    rps: float = 200.0            # open-loop target arrival rate
    clients: int = 4              # closed-loop concurrency
    deadline_ms: Optional[float] = None  # per-request deadline (None = default)
    seed: int = 0
    burst_size: int = 32          # burst: requests landing together
    burst_idle_s: float = 0.05    # burst: gap between bursts
    diurnal_period_s: float = 2.0  # diurnal: one full rate cycle
    diurnal_floor: float = 0.25   # diurnal: trough rate as a peak fraction
    abuser_frac: float = 0.1      # slowloris: deadline-abuser fraction
    abuser_deadline_ms: float = 1.0  # slowloris: the abusive deadline
    dedup_unique: int = 16        # dedup: distinct texts in the pool
    dedup_alpha: float = 1.1      # dedup: Zipf skew (higher = more repeats)
    template_prefix: str = ""     # dedup: shared boilerplate prepended to all
    result_timeout_s: float = 60.0  # future-collection bound (hang detector)

    def __post_init__(self) -> None:
        if self.pattern not in PATTERNS:
            raise ValueError(
                f"unknown load pattern {self.pattern!r} (known: {PATTERNS})"
            )
        if self.requests < 1:
            raise ValueError("requests must be >= 1")


def arrival_offsets(config: LoadConfig) -> List[float]:
    """Submission times in seconds from load start — deterministic in
    ``config`` (the regression property: a re-run replays the exact
    schedule).  ``closed`` has no schedule (clients self-pace)."""
    rng = random.Random(config.seed)
    n = config.requests
    if config.pattern == "closed":
        return [0.0] * n
    if config.pattern == "burst":
        offsets: List[float] = []
        t = 0.0
        while len(offsets) < n:
            offsets.extend([t] * min(config.burst_size, n - len(offsets)))
            t += config.burst_idle_s
        return offsets
    if config.pattern == "diurnal":
        # thinning-free construction: integrate a sinusoidal rate —
        # each unit-mean exponential gap is divided by the instantaneous
        # rate, so troughs stretch gaps and peaks compress them
        offsets = []
        t = 0.0
        floor = max(0.0, min(1.0, config.diurnal_floor))
        for _ in range(n):
            phase = 2.0 * math.pi * (t / config.diurnal_period_s)
            scale = floor + (1.0 - floor) * 0.5 * (1.0 - math.cos(phase))
            rate = max(config.rps * scale, 1e-6)
            t += rng.expovariate(1.0) / rate
            offsets.append(t)
        return offsets
    # poisson, slowloris and dedup share the steady-state arrival process
    offsets = []
    t = 0.0
    for _ in range(n):
        t += rng.expovariate(max(config.rps, 1e-6))
        offsets.append(t)
    return offsets


def request_texts(config: LoadConfig, texts: Sequence[str]) -> List[str]:
    """Per-request text schedule, deterministic in ``config``.  Every
    pattern but ``dedup`` cycles round-robin (maximal text diversity —
    the pre-dedup behaviour, byte-identical).  ``dedup`` draws Zipf-ish
    repeats from a ``dedup_unique``-sized pool (rank-``r`` text gets
    weight ``1/(r+1)^dedup_alpha``) and prepends ``template_prefix`` to
    every draw, so a run has a knowable exact-duplicate rate the cache
    hit-rate assertions can be written against."""
    if not texts:
        raise ValueError("load generation needs at least one text")
    n = config.requests
    if config.pattern != "dedup":
        return [texts[i % len(texts)] for i in range(n)]
    rng = random.Random(config.seed ^ 0xDED0)
    pool = [str(t) for t in texts[: max(1, min(config.dedup_unique, len(texts)))]]
    weights = [
        1.0 / float(rank + 1) ** config.dedup_alpha
        for rank in range(len(pool))
    ]
    prefix = config.template_prefix or ""
    return [
        prefix + rng.choices(pool, weights=weights)[0] for _ in range(n)
    ]


def request_deadlines(config: LoadConfig) -> List[Optional[float]]:
    """Per-request deadlines.  Only ``slowloris`` mixes in abusers —
    drawn from a seed derived from (but distinct from) the arrival
    seed, so schedules and abuser picks vary independently."""
    if config.pattern != "slowloris":
        return [config.deadline_ms] * config.requests
    rng = random.Random(config.seed ^ 0x5105)
    return [
        config.abuser_deadline_ms
        if rng.random() < config.abuser_frac
        else config.deadline_ms
        for _ in range(config.requests)
    ]


def _percentile(ordered: Sequence[float], q: float) -> Optional[float]:
    if not ordered:
        return None
    idx = int(round((len(ordered) - 1) * (q / 100.0)))
    return ordered[max(0, min(idx, len(ordered) - 1))]


class LoadGenerator:
    """Drive a ``submit(text, deadline_ms) -> ScoreFuture`` target —
    a :class:`ScoringService` or a :class:`ReplicaRouter` — through one
    :class:`LoadConfig` scenario and measure it."""

    def __init__(
        self,
        submit: Callable[..., Any],
        config: Optional[LoadConfig] = None,
    ) -> None:
        self.submit = submit
        self.config = config or LoadConfig()

    def run(self, texts: Sequence[str]) -> Dict[str, Any]:
        """Submit the scenario's requests (cycling over ``texts``) and
        collect every outcome.  Returns the load-side SLO report."""
        cfg = self.config
        if not texts:
            raise ValueError("load generation needs at least one text")
        deadlines = request_deadlines(cfg)
        schedule = request_texts(cfg, texts)
        entries: List[Dict[str, Any]] = []
        entries_lock = threading.Lock()

        def _record(i: int, t0: float, future) -> None:
            with entries_lock:
                entries.append({"i": i, "t0": t0, "future": future})

        start = time.perf_counter()
        if cfg.pattern == "closed":
            cursor = iter(range(cfg.requests))
            cursor_lock = threading.Lock()

            def _client() -> None:
                while True:
                    with cursor_lock:
                        i = next(cursor, None)
                    if i is None:
                        return
                    t0 = time.perf_counter()
                    future = self.submit(
                        schedule[i], deadline_ms=deadlines[i]
                    )
                    # closed loop: wait before taking the next request
                    try:
                        future.result(timeout=cfg.result_timeout_s)
                    except TimeoutError:
                        pass  # scored as a hang at collection below
                    _record(i, t0, future)

            threads = [
                threading.Thread(target=_client, daemon=True)
                for _ in range(max(1, cfg.clients))
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            offsets = arrival_offsets(cfg)
            for i, offset in enumerate(offsets):
                delay = start + offset - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                t0 = time.perf_counter()
                _record(
                    i, t0,
                    self.submit(schedule[i], deadline_ms=deadlines[i]),
                )
        submitted_span = time.perf_counter() - start

        outcomes = {
            "ok": 0, "shed": 0, "deadline": 0, "drain": 0, "error": 0,
            "hang": 0,
        }
        latencies: List[float] = []
        last_done = start
        for entry in entries:
            try:
                response = entry["future"].result(timeout=cfg.result_timeout_s)
            except TimeoutError:
                # the one outcome that must never happen: an unresolved
                # client — surfaces as hang > 0 in the record
                outcomes["hang"] += 1
                continue
            status = response.get("status", "error")
            outcomes[status] = outcomes.get(status, 0) + 1
            now = time.perf_counter()
            last_done = max(last_done, now)
            if status == "ok":
                latencies.append(
                    response.get("latency_ms", (now - entry["t0"]) * 1e3)
                )
        duration = max(last_done - start, submitted_span, 1e-9)
        latencies.sort()
        report: Dict[str, Any] = {
            "pattern": cfg.pattern,
            "requests": cfg.requests,
            "seed": cfg.seed,
            "duration_s": round(duration, 4),
            "offered_rps": (
                round(cfg.requests / max(submitted_span, 1e-9), 2)
                if cfg.pattern != "closed" else None
            ),
            "achieved_rps": round(outcomes["ok"] / duration, 2),
            "latency_ms": {
                "p50": _percentile(latencies, 50),
                "p95": _percentile(latencies, 95),
                "p99": _percentile(latencies, 99),
                "mean": (
                    round(sum(latencies) / len(latencies), 3)
                    if latencies else None
                ),
                "max": latencies[-1] if latencies else None,
            },
            "outcomes": outcomes,
        }
        return report


def fleet_snapshot(replicas) -> Dict[str, Any]:
    """Per-replica counters and the fleet invariant, read from each
    replica's own registry.  The invariant, ``served + shed + errors ==
    requests`` per replica and so fleet-wide, is the leak detector: a
    request a death dropped breaks the sum."""
    members = []
    total_served = 0
    invariant_ok = True
    for replica in replicas:
        snapshot = replica.registry.snapshot()["counters"]
        served = snapshot.get("serve.served", 0)
        shed = snapshot.get("serve.shed", 0)
        errors = snapshot.get("serve.errors", 0)
        requests = snapshot.get("serve.requests", 0)
        invariant_ok &= served + shed + errors == requests
        total_served += served
        members.append({
            "name": replica.name,
            "state": replica.state,
            "restarts": replica.restart_count,
            "bank_version": replica.bank_version,
            "heartbeat_age_s": round(replica.heartbeat_age_s(), 3),
            "requests": requests,
            "served": served,
            "shed": shed,
            "shed_overflow": snapshot.get("serve.shed_overflow", 0),
            "shed_deadline": snapshot.get("serve.shed_deadline", 0),
            "shed_drain": snapshot.get("serve.shed_drain", 0),
            "errors": errors,
            "errors_lost": snapshot.get("serve.errors_lost", 0),
        })
    for member in members:
        member["utilization"] = (
            round(member["served"] / total_served, 4) if total_served else 0.0
        )
    return {
        "replicas": members,
        "served_total": total_served,
        "invariant_ok": bool(invariant_ok),
    }


def run_slo_harness(
    target,
    texts: Sequence[str],
    config: Optional[LoadConfig] = None,
    replicas=None,
    router_registry=None,
    slo_monitor=None,
) -> Dict[str, Any]:
    """One SLO measurement: drive ``target`` (a service or a router) with
    a load scenario and merge the client-side report with the fleet view
    into one JSON-able record.  With an
    :class:`~memvul_tpu_torch.serving.slo.SLOMonitor` attached to the
    target (``build.serve_from_archive`` attaches one) or passed, the
    record gains its ``slo`` block, evaluated once more after the load."""
    report = LoadGenerator(target.submit, config).run(texts)
    record: Dict[str, Any] = {"load": report}
    if replicas is None:
        replicas = getattr(target, "replicas", None)
    if replicas:
        record["fleet"] = fleet_snapshot(replicas)
    registry = router_registry or getattr(target, "_tel", None)
    if registry is not None and hasattr(registry, "snapshot"):
        counters = registry.snapshot()["counters"]
        record["router"] = {
            name.split(".", 1)[1]: value
            for name, value in counters.items()
            if name.startswith("router.")
        }
    # the admission cache: one per service, so a fleet sums the replicas'
    # registries; a hit resolves without a device call
    cache_sources = (
        [r.registry for r in replicas] if replicas
        else [registry] if registry is not None else []
    )
    cache: Dict[str, Any] = {}
    for source in cache_sources:
        if not hasattr(source, "snapshot"):
            continue
        for name, value in source.snapshot()["counters"].items():
            if name.startswith("cache."):
                key = name.split(".", 1)[1]
                cache[key] = cache.get(key, 0) + value
    if cache:
        hits = cache.get("hits", 0)
        lookups = hits + cache.get("misses", 0)
        cache["hit_rate"] = round(hits / lookups, 4) if lookups else 0.0
        cache["device_calls_avoided"] = hits
        record["cache"] = cache
    monitor = slo_monitor or getattr(target, "slo_monitor", None)
    if monitor is not None:
        monitor.tick()
        record["slo"] = monitor.status()
    return record

"""The in-process online scoring service (the JAX package's
``serving/service.py``).

A service sees one report at a time and must answer in milliseconds.
Requests land in a bounded deque (:meth:`ScoringService.submit`); one
batcher thread runs a dispatch strategy (:mod:`.dispatch`) chosen by the
predictor's ``score_impl``:

* ``"bucketed"`` coalesces up to ``max_batch`` requests and pads each to
  the smallest length bucket that covers it;
* ``"ragged"`` packs the same pull into fixed ``[1, token_budget]`` rows
  scored through the segment-masked attention kernel;
* ``"continuous"`` admits each request straight into the open pack while
  the previous pack is on the card, on a device worker thread;
* ``"cascade"`` routes as ``"bucketed"``, scores on the int8 tier first
  and rescores the uncertain rows at full precision.

Admission control lives here: the queue is bounded (``max_queue``) and on
overflow the *oldest* request is shed (``"shed"``); every request carries
a deadline after which it resolves ``"deadline"`` instead of being
dispatched; a drain resolves what is still queued with ``"drain"``.  Each
micro-batch captures ONE anchor-bank snapshot, so no response mixes two
banks.  The counters keep ``serve.served + serve.shed + serve.errors ==
serve.requests``.

:meth:`ScoringService.swap_bank` installs a new bank (encoded, and its
shapes warmed when its geometry is new, before the install), with its
provenance (``source``, ``store_version``), the next version number and
the per-anchor weights of a reweighted bank (the winner is the weighted
``argmax``; the served probabilities stay raw);
:meth:`ScoringService.set_shadow_tap` hands every served chunk to a shadow
scorer (``bankops/shadow.py``) after its futures resolve.  With
``manifest_dir`` the live default bank is described in
``anchor_bank_manifest.json`` there, rewritten atomically at start and
after every swap.

Named tenants (``serving/tenancy.py``): ``swap_bank(..., tenant=)``
installs a bank into a tenant's own slot, ``submit(..., tenant=)`` scores
against it, and the dispatchers take one snapshot per tenant group of a
pull.  The ``bank.resolve`` fault point fires at each submit's tenant
resolution; a failure errors that request only.

On a serving mesh the service runs on rank 0, the leader, over a
predictor whose ``channel`` carries each device call to the followers
(:mod:`.mesh`): a snapshot's bank is this rank's shard, installed on every
rank under one id before :meth:`ScoringService.swap_bank` flips to it (a
failed install on any rank leaves the old bank serving on every rank),
and the end of a drain or a hard kill sends the followers the stop
command.

With ``cache_capacity > 0`` an :class:`~.admission_cache.AdmissionCache`
answers an exact repeat at submit, on the caller's thread, with the score
fields of its first answer and no device call.

Request tracing (``trace_sample_rate > 0``): every request carries a
:class:`_Trace` whose waypoints the service threads stamp (``received →
enqueued → coalesced → dispatched → device_done → resolved``); the four
stages feed the ``serve.queue_wait_s`` / ``serve.pack_s`` /
``serve.device_s`` / ``serve.resolve_s`` histograms, completed traces
land in a bounded ring (``recent_traces``, ``GET /tracez``), and a sampled
share of served requests (every non-``ok`` one) emits an ``rtrace`` event.
At the default rate 0.0 nothing is stamped, kept or emitted.  A router
carries one ``trace_id`` across re-routes and counts them in ``hops``.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..resilience import faults
from ..resilience.retry import RetryPolicy
from ..telemetry import Registry
from .tenancy import DEFAULT_TENANT

logger = logging.getLogger(__name__)

# terminal request statuses
STATUS_OK = "ok"              # scored; the response carries the anchor probs
STATUS_SHED = "shed"          # evicted by admission control (queue overflow)
STATUS_DEADLINE = "deadline"  # deadline expired before dispatch
STATUS_DRAIN = "drain"        # still queued when the service drained
STATUS_ERROR = "error"        # batch dead-lettered after retries; see "reason"

MANIFEST_NAME = "anchor_bank_manifest.json"


# the background workers a build attaches to a serving target (service,
# router or balancer); its drain stops each one present
ATTACHED_WORKERS = ("autoscaler", "drift_monitor", "slo_monitor", "alert_engine",
                    "metrics_sampler", "incident_recorder")


def stop_attached(target) -> None:
    """Stop the background workers attached to ``target``
    (:data:`ATTACHED_WORKERS`); the incident recorder writes what it has
    queued first."""
    recorder = getattr(target, "incident_recorder", None)
    for attr in ATTACHED_WORKERS:
        worker = getattr(target, attr, None)
        if worker is not None:
            worker.stop()
    if recorder is not None:
        recorder.drain()


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Micro-batcher and admission-control knobs; defaults mirror
    ``config.SERVING_DEFAULTS``."""

    max_batch: int = 16          # requests pulled per flush cycle
    max_wait_ms: float = 5.0     # oldest-request coalescing window
    max_queue: int = 256         # bounded queue depth (admission control)
    default_deadline_ms: float = 2000.0  # per-request budget; <= 0 = none
    # continuous packs: an exact duplicate of a request already in the
    # open pack shares its segment instead of paying tokens
    prefix_share: bool = False
    # count each served decision's winning anchor (bank.anchor_wins.<id>,
    # bank.anchor_score.<id>): the raw data of bankops/drift.py
    anchor_stats: bool = True
    # request tracing: 0.0 = off (nothing stamped or kept); > 0 stamps every
    # request's waypoints and emits an ``rtrace`` event for about this share
    # of served requests (for every request that was not served)
    trace_sample_rate: float = 0.0
    trace_ring: int = 256        # completed traces kept for GET /tracez
    # the admission cache's LRU entries; 0 builds no cache
    cache_capacity: int = 0
    # serve.hbm_in_use_bytes / serve.hbm_peak_bytes from the service's own
    # card at heartbeat cadence (nothing on the CPU)
    hbm_gauges: bool = True


class ScoreFuture:
    """Resolved exactly once with a response dict; waiters block on an
    event, never on the batcher's locks."""

    __slots__ = ("_event", "_response", "_lock", "_callbacks")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._response: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()
        self._callbacks: List[Any] = []

    def done(self) -> bool:
        return self._event.is_set()

    def add_done_callback(self, fn) -> None:
        """Run ``fn(response)`` when the future resolves (at once if it
        has).  The router relays through this instead of parking a thread
        per request; callbacks run on the resolving thread and must be
        cheap."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
            response = self._response
        fn(response)

    def resolve(self, response: Dict[str, Any]) -> bool:
        """First resolution wins; later ones are ignored."""
        with self._lock:
            if self._event.is_set():
                return False
            self._response = response
            callbacks, self._callbacks = self._callbacks, []
            self._event.set()
        for fn in callbacks:  # outside the lock: a callback may re-submit
            try:
                fn(response)
            except Exception:  # pragma: no cover - defensive
                logger.exception("score-future callback failed")
        return True

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._event.wait(timeout):
            raise TimeoutError("scoring request not resolved in time")
        assert self._response is not None
        return self._response


@dataclasses.dataclass
class _Trace:
    """One request's journey: monotonic waypoints stamped as it advances
    (``None``: the journey never reached that stage)."""

    trace_id: str
    hops: int = 0                # router re-routes (0 = first try)
    received: Optional[float] = None
    enqueued: Optional[float] = None
    coalesced: Optional[float] = None
    dispatched: Optional[float] = None
    device_done: Optional[float] = None
    resolved: Optional[float] = None
    batch: Optional[int] = None  # micro-batch (pull or pack) sequence number
    shape: str = ""              # "bucket:RxL fill=n/R" | "pack:real/budget"
    cause: str = ""              # terminal status


_WAYPOINT_ORDER = ("received", "enqueued", "coalesced", "dispatched", "device_done", "resolved")
# adjacent waypoints → the stage between them; the four stages partition
# enqueued → resolved, so they sum to the end-to-end latency
_STAGES = (
    ("queue_wait_s", "enqueued", "coalesced"),
    ("pack_s", "coalesced", "dispatched"),
    ("device_s", "dispatched", "device_done"),
    ("resolve_s", "device_done", "resolved"),
)


def _trace_record(trace: _Trace) -> Dict[str, Any]:
    """One completed trace as JSON: what ``/tracez`` serves and the
    ``rtrace`` event carries."""
    waypoints = {name: getattr(trace, name) for name in _WAYPOINT_ORDER
                 if getattr(trace, name) is not None}
    stages = {}
    for stage, begin, end in _STAGES:
        b, e = getattr(trace, begin), getattr(trace, end)
        if b is not None and e is not None:
            stages[stage] = e - b
    record: Dict[str, Any] = {"trace_id": trace.trace_id, "cause": trace.cause,
                              "hops": trace.hops, "waypoints": waypoints, "stages": stages}
    if trace.batch is not None:
        record["batch"] = trace.batch
    if trace.shape:
        record["shape"] = trace.shape
    if trace.resolved is not None and trace.enqueued is not None:
        record["total_s"] = trace.resolved - trace.enqueued
    return record


@dataclasses.dataclass
class _Request:
    text: str
    future: ScoreFuture
    enqueued_monotonic: float
    deadline_monotonic: Optional[float]  # None = no deadline
    trace: Optional[_Trace] = None       # only when tracing is on
    tenant: str = DEFAULT_TENANT         # whose anchor bank scores it
    n_tokens: int = 0  # real tokens, stamped at encode (the cache's ledger)


@dataclasses.dataclass(frozen=True)
class _BankVersion:
    """One immutable anchor-bank snapshot: the device bank [A, D], its
    labels and real row count.  A micro-batch captures one and labels its
    whole response from it.  ``source``, ``parent_version`` and
    ``store_version`` are provenance: how it was installed ("startup",
    "manual", "promotion", "demotion"), which serving version it replaced,
    and its bank-store version id when it came out of one."""

    version: int
    array: Any
    labels: Tuple[str, ...]
    n_anchors: int
    source: str = "startup"
    parent_version: Optional[int] = None
    store_version: Optional[str] = None
    tenant: str = DEFAULT_TENANT  # which tenant's bank this is
    # per-anchor weights (``meta["weight"]`` of each instance) for the
    # weighted winner selection; ``None`` for an all-1.0 bank, which then
    # selects by the plain ``argmax``, bitwise as an unweighted bank
    weights: Any = None


def _bank_weights(instances: List[Dict], n_anchors: int):
    """The per-anchor weight vector from the instances' meta, in encode
    order (``encode_bank`` keeps the instances' order); ``None`` for the
    all-1.0 bank, or when the counts differ and the weights cannot be
    aligned with the anchors (logged)."""
    if len(instances) != int(n_anchors):
        logger.warning("bank weights dropped: %d instances vs %d anchors",
                       len(instances), n_anchors)
        return None
    raw = [float((inst.get("meta") or {}).get("weight", 1.0)) for inst in instances]
    if all(w == 1.0 for w in raw):
        return None
    return np.asarray(raw, dtype=np.float32)


class ScoringService:
    """Micro-batching scorer over a warmed
    :class:`~memvul_tpu_torch.evaluate.predict_memory.SiamesePredictor`
    whose anchor bank is encoded.  ``registry`` receives the ``serve.*``
    counters (a fresh one by default; a replica passes its own); with
    ``out_dir`` its snapshot is written to ``<out_dir>/telemetry.json``
    when the service drains; with ``manifest_dir`` the live bank's
    manifest is kept there."""

    def __init__(
        self,
        predictor,
        config: Optional[ServiceConfig] = None,
        retry_policy: Optional[RetryPolicy] = None,
        registry: Optional[Registry] = None,
        out_dir: Optional[Union[str, Path]] = None,
        manifest_dir: Optional[Union[str, Path]] = None,
        device: Any = None,
    ) -> None:
        if predictor.anchor_bank is None:
            raise RuntimeError(
                "predictor has no anchor bank: call encode_anchors() before "
                "constructing the service"
            )
        self.predictor = predictor
        self.config = config or ServiceConfig()
        self.retry_policy = retry_policy
        self.out_dir = Path(out_dir) if out_dir is not None else None
        self.manifest_dir = Path(manifest_dir) if manifest_dir is not None else None
        self._rows_by_length: Dict[int, int] = {
            length: rows for rows, length in predictor.stream_shapes()
        }
        self._lengths = sorted(self._rows_by_length)
        self._score_impl = predictor.score_impl
        if self._score_impl in ("ragged", "continuous"):
            self._token_budget, self._max_rows = predictor.ragged_shape()
        else:
            self._token_budget = self._max_rows = 0
        self._bank = _BankVersion(
            version=1,
            array=predictor.anchor_bank,
            labels=tuple(predictor.anchor_labels),
            n_anchors=predictor.n_anchors,
        )
        self._bank_lock = threading.Lock()
        # serializes swaps (the control plane); the request path never takes it
        self._swap_lock = threading.Lock()
        # named tenants' banks (the default tenant's stays self._bank);
        # guarded by _bank_lock
        self._banks: Dict[str, _BankVersion] = {}
        self._multi_tenant = False  # set by the first named install
        self._warmed_bank_shapes = {tuple(predictor.anchor_bank.shape)}
        # bankops/shadow.py's tap: called on the batcher after each served
        # chunk's futures resolve; it only enqueues
        self._shadow_tap: Optional[Any] = None
        # bankops.baseline's DriftMonitor (build.serve_from_archive); stopped at drain
        self.drift_monitor: Optional[Any] = None
        self._queue: "collections.deque[_Request]" = collections.deque()
        self._cond = threading.Condition()
        # drain is a bare Event (no lock), so a signal handler can set it
        # while the main thread holds the queue condition
        self._draining = threading.Event()
        # hard kill: the batcher abandons its work UNRESOLVED; a caller
        # sweeps the survivors with take_unresolved()
        self._killed = threading.Event()
        self._inflight: List[_Request] = []  # guarded by self._cond
        self._tel = registry if registry is not None else Registry()
        self._precision = getattr(predictor, "encoder_precision", "fp32")
        self.admission_cache = None
        if int(self.config.cache_capacity) > 0:
            from .admission_cache import AdmissionCache

            self.admission_cache = AdmissionCache(int(self.config.cache_capacity),
                                                  registry=self._tel)
        # request tracing: at rate 0 nothing is allocated, stamped or emitted
        self._trace_enabled = self.config.trace_sample_rate > 0
        self._trace_seq = itertools.count(1)
        self._batch_seq = itertools.count(1)
        self._trace_accum = 0.0  # sampling credit
        self._trace_prefix = f"{os.getpid():x}"
        self._trace_ring: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=max(1, int(self.config.trace_ring)))
        self._ring_lock = threading.Lock()  # guards the ring and the credit
        # the device-memory gauges read this service's own device (the
        # predictor's unless given), sampled on the batcher thread
        self._device = device if device is not None else getattr(predictor, "device", None)
        self._hbm_next_monotonic = 0.0
        self._write_manifest()
        from .dispatch import make_dispatcher  # dispatch imports this module

        self._dispatcher = make_dispatcher(self)
        self._thread = threading.Thread(
            target=self._dispatcher.run, name="memvul-serve-batcher", daemon=True
        )
        self._thread.start()

    @property
    def registry(self) -> Registry:
        return self._tel

    # -- submission (any thread) ----------------------------------------------

    def submit(
        self,
        text: str,
        deadline_ms: Optional[float] = None,
        trace_id: Optional[str] = None,
        hops: int = 0,
        tenant: Optional[str] = None,
    ) -> ScoreFuture:
        """Enqueue one report text; returns a future at once.  During a
        drain the request resolves ``"drain"``; on queue overflow the
        oldest queued request is shed.  ``tenant`` picks that tenant's bank
        (``None`` or empty: the default tenant); a tenant without a bank
        resolves ``"error"`` without touching the queue.  An exact repeat
        that the admission cache holds resolves here, with no device call.
        ``trace_id`` and ``hops`` carry a router's journey across
        re-routes (ignored when tracing is off)."""
        future = ScoreFuture()
        now = time.monotonic()
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        deadline = now + deadline_ms / 1000.0 if deadline_ms > 0 else None
        trace = None
        if self._trace_enabled:
            trace = _Trace(trace_id=trace_id or f"{self._trace_prefix}-{next(self._trace_seq)}",
                           hops=int(hops), received=now)
        tenant = str(tenant) if tenant else DEFAULT_TENANT
        request = _Request(text=text, future=future, enqueued_monotonic=now,
                           deadline_monotonic=deadline, trace=trace, tenant=tenant)
        self._tel.counter("serve.requests").inc()
        self._tenant_count(tenant, "requests")
        try:
            # chaos hook: a failed resolution errors this request only
            faults.fault_point("bank.resolve")
            bank = self._bank_for(tenant)
        except Exception as e:
            self._tel.counter("serve.errors").inc()
            self._tenant_count(tenant, "errors")
            future.resolve({"status": STATUS_ERROR,
                            "reason": f"tenant resolution failed: {e}", "tenant": tenant})
            self._finish_trace(request, STATUS_ERROR)
            return future
        if self._draining.is_set():
            self._finish_unserved(request, STATUS_DRAIN)
            return future
        if self.admission_cache is not None:
            payload = self.admission_cache.lookup(tenant, text, bank.version, self._score_impl,
                                                  self._precision)
            if payload is not None:
                self._tel.counter("serve.served").inc()
                self._tenant_count(tenant, "served")
                payload["status"] = STATUS_OK
                payload["latency_ms"] = round((time.monotonic() - now) * 1000.0, 3)
                payload["cached"] = True
                future.resolve(payload)
                self._finish_trace(request, STATUS_OK)
                return future
        shed: Optional[_Request] = None
        with self._cond:
            if len(self._queue) >= self.config.max_queue:
                shed = self._queue.popleft()
            self._queue.append(request)
            if trace is not None:
                trace.enqueued = time.monotonic()
            self._tel.gauge("serve.queue_depth").set(len(self._queue))
            self._cond.notify()
        if shed is not None:
            self._finish_unserved(shed, STATUS_SHED)
        return future

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def bank_snapshot(self) -> _BankVersion:
        """The current immutable default bank snapshot (version and
        provenance)."""
        with self._bank_lock:
            return self._bank

    @property
    def bank_version(self) -> int:
        return self.bank_snapshot().version

    @property
    def bank_labels(self) -> Tuple[str, ...]:
        return self.bank_snapshot().labels

    def _bank_for(self, tenant: str) -> _BankVersion:
        """One tenant's current snapshot; a named tenant with no bank
        raises KeyError."""
        with self._bank_lock:
            if tenant == DEFAULT_TENANT:
                return self._bank
            bank = self._banks.get(tenant)
        if bank is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        return bank

    def tenant_banks(self) -> Dict[str, _BankVersion]:
        """Every installed tenant's snapshot, the default included."""
        with self._bank_lock:
            out = {DEFAULT_TENANT: self._bank}
            out.update(self._banks)
        return out

    def _tenant_count(self, tenant: str, what: str, n: int = 1) -> None:
        """``serve.<tenant>.<what>``, once a named tenant is installed (then
        for every request, the default tenant's too, so the per-tenant
        ledgers sum to the service's)."""
        if self._multi_tenant and n:
            self._tel.counter(f"serve.{tenant}.{what}").inc(n)

    # -- shadow tap (bankops/shadow.py) ---------------------------------------

    def set_shadow_tap(self, tap) -> None:
        """Install ``tap(texts, probs, bank_snapshot)``, called on the
        batcher thread after each served chunk's futures resolve.  The tap
        must only enqueue (the shadow scorer works on its own thread); an
        exception from it is counted (``bank.shadow_errors``), never seen
        by a client."""
        self._shadow_tap = tap

    def clear_shadow_tap(self) -> None:
        self._shadow_tap = None

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @property
    def killed(self) -> bool:
        return self._killed.is_set()

    @property
    def batcher_alive(self) -> bool:
        """Whether the batcher runs (a replica health signal): its thread
        and, for the continuous strategy, its device worker."""
        return self._thread.is_alive() and self._dispatcher.alive

    # -- hot anchor-bank swap --------------------------------------------------

    def swap_bank(
        self,
        anchor_instances,
        version: Optional[int] = None,
        source: str = "manual",
        store_version: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> int:
        """Encode a new anchor set and install it atomically, in the
        caller's thread: the encode, and a warmup of every serving shape
        when the bank's geometry is new, happen before the install, so the
        batcher never meets a shape it has not run.  Micro-batches in
        flight keep the snapshot they captured.  The new snapshot is
        ``version`` (a fleet stamps one rollout with one number), else the
        current version + 1, with the instances' ``meta["weight"]`` as its
        per-anchor weights; ``source`` and ``store_version`` are its
        provenance.  ``tenant`` installs into that tenant's slot instead of
        the default bank.  Returns the new version."""
        tenant = str(tenant) if tenant else DEFAULT_TENANT
        instances = list(anchor_instances)
        with self._swap_lock:
            # the swap lock is control-plane-only (it serializes concurrent
            # swaps); the request path never takes it, so encoding and
            # warming under it is deliberate, not a batcher stall
            bank, labels, n_anchors = self.predictor.encode_bank(instances)  # lint: disable=MV301
            weights = _bank_weights(instances, n_anchors)
            shape = tuple(bank.shape)
            if shape not in self._warmed_bank_shapes:
                logger.info("bank swap introduces shape %s: warming the serving shapes first",
                            shape)
                with self._tel.span("serve.bank_warmup"):
                    # same contract as the encode above: a control-plane
                    # lock, never contended by the request path
                    self.predictor.warmup_bank_shapes(bank)  # lint: disable=MV301
                self._warmed_bank_shapes.add(shape)
            with self._bank_lock:
                current = self._bank if tenant == DEFAULT_TENANT else self._banks.get(tenant)
                new = _BankVersion(
                    version=((current.version + 1 if current is not None else 1)
                             if version is None else int(version)),
                    array=bank,
                    labels=tuple(labels),
                    n_anchors=n_anchors,
                    source=source,
                    parent_version=current.version if current is not None else None,
                    store_version=store_version,
                    tenant=tenant,
                    weights=weights,
                )
                if tenant == DEFAULT_TENANT:
                    self._bank = new
                else:
                    self._banks[tenant] = new
                    self._multi_tenant = True
        self._tel.counter("serve.bank_swaps").inc()
        if tenant == DEFAULT_TENANT:
            self._tel.gauge("serve.bank_version").set(new.version)
        else:
            self._tel.counter(f"bank.{tenant}.swaps").inc()
            self._tel.gauge(f"bank.{tenant}.version").set(new.version)
        self._tel.event("bank_swap", version=new.version, n_anchors=new.n_anchors,
                        source=source, store_version=store_version, tenant=tenant)
        if self.admission_cache is not None:
            # the version in the key already fences correctness; this
            # reclaims the tenant's LRU room
            self.admission_cache.invalidate(tenant)
        if tenant == DEFAULT_TENANT:
            self._write_manifest()
        logger.info("anchor bank v%d installed for tenant %s (%s%s): %d anchors%s", new.version,
                    tenant, source, f", store {store_version}" if store_version else "",
                    new.n_anchors, "" if weights is None else " (weighted)")
        return new.version

    def _stop_followers(self) -> None:
        """A serving mesh's leader: the followers' stop command (sent once;
        later device calls raise)."""
        channel = getattr(self.predictor, "channel", None)
        if channel is not None:
            channel.stop()

    def _write_manifest(self) -> None:
        """The live default bank's manifest beside the telemetry sinks,
        written atomically, so a reader never sees a torn view."""
        if self.manifest_dir is None:
            return
        from ..resilience.io import atomic_write_text

        bank = self.bank_snapshot()
        self.manifest_dir.mkdir(parents=True, exist_ok=True)
        atomic_write_text(self.manifest_dir / MANIFEST_NAME, json.dumps({
            "version": bank.version,
            "n_anchors": bank.n_anchors,
            "labels_sha256": hashlib.sha256("\n".join(bank.labels).encode("utf-8")).hexdigest(),
            "labels": list(bank.labels),
            "parent_version": bank.parent_version,
            "source": bank.source,
            "store_version": bank.store_version,
            "written_wall": time.time(),
        }, indent=2))

    @property
    def default_deadline_ms(self) -> float:
        return self.config.default_deadline_ms

    def health_summary(self) -> Dict[str, Any]:
        """The ``/healthz`` body: drain state, queue depth, the dispatch
        strategy and the active bank; with named tenants, a row per tenant
        bank, and the tenant manager's view when one is attached."""
        draining = self._draining.is_set()
        bank = self.bank_snapshot()
        out = {
            "status": "draining" if draining else "ok",
            "draining": draining,
            "queue_depth": self.queue_depth,
            "score_impl": self._score_impl,
            "bank_version": bank.version,
            "n_anchors": bank.n_anchors,
            "bank": {"version": bank.version, "source": bank.source,
                     "parent_version": bank.parent_version,
                     "store_version": bank.store_version,
                     "weighted": bank.weights is not None},
        }
        if self._multi_tenant:
            with self._bank_lock:
                named = dict(self._banks)
            out["tenants"] = {
                name: {"version": b.version, "n_anchors": b.n_anchors, "source": b.source,
                       "store_version": b.store_version, "weighted": b.weights is not None}
                for name, b in sorted(named.items())
            }
        manager = getattr(self, "tenant_manager", None)
        if manager is not None:
            out["tenancy"] = manager.summary()
        return out

    # -- live exposition (GET /metrics, /tracez) --------------------------------

    def metrics_snapshots(self) -> List[Tuple[Dict[str, str], Dict[str, Any]]]:
        """The snapshot parts ``GET /metrics`` renders: one unlabeled part
        (a router fans out one per replica), and the predictor's program
        registry's ``program.*`` rows as a second one."""
        parts = [({}, self._tel.snapshot())]
        programs = getattr(self.predictor, "programs", None)
        if programs is not None:
            part = programs.metrics_part()
            if part:
                parts.append(({}, part))
        return parts

    def programs_snapshot(self) -> List[Dict[str, Any]]:
        """The predictor's program rows, newest first (``GET /programz``)."""
        programs = getattr(self.predictor, "programs", None)
        return programs.snapshot() if programs is not None else []

    def programs_roofline(self) -> Optional[Dict[str, Any]]:
        """The predictor's roofline reading (``GET /programz``)."""
        programs = getattr(self.predictor, "programs", None)
        return programs.roofline() if programs is not None else None

    def recent_traces(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Completed request traces, newest first (the ``GET /tracez``
        body); empty when tracing is off."""
        with self._ring_lock:
            records = list(self._trace_ring)
        records.reverse()
        return records[: int(limit)] if limit else records

    # -- shutdown --------------------------------------------------------------

    def request_drain(self) -> None:
        """Begin a graceful shutdown (signal-safe: sets a flag only).  The
        batcher finishes the work it already pulled, resolves everything
        still queued with ``"drain"`` and exits."""
        self._draining.set()

    def drain(self, timeout: Optional[float] = 30.0) -> None:
        """Graceful shutdown; waits for the batcher.  Idempotent."""
        self.request_drain()
        self._thread.join(timeout)
        stop_attached(self)
        self._stop_followers()
        if self._thread.is_alive():  # pragma: no cover - defensive
            logger.warning("serve batcher did not exit within %ss", timeout)
        if self.out_dir is not None:
            from ..resilience.io import atomic_write_text

            self.out_dir.mkdir(parents=True, exist_ok=True)
            atomic_write_text(self.out_dir / "telemetry.json",
                              json.dumps(self._tel.snapshot(), indent=2))


    def hard_kill(self) -> None:
        """Stop like a killed worker: resolve nothing, leave the queue as
        it is.  Follow with :meth:`take_unresolved`."""
        self._killed.set()
        self._draining.set()  # wakes the pull loop; it checks killed
        self._stop_followers()

    def take_unresolved(self, timeout: float = 5.0) -> List[_Request]:
        """After :meth:`hard_kill`: every accepted but unresolved request
        (queued and in flight).  Waits up to ``timeout`` for the batcher to
        see the kill: a batcher inside a device call returns from it first,
        so the tensors that call reads stay alive until the card is done
        with them; the kill flag keeps it from resolving anything after."""
        self._thread.join(timeout)
        with self._cond:
            pending = [r for r in self._inflight if not r.future.done()]
            pending += [r for r in self._queue if not r.future.done()]
            self._queue.clear()
            self._inflight = []
        return pending

    # -- used by the dispatchers (batcher thread) ------------------------------

    def _count_truncated(self, live: Sequence[_Request], seqs) -> None:
        """``serve.truncated``: requests whose text tokenized past the
        serving cap (the bucket or pack budget) and was clamped."""
        encoder = self.predictor.encoder
        cap = encoder.max_length
        if self._score_impl in ("ragged", "continuous"):
            cap = min(cap, self._token_budget)
        truncated = sum(
            1 for request, seq in zip(live, seqs)
            if len(seq) >= cap and encoder.encodes_beyond(request.text, cap)
        )
        if truncated:
            self._tel.counter("serve.truncated").inc(truncated)

    def _finish_unserved(self, request: _Request, status: str) -> None:
        """Resolve a request that will never be scored.  ``serve.shed``
        counts overflow, deadline and drain alike; the sub-counters say
        which."""
        sub = {
            STATUS_SHED: "serve.shed_overflow",
            STATUS_DEADLINE: "serve.shed_deadline",
            STATUS_DRAIN: "serve.shed_drain",
        }[status]
        self._tel.counter("serve.shed").inc()
        self._tel.counter(sub).inc()
        self._tenant_count(request.tenant, "shed")
        request.future.resolve({"status": status})
        self._finish_trace(request, status)

    def _finish_trace(self, request: _Request, cause: str) -> None:
        """Complete a request's trace: stamp its resolution, ring the
        record and emit an ``rtrace`` event (for a share
        ``trace_sample_rate`` of served requests, for every other
        outcome).  A no-op when tracing is off."""
        trace = request.trace
        if trace is None:
            return
        trace.cause = cause
        if trace.resolved is None:
            trace.resolved = time.monotonic()
        record = _trace_record(trace)
        with self._ring_lock:
            self._trace_ring.append(record)
            if cause == STATUS_OK:
                # deterministic credit sampling
                self._trace_accum += self.config.trace_sample_rate
                if self._trace_accum < 1.0:
                    return
                self._trace_accum -= 1.0
        self._tel.counter("serve.traces_sampled").inc()
        self._tel.event("rtrace", **record)

    def _maybe_sample_hbm(self) -> None:
        """``serve.hbm_in_use_bytes`` / ``serve.hbm_peak_bytes``: the
        allocator's live and peak bytes on this service's card, at most once
        a heartbeat interval (batcher thread).  Nothing on the CPU."""
        if not self.config.hbm_gauges or self._device is None:
            return
        now = time.monotonic()
        if now < self._hbm_next_monotonic:
            return
        self._hbm_next_monotonic = now + max(1.0, float(self._tel.heartbeat_every_s))
        from ..utils import profiling

        try:
            stats = profiling.device_memory_stats(self._device)
        except Exception:  # pragma: no cover - a device probe never stops the batcher
            return
        if not stats:
            return
        self._tel.gauge("serve.hbm_in_use_bytes").set(stats["bytes_in_use"])
        self._tel.gauge("serve.hbm_peak_bytes").set(stats["peak_bytes_in_use"])

    def _shed_queue(self, status: str) -> None:
        while True:
            with self._cond:
                if not self._queue:
                    self._tel.gauge("serve.queue_depth").set(0)
                    return
                request = self._queue.popleft()
            self._finish_unserved(request, status)

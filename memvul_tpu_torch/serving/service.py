"""The in-process online scoring service (the JAX package's
``serving/service.py``, single replica).

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
scorer (``bankops/shadow.py``) after its futures resolve.

Not ported yet (ROADMAP.md, the serving-plane slice): request tracing, the
admission cache, named tenants, HBM gauges and the bank manifest.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..resilience.retry import RetryPolicy
from ..telemetry import Registry

logger = logging.getLogger(__name__)

# terminal request statuses
STATUS_OK = "ok"              # scored; the response carries the anchor probs
STATUS_SHED = "shed"          # evicted by admission control (queue overflow)
STATUS_DEADLINE = "deadline"  # deadline expired before dispatch
STATUS_DRAIN = "drain"        # still queued when the service drained
STATUS_ERROR = "error"        # batch dead-lettered after retries; see "reason"

# the one tenant this port serves (named tenants wait for the ops plane)
DEFAULT_TENANT = "default"


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


class ScoreFuture:
    """Resolved exactly once with a response dict; waiters block on an
    event, never on the batcher's locks."""

    __slots__ = ("_event", "_response", "_lock")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._response: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def resolve(self, response: Dict[str, Any]) -> bool:
        """First resolution wins; later ones are ignored."""
        with self._lock:
            if self._event.is_set():
                return False
            self._response = response
            self._event.set()
        return True

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._event.wait(timeout):
            raise TimeoutError("scoring request not resolved in time")
        assert self._response is not None
        return self._response


@dataclasses.dataclass
class _Request:
    text: str
    future: ScoreFuture
    enqueued_monotonic: float
    deadline_monotonic: Optional[float]  # None = no deadline


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
    counters (a fresh one by default); with ``out_dir`` its snapshot is
    written to ``<out_dir>/telemetry.json`` when the service drains."""

    def __init__(
        self,
        predictor,
        config: Optional[ServiceConfig] = None,
        retry_policy: Optional[RetryPolicy] = None,
        registry: Optional[Registry] = None,
        out_dir: Optional[Union[str, Path]] = None,
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
        tenant: Optional[str] = None,
    ) -> ScoreFuture:
        """Enqueue one report text; returns a future at once.  During a
        drain the request resolves ``"drain"``; on queue overflow the
        oldest queued request is shed.  Raises ValueError for a named
        tenant (tenants are not ported)."""
        if tenant not in (None, "", DEFAULT_TENANT):
            raise ValueError(
                f"tenant {tenant!r}: named tenants are not ported yet; this "
                f"service serves only the {DEFAULT_TENANT!r} tenant"
            )
        future = ScoreFuture()
        now = time.monotonic()
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        deadline = now + deadline_ms / 1000.0 if deadline_ms > 0 else None
        request = _Request(text=text, future=future, enqueued_monotonic=now,
                           deadline_monotonic=deadline)
        self._tel.counter("serve.requests").inc()
        if self._draining.is_set():
            self._finish_unserved(request, STATUS_DRAIN)
            return future
        shed: Optional[_Request] = None
        with self._cond:
            if len(self._queue) >= self.config.max_queue:
                shed = self._queue.popleft()
            self._queue.append(request)
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
        """The current immutable bank snapshot (version and provenance)."""
        with self._bank_lock:
            return self._bank

    @property
    def bank_version(self) -> int:
        return self.bank_snapshot().version

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

    # -- hot anchor-bank swap --------------------------------------------------

    def swap_bank(
        self,
        anchor_instances,
        source: str = "manual",
        store_version: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> int:
        """Encode a new anchor set and install it atomically, in the
        caller's thread: the encode, and a warmup of every serving shape
        when the bank's geometry is new, happen before the install, so the
        batcher never meets a shape it has not run.  Micro-batches in
        flight keep the snapshot they captured.  The new snapshot is the
        current version + 1, with the instances' ``meta["weight"]`` as its
        per-anchor weights; ``source`` and ``store_version`` are its
        provenance.  Returns the new version.
        A named ``tenant`` raises: tenants belong to the serving-plane
        slice (ROADMAP.md)."""
        if tenant not in (None, "", DEFAULT_TENANT):
            raise NotImplementedError(
                f"swap_bank(tenant={tenant!r}): named tenants belong to the serving-plane "
                "slice, which is not ported yet (ROADMAP.md)"
            )
        instances = list(anchor_instances)
        with self._swap_lock:
            bank, labels, n_anchors = self.predictor.encode_bank(instances)
            weights = _bank_weights(instances, n_anchors)
            shape = tuple(bank.shape)
            if shape not in self._warmed_bank_shapes:
                logger.info("bank swap introduces shape %s: warming the serving shapes first",
                            shape)
                self.predictor.warmup_bank_shapes(bank)
                self._warmed_bank_shapes.add(shape)
            with self._bank_lock:
                current = self._bank
                new = _BankVersion(
                    version=current.version + 1,
                    array=bank,
                    labels=tuple(labels),
                    n_anchors=n_anchors,
                    source=source,
                    parent_version=current.version,
                    store_version=store_version,
                    weights=weights,
                )
                self._bank = new
        self._tel.counter("serve.bank_swaps").inc()
        self._tel.gauge("serve.bank_version").set(new.version)
        logger.info("anchor bank v%d installed (%s%s): %d anchors%s", new.version, source,
                    f", store {store_version}" if store_version else "", new.n_anchors,
                    "" if weights is None else " (weighted)")
        return new.version

    @property
    def default_deadline_ms(self) -> float:
        return self.config.default_deadline_ms

    def health_summary(self) -> Dict[str, Any]:
        """The ``/healthz`` body: drain state, queue depth, the dispatch
        strategy and the active bank."""
        draining = self._draining.is_set()
        bank = self.bank_snapshot()
        return {
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
        if self.drift_monitor is not None:
            self.drift_monitor.stop()
        if self._thread.is_alive():  # pragma: no cover - defensive
            logger.warning("serve batcher did not exit within %ss", timeout)
        if self.out_dir is not None:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            (self.out_dir / "telemetry.json").write_text(
                json.dumps(self._tel.snapshot(), indent=2)
            )

    def hard_kill(self) -> None:
        """Stop like a killed worker: resolve nothing, leave the queue as
        it is.  Follow with :meth:`take_unresolved`."""
        self._killed.set()
        self._draining.set()  # wakes the pull loop; it checks killed

    def take_unresolved(self, timeout: float = 5.0) -> List[_Request]:
        """After :meth:`hard_kill`: every accepted but unresolved request
        (queued and in flight)."""
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
        request.future.resolve({"status": status})

    def _shed_queue(self, status: str) -> None:
        while True:
            with self._cond:
                if not self._queue:
                    self._tel.gauge("serve.queue_depth").set(0)
                    return
                request = self._queue.popleft()
            self._finish_unserved(request, status)

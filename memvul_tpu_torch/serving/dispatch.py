"""Dispatch strategies for the scoring service (the JAX package's
``serving/dispatch.py``).

:class:`Dispatcher` owns the semantics every strategy shares, once:
deadline expiry at the pull, ONE bank snapshot per micro-batch, the retry
window around each device call, dead-lettering when retries run out,
hard-kill abandonment (resolve nothing, stay visible to the sweep) and the
padding ledger (``serve.tokens_real`` / ``serve.tokens_padded``).  A
strategy decides only how accepted requests become device calls:

* :class:`BucketedDispatcher` coalesces up to ``max_batch`` requests and
  pads each chunk to the smallest length bucket that covers it;
* :class:`RaggedDispatcher` packs the same pull into fixed
  ``[1, token_budget]`` rows by token budget, scored through the
  segment-masked attention kernel;
* :class:`ContinuousDispatcher` pulls nothing: an admission loop writes
  each request straight into the open pack of a
  :class:`~memvul_tpu_torch.data.batching.PackSlotAllocator` while a
  device worker thread scores the sealed one, so pack N+1 fills during
  pack N's round trip (``serve.pack_topups`` counts those admissions);
* :class:`CascadeDispatcher` routes like the bucketed strategy but scores
  each block on the int8 tier first and rescores, at the same (rows,
  length), only the rows whose best probability lies in the cascade band.

A pull is grouped by tenant and each group scored against that tenant's
ONE bank snapshot (a continuous pack seals when the tenant changes), so
K1 runs once per tenant group of a pull.  The ``serve.batch`` fault point
fires inside each device call's retried window (``serve.cascade`` inside
the cascade's rescore).  A served response is stored in the admission
cache before it resolves, and traced requests get their ``coalesced``,
``dispatched`` and ``device_done`` waypoints here.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.batching import PackSlotAllocator, _pad_block, collate_ragged, pack_token_budget
from ..resilience import faults
from ..resilience.retry import exception_text
from .service import STATUS_DEADLINE, STATUS_DRAIN, STATUS_ERROR, STATUS_OK, _BankVersion, _Request
from .tenancy import DEFAULT_TENANT

logger = logging.getLogger(__name__)

Chunk = Sequence[Tuple[_Request, List[int]]]


class Dispatcher:
    """The batcher-thread body of one
    :class:`~memvul_tpu_torch.serving.service.ScoringService`.  Subclasses
    override :meth:`_dispatch_live`; the continuous strategy replaces
    :meth:`run` but scores through the shared :meth:`_score_chunk`."""

    def __init__(self, service) -> None:
        self.service = service

    @property
    def alive(self) -> bool:
        """Liveness beyond the batcher thread (the service watches that
        itself); the continuous strategy adds its device worker."""
        return True

    # -- the batcher loop (service thread) -------------------------------------

    def run(self) -> None:
        svc = self.service
        while not svc._draining.is_set():
            pulled = self._pull_batch()
            if not pulled:
                continue
            if svc._trace_enabled:
                coalesced = time.monotonic()
                batch = next(svc._batch_seq)
                for request in pulled:
                    if request.trace is not None:
                        request.trace.coalesced = coalesced
                        request.trace.batch = batch
            # the pull is the in-flight work: a hard kill's sweep finds it
            with svc._cond:
                svc._inflight = list(pulled)
            if svc._killed.is_set():
                return
            # a pull completed before the drain flag was seen finishes;
            # everything still queued resolves "drain"
            self._dispatch(pulled)
            if svc._killed.is_set():
                return  # keep _inflight visible for take_unresolved
            with svc._cond:
                svc._inflight = []
            svc._maybe_sample_hbm()
            svc._tel.heartbeat()
        if svc._killed.is_set():
            return
        svc._shed_queue(STATUS_DRAIN)
        svc._tel.heartbeat(force=True)

    def _pull_batch(self) -> List[_Request]:
        """Wait for the first request, then pull until ``max_batch`` are
        in hand or ``max_wait_ms`` has passed since the first.  Waits are
        short so the drain flag is noticed promptly."""
        svc = self.service
        cfg = svc.config
        pulled: List[_Request] = []
        while True:
            with svc._cond:
                if svc._queue:
                    pulled.append(svc._queue.popleft())
                    break
                if svc._draining.is_set():
                    return pulled
                svc._cond.wait(0.05)
            # idle liveness tick, outside the queue lock: an idle batcher
            # keeps its heartbeat age near zero, so only a wedged one ages
            svc._maybe_sample_hbm()
            svc._tel.heartbeat()
        flush_at = time.monotonic() + cfg.max_wait_ms / 1000.0
        while len(pulled) < cfg.max_batch and not svc._draining.is_set():
            remaining = flush_at - time.monotonic()
            if remaining <= 0:
                break
            with svc._cond:
                if not svc._queue:
                    svc._cond.wait(min(remaining, 0.05))
                if svc._queue:
                    pulled.append(svc._queue.popleft())
        with svc._cond:
            svc._tel.gauge("serve.queue_depth").set(len(svc._queue))
        return pulled

    def _dispatch(self, pulled: List[_Request]) -> None:
        """Expire stale requests, encode the rest, group them by tenant and
        hand each group to the strategy with ONE snapshot of its bank."""
        svc = self.service
        now = time.monotonic()
        live: List[_Request] = []
        for request in pulled:
            if request.deadline_monotonic is not None and now > request.deadline_monotonic:
                svc._finish_unserved(request, STATUS_DEADLINE)
            else:
                live.append(request)
        if not live:
            return
        seqs = svc.predictor.encoder.encode_many([r.text for r in live])
        svc._count_truncated(live, seqs)
        groups: Dict[str, List[Tuple[_Request, List[int]]]] = {}
        for request, seq in zip(live, seqs):
            request.n_tokens = len(seq)  # the cache's tokens-saved ledger
            groups.setdefault(request.tenant, []).append((request, seq))
        for tenant, grouped in groups.items():
            try:
                bank = svc._bank_for(tenant)
            except KeyError as e:  # pragma: no cover - submit() resolves tenants
                reason = exception_text(e)
                svc._tel.counter("serve.errors").inc(len(grouped))
                svc._tenant_count(tenant, "errors", len(grouped))
                for request, _ in grouped:
                    request.future.resolve({"status": STATUS_ERROR, "reason": reason})
                    svc._finish_trace(request, STATUS_ERROR)
                continue
            self._dispatch_live([r for r, _ in grouped], [q for _, q in grouped], bank)

    def _dispatch_live(self, live: List[_Request], seqs: List[List[int]], bank: _BankVersion) -> None:
        raise NotImplementedError

    # -- the shared device-dispatch core ---------------------------------------

    def _score_chunk(
        self,
        chunk: Chunk,
        bank: _BankVersion,
        *,
        sample: Dict[str, np.ndarray],
        occupancy_rows: int,
        padded_tokens: int,
        real_tokens: int,
        score_fn: Callable[[Dict[str, np.ndarray], Any], np.ndarray],
        shape: str,
    ) -> None:
        """One retried device round trip, booked and resolved to clients."""
        probs = self._device_call(chunk, bank, sample=sample, score_fn=score_fn, shape=shape)
        if probs is None:
            return  # dead-lettered or killed: nothing left to resolve
        self._finalize_batch(len(chunk), occupancy_rows=occupancy_rows,
                             padded_tokens=padded_tokens, real_tokens=real_tokens)
        self._resolve_scored(chunk, probs, bank)

    def _device_call(
        self,
        chunk: Chunk,
        bank: _BankVersion,
        *,
        sample: Dict[str, np.ndarray],
        score_fn: Callable[[Dict[str, np.ndarray], Any], np.ndarray],
        shape: str,
        fault_name: str = "serve.batch",
    ) -> Optional[np.ndarray]:
        """One retried device round trip: the ``[len(chunk), n_anchors]``
        probabilities, or None when the worker was killed or the chunk was
        dead-lettered (retries exhausted or a non-transient failure: every
        request resolves ``"error"`` with the reason).  ``fault_name``
        fires inside the retried window; ``shape`` labels the traces."""
        svc = self.service
        tel = svc._tel

        def once():
            faults.fault_point(fault_name)
            return score_fn(sample, bank.array)

        def count_retry(exc, attempt):
            tel.counter("resilience.retries").inc()

        if svc._trace_enabled:
            dispatched = time.monotonic()
            for request, _ in chunk:
                if request.trace is not None:
                    request.trace.dispatched = dispatched
                    request.trace.shape = shape
        start = time.perf_counter()
        try:
            if svc.retry_policy is None:
                probs = once()
            else:
                probs = svc.retry_policy.call(once, description="serve batch", on_retry=count_retry)
            probs = np.asarray(probs)[: len(chunk), : bank.n_anchors]
        except Exception as e:
            if svc._killed.is_set():
                return None  # a killed worker neither counts nor resolves
            reason = exception_text(e)
            logger.error("serve batch dead-lettered (%d request(s)): %s", len(chunk), reason[:300])
            tel.counter("serve.dead_letters").inc()
            tel.counter("serve.errors").inc(len(chunk))
            for request, _ in chunk:
                svc._tenant_count(request.tenant, "errors")
                request.future.resolve({"status": STATUS_ERROR, "reason": reason})
                svc._finish_trace(request, STATUS_ERROR)
            return None
        if svc._killed.is_set():
            return None  # killed mid-dispatch: the sweep accounts this chunk
        if svc._trace_enabled:
            device_done = time.monotonic()
            for request, _ in chunk:
                if request.trace is not None:
                    request.trace.device_done = device_done
        tel.histogram("serve.batch_latency_s").observe(time.perf_counter() - start)
        return probs

    def _finalize_batch(self, n_rows: int, *, occupancy_rows: int, padded_tokens: int,
                        real_tokens: int) -> None:
        """Book one device batch into the occupancy and padding ledger (a
        cascade's rescore is a second batch and books a second entry)."""
        tel = self.service._tel
        tel.histogram("serve.batch_occupancy").observe(n_rows / occupancy_rows)
        tel.counter("serve.tokens_real").inc(real_tokens)
        tel.counter("serve.tokens_padded").inc(padded_tokens)
        tel.counter("serve.batches").inc()

    def _resolve_scored(self, chunk: Chunk, probs: np.ndarray, bank: _BankVersion) -> None:
        """Resolve scored rows to their clients (each request passes here
        exactly once on the success path), then hand them to the shadow tap
        if one is installed."""
        svc = self.service
        tel = svc._tel
        tel.counter("serve.served").inc(len(chunk))
        tel.progress()
        now = time.monotonic()
        anchor_stats = svc.config.anchor_stats
        cache = svc.admission_cache
        weights = bank.weights
        for (request, _), row in zip(chunk, probs):
            # a reweighted bank picks its winner by the weighted scores and
            # reports the raw probabilities; an all-1.0 bank (weights None)
            # takes the plain argmax, bitwise as before
            best = int(np.argmax(row * weights if weights is not None else row))
            latency = now - request.enqueued_monotonic
            tel.histogram("serve.latency_s").observe(latency)
            if anchor_stats:
                label = bank.labels[best]
                tel.counter(f"bank.anchor_wins.{label}").inc()
                tel.histogram(f"bank.anchor_score.{label}").observe(float(row[best]))
            response = {
                "status": STATUS_OK,
                "predict": {label: float(p) for label, p in zip(bank.labels, row)},
                "score": float(row[best]),
                "anchor": bank.labels[best],
                "bank_version": bank.version,
                "latency_ms": round(latency * 1e3, 3),
            }
            if cache is not None:
                # before resolve: the client owns the resolved dict
                cache.store(request.tenant, request.text, bank.version, svc._score_impl,
                            svc._precision, response, n_tokens=request.n_tokens)
            svc._tenant_count(request.tenant, "served")
            request.future.resolve(response)
            trace = request.trace
            if trace is not None:
                # the four stage histograms partition enqueued → resolved
                trace.resolved = now
                for stage, begin, end in (("queue_wait_s", trace.enqueued, trace.coalesced),
                                          ("pack_s", trace.coalesced, trace.dispatched),
                                          ("device_s", trace.dispatched, trace.device_done),
                                          ("resolve_s", trace.device_done, now)):
                    if begin is not None and end is not None:
                        tel.histogram(f"serve.{stage}").observe(end - begin)
                svc._finish_trace(request, STATUS_OK)
        tap = svc._shadow_tap
        if tap is not None:
            # after resolution, so shadow sampling adds nothing to a client's
            # latency; the tap only enqueues copies, and a raising tap is
            # counted, never seen by a client (bankops/shadow.py)
            try:
                tap([request.text for request, _ in chunk], probs, bank)
            except Exception:
                tel.counter("bank.shadow_errors").inc()
                logger.exception("shadow tap failed (active path unaffected)")


class BucketedDispatcher(Dispatcher):
    """Route each live request to the smallest bucket covering its token
    count and pad every chunk to that bucket's (rows, length) block."""

    def _dispatch_live(self, live, seqs, bank) -> None:
        svc = self.service
        groups: Dict[int, List[Tuple[_Request, List[int]]]] = {}
        for request, seq in zip(live, seqs):
            groups.setdefault(self._bucket_for(len(seq)), []).append((request, seq))
        for length in sorted(groups):
            rows = svc._rows_by_length[length]
            group = groups[length]
            for start in range(0, len(group), rows):
                if svc._killed.is_set():
                    return  # abandoned: the kill sweep takes over
                self._score_bucket_chunk(group[start : start + rows], bank, rows, length)

    def _pad_bucket(self, chunk: Chunk, rows: int, length: int) -> Dict[str, np.ndarray]:
        return _pad_block([seq for _, seq in chunk], rows, self.service.predictor.encoder.pad_id,
                          length)

    def _score_bucket_chunk(self, chunk: Chunk, bank: _BankVersion, rows: int, length: int) -> None:
        self._score_chunk(
            chunk, bank,
            sample=self._pad_bucket(chunk, rows, length),
            occupancy_rows=rows,
            padded_tokens=rows * length,
            real_tokens=sum(min(len(seq), length) for _, seq in chunk),
            score_fn=self.service.predictor.score_block,
            shape=f"bucket:{rows}x{length} fill={len(chunk)}/{rows}",
        )

    def _bucket_for(self, n_tokens: int) -> int:
        """Smallest bucket covering the token count; longer texts
        truncate into the largest."""
        for length in self.service._lengths:
            if length >= n_tokens:
                return length
        return self.service._lengths[-1]


class CascadeDispatcher(BucketedDispatcher):
    """The two-tier int8 cascade: every block is scored on the int8 tier
    first; rows whose best probability lies in the inclusive
    ``[cascade_low, cascade_high]`` band are scored again, at the same
    (rows, length), on the full-precision model, and resolve with the
    bucketed strategy's bits.  The rest resolve with their int8 scores.
    Both tiers read ONE bank snapshot; each tier's device call is retried
    and dead-lettered on its own (a failing rescore dead-letters only the
    in-band rows).  ``serve.cascade_shortcircuit`` and
    ``serve.cascade_rescored`` count the rows of each exit."""

    def _score_bucket_chunk(self, chunk: Chunk, bank: _BankVersion, rows: int, length: int) -> None:
        predictor = self.service.predictor
        tel = self.service._tel
        probs = self._device_call(
            chunk, bank, sample=self._pad_bucket(chunk, rows, length),
            score_fn=predictor.score_block_int8,
            shape=f"bucket:{rows}x{length} fill={len(chunk)}/{rows} tier=int8")
        if probs is None:
            return
        self._finalize_batch(len(chunk), occupancy_rows=rows, padded_tokens=rows * length,
                             real_tokens=sum(min(len(seq), length) for _, seq in chunk))
        low, high = predictor.cascade_band
        best = probs.max(axis=1) if probs.size else np.zeros(len(chunk))
        in_band = [i for i, b in enumerate(best) if low <= b <= high]
        confident = [i for i in range(len(chunk)) if not low <= best[i] <= high]
        if confident:
            tel.counter("serve.cascade_shortcircuit").inc(len(confident))
            self._resolve_scored([chunk[i] for i in confident], probs[confident], bank)
        if not in_band:
            return
        tel.counter("serve.cascade_rescored").inc(len(in_band))
        sub = [chunk[i] for i in in_band]
        rescored = self._device_call(
            sub, bank, sample=self._pad_bucket(sub, rows, length), score_fn=predictor.score_block,
            shape=f"bucket:{rows}x{length} fill={len(sub)}/{rows} tier=fp32",
            fault_name="serve.cascade")
        if rescored is None:
            return  # the in-band rows dead-lettered (or the worker was killed)
        self._finalize_batch(len(sub), occupancy_rows=rows, padded_tokens=rows * length,
                             real_tokens=sum(min(len(seq), length) for _, seq in sub))
        self._resolve_scored(sub, rescored, bank)


class RaggedDispatcher(Dispatcher):
    """Pack the pull by token budget into as few ``[1, token_budget]``
    rows as the greedy in-order packer allows."""

    def _dispatch_live(self, live, seqs, bank) -> None:
        svc = self.service
        budget, max_rows = svc._token_budget, svc._max_rows
        for pack in pack_token_budget([len(seq) for seq in seqs], budget, max_rows):
            if svc._killed.is_set():
                return
            chunk = [(live[i], seqs[i]) for i in pack]
            real_tokens = sum(min(len(seq), budget) for _, seq in chunk)
            self._score_chunk(
                chunk, bank,
                sample=collate_ragged([seq for _, seq in chunk], budget, max_rows,
                                      svc.predictor.encoder.pad_id),
                occupancy_rows=max_rows,
                padded_tokens=budget,
                real_tokens=real_tokens,
                score_fn=svc.predictor.score_ragged_sample,
                shape=f"pack:{real_tokens}/{budget}",
            )


class _SealedPack:
    """One sealed pack in the admission → device handoff: its rows, the
    sample copied off the page table, its real tokens and the ONE bank
    snapshot it is scored against."""

    __slots__ = ("chunk", "sample", "real_tokens", "bank")

    def __init__(self, chunk, sample, real_tokens, bank) -> None:
        self.chunk = chunk
        self.sample = sample
        self.real_tokens = real_tokens
        self.bank = bank


class ContinuousDispatcher(Dispatcher):
    """Continuous admission into the in-flight pack.

    The service's batcher thread runs the admission loop: it pops each
    request as it arrives (its deadline checked at the pop), encodes it
    and writes it into the open pack.  The pack seals when it is full
    (budget or rows) or when its oldest row has waited ``max_wait_ms``,
    and goes to a device worker thread through a handoff queue of one.
    One pack on the card, one sealed and one filling bound the memory;
    when all three are full, requests wait in the service queue and expire
    at the pop, never inside a pack.

    A hard kill abandons the open pack, the handoff and the pack on the
    card unresolved (all in the service's in-flight list, kept
    incrementally); a drain seals and finishes the open pack, then sheds
    the queue with ``"drain"``.
    """

    def __init__(self, service) -> None:
        super().__init__(service)
        self._token_budget = service._token_budget
        self._max_rows = service._max_rows
        self._alloc = PackSlotAllocator(
            self._token_budget, self._max_rows, service.predictor.encoder.pad_id,
            share_prefixes=bool(service.config.prefix_share),
        )
        # admission-thread-only state
        self._open: List[Tuple[_Request, List[int]]] = []
        self._open_tenant: str = DEFAULT_TENANT
        self._flush_at: Optional[float] = None
        self._reported = {"slots_reused": 0, "rows_aliased": 0, "tokens_aliased": 0}
        # cross-thread state, each with its own synchronization
        self._handoff: "queue.Queue[Optional[_SealedPack]]" = queue.Queue(maxsize=1)
        self._device_busy = threading.Event()
        self._worker: Optional[threading.Thread] = None

    @property
    def alive(self) -> bool:
        worker = self._worker
        if worker is None:
            return True  # not started yet
        # a worker that exited outside a drain or a kill is a dead replica
        return worker.is_alive() or self.service._draining.is_set()

    def run(self) -> None:
        svc = self.service
        worker = threading.Thread(target=self._device_loop, name="memvul-serve-device", daemon=True)
        worker.start()  # start, then publish: a published thread is a live one
        self._worker = worker
        while not svc._draining.is_set():
            request = None
            with svc._cond:
                if svc._queue:
                    request = svc._queue.popleft()
                    svc._tel.gauge("serve.queue_depth").set(len(svc._queue))
                else:
                    timeout = 0.05
                    if self._flush_at is not None:
                        timeout = min(timeout, max(self._flush_at - time.monotonic(), 0.0))
                    if timeout > 0:
                        svc._cond.wait(timeout)
            if request is not None:
                self._admit(request)
                if svc._killed.is_set():
                    return
            else:
                svc._maybe_sample_hbm()
                svc._tel.heartbeat()  # idle liveness tick, outside the lock
            if self._open and self._flush_at is not None and time.monotonic() >= self._flush_at:
                self._seal_and_submit()
                if svc._killed.is_set():
                    return
        # drain: the admitted but unsealed pack is pulled work; it finishes
        if not svc._killed.is_set() and self._open:
            self._seal_and_submit()
        self._stop_worker(worker)
        if svc._killed.is_set():
            return
        svc._shed_queue(STATUS_DRAIN)
        svc._tel.heartbeat(force=True)

    # -- admission loop (service batcher thread) -------------------------------

    def _admit(self, request: _Request) -> None:
        """One pop → one page-table write (or a deadline resolution)."""
        svc = self.service
        now = time.monotonic()
        if request.deadline_monotonic is not None and now > request.deadline_monotonic:
            svc._finish_unserved(request, STATUS_DEADLINE)
            return
        seq = svc.predictor.encoder.encode_many([request.text])[0]
        svc._count_truncated([request], [seq])
        request.n_tokens = len(seq)
        # in flight from the moment it leaves the queue
        with svc._cond:
            svc._inflight.append(request)
        if request.trace is not None:
            request.trace.coalesced = now  # admission into the pack
        if self._open and request.tenant != self._open_tenant:
            # a pack serves ONE tenant's snapshot: a tenant switch seals it
            self._seal_and_submit()
            if svc._killed.is_set():
                return
        row = self._alloc.admit(seq)
        if row is None:
            self._seal_and_submit()
            if svc._killed.is_set():
                return
            row = self._alloc.admit(seq)
            assert row is not None, "a cap-length request must fit an empty pack"
        if self._device_busy.is_set():
            # this request joined pack N+1 while pack N was on the card
            svc._tel.counter("serve.pack_topups").inc()
        if not self._open:
            self._flush_at = time.monotonic() + svc.config.max_wait_ms / 1000.0
            self._open_tenant = request.tenant
        self._open.append((request, seq))
        if self._alloc.rows >= self._max_rows:
            self._seal_and_submit()

    def _seal_and_submit(self) -> None:
        """Seal the open pack (ONE bank snapshot, the sample copied off the
        page table, the slots recycled) and hand it to the device worker.
        Blocks, in short kill-aware steps, only while a sealed pack already
        waits behind the one on the card."""
        if not self._open:
            return
        svc = self.service
        bank = svc._bank_for(self._open_tenant)  # the pack is single-tenant
        chunk, self._open = self._open, []
        self._flush_at = None
        item = _SealedPack(chunk, self._alloc.sample(), self._alloc.real_tokens, bank)
        self._alloc.reset()
        for attr, name in (("slots_reused", "serve.pack_slots_reused"),
                           ("rows_aliased", "serve.prefix_rows_aliased"),
                           ("tokens_aliased", "serve.prefix_tokens_saved")):
            total = getattr(self._alloc, attr)
            if total > self._reported[attr]:
                svc._tel.counter(name).inc(total - self._reported[attr])
                self._reported[attr] = total
        if svc._trace_enabled:
            batch = next(svc._batch_seq)
            for request, _ in chunk:
                if request.trace is not None:
                    request.trace.batch = batch
        while True:
            if svc._killed.is_set():
                return  # abandon unresolved; the sweep accounts them
            try:
                self._handoff.put(item, timeout=0.05)
                return
            except queue.Full:
                continue  # backpressure: the card and the handoff are both full

    def _stop_worker(self, worker: threading.Thread) -> None:
        """Deliver the shutdown sentinel behind any queued pack, then wait
        for the worker to finish it."""
        svc = self.service
        while worker.is_alive():
            if svc._killed.is_set():
                try:
                    self._handoff.put_nowait(None)
                except queue.Full:
                    pass
                break
            try:
                self._handoff.put(None, timeout=0.05)
                break
            except queue.Full:
                continue
        worker.join(timeout=30.0)

    # -- device worker thread --------------------------------------------------

    def _device_loop(self) -> None:
        svc = self.service
        while True:
            try:
                item = self._handoff.get(timeout=0.5)
            except queue.Empty:
                if svc._killed.is_set():
                    return
                continue
            if item is None:
                return  # drain sentinel
            if svc._killed.is_set():
                return  # abandon unresolved (still in the in-flight list)
            self._device_busy.set()
            try:
                self._score_chunk(
                    item.chunk, item.bank,
                    sample=item.sample,
                    occupancy_rows=self._max_rows,
                    padded_tokens=self._token_budget,
                    real_tokens=item.real_tokens,
                    score_fn=svc.predictor.score_ragged_sample,
                    shape=f"pack:{item.real_tokens}/{self._token_budget}",
                )
            finally:
                self._device_busy.clear()
            if svc._killed.is_set():
                return
            with svc._cond:
                svc._inflight = [r for r in svc._inflight if not r.future.done()]


_DISPATCHERS = {
    "bucketed": BucketedDispatcher,
    "ragged": RaggedDispatcher,
    "continuous": ContinuousDispatcher,
    "cascade": CascadeDispatcher,
}


def make_dispatcher(service) -> Dispatcher:
    """The strategy for the predictor's ``score_impl``."""
    impl = service._score_impl
    if impl not in _DISPATCHERS:
        raise ValueError(f"unknown score_impl {impl!r} (known: {sorted(_DISPATCHERS)})")
    return _DISPATCHERS[impl](service)

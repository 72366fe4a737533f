"""Content-addressed admission cache: exact repeats never touch the card
(the JAX package's ``serving/admission_cache.py``).

The serving path hands the raw text straight to ``encoder.encode_many``,
so identical raw bytes give the identical token sequence, the identical
device call and the identical score row, provided the anchor bank, the
dispatch impl and the encoder precision are the same too.  That is the
cache key:

    (tenant, sha256(text), bank_version, score_impl, precision)

``bank_version`` in the key makes a bank swap a structural invalidation;
:meth:`AdmissionCache.invalidate` also drops a tenant's entries at swap
time so unreachable payloads do not squat on the LRU's capacity.

Only the score payload is cached (``predict`` / ``score`` / ``anchor`` /
``bank_version``): a hit rebuilds the response with a fresh
``status``/``latency_ms``, so its score fields are bitwise those of the
miss.  A hit counts ``serve.served`` (the invariant ``served + shed +
errors == requests`` keeps summing) and ``cache.hits``; the token count
recorded at store time feeds ``cache.tokens_saved``.

A lookup is a dict probe under a lock, never an encode or a score.  The
``cache.lookup`` fault point degrades an armed lookup to a miss (one
``cache.errors``): a broken cache costs a device call, never a request.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from ..resilience import faults
from ..telemetry import get_registry

__all__ = ["AdmissionCache", "text_digest"]

# the public score fields a hit replays; everything else (status,
# latency_ms, trace bookkeeping) is rebuilt fresh per response
PAYLOAD_FIELDS = ("predict", "score", "anchor", "bank_version")

_CacheKey = Tuple[str, str, int, str, str]


def text_digest(text: str) -> str:
    """sha256 of the raw utf-8 text — raw, not normalized, because the
    serve path encodes raw text (identical bytes ⇒ identical tokens ⇒
    identical scores; a normalizer here would alias texts the encoder
    distinguishes)."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


class AdmissionCache:
    """Bounded LRU of exact-duplicate score payloads, keyed on
    (tenant, text digest, bank version, impl, precision).

    Thread-safe: lookups run on submitter threads, stores on the
    batcher/device threads, invalidations on the control plane — one
    lock guards the ordered map, and all metric emission happens
    outside it."""

    def __init__(self, capacity: int, registry=None) -> None:
        if int(capacity) <= 0:
            raise ValueError(f"cache capacity must be > 0, got {capacity!r}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[_CacheKey, Dict[str, Any]]" = OrderedDict()
        self._tel = registry if registry is not None else get_registry()

    @staticmethod
    def _key(
        tenant: str, text: str, bank_version: int, impl: str, precision: str
    ) -> _CacheKey:
        return (
            str(tenant), text_digest(text), int(bank_version),
            str(impl), str(precision),
        )

    def lookup(
        self,
        tenant: str,
        text: str,
        bank_version: int,
        impl: str,
        precision: str,
    ) -> Optional[Dict[str, Any]]:
        """The score payload for an exact repeat, or ``None`` (miss).
        A hit returns a fresh dict (callers mutate responses); an armed
        ``cache.lookup`` fault degrades to a miss — the request falls
        through to the device instead of failing."""
        try:
            faults.fault_point("cache.lookup")
        except BaseException:
            self._tel.counter("cache.errors").inc()
            return None
        key = self._key(tenant, text, bank_version, impl, precision)
        with self._lock:
            payload = self._entries.get(key)
            if payload is not None:
                self._entries.move_to_end(key)
        if payload is None:
            self._tel.counter("cache.misses").inc()
            return None
        self._tel.counter("cache.hits").inc()
        tokens = int(payload.get("n_tokens", 0))
        if tokens:
            self._tel.counter("cache.tokens_saved").inc(tokens)
        return {
            "predict": dict(payload["predict"]),
            "score": payload["score"],
            "anchor": payload["anchor"],
            "bank_version": payload["bank_version"],
        }

    def store(
        self,
        tenant: str,
        text: str,
        bank_version: int,
        impl: str,
        precision: str,
        response: Dict[str, Any],
        n_tokens: int = 0,
    ) -> None:
        """Remember a served response's score payload.  Only the
        :data:`PAYLOAD_FIELDS` are copied out of ``response``; the
        request's real token count rides along so a later hit can
        credit ``cache.tokens_saved``."""
        payload = {field: response[field] for field in PAYLOAD_FIELDS}
        payload["predict"] = dict(payload["predict"])
        payload["n_tokens"] = int(n_tokens)
        key = self._key(tenant, text, bank_version, impl, precision)
        evicted = 0
        with self._lock:
            self._entries[key] = payload
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                evicted += 1
            size = len(self._entries)
        if evicted:
            self._tel.counter("cache.evictions").inc(evicted)
        self._tel.gauge("cache.size").set(size)

    def invalidate(self, tenant: str) -> int:
        """Drop every entry of one tenant (called at bank-swap time).
        The version-in-key already makes stale entries unreachable;
        this reclaims their LRU capacity eagerly.  Returns the count
        dropped."""
        tenant = str(tenant)
        with self._lock:
            doomed = [k for k in self._entries if k[0] == tenant]
            for key in doomed:
                del self._entries[key]
            size = len(self._entries)
        if doomed:
            self._tel.counter("cache.invalidations").inc(len(doomed))
        self._tel.gauge("cache.size").set(size)
        return len(doomed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        """Point-in-time size/capacity (counters live in telemetry)."""
        with self._lock:
            return {"size": len(self._entries), "capacity": self.capacity}

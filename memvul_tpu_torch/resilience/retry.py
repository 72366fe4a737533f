"""Transient-failure classification and a retry/backoff policy (the JAX
package's ``resilience/retry.py``).

A failure is transient when its text carries one of the markers below;
anything else is a bug and propagates at once.  The serving path wraps each
device call in :meth:`RetryPolicy.call` and dead-letters the batch when the
retries run out.  The chaos hooks that drive it in tests are in :mod:`.faults`.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional, Sequence, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

# substrings marking a transient backend failure worth retrying
RETRYABLE_MARKERS = (
    "UNAVAILABLE",
    "Unable to initialize backend",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "Socket closed",
    "failed to connect",
    "watchdog: phase",
)


def exception_text(exc: BaseException) -> str:
    """What the markers are matched against: type name and message."""
    return f"{type(exc).__name__}: {exc}"


@dataclasses.dataclass
class RetryPolicy:
    """Attempts, backoff and the transient classification.  ``delay`` is
    ``backoff * attempt`` seconds after the attempt-th failure, or
    ``backoff * 2**(attempt - 1)`` with ``exponential``."""

    attempts: int = 3
    backoff: float = 2.0
    markers: Sequence[str] = RETRYABLE_MARKERS
    sleep: Callable[[float], None] = time.sleep
    exponential: bool = False

    def is_transient(self, text: str) -> bool:
        return any(m in text for m in self.markers)

    def delay(self, attempt: int) -> float:
        if self.exponential:
            return self.backoff * (2 ** (max(1, attempt) - 1))
        return self.backoff * attempt

    def call(
        self,
        fn: Callable[[], T],
        description: str = "operation",
        on_retry: Optional[Callable[[BaseException, int], None]] = None,
    ) -> T:
        """Run ``fn`` with up to ``attempts`` tries.  Only transient
        failures are retried (``on_retry(exc, attempt)`` before each
        wait); anything else propagates without burning retries."""
        last: Optional[BaseException] = None
        for attempt in range(1, max(1, self.attempts) + 1):
            try:
                return fn()
            except BaseException as e:
                if not self.is_transient(exception_text(e)):
                    raise
                last = e
                if attempt >= self.attempts:
                    break
                if on_retry is not None:
                    on_retry(e, attempt)
                logger.warning(
                    "%s failed transiently (%s); retry %d/%d in %.0fs",
                    description, exception_text(e)[:200],
                    attempt, self.attempts - 1, self.delay(attempt),
                )
                self.sleep(self.delay(attempt))
        assert last is not None
        raise last

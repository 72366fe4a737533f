"""Per-anchor win attribution and drift against a pinned baseline (the
JAX package's ``bankops/drift.py``).

A serving path that counts each served decision's winning anchor
(``bank.anchor_wins.<id>`` counters) gives the win-share distribution:
what fraction of decisions each anchor wins.  Its drift against a pinned
baseline, captured while the bank was known healthy, is the total-variation
distance (0 identical, 1 disjoint), published as the ``bank.anchor_drift``
gauge.  The baseline is a plain JSON file (``anchor_baseline.json``),
written atomically.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, Optional, Union

from ..resilience.io import atomic_write_text

WINS_PREFIX = "bank.anchor_wins."
SCORE_PREFIX = "bank.anchor_score."
BASELINE_NAME = "anchor_baseline.json"
DRIFT_GAUGE = "bank.anchor_drift"


def win_counts(counters: Dict[str, int]) -> Dict[str, int]:
    """Per-anchor win counts from a counter mapping (a registry
    snapshot or a ``telemetry.json`` counters dict)."""
    return {
        name[len(WINS_PREFIX):]: int(value)
        for name, value in counters.items()
        if name.startswith(WINS_PREFIX)
    }


def win_shares(counts: Dict[str, int]) -> Dict[str, float]:
    total = sum(counts.values())
    if total <= 0:
        return {}
    return {anchor: count / total for anchor, count in counts.items()}


def total_variation(
    current: Dict[str, float], baseline: Dict[str, float]
) -> float:
    """Total-variation distance between two win-share distributions —
    half the L1 over the union of anchors, so an anchor present in only
    one distribution contributes its full share."""
    keys = set(current) | set(baseline)
    return 0.5 * sum(
        abs(current.get(k, 0.0) - baseline.get(k, 0.0)) for k in keys
    )


def pin_baseline(
    registry, path: Union[str, Path]
) -> Dict[str, float]:
    """Snapshot the registry's current win-share distribution as the
    pinned baseline file.  Returns the pinned distribution."""
    shares = win_shares(win_counts(registry.snapshot()["counters"]))
    atomic_write_text(
        Path(path),
        json.dumps({"win_shares": shares}, indent=2, sort_keys=True),
    )
    return shares


def load_baseline(path: Union[str, Path]) -> Optional[Dict[str, float]]:
    """The pinned win-share distribution, or None when absent or
    unreadable (a report/monitor must degrade, not crash)."""
    try:
        obj = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None
    shares = obj.get("win_shares") if isinstance(obj, dict) else None
    if not isinstance(shares, dict):
        return None
    try:
        return {str(k): float(v) for k, v in shares.items()}
    except (TypeError, ValueError):
        return None


def update_drift_gauge(
    registry, baseline: Dict[str, float]
) -> Optional[float]:
    """Recompute win-share drift vs ``baseline`` and publish it as the
    ``bank.anchor_drift`` gauge.  Returns the drift, or None when no
    wins have been recorded yet."""
    shares = win_shares(win_counts(registry.snapshot()["counters"]))
    if not shares:
        return None
    drift = total_variation(shares, baseline)
    registry.gauge(DRIFT_GAUGE).set(drift)
    return drift


class DriftMonitor:
    """Background drift publisher for a serving process: every
    ``interval_s`` it recomputes the drift gauge from the registry's
    win counters.  Pure control plane — it never touches the request
    path, and a missing/empty distribution is just skipped."""

    def __init__(
        self,
        registry,
        baseline: Dict[str, float],
        interval_s: float = 30.0,
    ) -> None:
        self._registry = registry
        self._baseline = dict(baseline)
        self._interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="memvul-bank-drift", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                update_drift_gauge(self._registry, self._baseline)
            except Exception:  # a monitor must never take the process down
                pass

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout)

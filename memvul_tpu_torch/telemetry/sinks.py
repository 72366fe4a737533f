"""Telemetry sinks: the on-disk formats a run directory accumulates (the
JAX package's ``telemetry/sinks.py``).

* ``events.jsonl`` — append-only, one self-contained JSON object per line,
  flushed per write, so a SIGKILL tears at most the last line; readers
  skip an unparseable tail.
* ``telemetry.json`` — the rolled-up summary, rewritten whole through
  ``resilience.io.atomic_write_text``.
* ``HEARTBEAT.json`` — the liveness file, same atomic contract: a
  supervisor polls it to tell a stalled run from a slow one.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union


class JsonlSink:
    """Append-only JSONL event stream (one flushed line per event)."""

    def __init__(self, path: Union[str, Path]) -> None:
        self.path = Path(path)
        self._f = None
        self._lock = threading.Lock()

    def emit(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, default=str)
        with self._lock:
            if self._f is None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                # JsonlSink IS the sanctioned append-only writer (one
                # flushed line per event, torn-tail-tolerant readers)
                self._f = open(self.path, "a", encoding="utf-8")  # lint: disable=MV103
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def read_jsonl(path: Union[str, Path]) -> Tuple[List[Dict[str, Any]], int]:
    """``(records, n_skipped)`` of a JSONL stream: unparseable or non-object
    lines (a torn tail) are skipped, not fatal."""
    path = Path(path)
    if not path.exists():
        return [], 0
    records: List[Dict[str, Any]] = []
    skipped = 0
    for line in path.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            skipped += 1
            continue
        if isinstance(obj, dict):
            records.append(obj)
        else:
            skipped += 1
    return records, skipped


class AtomicJsonFile:
    """Whole-document JSON snapshot through a tmp file and ``os.replace``."""

    def __init__(self, path: Union[str, Path]) -> None:
        self.path = Path(path)

    def write(self, payload: Dict[str, Any]) -> None:
        from ..resilience.io import atomic_write_text

        atomic_write_text(self.path, json.dumps(payload, indent=2, default=str))

    def read(self) -> Dict[str, Any]:
        """The current snapshot, or {} when it is absent or unreadable."""
        try:
            obj = json.loads(self.path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            return {}
        return obj if isinstance(obj, dict) else {}


class HeartbeatFile(AtomicJsonFile):
    """The liveness snapshot (``HEARTBEAT.json``)."""


class SummaryFile(AtomicJsonFile):
    """The rolled-up run summary (``telemetry.json``)."""

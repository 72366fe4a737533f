"""Progress journal and dead-letter quarantine for restartable scoring
(the JAX package's ``resilience/journal.py``).

A corpus pass (``SiamesePredictor.predict_file``) writes one output line
per batch.  The journal is an append-only JSONL file beside it
(``<out>.journal``) with one entry per committed output line:

    {"line": <0-based output line index>,
     "rows": [[start, end), ...]  # stream indices of the reports scored,
     "n": <row count>,
     "sha256": <hex digest of the output line, newline excluded>}

On restart :meth:`ScoreJournal.verified_prefix` replays the journal
against the output file and keeps the longest prefix whose lines hash
clean: a torn last line, or an entry whose output line never landed,
falls off the end and its rows are scored again.  The kept rows are
skipped in the input stream and the kept lines fed back into the metrics,
so a resumed run ends with the output and metrics of an uninterrupted
one.

The dead-letter file (``<out>.deadletter``) takes the records the stream
cannot score (unparseable lines, records that fail to prepare, over-long
texts), one JSON line each with its reason.

Both take an optional :class:`~memvul_tpu_torch.telemetry.Registry` and
count into it: ``score.dead_letters``, ``journal.lines_committed`` and
``journal.rows_committed`` (this process's appends only).
"""

from __future__ import annotations

import hashlib
import json
import logging
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple, Union

from .io import atomic_write_text

logger = logging.getLogger(__name__)

# texts beyond this many characters are quarantined, not tokenized: one
# pasted dump of 100 MB would stall the whole stream
DEFAULT_MAX_TEXT_CHARS = 1_000_000


def line_digest(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def to_spans(indices: Iterable[int]) -> List[List[int]]:
    """Sorted indices → the fewest ``[start, end)`` spans."""
    spans: List[List[int]] = []
    for i in sorted(indices):
        if spans and i == spans[-1][1]:
            spans[-1][1] = i + 1
        else:
            spans.append([i, i + 1])
    return spans


def from_spans(spans: Iterable[Sequence[int]]) -> Set[int]:
    out: Set[int] = set()
    for start, end in spans:
        out.update(range(int(start), int(end)))
    return out


class DeadLetter:
    """Append-only quarantine of malformed and over-long records (with
    ``path`` None, a count only: a mesh rank that writes no files)."""

    def __init__(
        self,
        path: Optional[Union[str, Path]],
        max_text_chars: int = DEFAULT_MAX_TEXT_CHARS,
        registry=None,
    ) -> None:
        self.path = Path(path) if path is not None else None
        self.max_text_chars = max_text_chars
        self.count = 0
        self._registry = registry
        self._f = None

    def record(
        self,
        reason: str,
        raw: Optional[str] = None,
        meta: Optional[Dict[str, Any]] = None,
    ) -> None:
        if self.path is not None and self._f is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            # the dead-letter trail is itself the committed append-only
            # artifact (flushed per line, torn-tail-tolerant readers)
            self._f = open(self.path, "w", encoding="utf-8")  # lint: disable=MV103
        entry: Dict[str, Any] = {"reason": reason}
        if raw is not None:
            entry["raw"] = raw[:2000]  # enough to identify, never a whole dump
        if meta:
            entry["meta"] = meta
        if self._f is not None:
            self._f.write(json.dumps(entry, default=str) + "\n")
            self._f.flush()
        self.count += 1
        logger.warning("dead-letter: %s", reason)
        if self._registry is not None:
            self._registry.counter("score.dead_letters").inc()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class ScoreJournal:
    """Append-only progress journal beside a scoring output file."""

    def __init__(self, path: Union[str, Path], registry=None) -> None:
        self.path = Path(path)
        self._registry = registry
        self._f = None
        self.entries_written = 0  # the verified prefix plus this run's appends

    # -- resume side ---------------------------------------------------------

    def read_entries(self) -> List[Dict[str, Any]]:
        """Every parseable entry, in order.  A torn last line (the kill
        window) is dropped quietly; a torn line anywhere else ends the
        trusted prefix there."""
        if not self.path.exists():
            return []
        entries: List[Dict[str, Any]] = []
        lines = self.path.read_text(encoding="utf-8").splitlines()
        for i, line in enumerate(lines):
            try:
                entry = json.loads(line)
            except ValueError:
                if i != len(lines) - 1:
                    logger.warning(
                        "journal %s: unparseable entry at line %d; trusting only "
                        "the %d entries before it", self.path, i, len(entries),
                    )
                break
            if not isinstance(entry, dict) or "sha256" not in entry:
                break
            entries.append(entry)
        return entries

    def verified_prefix(self, out_path: Union[str, Path]) -> Tuple[int, Set[int], List[str]]:
        """``(n_lines, completed_rows, kept_lines)``: how many output lines
        verify against the journal (in order, no gaps), the stream rows
        they cover, and their texts (newline stripped)."""
        entries = self.read_entries()
        out_path = Path(out_path)
        if not entries or not out_path.exists():
            return 0, set(), []
        with open(out_path, encoding="utf-8") as f:
            out_lines = f.read().splitlines()
        kept: List[str] = []
        completed: Set[int] = set()
        for i, entry in enumerate(entries):
            if entry.get("line") != i:
                logger.warning(
                    "journal %s: entry %d indexes line %s; the verified prefix "
                    "stops here", self.path, i, entry.get("line"),
                )
                break
            if i >= len(out_lines) or line_digest(out_lines[i]) != entry["sha256"]:
                logger.warning(
                    "journal %s: output line %d missing or its checksum differs "
                    "(a torn write); scoring again from there", self.path, i,
                )
                break
            kept.append(out_lines[i])
            completed |= from_spans(entry.get("rows", ()))
        return len(kept), completed, kept

    def truncate_to(self, n_entries: int, out_path: Union[str, Path]) -> None:
        """Drop everything past the verified prefix: the journal rewritten
        (atomically) to its first ``n_entries`` entries, the output file cut
        to the matching byte length."""
        entries = self.read_entries()[:n_entries]
        atomic_write_text(self.path, "".join(json.dumps(e) + "\n" for e in entries))
        out_path = Path(out_path)
        if out_path.exists():
            keep_bytes = 0
            with open(out_path, "rb") as f:
                for _ in range(n_entries):
                    line = f.readline()
                    if not line:
                        break
                    keep_bytes += len(line)
            # truncating a torn tail back to the last committed line is
            # the journal's own recovery commit, not a bare write
            with open(out_path, "r+b") as f:  # lint: disable=MV103
                f.truncate(keep_bytes)
        self.entries_written = n_entries

    # -- writer side ---------------------------------------------------------

    def append(self, line_index: int, rows: Iterable[int], line_text: str) -> None:
        """Record one committed output line.  The caller flushes the line
        to its file first: the entry is the durable claim that it landed."""
        if self.path is not None and self._f is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            # the journal IS the committed append-only trail (flushed per
            # entry; a restart verifies and truncates any torn tail)
            self._f = open(self.path, "a", encoding="utf-8")  # lint: disable=MV103
        rows = list(rows)
        entry = {
            "line": line_index,
            "rows": to_spans(rows),
            "n": len(rows),
            "sha256": line_digest(line_text),
        }
        self._f.write(json.dumps(entry) + "\n")
        self._f.flush()
        self.entries_written += 1
        if self._registry is not None:
            self._registry.counter("journal.lines_committed").inc()
            self._registry.counter("journal.rows_committed").inc(len(rows))

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

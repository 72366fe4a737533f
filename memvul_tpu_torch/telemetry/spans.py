"""The process's span recorder: named intervals of every thread on one clock.

A span is a scope of host work: its name, the OS thread that ran it
(``threading.get_native_id()``, the id ``torch.profiler`` gives that
thread's events), its start and end in ``time.perf_counter_ns()``, the span
open around it on the same thread (``parent``, that span's ``seq``) and an
optional ``id``, a batch or block number.  A span opened without an id takes
its parent's, so the copies inside a batch's launch carry the batch's id.

Recording is off by default; :func:`record` switches it on (a fresh, empty
buffer) and off (the buffer stays readable through :func:`recorded`).  The
buffer is in memory and keeps the first :data:`CAPACITY` spans of a
recording; the rest are counted (:func:`dropped`).  While recording is off,
:func:`span` costs one flag check and returns a shared no-op scope, and
:func:`begin` / :func:`end` read the clock and write nothing.

Two forms share the buffer.  :meth:`~memvul_tpu_torch.telemetry.Registry.
span` records here besides its events and ``span.<name>`` histogram
(``anchor_encode``, ``aot_warmup``, ``score_stream``).  The light form,
:func:`span` and :func:`begin` / :func:`end`, writes only here: the per-batch
boundaries of corpus scoring (``score.*``), the feed thread's (``feed.*``)
and set-up's (``kernels.load``, ``warmup.shape``).  :func:`begin` and
:func:`end` return their clock reads, so a caller that books durations of
its own (``SiamesePredictor.stats``) books the spans' own timestamps.  A
:func:`begin` is closed by the next :func:`end` on its thread, so a span
never stays open across a generator's ``yield``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional

# spans one recording keeps (a 51 s scoring window writes a few thousand)
CAPACITY = 1 << 18


class Span(NamedTuple):
    seq: int  # unique in the process, in the order spans were opened
    name: str
    tid: int  # threading.get_native_id() of the thread that ran it
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: Optional[int]  # seq of the span open around it on its thread
    id: Optional[int]  # a batch or block number; else the parent's


_on = False
_generation = 0  # a new recording leaves the frames of an older one behind
_records: List[tuple] = []  # Span's fields, made Spans when read
_dropped = 0
_seq = itertools.count()
_local = threading.local()


def record(on: bool = True) -> None:
    """Switch recording on, into a fresh empty buffer, or off (the buffer
    stays readable)."""
    global _on, _generation, _records, _dropped
    if on:
        _generation += 1
        _records, _dropped = [], 0
    _on = bool(on)


def recorded() -> List[Span]:
    """The spans closed so far in the current (or last) recording, in the
    order they closed."""
    return [Span._make(r) for r in list(_records)]


def dropped() -> int:
    """Spans the current recording closed beyond :data:`CAPACITY`."""
    return _dropped


def _stack() -> list:
    local = _local.__dict__
    stack = local.get("stack")
    if stack is None:
        stack = local["stack"] = []
        local["tid"] = threading.get_native_id()
    return stack


def begin(name: str, id: Optional[int] = None) -> int:
    """Open a span on this thread; returns its start, ``perf_counter_ns``."""
    t = time.perf_counter_ns()
    if _on:
        stack = _stack()
        if stack and stack[-1][0] != _generation:
            stack.clear()  # opened before this recording started
        parent = stack[-1] if stack else None
        if id is None and parent is not None:
            id = parent[5]
        stack.append((_generation, next(_seq), name, t,
                      parent[1] if parent is not None else None, id))
    return t


def end() -> int:
    """Close this thread's innermost span; returns its end,
    ``perf_counter_ns``."""
    global _dropped
    t = time.perf_counter_ns()
    if _on:
        stack = _stack()
        if stack:
            generation, seq, name, start, parent, id = stack.pop()
            if generation == _generation:
                if len(_records) < CAPACITY:
                    _records.append((seq, name, _local.tid, start, t, parent, id))
                else:
                    _dropped += 1
            else:
                stack.clear()
    return t


class _Scope:
    __slots__ = ("name", "id")

    def __init__(self, name: str, id: Optional[int]) -> None:
        self.name, self.id = name, id

    def __enter__(self) -> None:
        begin(self.name, self.id)

    def __exit__(self, *exc) -> None:
        end()


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


def span(name: str, id: Optional[int] = None):
    """A span over a ``with`` block; while recording is off, a shared scope
    that does nothing."""
    return _Scope(name, id) if _on else _OFF

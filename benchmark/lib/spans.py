"""The program's own spans, put on the profiler's clock, and the idle
seconds of the card that they name.

The program records spans when its recorder is on
(``memvul_tpu_torch.telemetry.spans``): a name, the OS thread, a start and
an end in ``time.perf_counter_ns()``, the span around it on its thread and a
batch or block id.  :class:`SpanTracer` is the harness's tracer that also
reads ``perf_counter_ns()`` immediately before it opens ``perfbench.window``;
that read and the window's start on the profiler's clock are one pair
(``trace["clock"]``), and :func:`program_view` moves every span onto the
profiler's clock with it (the profiler stamps a range about 30-100 us into
its opening, on the host).

A run that carries the program's spans holds, beside the harness's keys:

* ``run["trace"]["clock"]``: ``[perf_counter_ns, profiler ns]`` of the
  window's opening;
* ``run["program"]``: ``{"spans": [[seq, name, tid, start, end, parent,
  id], ...], "counters": {...}, "dropped": n}``, the spans on the profiler's
  clock (:func:`program_view`).

The readers of ``metrics/`` take their numbers from here and return None
where a run has no such key or no such span; :func:`idle_by_span` names each
idle gap of the window by the innermost program span open at its middle on
the thread that launches the batches (``score.launch``) and on the feed
thread (``feed.collate``).  Nothing here imports the program.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import harness, trace

SEQ, NAME, TID, START, END, PARENT, ID = range(7)
SETUP = ("kernels.load", "anchor_encode", "aot_warmup")
NONE = "-"


class SpanTracer(harness.Tracer):
    """:class:`~benchmark.lib.harness.Tracer` with the clock pair."""

    clock_ns: Optional[int] = None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self._window = record_function(trace.WINDOW)
        self.clock_ns = time.perf_counter_ns()
        self._window.__enter__()
        self.active = True

    def collected(self) -> Optional[Dict]:
        out = super().collected()
        if out is not None:
            out["clock"] = [self.clock_ns, out["window"][0]]
        return out


def program_view(recorded: Sequence, counters: Dict, dropped: int,
                 clock: Optional[Sequence[int]] = None) -> Dict:
    """``run["program"]`` from the recorder's spans (on the profiler's clock
    when ``clock`` is given) and the predictor's counters."""
    shift = clock[1] - clock[0] if clock else 0
    out = [[s[SEQ], s[NAME], s[TID], s[START] + shift, s[END] + shift, s[PARENT], s[ID]]
           for s in recorded]
    return {"spans": out, "counters": dict(counters), "dropped": int(dropped)}


def program_spans(run) -> Optional[List[list]]:
    program = run.get("program")
    return program["spans"] if program and program.get("spans") else None


def seconds_of(spans: Sequence[list]) -> float:
    return sum(s[END] - s[START] for s in spans) / 1e9


def launch_split(run) -> Tuple[Optional[float], Optional[float]]:
    """(seconds in ``score.launch``, seconds in the ``score.h2d`` spans
    inside them) on rank 0, or (None, None) without launch spans."""
    spans = program_spans(run)
    launches = {s[SEQ] for s in spans or () if s[NAME] == "score.launch"}
    if not launches:
        return None, None
    launch = seconds_of([s for s in spans if s[SEQ] in launches])
    h2d = seconds_of([s for s in spans if s[NAME] == "score.h2d" and s[PARENT] in launches])
    return launch, h2d


def stream_share(run, seconds: Optional[float]) -> Optional[float]:
    """``seconds`` as a share of the scoring stream's wall time, in %."""
    return None if seconds is None else 100.0 * seconds / run["stream"]["seconds"]


def _tid_of(spans: Sequence[list], name: str) -> Optional[int]:
    tids = {s[TID] for s in spans if s[NAME] == name}
    return tids.pop() if len(tids) == 1 else None


def _timeline(intervals: Sequence[Tuple[str, int, int]]) -> Tuple[List[int], List[Optional[str]]]:
    """Properly nested intervals of one thread as the innermost name from
    each time on: (times, names), for :func:`bisect.bisect_right`."""
    times: List[int] = []
    names: List[Optional[str]] = []
    stack: List[Tuple[int, str]] = []

    def close_until(t: int) -> None:
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            times.append(end)
            names.append(stack[-1][1] if stack else None)

    for name, s, e in sorted(intervals, key=lambda x: (x[1], -x[2])):
        close_until(s)
        stack.append((e, name))
        times.append(s)
        names.append(name)
    close_until(float("inf"))
    return times, names


def _at(timeline, t: int) -> Optional[str]:
    times, names = timeline
    i = bisect.bisect_right(times, t) - 1
    return names[i] if i >= 0 else None


def idle_by_span(run) -> Optional[Dict]:
    """Each idle gap of rank 0's traced window, named at its middle by the
    innermost program span open on the launch thread (else the innermost
    ``perfbench.*`` range other than the window, else ``-``) and on the feed
    thread (else ``-``): ``{"pairs": [["launch / feed", seconds], ...],
    "idle_s": ..., "unnamed_s": ...}``, where ``unnamed_s`` is the idle time
    in which the launch thread was in neither."""
    spans, tr = program_spans(run), run.get("trace")
    if not spans or not tr or "clock" not in tr:
        return None
    launch_tid, feed_tid = _tid_of(spans, "score.launch"), _tid_of(spans, "feed.collate")
    if launch_tid is None:
        return None
    launch = _timeline([(s[NAME], s[START], s[END]) for s in spans if s[TID] == launch_tid])
    feed = _timeline([(s[NAME], s[START], s[END]) for s in spans if s[TID] == feed_tid])
    ranges = _timeline([(h[0], h[1], h[2]) for h in tr["host"]
                        if h[3] and h[0].startswith("perfbench.") and h[0] != trace.WINDOW])
    lo, hi = tr["window"]
    busy = trace.busy_intervals(tr["device"], lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    pairs: Dict[str, float] = {}
    idle = unnamed = 0.0
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid, dur = (s + e) // 2, (e - s) / 1e9
        on_launch = _at(launch, mid) or _at(ranges, mid)
        label = f"{on_launch or NONE} / {_at(feed, mid) or NONE}"
        pairs[label] = pairs.get(label, 0.0) + dur
        idle += dur
        if on_launch is None:
            unnamed += dur
    ranked = [[k, v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])]
    return {"pairs": ranked, "idle_s": idle, "unnamed_s": unnamed}


def format_table(table: Dict, top: int = 20) -> str:
    lines = [f"idle by span (launch thread / feed thread), {table['idle_s']:.3f} s idle, "
             f"{table['unnamed_s']:.3f} s where the launch thread was in no span:"]
    for label, sec in table["pairs"][:top]:
        lines.append(f"  {sec:10.3f} s  {100.0 * sec / max(table['idle_s'], 1e-12):5.1f}%  {label}")
    return "\n".join(lines)

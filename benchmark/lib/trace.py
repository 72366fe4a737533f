"""A ``torch.profiler`` trace, reduced to plain lists and then to numbers.

:func:`collect` keeps, from the profiler's events, the device's operations
(kernels, copies, sets) and the host events of the thread that ran the
benchmark's ``perfbench.window`` range; the rest of the trace is dropped.
:func:`summarize` works on those lists alone, so it is tested without a
card: the traced window, the seconds in which some operation ran on the
device (the union of their intervals), the operations that took the most
time, and the idle gaps, each named by what that thread was doing at its
middle (the innermost ``perfbench.*`` range and the innermost operation).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "perfbench.window"
Interval = Tuple[str, int, int]  # (name, start_ns, end_ns)


def collect(prof) -> Dict:
    """The device operations and the window thread's host events of a
    finished profile, times in nanoseconds on the profiler's clock."""
    device: List[Interval] = []
    host: Dict[int, List[Tuple[str, int, int, bool]]] = {}
    window: Optional[Tuple[int, int, int]] = None
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        start, end = int(e.start_ns()), int(e.end_ns())
        annotation = bool(e.is_user_annotation())
        if kind.endswith("CUDA"):
            # a range of the host's also shows on the device's timeline: not work
            if not annotation:
                device.append((e.name(), start, end))
            continue
        tid = int(e.device_resource_id())
        host.setdefault(tid, []).append((e.name(), start, end, annotation))
        if annotation and e.name() == WINDOW:
            window = (start, end, tid)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    start, end, tid = window
    device.sort(key=lambda x: x[1])
    return {"window": (start, end), "device": device,
            "host": sorted(host.get(tid, []), key=lambda x: x[1])}


def busy_intervals(device: Sequence[Interval], lo: int, hi: int,
                   match: Optional[str] = None) -> List[Tuple[int, int]]:
    """The union of the operations' intervals (those whose name holds
    ``match``, if given), clipped to ``[lo, hi]``."""
    out: List[Tuple[int, int]] = []
    for name, s, e in sorted(device, key=lambda x: x[1]):
        if match is not None and match not in name:
            continue
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def seconds(intervals: Sequence[Tuple[int, int]]) -> float:
    return sum(e - s for s, e in intervals) / 1e9


def _innermost(events: Sequence[Tuple[str, int, int, bool]], starts: List[int], t: int,
               lookback: int) -> Optional[str]:
    i = bisect.bisect_right(starts, t)
    for name, s, e, _ in reversed(events[max(0, i - lookback) : i]):
        if s <= t < e:
            return name
    return None


def summarize(trace: Dict, top: int = 10) -> Dict:
    """window_s, busy_s, the ``top`` device operations by time and the
    ``top`` idle-gap labels by time, each as ``[name, seconds]``."""
    lo, hi = trace["window"]
    device = trace["device"]
    busy = busy_intervals(device, lo, hi)
    by_name: Dict[str, float] = {}
    for name, s, e in device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    spans = [h for h in trace["host"] if h[3] and h[0].startswith("perfbench.") and h[0] != WINDOW]
    ops = [h for h in trace["host"] if not h[3]]
    span_starts, op_starts = [h[1] for h in spans], [h[1] for h in ops]
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            mid = (s + e) // 2
            span = _innermost(spans, span_starts, mid, 8) or WINDOW
            op = _innermost(ops, op_starts, mid, 400) or "python"
            label = f"{span}/{op}"
            gaps[label] = gaps.get(label, 0.0) + (e - s) / 1e9
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"window_s": (hi - lo) / 1e9, "busy_s": seconds(busy),
            "device_ops": rank(by_name), "idle_gaps": rank(gaps)}

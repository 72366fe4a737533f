"""Step timing, device memory and profiler traces (the JAX package's
``utils/profiling.py``).

* :class:`StepTimer` — per-step wall durations with a percentile summary;
  the first step (which builds and warms) is reported apart as
  ``first_s``;
* :func:`device_memory_stats` — live and peak bytes of a CUDA device from
  ``torch.cuda.memory_stats`` (``bytes_in_use`` is the caching
  allocator's ``allocated_bytes.all.current``, ``peak_bytes_in_use`` its
  ``allocated_bytes.all.peak``, ``bytes_limit`` the card's memory); ``{}``
  for the CPU, as the JAX package returns for a backend without memory
  stats.  These are the allocator's bytes, not the device's: memory the
  allocator caches but has not handed out, and the CUDA context, are not
  in them;
* :func:`trace_context` — a ``torch.profiler`` scope with the CPU and the
  CUDA activities that writes a Chrome trace (``trace.json``) into the
  given directory, where the JAX package writes a TensorBoard trace
  directory;
* :class:`ProfilerCapture` — on-demand timed captures of a live process
  through that scope, one at a time (``POST /profilez``).  A capture
  starts and stops on a thread of its own, never on a request handler;
  CUDA kernels are traced from every thread of the process, so the trace
  names the kernels the serving threads launch.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

TRACE_FILE = "trace.json"


class StepTimer:
    """Per-step wall durations.  A stats drain's time is spread over the
    steps it covers (:meth:`distribute_over_last`): the steps themselves
    only enqueue work on the card, the drain waits for it."""

    def __init__(self) -> None:
        self._durations: List[float] = []

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self._durations.append(time.perf_counter() - start)

    @contextlib.contextmanager
    def distribute_over_last(self, n: int) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            if not self._durations:
                if elapsed > 0:
                    self._durations.append(elapsed)
            else:
                n = max(1, min(n, len(self._durations)))
                for i in range(len(self._durations) - n, len(self._durations)):
                    self._durations[i] += elapsed / n

    def __len__(self) -> int:
        return len(self._durations)

    @property
    def durations(self) -> tuple:
        return tuple(self._durations)

    def summary(self, prefix: str = "step_") -> Dict[str, float]:
        """The first step (which builds and warms) apart as ``first_s``."""
        if not self._durations:
            return {}
        first, rest = self._durations[0], self._durations[1:]
        out = {
            f"{prefix}first_s": first,
            f"{prefix}count": float(len(self._durations)),
            f"{prefix}total_s": float(np.sum(self._durations)),
        }
        if rest:
            out.update({
                f"{prefix}mean_s": float(np.mean(rest)),
                f"{prefix}p50_s": float(np.percentile(rest, 50)),
                f"{prefix}p95_s": float(np.percentile(rest, 95)),
                f"{prefix}max_s": float(np.max(rest)),
            })
        return out

    def reset(self) -> None:
        self._durations.clear()


def _cuda_stats(index: int) -> Dict[str, float]:
    import torch

    stats = torch.cuda.memory_stats(index)
    out = {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": float(torch.cuda.get_device_properties(index).total_memory),
    }
    return out


def device_memory_stats(device=None, all_devices: bool = False) -> Dict[str, float]:
    """Live, peak and limit bytes of one CUDA device (``device``, else the
    current one); ``{}`` for a CPU device or a host without CUDA.  With
    ``all_devices`` every visible card is read: the three byte keys are
    summed, each card's peak is also ``peak_bytes_in_use_device<i>`` and
    ``devices_reporting`` counts the cards."""
    import torch

    if not torch.cuda.is_available():
        return {}
    if not all_devices:
        if device is None:
            index = torch.cuda.current_device()
        else:
            device = torch.device(device)
            if device.type != "cuda":
                return {}
            index = device.index if device.index is not None else torch.cuda.current_device()
        return _cuda_stats(index)
    out: Dict[str, float] = {}
    for i in range(torch.cuda.device_count()):
        stats = _cuda_stats(i)
        for key, value in stats.items():
            out[key] = out.get(key, 0.0) + value
        out[f"peak_bytes_in_use_device{i}"] = stats["peak_bytes_in_use"]
    out["devices_reporting"] = float(torch.cuda.device_count())
    return out


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` scope (CPU, and CUDA where there is a card)
    whose Chrome trace goes to ``<log_dir>/trace.json``; a no-op when
    ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(out / TRACE_FILE))


class CaptureInProgress(RuntimeError):
    """A capture is already running: the profiler allows one at a time,
    so the caller gets a 409, not a nested profiler."""


class ProfilerCapture:
    """One-at-a-time on-demand profiler captures of a live process.

    ``start(seconds)`` opens a :func:`trace_context` on a thread of its
    own for the requested duration and returns at once with the capture's
    trace dir (``profile-<n>/`` under ``base_dir``); a second start while
    one runs raises :class:`CaptureInProgress`."""

    def __init__(self, base_dir, max_seconds: float = 300.0) -> None:
        self.base_dir = Path(base_dir)
        self.max_seconds = float(max_seconds)
        self._lock = threading.Lock()
        self._busy = False
        self._captures = 0

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._busy

    @property
    def captures(self) -> int:
        """Completed and in-flight captures this process started."""
        with self._lock:
            return self._captures

    def start(self, seconds: float) -> Dict[str, object]:
        """Begin one timed capture; returns ``{"trace_dir", "seconds"}``.
        Raises ``ValueError`` on a duration outside ``(0, max_seconds]``
        and :class:`CaptureInProgress` while a capture runs."""
        seconds = float(seconds)
        if not (0.0 < seconds <= self.max_seconds):
            raise ValueError(
                f"seconds must be in (0, {self.max_seconds:g}], got {seconds!r}"
            )
        with self._lock:
            if self._busy:
                raise CaptureInProgress(
                    "a profiler capture is already running (one trace at a time)"
                )
            self._busy = True
            self._captures += 1
            trace_dir = self.base_dir / f"profile-{self._captures:03d}"
        thread = threading.Thread(
            target=self._run, args=(trace_dir, seconds),
            name="memvul-profilez-capture", daemon=True,
        )
        thread.start()
        return {"trace_dir": str(trace_dir), "seconds": seconds}

    def _wait(self, seconds: float) -> None:
        """Dwell inside the trace scope for the capture's duration (tests
        replace it with an event wait)."""
        time.sleep(seconds)

    def _run(self, trace_dir: Path, seconds: float) -> None:
        try:
            with trace_context(str(trace_dir)):
                self._wait(seconds)
        except Exception:  # a failed capture must never take the server down
            pass
        finally:
            with self._lock:
                self._busy = False

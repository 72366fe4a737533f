"""The program registry: which device programs the process runs, what each
cost to build, what it does per call and how often it ran (the JAX
package's ``telemetry/programs.py``).

XLA compiles a program per shape; PyTorch runs eagerly, so here a
**program** is:

* one score shape of a predictor, keyed by its shape: a bucket block
  ``score:<rows>x<T>`` (``score_int8:`` on the int8 tier), the pack
  ``ragged:1x<budget>`` and the anchor-bank chunk ``bank:<rows>x<T>``.
  Its ``compile_s`` is the wall time of its first, warming call (which on
  the card also launches each kernel for the first time);
* the kernel library (``ops/_kernels.py``), ``kernels:<library>``, whose
  ``compile_s`` is the ``nvcc`` build and the load.

**Costs are analytic.**  XLA's ``cost_analysis`` has no counterpart, so
:func:`score_cost` counts a call's work from the model's configuration and
the call's shape, the way the kernel bounds in ``PERF.md`` are counted:
the encoder's GEMMs over every token the call processes, the attention at
its live tokens (``4·hidden·Σ n²`` a layer, each row or packed segment of
``n`` live tokens), the pooler, the header and the anchor match (K1); and
the bytes every weight and input read once and every output written once.
A call can pass its own count (a pack's live tokens differ from pack to
pack); the registry then books what that call needed.

**Device time** comes from CUDA events around a call's launches, read after
its host copy has waited for them (``SiamesePredictor``).  A call without
events (the CPU) counts invocations and work only.  ``program.busy_util``
is the work of the timed calls over their device time against the card's
peak (:data:`PEAK_SPECS`): a utilization of the time the card was busy with
them, not of a window (the card's idle time is not in it; the JAX package
names it ``xla.mfu``).  It is only as true as the count and the events, and
a value above 1 means one of them is wrong.

**Recompiles.**  A scope (``"score"``) is marked warm when its warmup has
run every expected shape (:meth:`ProgramRegistry.mark_warm`); a shape key
met for the first time in a warm scope (:meth:`ProgramRegistry.note_trace`)
counts in ``program.recompiles`` and emits an ``rcompile`` event naming
it, where the JAX package counts a trace after warmup.

The rows are named ``program.*`` where the JAX package names them
``xla.*``, one to one: ``program.programs``, ``.compiles``,
``.recompiles``, ``.invocations``, ``.flops_total``, ``.bytes_total``
(counters), ``.device_time_s``, ``.interpret_only``, ``.hbm_bytes``,
``.busy_util`` (``xla.mfu``), ``.achieved_flops_per_s``,
``.achieved_bytes_per_s`` (gauges) and the ``program.compile_s`` histogram.  They live in this registry, not
in a telemetry registry: :meth:`ProgramRegistry.metrics_part` renders them
as an extra snapshot part, so a process that registers nothing scrapes
exactly what it did before.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Peak specs for the roofline denominators: dense bf16 FLOP/s, memory
# bandwidth and memory per card, keyed by a lowercase substring of
# ``torch.cuda.get_device_name``.  Any other device, the CPU included, is
# interpret-only (costs still report; the utilization stays null).
PEAK_SPECS: Dict[str, Dict[str, float]] = {
    "h100": {"flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12, "hbm_bytes": 80e9},
}


def device_info(device: Any = None) -> Tuple[str, str]:
    """(platform, device kind) of ``device`` (default: the current CUDA
    device where there is one): ``("gpu", <card name>)`` or ``("cpu",
    "cpu")``; never raises."""
    try:
        import torch

        if device is not None:
            device = torch.device(device)
            if device.type != "cuda":
                return "cpu", "cpu"
        if not torch.cuda.is_available():
            return "cpu", "cpu"
        index = None if device is None else device.index
        return "gpu", str(torch.cuda.get_device_name(index))
    except Exception:  # pragma: no cover - a failed device query
        return "unknown", "unknown"


def peak_spec(device_kind: str) -> Optional[Dict[str, float]]:
    """The peak-spec row for a device kind, or None (interpret-only)."""
    kind = device_kind.lower()
    for marker, spec in PEAK_SPECS.items():
        if marker in kind:
            return spec
    return None


def shape_key(prefix: str, shape: Sequence[int]) -> str:
    """``prefix:<d0>x<d1>...``, e.g. ``ragged:1x2048``."""
    return f"{prefix}:{'x'.join(str(int(d)) for d in shape)}"


def model_bytes(model) -> int:
    """Bytes of a module's parameters (each weight read once a call)."""
    return int(sum(p.numel() * p.element_size() for p in model.parameters()))


def score_cost(
    config,
    processed_tokens: int,
    live_lengths: Sequence[int],
    rows: int,
    n_anchors: int = 0,
    header_dim: Optional[int] = None,
    num_classes: int = 2,
    weight_bytes: int = 0,
    bank_bytes: int = 0,
) -> Tuple[float, float]:
    """(FLOPs, bytes) of one encoder call and anchor match.

    ``config`` is the encoder's ``BertConfig`` (or a config with its own
    ``encoder_flops``, as LFM2's: a decoder with no pooler, its attention
    causal); ``processed_tokens`` every
    token slot the GEMMs run over (a block's ``rows × T``, a pack's
    budget); ``live_lengths`` each row's (or packed segment's) live
    tokens, at which the attention is counted; ``rows`` the embeddings
    pooled; ``n_anchors`` the bank rows matched (0: an encode only).
    Bytes: the weights once, the ids and mask in, the embeddings or the
    ``[rows, A]`` probabilities out, and the bank read once."""
    d = int(config.hidden_size)
    tokens = float(processed_tokens)
    attn = float(sum(int(n) * int(n) for n in live_lengths))
    encoder_flops = getattr(config, "encoder_flops", None)
    if encoder_flops is not None:
        flops = encoder_flops(tokens, attn)
    else:
        f = int(config.intermediate_size)
        layers = int(config.num_layers)
        flops = layers * (2.0 * d * (4 * d + 2 * f) * tokens + 4.0 * d * attn)
        flops += 2.0 * d * d * rows  # pooler
    out_dim = d
    if header_dim:
        flops += 2.0 * d * header_dim * rows
        out_dim = int(header_dim)
    nbytes = float(weight_bytes) + tokens * 8  # int32 ids + int32 mask
    if n_anchors:
        a = int(n_anchors)
        c = int(num_classes)
        # |u - v| and one FMA per class and feature, plus the u and v terms
        flops += rows * a * out_dim * (2.0 * c + 1.0) + 2.0 * out_dim * c * (rows + a)
        nbytes += float(bank_bytes) + rows * a * 4
    else:
        nbytes += rows * out_dim * 2
    return flops, nbytes


@dataclass
class ProgramRecord:
    """One registered program (one shape key)."""

    key: str
    scope: str
    compile_s: float
    compiled_wall: float
    compiled_monotonic: float
    platform: str
    device_kind: str
    interpret_only: bool
    flops: float = 0.0
    bytes_accessed: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    invocations: int = 0
    device_time_s: float = 0.0
    recompiles: int = 0
    # work of every invocation, and of the timed ones (the MFU numerator)
    flops_done: float = 0.0
    bytes_done: float = 0.0
    timed_flops: float = 0.0
    timed_bytes: float = 0.0
    compile_times: List[float] = field(default_factory=list)

    @property
    def hbm_bytes(self) -> int:
        return self.argument_bytes + self.output_bytes + self.temp_bytes

    def as_dict(self, peak: Optional[Dict[str, float]]) -> Dict[str, Any]:
        busy_util = None
        if peak is not None and self.device_time_s > 0 and self.timed_flops > 0:
            busy_util = (self.timed_flops / self.device_time_s) / peak["flops_per_s"]
        return {
            "key": self.key,
            "scope": self.scope,
            "compile_s": round(self.compile_s, 6),
            "compiled_wall": self.compiled_wall,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "hbm_bytes": self.hbm_bytes,
            "invocations": self.invocations,
            "device_time_s": round(self.device_time_s, 6),
            "recompiles": self.recompiles,
            "platform": self.platform,
            "device_kind": self.device_kind,
            "interpret_only": self.interpret_only,
            "busy_util": busy_util,
        }


class ProgramRegistry:
    """Thread-safe record of the programs of the process, or of one
    replica (a replica factory builds one per replica).  ``telemetry``
    binds the event channel to a registry (a replica's); unbound, events
    go to the process-wide registry at emit time."""

    def __init__(self, telemetry=None) -> None:
        self._telemetry = telemetry
        self._lock = threading.Lock()
        self._records: Dict[str, ProgramRecord] = {}
        self._order: List[str] = []  # insertion order; newest = last
        self._warm_scopes: Dict[str, bool] = {}
        self._rcompiles = 0
        self._unattributed_invocations = 0

    def _tel(self, override=None):
        if override is not None:
            return override
        if self._telemetry is not None:
            return self._telemetry
        from . import get_registry

        return get_registry()

    # -- registration ----------------------------------------------------------

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._records

    def register(
        self,
        key: str,
        *,
        scope: str = "default",
        compile_s: float = 0.0,
        flops: float = 0.0,
        bytes_accessed: float = 0.0,
        argument_bytes: int = 0,
        output_bytes: int = 0,
        temp_bytes: int = 0,
        device: Any = None,
        telemetry=None,
    ) -> None:
        """Record a built and warmed program under ``key``.  Registering a
        key again (a second predictor warming the same shape) updates the
        record in place, bumps its ``recompiles`` and moves it to the head
        of the newest-first order."""
        platform, kind = device_info(device)
        now_wall, now_mono = time.time(), time.monotonic()
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                rec = ProgramRecord(
                    key=key, scope=scope, compile_s=compile_s, compiled_wall=now_wall,
                    compiled_monotonic=now_mono, platform=platform, device_kind=kind,
                    interpret_only=peak_spec(kind) is None,
                )
                self._records[key] = rec
            else:
                rec.recompiles += 1
                rec.compile_s = compile_s
                rec.compiled_wall = now_wall
                rec.compiled_monotonic = now_mono
                self._order.remove(key)
            rec.compile_times.append(float(compile_s))
            rec.flops = float(flops)
            rec.bytes_accessed = float(bytes_accessed)
            rec.argument_bytes = int(argument_bytes)
            rec.output_bytes = int(output_bytes)
            rec.temp_bytes = int(temp_bytes)
            self._order.append(key)
        self._tel(telemetry).event(
            "program", key=key, scope=scope, compile_s=round(compile_s, 6), flops=rec.flops,
            bytes_accessed=rec.bytes_accessed, hbm_bytes=rec.hbm_bytes, device_kind=kind,
        )

    # -- runtime accounting ----------------------------------------------------

    def record_invocation(
        self,
        key: str,
        seconds: Optional[float] = None,
        flops: Optional[float] = None,
        bytes_accessed: Optional[float] = None,
    ) -> None:
        """One call of a registered program.  ``seconds`` is its device
        time where the call site has events around it; ``flops`` and
        ``bytes_accessed`` the call's own work where it differs from the
        program's (a pack's live tokens), else the program's count."""
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                self._unattributed_invocations += 1
                return
            work = rec.flops if flops is None else float(flops)
            moved = rec.bytes_accessed if bytes_accessed is None else float(bytes_accessed)
            rec.invocations += 1
            rec.flops_done += work
            rec.bytes_done += moved
            if seconds is not None and seconds > 0:
                rec.device_time_s += float(seconds)
                rec.timed_flops += work
                rec.timed_bytes += moved

    def mark_warm(self, scope: str, warm: bool = True) -> None:
        """A scope's warmup edge: ``mark_warm(scope, False)`` on entry to a
        warmup (an intended re-warm stays quiet), ``mark_warm(scope)`` once
        every expected shape has run."""
        with self._lock:
            self._warm_scopes[scope] = bool(warm)

    def is_warm(self, scope: str) -> bool:
        with self._lock:
            return self._warm_scopes.get(scope, False)

    def note_trace(self, scope: str, key: str, telemetry=None) -> None:
        """A shape key met for the first time: in a warm scope that is a
        recompile, counted and emitted as an ``rcompile`` event."""
        with self._lock:
            warm = self._warm_scopes.get(scope, False)
            if warm:
                self._rcompiles += 1
        if warm:
            self._tel(telemetry).event("rcompile", scope=scope, key=key)

    # -- read surfaces ---------------------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        """Per-program rows, newest first (the ``/programz`` order)."""
        with self._lock:
            records = [self._records[k] for k in reversed(self._order)]
            return [r.as_dict(peak_spec(r.device_kind)) for r in records]

    def last_compile(self) -> Optional[Dict[str, Any]]:
        """The most recently registered program (key, ``compile_s`` and its
        age in seconds), or None: the bench watchdog's clue whether a hung
        phase is stuck in or right after that build."""
        with self._lock:
            if not self._order:
                return None
            rec = self._records[self._order[-1]]
            return {
                "key": rec.key,
                "compile_s": round(rec.compile_s, 6),
                "age_s": time.monotonic() - rec.compiled_monotonic,
            }

    def roofline(self) -> Dict[str, Any]:
        """Achieved against peak over every recorded program: the work of
        all calls, and the rates and utilizations of the timed ones
        (interpret-only devices keep the denominators null)."""
        with self._lock:
            records = list(self._records.values())
        platform, kind = device_info()
        if records:
            platform = records[-1].platform
            kind = records[-1].device_kind
        peak = peak_spec(kind)
        flops_total = sum(r.flops_done for r in records)
        bytes_total = sum(r.bytes_done for r in records)
        device_time = sum(r.device_time_s for r in records)
        timed_flops = sum(r.timed_flops for r in records)
        timed_bytes = sum(r.timed_bytes for r in records)
        achieved_flops = timed_flops / device_time if device_time > 0 else None
        achieved_bytes = timed_bytes / device_time if device_time > 0 else None
        busy_util = membw_util = None
        if peak is not None and achieved_flops is not None:
            busy_util = achieved_flops / peak["flops_per_s"]
        if peak is not None and achieved_bytes is not None:
            membw_util = achieved_bytes / peak["hbm_bytes_per_s"]
        return {
            "platform": platform,
            "device_kind": kind,
            "interpret_only": peak is None,
            "peak_flops_per_s": peak["flops_per_s"] if peak else None,
            "peak_bytes_per_s": peak["hbm_bytes_per_s"] if peak else None,
            "programs": len(records),
            "flops_total": flops_total,
            "bytes_total": bytes_total,
            "device_time_s": round(device_time, 6),
            "timed_flops": timed_flops,
            "timed_bytes": timed_bytes,
            "achieved_flops_per_s": achieved_flops,
            "achieved_bytes_per_s": achieved_bytes,
            "busy_util": busy_util,
            "membw_util": membw_util,
        }

    def metrics_part(self) -> Dict[str, Any]:
        """The ``program.*`` rows as one snapshot-shaped dict (an extra
        exposition part); empty when nothing is registered."""
        with self._lock:
            records = list(self._records.values())
            rcompiles = self._rcompiles
            unattributed = self._unattributed_invocations
        if not records:
            return {}
        roof = self.roofline()
        compile_times = sorted(t for r in records for t in r.compile_times)
        n = len(compile_times)
        hist = {
            "count": float(n),
            "total": sum(compile_times),
            "mean": sum(compile_times) / n,
            "min": compile_times[0],
            "max": compile_times[-1],
            "p50": compile_times[(n - 1) // 2],
            "p95": compile_times[min(n - 1, int(round((n - 1) * 0.95)))],
        }
        counters = {
            "program.programs": len(records),
            "program.compiles": n,
            "program.recompiles": rcompiles,
            "program.invocations": sum(r.invocations for r in records) + unattributed,
            "program.flops_total": int(roof["flops_total"]),
            "program.bytes_total": int(roof["bytes_total"]),
        }
        gauges: Dict[str, float] = {
            "program.device_time_s": roof["device_time_s"],
            "program.interpret_only": 1.0 if roof["interpret_only"] else 0.0,
            "program.hbm_bytes": float(max(r.hbm_bytes for r in records)),
        }
        for name, value in (
            ("program.busy_util", roof["busy_util"]),
            ("program.achieved_flops_per_s", roof["achieved_flops_per_s"]),
            ("program.achieved_bytes_per_s", roof["achieved_bytes_per_s"]),
        ):
            if value is not None:
                gauges[name] = float(value)
        return {"counters": counters, "gauges": gauges,
                "histograms": {"program.compile_s": hist}}

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._order.clear()
            self._warm_scopes.clear()
            self._rcompiles = 0
            self._unattributed_invocations = 0


# -- the process-wide registry ---------------------------------------------------

_programs = ProgramRegistry()


def get_program_registry() -> ProgramRegistry:
    """The process-wide program registry (the trainers, the corpus scorer,
    a single service and the kernel library record here; a replica factory
    builds one per replica)."""
    return _programs


def write_programs(run_dir, registry: Optional[ProgramRegistry] = None) -> None:
    """``<run_dir>/programs.json``: the registry's rows and roofline (the
    process-wide one by default), written atomically.  Nothing is written
    when nothing is registered."""
    import json
    from pathlib import Path

    from ..resilience.io import atomic_write_text

    registry = registry if registry is not None else _programs
    snapshot = registry.snapshot()
    if not snapshot:
        return
    payload = {
        "schema": 1,
        "written_wall": time.time(),
        "programs": snapshot,
        "roofline": registry.roofline(),
    }
    Path(run_dir).mkdir(parents=True, exist_ok=True)
    atomic_write_text(Path(run_dir) / "programs.json", json.dumps(payload, indent=2, default=float))

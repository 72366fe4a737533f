"""Deterministic fault injection for chaos tests (the JAX package's
``resilience/faults.py``, with the same ``MEMVUL_FAULTS`` grammar, so one
chaos string drives both packages).

Production code is salted with named injection points, calls to
:func:`fault_point` where the real world can hurt it.  The port wires:

=================  ==========================================================
point              fires
=================  ==========================================================
``score.batch``    once per scoring batch, inside its retried window
                   (``SiamesePredictor.score_instances``)
``shard.kill``     once per corpus row a shard worker yields
                   (``distributed/worker.py``); arm it with ``sigkill`` to
                   die like an OOM-killed host; ``shard.kill.shard-<i>``
                   targets one shard
``shard.stall``    the same site; armed with a ``raise`` action the worker
                   wedges (alive, no progress) so the coordinator's
                   heartbeat-age stall detector must catch it;
                   ``shard.stall.shard-<i>`` targets one shard
``merge.verify``   at the merge's start, before the exactly-once
                   verification (``distributed/coordinator.py``)
``bank.shadow``    once per shadow-scored sample batch, on the shadow
                   worker's thread (``bankops/shadow.py``): a firing lands
                   in ``bank.shadow_errors`` and never reaches a client
``serve.batch``    once per serving device call, inside its retried window
                   (``serving/dispatch.py``); retries exhausted dead-letter
                   the batch: its requests resolve ``"error"``
``serve.cascade``  the same, for the cascade's full-precision rescore
``replica.kill``   once per submit a replica takes (``serving/replica.py``);
                   a firing hard-kills the replica, which the router's
                   monitor sweeps and restarts; ``replica.kill.replica-<i>``
                   targets one replica
``cache.lookup``   once per admission-cache lookup: a firing degrades the
                   lookup to a miss (``cache.errors``)
``bank.resolve``   once per submit, at its tenant's bank resolution: a
                   firing errors that request only
``host.kill``      once per request routed to an in-process fleet host
                   (``serving/fleet.py``): a firing kills the whole host,
                   which the balancer re-routes around and restarts;
                   ``host.kill.host-<i>`` targets one host
``host.stall``     the same site: the host wedges (alive, no progress) until
                   the balancer's heartbeat-age detector catches it
``scaler.spawn``   once per autoscaler spawn attempt, inside its retried
                   window (``serving/autoscaler.py``)
``incident.dump``  once per incident bundle, on the recorder's worker
                   (``serving/incident.py``): counted in
                   ``incident.dump_errors``, never seen by a request
=================  ==========================================================

The JAX package's other points (``data.read``, ``ckpt.write``,
``step.N``) belong to slice 11 (ROADMAP.md); ``kernel.lower`` exercises
the JAX package's fall-back to XLA, which the port does not have.

With no configuration every point is a near-zero-cost no-op.  Arming is by
the ``MEMVUL_FAULTS`` environment variable (read once, at the first
``fault_point`` call) or :func:`configure`:

    MEMVUL_FAULTS="score.batch@3=raise:RuntimeError:UNAVAILABLE injected"
    MEMVUL_FAULTS="shard.kill.shard-1@3=sigkill;merge.verify=raise"

Grammar: ``;``-separated clauses ``point[@n]=action``; ``@n`` is the
1-based hit at which the fault fires (default 1); the action is
``raise[:ExcName[:message]]`` (a builtin exception, default
``RuntimeError("injected fault")``), ``sigterm``, ``sigint`` (that signal to
this process) or ``sigkill`` (no handler runs, no cleanup happens).  Each
clause fires exactly once and then disarms.
"""

from __future__ import annotations

import builtins
import dataclasses
import os
import signal
import threading
from typing import Dict, List, Optional

_ENV_VAR = "MEMVUL_FAULTS"

_lock = threading.Lock()
_faults: Dict[str, List["_Fault"]] = {}
_armed = False  # fast-path gate: fault_point returns at once when False
_env_loaded = False


@dataclasses.dataclass
class _Fault:
    point: str
    trigger: int = 1  # fire at the trigger-th hit of the point
    action: str = "raise"  # "raise" | "sigterm" | "sigint" | "sigkill"
    exc_name: str = "RuntimeError"
    message: str = "injected fault"
    hits: int = 0
    fired: bool = False

    def fire(self) -> None:
        self.fired = True
        signals = {"sigterm": signal.SIGTERM, "sigint": signal.SIGINT, "sigkill": signal.SIGKILL}
        if self.action in signals:
            os.kill(os.getpid(), signals[self.action])
            return
        exc_type = getattr(builtins, self.exc_name, None)
        if not (isinstance(exc_type, type) and issubclass(exc_type, BaseException)):
            exc_type = RuntimeError
        raise exc_type(f"{self.message} [injected at {self.point}]")


def parse_spec(spec: str) -> List[_Fault]:
    """``point[@n]=action`` clauses, ``;``-separated.  Raises ValueError on
    a malformed clause: a typo'd chaos spec must fail loudly, not test
    nothing."""
    out: List[_Fault] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise ValueError(f"fault clause {clause!r}: expected point[@n]=action")
        target, action = (part.strip() for part in clause.split("=", 1))
        trigger = 1
        if "@" in target:
            target, n = target.rsplit("@", 1)
            try:
                trigger = int(n)
            except ValueError:
                raise ValueError(f"fault clause {clause!r}: bad trigger count {n!r}")
            if trigger < 1:
                raise ValueError(f"fault clause {clause!r}: trigger must be >= 1")
        if not target:
            raise ValueError(f"fault clause {clause!r}: empty point name")
        fault = _Fault(point=target, trigger=trigger)
        parts = action.split(":", 2)
        kind = parts[0]
        if kind in ("sigterm", "sigint", "sigkill"):
            if len(parts) > 1:
                raise ValueError(f"fault clause {clause!r}: {kind} takes no arguments")
            fault.action = kind
        elif kind == "raise":
            if len(parts) > 1 and parts[1]:
                fault.exc_name = parts[1]
            if len(parts) > 2:
                fault.message = parts[2]
        else:
            raise ValueError(
                f"fault clause {clause!r}: unknown action {kind!r} "
                "(want raise[:Exc[:msg]] | sigterm | sigint | sigkill)"
            )
        out.append(fault)
    return out


def configure(spec: Optional[str]) -> None:
    """Arm the fault set from a spec string (None or "" disarms).  Replaces
    any earlier configuration, the environment's included."""
    global _armed, _env_loaded
    with _lock:
        _faults.clear()
        _env_loaded = True  # an explicit configure wins over the env var
        for fault in parse_spec(spec) if spec else []:
            _faults.setdefault(fault.point, []).append(fault)
        _armed = bool(_faults)


def reset() -> None:
    """Disarm everything and forget that the environment was read (tests)."""
    global _armed, _env_loaded
    with _lock:
        _faults.clear()
        _armed = False
        _env_loaded = False


def active() -> bool:
    _ensure_env_loaded()
    return _armed


def describe() -> List[str]:
    """The armed clauses that have not fired (for start-up logging)."""
    _ensure_env_loaded()
    with _lock:
        return [f"{f.point}@{f.trigger}={f.action}" for fs in _faults.values() for f in fs
                if not f.fired]


def _ensure_env_loaded() -> None:
    global _armed, _env_loaded
    if _env_loaded:
        return
    spec = os.environ.get(_ENV_VAR)
    if spec is not None:
        configure(spec)
    else:
        with _lock:
            _env_loaded = True
            _armed = False


def fault_point(name: str) -> None:
    """Mark an injection point: a no-op unless a configured fault targets
    ``name`` and this hit reaches its trigger count; then the fault fires
    (raise or signal) once and disarms."""
    if not _env_loaded:
        _ensure_env_loaded()
    if not _armed:
        return
    to_fire = None
    with _lock:
        for fault in _faults.get(name, ()):
            if fault.fired:
                continue
            fault.hits += 1
            if fault.hits >= fault.trigger:
                to_fire = fault
                break
    if to_fire is not None:
        to_fire.fire()  # outside the lock: a handler may hit another point

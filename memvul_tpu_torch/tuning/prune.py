"""Analytic candidate pruning (the JAX package's ``tuning/prune.py``).

A microbench run is the expensive part of tuning — each survivor pays a
compile + a timed run.  This module rejects candidates the registry's
cost/memory analysis already proves infeasible, BEFORE they cost
anything:

* **compiled-program-count blowup** — the training bucket grid compiles
  one step program per occupied ``(anchor_bucket, report_bucket)`` cell,
  times the dedup capacity ladder (``data.batching.dedup_capacities``)
  when dedup is on.  A grid whose worst-case step-shape count exceeds
  ``tuning.max_programs`` is pruned: each shape is a first, warming call
  and its own set of cached allocator blocks on the card.
* **HBM overflow** — scale the registry's measured per-program device
  memory (``ProgramRegistry`` ``hbm_bytes``: the caching allocator's
  bytes, the ``program.hbm_bytes`` gauge) by the candidate's padded-token
  ratio against the measured baseline shape, and prune when the
  projection exceeds ``hbm_fraction`` of the device class's
  ``PEAK_SPECS["hbm_bytes"]`` (the H100 row).

Both checks are *honest*: on an interpret-only host (the CPU, no
peak spec) or before any program has been measured,
the corresponding check is skipped and recorded as a note instead of
pruning against numbers that do not exist.  Every decision is a
JSON-serializable record carried into the tune report.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from .knobs import Candidate


@dataclasses.dataclass
class PruneDecision:
    """One candidate's analytic verdict.  ``feasible=False`` carries
    the refusal in ``reasons`` as ``{code, observed, limit}`` rows
    (the ``PromotionDecision`` reason idiom); skipped checks land in
    ``notes``."""

    candidate: Candidate
    feasible: bool = True
    reasons: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)
    estimated_programs: Optional[int] = None
    estimated_hbm_bytes: Optional[float] = None

    def refuse(self, code: str, observed: float, limit: float) -> None:
        self.feasible = False
        self.reasons.append(
            {"code": code, "observed": observed, "limit": limit}
        )

    def to_json(self) -> Dict[str, Any]:
        return {
            "candidate": self.candidate.to_json(),
            "feasible": self.feasible,
            "reasons": list(self.reasons),
            "notes": list(self.notes),
            "estimated_programs": self.estimated_programs,
            "estimated_hbm_bytes": self.estimated_hbm_bytes,
        }


def _resolve_buckets(train_buckets, max_length: int) -> Optional[List[int]]:
    """The concrete bucket boundary list a knob value produces, via the
    same resolver the trainer uses (None → pad-to-max)."""
    if train_buckets is None:
        return None
    from ..data.batching import resolve_train_buckets

    return list(resolve_train_buckets(train_buckets, max_length))


def estimate_train_programs(
    train_buckets,
    dedup_anchors: bool,
    batch_size: int,
    max_length: int,
) -> int:
    """Worst-case compiled train-step program count for one collation
    candidate: every occupied ``(b_anchor, b_report)`` grid cell is a
    distinct step signature, and dedup multiplies each cell by its
    anchor-capacity ladder (``dedup_capacities``)."""
    buckets = _resolve_buckets(train_buckets, max_length)
    cells = 1 if buckets is None else len(buckets) ** 2
    if not dedup_anchors or buckets is None:
        return cells
    from ..data.batching import dedup_capacities

    ladder = len(dedup_capacities(batch_size))
    return cells * ladder


def measured_hbm_baseline(registry=None) -> Optional[Dict[str, float]]:
    """(max per-program HBM bytes, its padded token count proxy) from
    the live ``ProgramRegistry`` — None when nothing has been measured
    (a fresh process, or rows that recorded no memory)."""
    from ..telemetry.programs import get_program_registry

    reg = registry if registry is not None else get_program_registry()
    rows = [r for r in reg.snapshot() if r.get("hbm_bytes")]
    if not rows:
        return None
    worst = max(rows, key=lambda r: r["hbm_bytes"])
    return {"hbm_bytes": float(worst["hbm_bytes"]), "key": worst["key"]}


def _padded_token_ratio(candidate: Candidate, max_length: int,
                        batch_size: int, max_batch: int) -> float:
    """How the candidate's worst-case padded footprint scales against
    the baseline shape the registry measured (pad-to-max at the default
    batch).  Deliberately coarse — an upper bound, not a model: a
    bucket grid's worst cell is the full-length bucket, a serving
    token_budget IS the padded token count of one pack."""
    knobs = candidate.knobs
    if candidate.kind == "train":
        # worst-case cell is always (max bucket)^2 == pad-to-max, so
        # collation knobs never grow the footprint; prefetch_depth holds
        # `depth` host-side batches but no extra device residency
        return 1.0
    impl = knobs.get("score_impl", "bucketed")
    if impl == "bucketed":
        return float(knobs.get("max_batch", max_batch)) / float(max_batch)
    budget = float(knobs.get("token_budget") or 4 * max_length)
    baseline_tokens = float(max_batch * max_length)
    return budget / baseline_tokens if baseline_tokens else 1.0


def prune_candidates(
    candidates: Sequence[Candidate],
    *,
    batch_size: int = 32,
    max_length: int = 512,
    max_batch: int = 16,
    max_programs: int = 64,
    hbm_fraction: float = 0.9,
    peak: Optional[Dict[str, float]] = None,
    registry=None,
) -> List[PruneDecision]:
    """Run both analytic checks over a candidate list.  ``peak`` is the
    device class's ``PEAK_SPECS`` row (None on interpret-only hosts —
    the HBM check is then skipped with a note, never guessed)."""
    baseline = measured_hbm_baseline(registry)
    hbm_capacity = (peak or {}).get("hbm_bytes")
    out: List[PruneDecision] = []
    for cand in candidates:
        d = PruneDecision(candidate=cand)
        if cand.kind == "train":
            programs = estimate_train_programs(
                cand.knobs.get("train_buckets"),
                bool(cand.knobs.get("dedup_anchors")),
                batch_size,
                max_length,
            )
            d.estimated_programs = programs
            if programs > max_programs:
                d.refuse("program_count_blowup", programs, max_programs)
        if hbm_capacity is None:
            d.notes.append("hbm_check_skipped:no_peak_spec")
        elif baseline is None:
            d.notes.append("hbm_check_skipped:no_measured_footprint")
        else:
            ratio = _padded_token_ratio(cand, max_length, batch_size, max_batch)
            projected = baseline["hbm_bytes"] * ratio
            d.estimated_hbm_bytes = projected
            limit = hbm_fraction * float(hbm_capacity)
            if projected > limit:
                d.refuse("hbm_overflow", projected, limit)
        out.append(d)
    return out


def survivors(decisions: Sequence[PruneDecision]) -> List[Candidate]:
    return [d.candidate for d in decisions if d.feasible]

"""The mandatory parity gate: tuning may change speed, never results.

Every candidate the tuner would persist is classified and checked
against the untuned baseline BEFORE it is eligible to win:

* **serving layout knobs** (micro-batch cap, coalescing window,
  ``token_budget``, ``max_rows_per_pack`` — anything that only changes
  HOW rows are packed into programs) must reproduce the fixed probe
  set's scores **bitwise** (``np.array_equal``).  The serving paths pin
  this property in their own test suites (a row's bucket depends only
  on its own length), so a mismatch here is a real score change, not
  noise — refusal code ``parity_score_mismatch``.
* **training collation knobs** (bucket grid, dedup, prefetch depth)
  must reproduce the per-step loss trajectory of a short deterministic
  epoch within the pinned step-parity tolerance
  (tests/test_train_throughput.py holds padding invariance and dedup
  parity at ~1e-5 per step; the gate allows ``LOSS_TOL`` to absorb one
  epoch of accumulation) — refusal code ``parity_loss_divergence``.
  Trajectory *length* must match exactly (same stream, same step
  count) — refusal code ``parity_step_count``.
* **anything score-adjacent** (the cascade band) does NOT come through
  here — it goes through ``bankops.evaluate_cascade`` →
  ``evaluate_gate`` (tuning/cascade.py), the same machinery bank
  promotions answer to.

Verdicts reuse the ``PromotionDecision`` reason idiom
(``{code, observed, limit}``) so tune reports and promotion audit
trails read the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from .knobs import Candidate

# one short epoch of fp32 accumulation over the pinned 1e-5 per-step
# parity property; measured headroom, not an invitation
LOSS_TOL = 1e-4


@dataclasses.dataclass
class ParityVerdict:
    candidate: Candidate
    passed: bool
    reasons: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    max_abs_delta: Optional[float] = None

    def to_json(self) -> Dict[str, Any]:
        return {
            "candidate": self.candidate.to_json(),
            "passed": self.passed,
            "reasons": list(self.reasons),
            "max_abs_delta": self.max_abs_delta,
        }


def check_serve_parity(
    candidate: Candidate,
    baseline_scores,
    candidate_scores,
) -> ParityVerdict:
    """Bitwise score equality on the fixed probe set for a layout-only
    serving candidate."""
    import numpy as np

    base = np.asarray(baseline_scores)
    cand = np.asarray(candidate_scores)
    if base.shape != cand.shape:
        return ParityVerdict(
            candidate=candidate, passed=False,
            reasons=[{
                "code": "parity_score_mismatch",
                "observed": f"shape {cand.shape} vs {base.shape}",
                "limit": "identical shapes",
            }],
        )
    if np.array_equal(base, cand):
        return ParityVerdict(candidate=candidate, passed=True,
                             max_abs_delta=0.0)
    delta = float(np.max(np.abs(base.astype(np.float64)
                                - cand.astype(np.float64))))
    return ParityVerdict(
        candidate=candidate, passed=False, max_abs_delta=delta,
        reasons=[{
            "code": "parity_score_mismatch",
            "observed": delta,
            "limit": 0.0,
        }],
    )


def check_train_parity(
    candidate: Candidate,
    baseline_losses: Sequence[float],
    candidate_losses: Sequence[float],
    *,
    tol: float = LOSS_TOL,
) -> ParityVerdict:
    """Loss-trajectory equality (within ``tol``) for a training
    collation candidate over the identical seeded epoch stream."""
    base = list(baseline_losses)
    cand = list(candidate_losses)
    if len(base) != len(cand):
        return ParityVerdict(
            candidate=candidate, passed=False,
            reasons=[{
                "code": "parity_step_count",
                "observed": len(cand),
                "limit": len(base),
            }],
        )
    if not base:
        return ParityVerdict(
            candidate=candidate, passed=False,
            reasons=[{
                "code": "parity_no_evidence",
                "observed": 0,
                "limit": ">=1 probe step",
            }],
        )
    delta = max(abs(float(b) - float(c)) for b, c in zip(base, cand))
    if delta <= tol:
        return ParityVerdict(candidate=candidate, passed=True,
                             max_abs_delta=delta)
    return ParityVerdict(
        candidate=candidate, passed=False, max_abs_delta=delta,
        reasons=[{
            "code": "parity_loss_divergence",
            "observed": delta,
            "limit": tol,
        }],
    )

"""Gated promotion: a candidate bank earns its way into serving (the JAX
package's ``bankops/promote.py``).

A candidate must pass both checks before :func:`promote` installs it:

* **golden-set parity** — the active and candidate banks each score a
  pinned labeled golden set through the same predictor
  (``bankops/shadow.py:score_texts``); the candidate's AUC and F1 may not
  drop by more than the tolerances;
* **shadow evidence** — a shadow summary (online
  :class:`~.shadow.ShadowScorer` or offline :func:`~.shadow.replay_results`)
  must cover at least ``min_shadow_samples`` requests with a
  decision-flip rate at or under ``max_flip_rate``.

Refusals are machine-readable: a :class:`PromotionDecision` carries one
``{"code", "observed", "limit"}`` record per violated gate.

:func:`promote` installs an approved candidate (``source="promotion"``,
the store version id) on one service through ``ScoringService.swap_bank``
or across a fleet through ``router.rolling_swap``, then advances the
store's ``ACTIVE`` pointer and appends the audit record; :func:`demote`
re-installs the active version's parent.  ``tenant=`` scopes the install
and the audit record to one named tenant's bank.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from ..evaluate.metrics import SiameseMeasure
from ..telemetry import Registry
from .shadow import score_texts
from .store import BankStore, BankStoreError

logger = logging.getLogger(__name__)

# machine-readable refusal codes (the JAX package's)
REASON_AUC = "auc_regression"
REASON_F1 = "f1_regression"
REASON_FLIP_RATE = "flip_rate_exceeded"
REASON_SHADOW_SAMPLES = "insufficient_shadow_samples"
REASON_SHADOW_MISSING = "shadow_evidence_missing"


@dataclasses.dataclass(frozen=True)
class GateThresholds:
    """Promotion-gate tolerances (the JAX package's defaults)."""

    max_auc_drop: float = 0.01
    max_f1_drop: float = 0.01
    max_flip_rate: float = 0.02
    min_shadow_samples: int = 100
    require_shadow: bool = True


@dataclasses.dataclass
class PromotionDecision:
    """The gate's verdict.  ``reasons`` is empty iff ``approved``."""

    approved: bool
    candidate: Optional[str]
    parent: Optional[str]
    reasons: List[Dict[str, Any]]
    metrics: Dict[str, Any]

    def to_json(self) -> Dict[str, Any]:
        return {
            "approved": self.approved,
            "candidate": self.candidate,
            "parent": self.parent,
            "reasons": self.reasons,
            "metrics": self.metrics,
        }


class PromotionRefused(RuntimeError):
    """Raised by :func:`promote` on an unapproved decision; carries the
    machine-readable decision."""

    def __init__(self, decision: PromotionDecision) -> None:
        codes = [r.get("code") for r in decision.reasons]
        super().__init__(f"promotion refused: {codes}")
        self.decision = decision


def golden_metrics(
    predictor,
    bank_instances: Iterable[Dict],
    eval_instances: Iterable[Dict],
) -> Dict[str, float]:
    """Threshold-swept siamese metrics of one bank over a labeled golden
    set, scored through the predictor's serving impl (the bank's shapes
    are warmed first, so a serving process never pays a first launch
    mid-serve)."""
    bank, _labels, n_anchors = predictor.encode_bank(list(bank_instances))
    predictor.warmup_bank_shapes(bank)
    instances = list(eval_instances)
    probs = score_texts(
        predictor, [inst["text1"] for inst in instances], bank, n_anchors
    )
    measure = SiameseMeasure()
    measure.update(
        probs.max(axis=-1) if len(instances) else np.zeros((0,)),
        [inst.get("meta") or {} for inst in instances],
    )
    out = measure.compute(reset=True)
    out["n_eval"] = float(len(instances))
    return out


def evaluate_gate(
    active_metrics: Dict[str, float],
    candidate_metrics: Dict[str, float],
    shadow_summary: Optional[Dict[str, Any]],
    thresholds: Optional[GateThresholds] = None,
    candidate: Optional[str] = None,
    parent: Optional[str] = None,
) -> PromotionDecision:
    """Pure gate logic over already-computed evidence (deterministic,
    directly testable).  ``shadow_summary`` is the dict
    ``ShadowScorer.stop()`` / ``replay_results`` return."""
    thresholds = thresholds or GateThresholds()
    reasons: List[Dict[str, Any]] = []

    auc_drop = float(active_metrics.get("auc", 0.0)) - float(
        candidate_metrics.get("auc", 0.0)
    )
    if auc_drop > thresholds.max_auc_drop:
        reasons.append({
            "code": REASON_AUC,
            "observed": round(auc_drop, 6),
            "limit": thresholds.max_auc_drop,
        })
    f1_drop = float(active_metrics.get("f1", 0.0)) - float(
        candidate_metrics.get("f1", 0.0)
    )
    if f1_drop > thresholds.max_f1_drop:
        reasons.append({
            "code": REASON_F1,
            "observed": round(f1_drop, 6),
            "limit": thresholds.max_f1_drop,
        })

    if shadow_summary is None:
        if thresholds.require_shadow:
            reasons.append({
                "code": REASON_SHADOW_MISSING,
                "observed": None,
                "limit": thresholds.min_shadow_samples,
            })
    else:
        sampled = int(shadow_summary.get("sampled", 0))
        if sampled < thresholds.min_shadow_samples:
            reasons.append({
                "code": REASON_SHADOW_SAMPLES,
                "observed": sampled,
                "limit": thresholds.min_shadow_samples,
            })
        flip_rate = float(shadow_summary.get("flip_rate", 0.0))
        if flip_rate > thresholds.max_flip_rate:
            reasons.append({
                "code": REASON_FLIP_RATE,
                "observed": round(flip_rate, 6),
                "limit": thresholds.max_flip_rate,
            })

    return PromotionDecision(
        approved=not reasons,
        candidate=candidate,
        parent=parent,
        reasons=reasons,
        metrics={
            "active": dict(active_metrics),
            "candidate": dict(candidate_metrics),
            "shadow": dict(shadow_summary) if shadow_summary else None,
        },
    )


def evaluate_cascade(
    predictor,
    eval_instances: Iterable[Dict],
    shadow_summary: Optional[Dict[str, Any]] = None,
    thresholds: Optional[GateThresholds] = None,
    threshold: float = 0.5,
) -> PromotionDecision:
    """Parity gate for the int8 cascade: the same golden set scored twice
    through the same predictor and bank — the full-precision bucket grid
    as "active", the offline cascade rule (int8 everywhere, in-band rows
    rescored at full precision; ``score_texts(impl="cascade")``) as
    "candidate" — then :func:`evaluate_gate` over the AUC/F1 drop and the
    decision flip rate.  A band that lets uncertain rows short-circuit on
    int8 shows up as flips and refuses with a ``{code, observed, limit}``
    record.

    ``shadow_summary`` is the live evidence when there is one (a
    :class:`~.shadow.ShadowScorer` on a cascade service rescores served
    traffic at full precision).  Without one, a flip summary over the
    golden set is computed in the same shape (``flip``: the ``threshold``
    decision differs between the two scorings)."""
    if getattr(predictor, "int8_model", None) is None:
        raise ValueError(
            "evaluate_cascade needs an encoder_precision='int8' predictor"
        )
    instances = list(eval_instances)
    texts = [inst["text1"] for inst in instances]
    metas = [inst.get("meta") or {} for inst in instances]
    fp32 = predictor.score_texts(texts, impl="bucketed")
    cascade = predictor.score_texts(texts, impl="cascade")

    def _measured(probs) -> Dict[str, float]:
        measure = SiameseMeasure()
        measure.update(
            probs.max(axis=-1) if instances else np.zeros((0,)), metas
        )
        out = measure.compute(reset=True)
        out["n_eval"] = float(len(instances))
        return out

    if shadow_summary is None and instances:
        best_active = fp32.max(axis=-1)
        best_shadow = cascade.max(axis=-1)
        flips = int(
            ((best_active >= threshold) != (best_shadow >= threshold)).sum()
        )
        deltas = np.abs(best_shadow - best_active)
        shadow_summary = {
            "sampled": len(instances),
            "flips": flips,
            "flip_rate": flips / len(instances),
            "anchor_changes": int(
                (fp32.argmax(axis=-1) != cascade.argmax(axis=-1)).sum()
            ),
            "mean_abs_delta": float(deltas.mean()),
            "max_abs_delta": float(deltas.max()),
        }
    return evaluate_gate(
        _measured(fp32),
        _measured(cascade),
        shadow_summary,
        thresholds=thresholds,
        candidate="cascade",
        parent="fp32",
    )


def evaluate_reweight(
    predictor,
    store: BankStore,
    version: str,
    eval_instances: Iterable[Dict],
    shadow_summary: Optional[Dict[str, Any]] = None,
    thresholds: Optional[GateThresholds] = None,
    threshold: float = 0.5,
) -> PromotionDecision:
    """Parity gate for per-anchor reweighting: the golden set is scored once
    through a store version's bank, then judged twice from the same
    probabilities — the plain ``argmax`` as "active" and the weighted one
    (``argmax(probs * weights)``, weights from each anchor instance's
    ``meta["weight"]``, default 1.0) as "candidate", whose score is the raw
    probability of the weighted winner.  All-1.0 weights select the same
    anchors: no flips, the same metrics, approved.  Skewed weights show up
    as flips and refuse through :func:`evaluate_gate`'s records."""
    bank_instances = store.instances(version)
    bank, _labels, n_anchors = predictor.encode_bank(bank_instances)
    predictor.warmup_bank_shapes(bank)
    raw = [
        float((inst.get("meta") or {}).get("weight", 1.0))
        for inst in bank_instances
    ]
    if len(raw) != int(n_anchors):
        raise BankStoreError(
            f"bank {version}: {len(raw)} instances vs {n_anchors} anchors "
            "— cannot align weights to anchor rows"
        )
    weights = np.asarray(raw, dtype=np.float32)
    instances = list(eval_instances)
    texts = [inst["text1"] for inst in instances]
    metas = [inst.get("meta") or {} for inst in instances]
    probs = score_texts(predictor, texts, bank, n_anchors)
    probs = probs[:, :n_anchors] if len(instances) else probs

    if instances:
        best_active = probs.max(axis=-1)
        # raw prob of the weighted winner — the served "score"
        winners = (probs * weights[None, :]).argmax(axis=-1)
        best_candidate = probs[np.arange(len(instances)), winners]
    else:
        best_active = best_candidate = np.zeros((0,))
        winners = np.zeros((0,), dtype=np.int64)

    def _measured(best) -> Dict[str, float]:
        measure = SiameseMeasure()
        measure.update(best, metas)
        out = measure.compute(reset=True)
        out["n_eval"] = float(len(instances))
        return out

    if shadow_summary is None and instances:
        flips = int(
            ((best_active >= threshold) != (best_candidate >= threshold)).sum()
        )
        deltas = np.abs(best_candidate - best_active)
        shadow_summary = {
            "sampled": len(instances),
            "flips": flips,
            "flip_rate": flips / len(instances),
            "anchor_changes": int(
                (probs.argmax(axis=-1) != winners).sum()
            ),
            "mean_abs_delta": float(deltas.mean()),
            "max_abs_delta": float(deltas.max()),
        }
    return evaluate_gate(
        _measured(best_active),
        _measured(best_candidate),
        shadow_summary,
        thresholds=thresholds,
        candidate=f"{version}+reweight",
        parent=version,
    )


def evaluate_candidate(
    predictor,
    store: BankStore,
    candidate: str,
    eval_instances: Iterable[Dict],
    active: Optional[str] = None,
    shadow_summary: Optional[Dict[str, Any]] = None,
    thresholds: Optional[GateThresholds] = None,
) -> PromotionDecision:
    """Run the full gate for a store candidate: golden-set metrics for
    the active version (``ACTIVE`` pointer, else the candidate's
    parent) and the candidate, then :func:`evaluate_gate` with the
    shadow evidence."""
    manifest = store.manifest(candidate)
    if active is None:
        pointer = store.active()
        active = (
            pointer["version"] if pointer else manifest.get("parent")
        )
    if active is None:
        raise BankStoreError(
            f"candidate {candidate} has no parent and no ACTIVE pointer "
            "to gate against"
        )
    eval_instances = list(eval_instances)
    active_metrics = golden_metrics(
        predictor, store.instances(active), eval_instances
    )
    candidate_metrics = golden_metrics(
        predictor, store.instances(candidate), eval_instances
    )
    return evaluate_gate(
        active_metrics,
        candidate_metrics,
        shadow_summary,
        thresholds=thresholds,
        candidate=candidate,
        parent=active,
    )


def _install(target, instances: List[Dict], source: str, store_version: str,
             tenant: Optional[str] = None) -> int:
    """Install a bank on one service (``swap_bank``) or roll it across a
    fleet (``rolling_swap``), in ``tenant``'s slot when one is named."""
    if hasattr(target, "replicas"):
        from ..serving.router import rolling_swap

        return rolling_swap(target, instances, source=source, store_version=store_version,
                            tenant=tenant)
    return target.swap_bank(instances, source=source, store_version=store_version,
                            tenant=tenant)


def promote(
    target,
    store: BankStore,
    decision: PromotionDecision,
    registry: Optional[Registry] = None,
    tenant: Optional[str] = None,
) -> int:
    """Install an approved candidate on ``target`` and advance the store's
    ``ACTIVE`` pointer and audit trail.  Raises :class:`PromotionRefused`
    (carrying the decision) when the gate did not approve.  Returns the new
    serving bank version.  ``registry`` defaults to the target's (a
    router's is the process-wide one).  ``tenant`` scopes the install and
    the audit record to one named tenant."""
    tel = registry if registry is not None else target.registry
    if not decision.approved:
        store.record_promotion(kind="promotion_refused", tenant=tenant, **decision.to_json())
        tel.counter("bank.promotions_refused").inc()
        raise PromotionRefused(decision)
    if decision.candidate is None:
        raise BankStoreError("decision names no candidate version")
    serving_version = _install(target, store.instances(decision.candidate), source="promotion",
                               store_version=decision.candidate, tenant=tenant)
    store.set_active(decision.candidate, source="promotion")
    store.record_promotion(kind="promotion", candidate=decision.candidate,
                           parent=decision.parent, serving_version=serving_version,
                           reasons=decision.reasons, tenant=tenant)
    tel.counter("bank.promotions").inc()
    tel.event("bank_promotion", candidate=decision.candidate, serving_version=serving_version,
              tenant=tenant)
    logger.info("bank %s promoted to serving v%d", decision.candidate, serving_version)
    return serving_version


def demote(target, store: BankStore, registry: Optional[Registry] = None,
           tenant: Optional[str] = None) -> Dict[str, Any]:
    """Roll serving back to the active store version's parent: install the
    parent bank, repoint ``ACTIVE``, append the audit record.  Returns
    ``{"version": parent_id, "serving_version": int}``."""
    tel = registry if registry is not None else target.registry
    pointer = store.active()
    if pointer is None:
        raise BankStoreError("no ACTIVE pointer — nothing to demote from")
    current = pointer["version"]
    parent = store.manifest(current).get("parent")
    if parent is None:
        raise BankStoreError(f"active bank {current} is a root version — no parent to demote to")
    serving_version = _install(target, store.instances(parent), source="demotion",
                               store_version=parent, tenant=tenant)
    store.set_active(parent, source="demotion")
    store.record_promotion(kind="demotion", demoted=current, restored=parent,
                           serving_version=serving_version, tenant=tenant)
    tel.counter("bank.demotions").inc()
    tel.event("bank_demotion", demoted=current, restored=parent, tenant=tenant)
    logger.info("bank %s demoted — %s restored at serving v%d", current, parent, serving_version)
    return {"version": parent, "serving_version": serving_version}

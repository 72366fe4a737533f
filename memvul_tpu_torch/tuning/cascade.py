"""Cascade rescue-band autotuner (the JAX package's ``tuning/cascade.py``).

The two-tier cascade serves int8 scores everywhere and rescores only
rows whose int8 score lands inside ``[cascade_low, cascade_high]``
through the fp32 program.  The band has been hand-set (0.3/0.7) since
the cascade shipped; the right band is a property of the *score
distribution on this model + golden set* — wide enough to catch every
row the int8 tier might flip across the decision threshold, narrow
enough that the fp32 rescue bill stays at the target rescore rate.

:func:`choose_band` derives it from measurement: score the golden set
on the pure int8 tier, take the ``target_rescore_rate`` fraction of
rows NEAREST the decision threshold (those are the flippable ones), and
set the band to exactly cover their scores.  The chosen band is then
**gated, not trusted**: the predictor's band is set to the candidate
and ``bankops.evaluate_cascade`` runs the full fp32-vs-cascade
promotion gate (AUC/F1 drop, flip rate) over the same golden set — a
band that lets uncertain rows short-circuit on int8 refuses with the
standard machine-readable reasons and the hand-set default stays.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable


def choose_band(
    predictor,
    eval_instances: Iterable[Dict],
    *,
    target_rescore_rate: float = 0.1,
    threshold: float = 0.5,
    thresholds=None,
) -> Dict[str, Any]:
    """Pick ``[cascade_low, cascade_high]`` from the golden set's int8
    score distribution and gate it through ``evaluate_cascade``.

    Returns a JSON-ready record: the chosen band, the predicted rescore
    rate it implies on this golden set, and the gate's
    ``PromotionDecision``.  ``approved=False`` means the caller must
    keep the shipped default band.

    ``thresholds`` defaults to the standard :class:`GateThresholds`
    with ``min_shadow_samples`` relaxed to the golden-set size when the
    set is smaller than 100 — the offline flip summary IS the whole
    golden set here, there is no larger sample to insist on.
    """
    import numpy as np

    from ..bankops.promote import GateThresholds, evaluate_cascade

    instances = list(eval_instances)
    if not instances:
        raise ValueError("choose_band needs a non-empty golden set")
    if not 0.0 < target_rescore_rate <= 1.0:
        raise ValueError(
            f"target_rescore_rate must be in (0, 1], got {target_rescore_rate}"
        )
    texts = [inst["text1"] for inst in instances]
    int8 = predictor.score_texts(texts, impl="int8")
    best = np.asarray(int8).max(axis=-1)

    # the flippable rows are the ones nearest the decision threshold;
    # cover exactly the target fraction of them
    k = max(1, math.ceil(target_rescore_rate * len(best)))
    nearest = np.argsort(np.abs(best - threshold), kind="stable")[:k]
    low = float(best[nearest].min())
    high = float(best[nearest].max())
    # a one-sided cluster (every near-threshold score below it) still
    # must cover the threshold itself, or a row AT the decision
    # boundary would short-circuit on int8
    low = min(low, threshold)
    high = max(high, threshold)
    predicted = float(((best >= low) & (best <= high)).mean())

    if thresholds is None:
        thresholds = GateThresholds(
            min_shadow_samples=min(100, len(instances))
        )
    prior_band = tuple(predictor.cascade_band)
    predictor.cascade_band = (low, high)
    try:
        decision = evaluate_cascade(
            predictor, instances, thresholds=thresholds, threshold=threshold
        )
    finally:
        # the tuner only measures; installing the band is the profile
        # loader's job, after the gate approves
        predictor.cascade_band = prior_band
    return {
        "cascade_low": round(low, 6),
        "cascade_high": round(high, 6),
        "target_rescore_rate": target_rescore_rate,
        "predicted_rescore_rate": round(predicted, 6),
        "golden_set_size": len(instances),
        "decision_threshold": threshold,
        "gate": decision.to_json(),
        "approved": bool(decision.approved),
    }

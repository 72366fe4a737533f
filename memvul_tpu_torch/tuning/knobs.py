"""The autotuner's candidate space (the JAX package's ``tuning/knobs.py``).

A candidate is one named, JSON-serializable knob assignment for either
the training collation path or the serving dispatch path.  The grids
here are deliberately small — the tuner's cost model is "prune
analytically, then PAY for a microbench per survivor", so every axis
earns its place:

* training: ``train_buckets`` (pad-to-max / pow2 grid / an explicit
  coarse grid), ``dedup_anchors``, ``prefetch_depth`` — the three
  collation knobs of the train step's feed;
* serving: per dispatch impl — micro-batch cap (``max_batch``) and
  coalescing window for the bucketed path, ``token_budget`` +
  ``max_rows_per_pack`` for the packed (ragged/continuous) paths.

The optimal point shifts per device generation, which is why candidates
are swept per device class rather than hand-set once.  The space is the
JAX package's, candidate for candidate: no kernel tile size is a knob.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One knob assignment.  ``name`` is the stable label every prune /
    bench / parity record carries; ``knobs`` maps directly onto
    ``TrainerConfig`` fields (kind="train") or the serving section /
    ``SiamesePredictor`` arguments (kind="serve")."""

    kind: str  # "train" | "serve"
    name: str
    knobs: Dict[str, Any]

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "name": self.name, "knobs": dict(self.knobs)}


def _bucket_label(buckets) -> str:
    if buckets is None:
        return "none"
    if isinstance(buckets, str):
        return buckets
    return "x".join(str(b) for b in buckets)


def train_space(
    max_length: int = 512,
    batch_size: int = 32,
    bucket_grids: Optional[Sequence[Any]] = None,
    dedup_options: Sequence[bool] = (True, False),
    prefetch_depths: Sequence[int] = (2, 8, 16),
) -> List[Candidate]:
    """The training-collation candidate grid.

    The default bucket axis is pad-to-max (``None`` — the pre-PR-5
    baseline, kept so the tuner can *prove* the grid earns its compile
    bill on this device class), the shipped ``"pow2"`` derivation, and
    one coarse explicit grid (quartile boundaries).  ``dedup_anchors``
    only changes behavior under a bucketed collation, so the pad-to-max
    row is emitted once.
    """
    if bucket_grids is None:
        quartiles = sorted({
            max(8, max_length // 4), max(8, max_length // 2), max_length
        })
        bucket_grids = [None, "pow2", list(quartiles)]
    out: List[Candidate] = []
    seen = set()
    for buckets in bucket_grids:
        for dedup in dedup_options:
            if buckets is None and not dedup:
                continue  # dedup is a no-op under pad-to-max; one row suffices
            for depth in prefetch_depths:
                dedup_eff = bool(dedup) and buckets is not None
                key = (_bucket_label(buckets), dedup_eff, int(depth))
                if key in seen:
                    continue
                seen.add(key)
                out.append(Candidate(
                    kind="train",
                    name=(
                        f"train:buckets={_bucket_label(buckets)},"
                        f"dedup={int(dedup_eff)},prefetch={int(depth)}"
                    ),
                    knobs={
                        "train_buckets": buckets,
                        "dedup_anchors": dedup_eff,
                        "prefetch_depth": int(depth),
                    },
                ))
    return out


def serve_space(
    max_length: int = 512,
    max_batch: int = 16,
    impls: Sequence[str] = ("bucketed", "ragged", "continuous"),
    batch_caps: Optional[Sequence[int]] = None,
    wait_ms_options: Sequence[float] = (2.0, 5.0),
    budget_factors: Sequence[int] = (2, 4, 8),
    rows_factors: Sequence[int] = (1, 2),
) -> List[Candidate]:
    """The serving-dispatch candidate grid, one sub-grid per impl.

    Bucketed dispatch sweeps the micro-batch cap (its batch shape set —
    every cap is a new program family, which is why the analytic pruner
    sees these first) and the coalescing window; the packed impls sweep
    ``token_budget`` (multiples of ``max_length``) and the rows cap.
    The cascade band is NOT swept here — it is score-adjacent and owned
    by :mod:`.cascade` behind ``evaluate_cascade``.
    """
    if batch_caps is None:
        batch_caps = sorted({max(1, max_batch // 2), max_batch, 2 * max_batch})
    out: List[Candidate] = []
    for impl in impls:
        if impl == "bucketed":
            for cap in batch_caps:
                for wait in wait_ms_options:
                    out.append(Candidate(
                        kind="serve",
                        name=f"serve:{impl},max_batch={cap},wait_ms={wait:g}",
                        knobs={
                            "score_impl": impl,
                            "max_batch": int(cap),
                            "max_wait_ms": float(wait),
                        },
                    ))
        elif impl in ("ragged", "continuous"):
            for factor in budget_factors:
                for rf in rows_factors:
                    rows = int(max_batch * rf)
                    out.append(Candidate(
                        kind="serve",
                        name=(
                            f"serve:{impl},budget={factor}xL,"
                            f"rows={rows}"
                        ),
                        knobs={
                            "score_impl": impl,
                            "max_batch": int(max_batch),
                            "token_budget": int(factor * max_length),
                            "max_rows_per_pack": rows,
                        },
                    ))
        else:
            raise ValueError(
                f"serve_space: unknown impl {impl!r} "
                "(known: bucketed, ragged, continuous)"
            )
    return out

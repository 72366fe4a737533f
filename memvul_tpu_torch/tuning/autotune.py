"""Tune-run orchestration: the engine behind ``python -m memvul_tpu_torch
tune`` (the JAX package's ``tuning/autotune.py``).

One :func:`run_tune` call is one offline tuning pass for ONE device
class:

1. resolve the device class (``--device-class`` override or the card's
   name) and its ``PEAK_SPECS`` row — a class with no peak spec is a
   machine-readable ``unknown_device_class`` refusal unless the caller
   explicitly opts into measurement-only mode
   (``allow_unknown_device``: the analytic HBM pruner then skips with a
   note instead of pruning against a made-up roofline; this is how the
   CPU harness record is produced).  The microbenches run on ``device``:
   the card unless the caller asks for the CPU;
2. enumerate the knob space (tuning/knobs.py), prune analytically
   (tuning/prune.py), and microbench every survivor with the seeded
   in-process harness (tuning/microbench.py);
3. run the mandatory parity gate per survivor (tuning/parity.py):
   layout-only candidates must match the untuned baseline bitwise
   (serving probe scores) / within the pinned step tolerance (training
   loss trajectory).  A candidate that fails parity CANNOT win,
   whatever its throughput;
4. optionally tune the cascade band (tuning/cascade.py) — the one
   score-adjacent knob, gated through ``bankops.evaluate_cascade``;
5. pick winners (train: real-token throughput; serve: requests/sec),
   and persist the versioned profile (tuning/profile.py) when an output
   root is given.

The returned record is the whole audit trail: every candidate's prune
decision, parity verdict, and measurement, plus the winners and the
tuned-vs-default deltas.  ``tune.*`` counters
(candidates/pruned/parity_refused) and the ``tune.device_class.<class>``
gauge make a tune run observable like every other subsystem.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Union

from .knobs import serve_space, train_space
from .microbench import TuneBench
from .parity import check_serve_parity, check_train_parity
from .prune import prune_candidates
from .profile import resolve_device_class, save_profile

logger = logging.getLogger(__name__)

# the hand-set defaults the tuner must beat — and the parity baselines
# every candidate is compared against
DEFAULT_TRAIN_KNOBS: Dict[str, Any] = {
    "train_buckets": "pow2", "dedup_anchors": True, "prefetch_depth": 8,
}
DEFAULT_SERVE_KNOBS: Dict[str, Any] = {
    "score_impl": "bucketed", "max_batch": 16, "max_wait_ms": 5.0,
}


def unknown_device_refusal(device_class: str) -> Dict[str, Any]:
    """The machine-readable refusal contract: tuning against a device
    with no peak-spec row would prune against a made-up roofline."""
    from ..telemetry.programs import PEAK_SPECS

    return {
        "error": "unknown_device_class",
        "device_class": device_class,
        "known_markers": sorted(PEAK_SPECS),
        "hint": (
            "pass --allow-unknown-device to tune in measurement-only "
            "mode (analytic HBM pruning skipped), or --device-class "
            "with a known marker to tune for a target class"
        ),
    }


def _tel():
    from ..telemetry import get_registry

    return get_registry()


def _tune_train(
    bench: TuneBench,
    peak: Optional[Dict[str, float]],
    *,
    max_programs: int,
    hbm_fraction: float,
    space_kwargs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    kwargs = dict(
        max_length=bench.seq_len, batch_size=bench.batch_size,
    )
    kwargs.update(space_kwargs or {})
    candidates = train_space(**kwargs)
    decisions = prune_candidates(
        candidates, batch_size=bench.batch_size, max_length=bench.seq_len,
        max_batch=bench.max_batch, max_programs=max_programs,
        hbm_fraction=hbm_fraction, peak=peak,
    )
    _tel().counter("tune.candidates").inc(len(candidates))
    pruned = [d for d in decisions if not d.feasible]
    if pruned:
        _tel().counter("tune.pruned").inc(len(pruned))
    baseline = bench.bench_train(DEFAULT_TRAIN_KNOBS, with_losses=True)
    baseline_losses = baseline.pop("losses")
    results: List[Dict[str, Any]] = []
    best: Optional[Dict[str, Any]] = None
    for d in decisions:
        row: Dict[str, Any] = {"prune": d.to_json()}
        if d.feasible:
            measured = bench.bench_train(d.candidate.knobs, with_losses=True)
            losses = measured.pop("losses")
            verdict = check_train_parity(d.candidate, baseline_losses, losses)
            row["parity"] = verdict.to_json()
            if verdict.passed:
                row["bench"] = measured
                if (
                    best is None
                    or measured["real_tokens_per_s"]
                    > best["bench"]["real_tokens_per_s"]
                ):
                    best = row
            else:
                _tel().counter("tune.parity_refused").inc()
        results.append(row)
    return {
        "default_knobs": dict(DEFAULT_TRAIN_KNOBS),
        "default_bench": baseline,
        "candidates": results,
        "winner": best,
        "speedup_real_tokens": (
            round(
                best["bench"]["real_tokens_per_s"]
                / max(baseline["real_tokens_per_s"], 1e-9),
                3,
            )
            if best else None
        ),
    }


def _gate_impl_change(
    bench: TuneBench,
    base_knobs: Dict[str, Any],
    cand_knobs: Dict[str, Any],
    *,
    threshold: float = 0.5,
):
    """Cross-impl winner check: changing the dispatch impl itself
    (bucketed → ragged/continuous) is score-adjacent (the packed path
    runs other kernels, not bitwise), so it answers to the same
    ``evaluate_gate`` machinery as a bank promotion — measured AUC/F1
    on the golden set plus a synthesized flip summary."""
    import numpy as np

    from ..bankops.promote import GateThresholds, evaluate_gate
    from ..evaluate.metrics import SiameseMeasure

    instances = bench.golden_instances
    texts = [inst["text1"] for inst in instances]
    metas = [inst.get("meta") or {} for inst in instances]
    base = np.asarray(
        bench.build_predictor(base_knobs).score_texts(texts)
    )
    cand = np.asarray(
        bench.build_predictor(cand_knobs).score_texts(texts)
    )

    def _measured(probs) -> Dict[str, float]:
        measure = SiameseMeasure()
        measure.update(probs.max(axis=-1), metas)
        out = measure.compute(reset=True)
        out["n_eval"] = float(len(instances))
        return out

    best_base = base.max(axis=-1)
    best_cand = cand.max(axis=-1)
    flips = int(((best_base >= threshold) != (best_cand >= threshold)).sum())
    deltas = np.abs(best_cand - best_base)
    shadow_summary = {
        "sampled": len(instances),
        "flips": flips,
        "flip_rate": flips / max(len(instances), 1),
        "anchor_changes": int(
            (base.argmax(axis=-1) != cand.argmax(axis=-1)).sum()
        ),
        "mean_abs_delta": float(deltas.mean()) if len(deltas) else 0.0,
        "max_abs_delta": float(deltas.max()) if len(deltas) else 0.0,
    }
    return evaluate_gate(
        _measured(base),
        _measured(cand),
        shadow_summary,
        thresholds=GateThresholds(
            min_shadow_samples=min(100, len(instances))
        ),
        candidate=cand_knobs.get("score_impl", "?"),
        parent=base_knobs.get("score_impl", "?"),
    )


def _tune_serve(
    bench: TuneBench,
    peak: Optional[Dict[str, float]],
    *,
    max_programs: int,
    hbm_fraction: float,
    space_kwargs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    kwargs = dict(max_length=bench.seq_len, max_batch=bench.max_batch)
    kwargs.update(space_kwargs or {})
    candidates = serve_space(**kwargs)
    decisions = prune_candidates(
        candidates, batch_size=bench.batch_size, max_length=bench.seq_len,
        max_batch=bench.max_batch, max_programs=max_programs,
        hbm_fraction=hbm_fraction, peak=peak,
    )
    _tel().counter("tune.candidates").inc(len(candidates))
    pruned = [d for d in decisions if not d.feasible]
    if pruned:
        _tel().counter("tune.pruned").inc(len(pruned))
    default_knobs = dict(DEFAULT_SERVE_KNOBS, max_batch=bench.max_batch)
    baseline = bench.bench_serve(default_knobs)
    # per-impl parity baselines: layout knobs within an impl must be
    # bitwise against THAT impl's default layout; the impl change
    # itself is gated separately (evaluate_gate) on the winner
    probe_baselines: Dict[str, Any] = {}

    def _impl_baseline(impl: str):
        if impl not in probe_baselines:
            knobs = dict(default_knobs)
            if impl in ("ragged", "continuous"):
                knobs = {
                    "score_impl": impl,
                    "max_batch": bench.max_batch,
                    "token_budget": 4 * bench.seq_len,
                    "max_rows_per_pack": bench.max_batch,
                }
            probe_baselines[impl] = bench.probe_scores(knobs)
        return probe_baselines[impl]

    results: List[Dict[str, Any]] = []
    best: Optional[Dict[str, Any]] = None
    for d in decisions:
        row: Dict[str, Any] = {"prune": d.to_json()}
        if d.feasible:
            impl = d.candidate.knobs.get("score_impl", "bucketed")
            verdict = check_serve_parity(
                d.candidate,
                _impl_baseline(impl),
                bench.probe_scores(d.candidate.knobs),
            )
            row["parity"] = verdict.to_json()
            if verdict.passed:
                row["bench"] = bench.bench_serve(d.candidate.knobs)
                if (
                    best is None
                    or row["bench"]["requests_per_sec"]
                    > best["bench"]["requests_per_sec"]
                ):
                    best = row
            else:
                _tel().counter("tune.parity_refused").inc()
        results.append(row)
    impl_gate = None
    if best is not None:
        winner_knobs = best["prune"]["candidate"]["knobs"]
        if winner_knobs.get("score_impl", "bucketed") != "bucketed":
            decision = _gate_impl_change(bench, default_knobs, winner_knobs)
            impl_gate = decision.to_json()
            if not decision.approved:
                # fall back to the best same-impl candidate
                bucketed = [
                    r for r in results
                    if r.get("bench")
                    and r["prune"]["candidate"]["knobs"].get(
                        "score_impl", "bucketed") == "bucketed"
                ]
                best = max(
                    bucketed,
                    key=lambda r: r["bench"]["requests_per_sec"],
                    default=None,
                )
    return {
        "default_knobs": default_knobs,
        "default_bench": baseline,
        "candidates": results,
        "winner": best,
        "impl_gate": impl_gate,
        "speedup_rps": (
            round(
                best["bench"]["requests_per_sec"]
                / max(baseline["requests_per_sec"], 1e-9),
                3,
            )
            if best else None
        ),
    }


def run_tune(
    mode: str = "all",
    *,
    device_class: Optional[str] = None,
    allow_unknown_device: bool = False,
    out_dir: Optional[str] = None,
    cascade: bool = False,
    target_rescore_rate: float = 0.1,
    max_programs: int = 64,
    hbm_fraction: float = 0.9,
    bench_kwargs: Optional[Dict[str, Any]] = None,
    train_space_kwargs: Optional[Dict[str, Any]] = None,
    serve_space_kwargs: Optional[Dict[str, Any]] = None,
    device: Union[str, Any] = "cuda",
) -> Dict[str, Any]:
    """One offline tune pass on ``device`` (a CUDA device on a host
    without one raises).  Returns the full audit record; when the
    device class has no ``PEAK_SPECS`` row and ``allow_unknown_device``
    is False, returns the ``unknown_device_class`` refusal instead of
    tuning against a made-up roofline."""
    from ..build import resolve_device

    if mode not in ("train", "serve", "all"):
        raise ValueError(f"mode must be train|serve|all, got {mode!r}")
    device = resolve_device(device)
    cls, peak = resolve_device_class(device_class, device=device)
    _tel().gauge(f"tune.device_class.{cls}").set(1.0 if peak else 0.0)
    if peak is None and not allow_unknown_device:
        return unknown_device_refusal(cls)

    bench = TuneBench(**dict(bench_kwargs or {}, device=device))
    record: Dict[str, Any] = {
        "device_class": cls,
        "peak_spec": dict(peak) if peak else None,
        "mode": mode,
        "bench": {
            "model_size": bench.model_size, "seq_len": bench.seq_len,
            "batch_size": bench.batch_size,
            "steps_per_epoch": bench.steps_per_epoch,
            "n_requests": bench.n_requests, "n_clients": bench.n_clients,
            "max_batch": bench.max_batch, "seed": bench.seed,
        },
    }
    profile: Dict[str, Any] = {}
    if mode in ("train", "all"):
        record["train"] = _tune_train(
            bench, peak, max_programs=max_programs,
            hbm_fraction=hbm_fraction, space_kwargs=train_space_kwargs,
        )
        if record["train"]["winner"]:
            profile["train"] = dict(
                record["train"]["winner"]["prune"]["candidate"]["knobs"]
            )
    if mode in ("serve", "all"):
        record["serve"] = _tune_serve(
            bench, peak, max_programs=max_programs,
            hbm_fraction=hbm_fraction, space_kwargs=serve_space_kwargs,
        )
        if record["serve"]["winner"]:
            profile["serving"] = dict(
                record["serve"]["winner"]["prune"]["candidate"]["knobs"]
            )
    if cascade:
        from .cascade import choose_band

        predictor = bench.build_predictor({"score_impl": "cascade"})
        band = choose_band(
            predictor, bench.golden_instances,
            target_rescore_rate=target_rescore_rate,
        )
        record["cascade"] = band
        if band["approved"]:
            profile.setdefault("serving", {}).update(
                cascade_low=band["cascade_low"],
                cascade_high=band["cascade_high"],
            )
    record["profile"] = profile or None
    if out_dir and profile:
        evidence = {
            "train": {
                k: record.get("train", {}).get(k)
                for k in ("default_bench", "speedup_real_tokens")
            },
            "serve": {
                k: record.get("serve", {}).get(k)
                for k in ("default_bench", "speedup_rps")
            },
            "cascade": {
                k: record.get("cascade", {}).get(k)
                for k in ("predicted_rescore_rate", "approved")
            } if cascade else None,
        }
        path = save_profile(
            out_dir, cls, dict(profile, evidence=evidence)
        )
        record["profile_path"] = str(path)
        logger.info("tuned profile written: %s", path)
    return record

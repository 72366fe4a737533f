"""The anchor-bank lifecycle (the JAX package's ``bankops/``): MemVul's
external CWE memory as a managed, evolvable artifact.

* **store** — immutable versioned bank artifacts with sha256 manifests and
  their diff lineage (``add`` / ``retire`` / ``reweight`` / ``edit``), an
  ``ACTIVE`` pointer and a promotions audit trail;
* **shadow** — score live or recorded traffic against a candidate bank off
  the active path; one delta row per request in ``shadow_deltas.jsonl``;
* **promote** — the AUC/F1-parity and shadow-flip-rate gate with
  machine-readable refusals, install on one service, demote to the parent;
* **drift** — per-anchor win shares and their total-variation drift
  against a pinned baseline (``bank.anchor_drift``).

CLI: ``python -m memvul_tpu_torch bank {build,diff,log,shadow,promote}``.
"""

from .drift import (  # noqa: F401
    BASELINE_NAME,
    DRIFT_GAUGE,
    DriftMonitor,
    load_baseline,
    pin_baseline,
    total_variation,
    update_drift_gauge,
    win_counts,
    win_shares,
)
from .promote import (  # noqa: F401
    GateThresholds,
    PromotionDecision,
    PromotionRefused,
    demote,
    evaluate_candidate,
    evaluate_cascade,
    evaluate_gate,
    evaluate_reweight,
    golden_metrics,
    promote,
)
from .shadow import (  # noqa: F401
    SHADOW_DELTAS_NAME,
    ShadowConfig,
    ShadowScorer,
    replay_results,
    score_texts,
)
from .store import (  # noqa: F401
    ACTIVE_NAME,
    ANCHORS_NAME,
    DIFF_OPS,
    MANIFEST_NAME,
    PROMOTIONS_NAME,
    BankDiff,
    BankIntegrityError,
    BankStore,
    BankStoreError,
    DiffOp,
    anchor_sha256,
    canonical_anchor_text,
)

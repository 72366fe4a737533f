"""Prometheus text-format exposition of registry snapshots (the JAX
package's ``telemetry/exposition.py``): what ``GET /metrics``
(``serving/frontend.py``) serves.

* counters → ``# TYPE <name> counter`` samples, gauges → ``gauge``;
* histogram summaries → a Prometheus *summary*: ``<name>{quantile=..}``
  for the reservoir's p50 and p95 plus ``<name>_sum`` / ``<name>_count``;
* metric names are sanitized (``serve.queue_depth`` →
  ``serve_queue_depth``; any other byte outside ``[a-zA-Z0-9_:]`` becomes
  ``_``), so a scrape agrees exactly with the snapshot it came from;
* ``labels`` attach to every sample of a part: the router renders one part
  per replica with ``{"replica": "replica-<i>"}``, so per-replica counters
  stay separable at the scrape endpoint.

Rendering only reads snapshots: no device work, safe in an HTTP handler.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Sequence, Tuple

# the quantiles rendered for each histogram summary (the JAX package's two,
# so both packages render one snapshot to the same text)
_SUMMARY_QUANTILES = (("0.5", "p50"), ("0.95", "p95"))

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")

# one snapshot part: (labels, snapshot) — a bare service exposes one
# unlabeled part, a router one part per replica plus its own
SnapshotPart = Tuple[Mapping[str, str], Mapping[str, Any]]


def sanitize_metric_name(name: str) -> str:
    """``serve.queue_depth`` → ``serve_queue_depth`` (dots and every
    other byte outside the Prometheus name alphabet become ``_``; a
    leading digit is prefixed)."""
    out = _NAME_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_label_value(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r"\"")
    )


def _label_str(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{sanitize_metric_name(k)}="{_escape_label_value(v)}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(value: Any) -> str:
    if isinstance(value, bool):  # bool is an int subclass; be explicit
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    try:
        f = float(value)
    except (TypeError, ValueError):
        return "0"
    return repr(f)


def render_exposition(parts: Sequence[SnapshotPart]) -> str:
    """Render snapshot parts as one Prometheus text document.

    All samples of one metric are grouped under a single ``# TYPE``
    line (the format's requirement), so two replicas' ``serve.served``
    land adjacent with their ``replica`` labels telling them apart.
    """
    counters: Dict[str, List[str]] = {}
    gauges: Dict[str, List[str]] = {}
    summaries: Dict[str, List[str]] = {}
    for labels, snapshot in parts:
        label_str = _label_str(labels)
        for name, value in (snapshot.get("counters") or {}).items():
            metric = sanitize_metric_name(name)
            counters.setdefault(metric, []).append(
                f"{metric}{label_str} {_fmt_value(value)}"
            )
        for name, value in (snapshot.get("gauges") or {}).items():
            if value is None:
                continue
            metric = sanitize_metric_name(name)
            gauges.setdefault(metric, []).append(
                f"{metric}{label_str} {_fmt_value(value)}"
            )
        for name, summary in (snapshot.get("histograms") or {}).items():
            if not summary:
                continue
            metric = sanitize_metric_name(name)
            lines = summaries.setdefault(metric, [])
            for quantile, key in _SUMMARY_QUANTILES:
                if summary.get(key) is None:
                    continue
                q_labels = dict(labels)
                q_labels["quantile"] = quantile
                lines.append(
                    f"{metric}{_label_str(q_labels)} "
                    f"{_fmt_value(summary[key])}"
                )
            lines.append(
                f"{metric}_sum{label_str} "
                f"{_fmt_value(summary.get('total', 0.0))}"
            )
            lines.append(
                f"{metric}_count{label_str} "
                f"{_fmt_value(int(summary.get('count', 0)))}"
            )
    out: List[str] = []
    for metric in sorted(counters):
        out.append(f"# TYPE {metric} counter")
        out.extend(counters[metric])
    for metric in sorted(gauges):
        out.append(f"# TYPE {metric} gauge")
        out.extend(gauges[metric])
    for metric in sorted(summaries):
        out.append(f"# TYPE {metric} summary")
        out.extend(summaries[metric])
    return "\n".join(out) + ("\n" if out else "")


def render_target(target) -> str:
    """Render a serving target's live registries: anything exposing
    ``metrics_snapshots()``, a ``ScoringService`` (one unlabeled part) or
    a ``ReplicaRouter`` (its own registry plus one ``replica``-labeled
    part per replica)."""
    return render_exposition(target.metrics_snapshots())


def parse_exposition(text: str) -> Dict[str, Dict[str, float]]:
    """Parse Prometheus text format back into
    ``{metric: {label_str: value}}``.  Raises ``ValueError`` on a malformed
    sample line."""
    out: Dict[str, Dict[str, float]] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(
            r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$", line
        )
        if m is None:
            raise ValueError(f"not a Prometheus sample line: {raw!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        out.setdefault(name, {})[labels] = float(value)
    return out

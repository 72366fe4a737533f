"""Render a run directory's telemetry into a human summary (the JAX
package's ``telemetry/report.py``).

``python -m memvul_tpu_torch telemetry-report <run_dir> [--json]`` — the
operator's first stop on any run that died, stalled, or just finished: a
phase table, step-time percentiles, counter totals, and the
last-heartbeat age, all reconstructed from whatever subset of the three
sink files survived (a SIGKILLed run legitimately leaves only a torn
``events.jsonl`` and a stale ``HEARTBEAT.json`` — the report renders
those too, it never requires a clean shutdown).  It reads the run dirs of
``train``, ``evaluate``, ``serve`` (``replica-<i>/`` subdirs, incident
bundles) and ``score-corpus`` (``shard-<i>/`` subdirs), and the program
table of ``telemetry/programs.py``.  The text and ``report_json`` are the
JAX package's for the same sink files, but for the PROGRAMS header, which
names the port's programs (score shapes, bank chunks, the kernel library).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from .sinks import HeartbeatFile, SummaryFile, read_jsonl


def load_run(run_dir: Union[str, Path]) -> Dict[str, Any]:
    """Everything readable from a run dir's telemetry sinks."""
    run_dir = Path(run_dir)
    events, skipped = read_jsonl(run_dir / "events.jsonl")
    return {
        "run_dir": run_dir,
        "events": events,
        "events_skipped": skipped,
        "summary": SummaryFile(run_dir / "telemetry.json").read(),
        "heartbeat": HeartbeatFile(run_dir / "HEARTBEAT.json").read(),
    }


def _span_table(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Aggregate ``span`` events by name: count / total / mean / max."""
    table: Dict[str, Dict[str, float]] = {}
    for ev in events:
        if ev.get("kind") != "span":
            continue
        name = str(ev.get("name"))
        try:
            dur = float(ev.get("dur_s", 0.0))
        except (TypeError, ValueError):
            continue
        row = table.setdefault(name, {"count": 0.0, "total_s": 0.0, "max_s": 0.0})
        row["count"] += 1
        row["total_s"] += dur
        row["max_s"] = max(row["max_s"], dur)
    for row in table.values():
        row["mean_s"] = row["total_s"] / row["count"] if row["count"] else 0.0
    return table


def _fmt_s(v: Optional[float]) -> str:
    """Seconds for display; tolerates junk (a hand-edited or corrupted
    sink value must degrade to "-", never crash the report — the report
    is the post-mortem tool, it has no one to crash to)."""
    try:
        return f"{float(v):.3f}s"
    except (TypeError, ValueError):
        return "-"


def _fmt_num(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


_ROUTER_EVENT_KINDS = frozenset({
    "router_start", "router_drained", "replica_dead", "replica_restart",
    "replica_restart_failed", "rolling_swap_start", "rolling_swap_done",
    "replica_swap_begin", "replica_swap_done",
})


def _replica_rows(
    run_dir: Path, events: List[Dict[str, Any]], now: float
) -> Dict[str, Any]:
    """The data behind the REPLICAS section (and the ``replicas`` block
    of the ``--json`` report): per-replica counter rows from each
    ``replica-<i>/`` subdir's own sinks, plus the router's lifecycle
    event tallies from the main stream."""
    replica_dirs = sorted(
        d for d in run_dir.glob("replica-*") if d.is_dir()
    )
    router_events = [
        ev for ev in events if ev.get("kind") in _ROUTER_EVENT_KINDS
    ]
    restarts: Dict[str, int] = {}
    deaths: Dict[str, int] = {}
    for ev in router_events:
        name = str(ev.get("replica", "?"))
        if ev.get("kind") == "replica_restart":
            restarts[name] = restarts.get(name, 0) + 1
        elif ev.get("kind") == "replica_dead":
            deaths[name] = deaths.get(name, 0) + 1
    rows: List[Dict[str, Any]] = []
    for replica_dir in replica_dirs:
        name = replica_dir.name
        sub = load_run(replica_dir)
        counters = dict((sub["summary"] or {}).get("counters") or {})
        if not counters:
            counters = dict((sub["heartbeat"] or {}).get("counters") or {})
        if not (sub["events"] or sub["summary"] or sub["heartbeat"]):
            rows.append({"name": name, "recorded": False})
            continue
        heartbeat = sub["heartbeat"] or {}
        try:
            age: Optional[float] = now - float(heartbeat.get("written_wall"))
        except (TypeError, ValueError):
            age = None
        rows.append({
            "name": name,
            "recorded": True,
            "heartbeat_age_s": age,
            "served": counters.get("serve.served", 0),
            "shed": counters.get("serve.shed", 0),
            "errors": counters.get("serve.errors", 0),
            "restarts": counters.get(
                "replica.restarts", restarts.get(name, 0)
            ),
        })
    return {
        "router_events": len(router_events),
        "deaths": sum(deaths.values()),
        "restarts": sum(restarts.values()),
        "members": rows,
    }


def _replica_section(
    run_dir: Path, events: List[Dict[str, Any]], now: float
) -> List[str]:
    """Per-replica rows for a scale-out serving run dir (serve
    ``--replicas``): each ``replica-<i>/`` subdir carries that
    replica's own sinks, and the main event stream carries the
    router's lifecycle events.  Rendered whenever either is present; a
    replica that never wrote events (killed before its first flush, or
    telemetry disabled) renders as an explicit "(no telemetry
    recorded)" row instead of vanishing — its absence is exactly the
    post-mortem signal."""
    data = _replica_rows(run_dir, events, now)
    if not (data["members"] or data["router_events"]):
        return []
    lines = ["REPLICAS"]
    if data["router_events"]:
        lines.append(
            f"  router events: {data['router_events']}"
            + (f"  deaths: {data['deaths']}" if data["deaths"] else "")
            + (f"  restarts: {data['restarts']}" if data["restarts"] else "")
        )
    for row in data["members"]:
        if not row["recorded"]:
            lines.append(f"  {row['name']}: (no telemetry recorded)")
            continue
        lines.append(
            f"  {row['name']}: heartbeat {_fmt_s(row['heartbeat_age_s'])} ago"
            f"  served={_fmt_num(row['served'])}"
            f"  shed={_fmt_num(row['shed'])}"
            f"  errors={_fmt_num(row['errors'])}"
            f"  restarts={_fmt_num(row['restarts'])}"
        )
    return lines


_SHARD_EVENT_KINDS = frozenset({
    "shard_start", "shard_restart", "shard_dead", "shard_stalled",
    "shard_quarantined", "shard_done", "merge_verified",
})


def _shard_rows(
    run_dir: Path, events: List[Dict[str, Any]], now: float
) -> Dict[str, Any]:
    """The data behind the SHARDS section (and the ``shards`` block of
    the ``--json`` report): per-shard progress rows from each
    ``shard-<i>/`` subdir's own sinks (a sharded ``score-corpus`` run),
    plus the coordinator's lifecycle event tallies
    from the main stream — the ``_replica_rows`` pattern applied to the
    offline map-reduce tier."""
    shard_dirs = sorted(d for d in run_dir.glob("shard-*") if d.is_dir())
    shard_events = [
        ev for ev in events if ev.get("kind") in _SHARD_EVENT_KINDS
    ]
    restarts: Dict[str, int] = {}
    quarantined: Dict[str, bool] = {}
    done: Dict[str, bool] = {}
    for ev in shard_events:
        name = str(ev.get("shard", "?"))
        if ev.get("kind") == "shard_restart":
            restarts[name] = restarts.get(name, 0) + 1
        elif ev.get("kind") == "shard_quarantined":
            quarantined[name] = True
        elif ev.get("kind") == "shard_done":
            done[name] = True
    rows: List[Dict[str, Any]] = []
    for shard_dir in shard_dirs:
        name = shard_dir.name
        sub = load_run(shard_dir)
        if not (sub["events"] or sub["summary"] or sub["heartbeat"]):
            rows.append({"name": name, "recorded": False})
            continue
        heartbeat = sub["heartbeat"] or {}
        counters = dict((sub["summary"] or {}).get("counters") or {})
        if not counters:
            counters = dict(heartbeat.get("counters") or {})
        try:
            age: Optional[float] = now - float(heartbeat.get("written_wall"))
        except (TypeError, ValueError):
            age = None
        committed = heartbeat.get("rows_scored")
        if committed is None:
            committed = counters.get("journal.rows_committed", 0)
        rows.append({
            "name": name,
            "recorded": True,
            "heartbeat_age_s": age,
            "rows_committed": committed,
            "retries": counters.get("resilience.retries", 0),
            "restarts": restarts.get(name, 0),
            "quarantined": quarantined.get(name, False),
            "done": done.get(name, False),
        })
    return {
        "coordinator_events": len(shard_events),
        "restarts": sum(restarts.values()),
        "quarantined": sum(quarantined.values()),
        "members": rows,
    }


def _shard_section(
    run_dir: Path, events: List[Dict[str, Any]], now: float
) -> List[str]:
    """Per-shard rows for a sharded corpus-scoring run dir.  Always
    rendered (the PROGRAMS pattern): a pre-existing run dir — or a
    single-process one — says "(no shards recorded)" explicitly rather
    than leaving the operator to wonder whether the section was
    dropped.  A shard that never wrote telemetry (killed before its
    first heartbeat) renders as an explicit row — its silence is the
    post-mortem signal."""
    data = _shard_rows(run_dir, events, now)
    lines = ["SHARDS"]
    if not (data["members"] or data["coordinator_events"]):
        lines.append("  (no shards recorded)")
        return lines
    if data["coordinator_events"]:
        lines.append(
            f"  coordinator events: {data['coordinator_events']}"
            + (f"  restarts: {data['restarts']}" if data["restarts"] else "")
            + (f"  quarantined: {data['quarantined']}"
               if data["quarantined"] else "")
        )
    for row in data["members"]:
        if not row["recorded"]:
            lines.append(f"  {row['name']}: (no telemetry recorded)")
            continue
        status = (
            "quarantined" if row["quarantined"]
            else "done" if row["done"] else "running"
        )
        lines.append(
            f"  {row['name']}: heartbeat {_fmt_s(row['heartbeat_age_s'])} ago"
            f"  rows={_fmt_num(row['rows_committed'])}"
            f"  retries={_fmt_num(row['retries'])}"
            f"  restarts={_fmt_num(row['restarts'])}"
            f"  {status}"
        )
    return lines


def _anchor_bank_section(
    run_dir: Path, counters: Dict[str, Any], summary: Dict[str, Any]
) -> List[str]:
    """Per-anchor win/score/drift table: the
    serving path counts ``bank.anchor_wins.<id>`` and samples
    ``bank.anchor_score.<id>`` per served decision; a pinned
    ``anchor_baseline.json`` beside the sinks turns win shares into a
    drift column, so a degrading anchor is visible before it costs
    recall.  Shadow-scoring counters render as one summary line."""
    wins: Dict[str, float] = {}
    for name, value in counters.items():
        if name.startswith("bank.anchor_wins."):
            try:
                wins[name[len("bank.anchor_wins."):]] = float(value)
            except (TypeError, ValueError):
                continue
    shadow = {
        key: counters.get(f"bank.shadow_{key}", 0)
        for key in ("sampled", "flips", "errors", "dropped")
    }
    has_shadow = any(_as_num(v) for v in shadow.values())
    if not (wins or has_shadow):
        return []
    lines = ["ANCHOR BANK"]
    if wins:
        total = sum(wins.values())
        hists = summary.get("histograms") or {}
        baseline = None
        try:
            from ..bankops.drift import load_baseline

            baseline = load_baseline(run_dir / "anchor_baseline.json")
        except Exception:  # pragma: no cover - report must always render
            baseline = None
        gauges = summary.get("gauges") or {}
        drift_line = f"  decisions: {int(total)}"
        if gauges.get("bank.anchor_drift") is not None:
            drift_line += (
                f"  drift(gauge): {_fmt_num(gauges['bank.anchor_drift'])}"
            )
        if baseline and total > 0:
            shares = {k: v / total for k, v in wins.items()}
            keys = set(shares) | set(baseline)
            tv = 0.5 * sum(
                abs(shares.get(k, 0.0) - baseline.get(k, 0.0)) for k in keys
            )
            drift_line += f"  drift(vs baseline): {tv:.3f}"
        lines.append(drift_line)
        lines.append(
            f"  {'anchor':<24} {'wins':>8} {'share':>7} {'score p50':>10}"
            f" {'score max':>10}" + ("  Δshare" if baseline else "")
        )
        ranked = sorted(wins, key=lambda a: -wins[a])
        for anchor in ranked[:20]:
            count = wins[anchor]
            share = count / total if total else 0.0
            h = hists.get(f"bank.anchor_score.{anchor}") or {}
            row = (
                f"  {anchor:<24} {int(count):>8} {share:>6.1%}"
                f" {_fmt_num(h.get('p50', '-')):>10}"
                f" {_fmt_num(h.get('max', '-')):>10}"
            )
            if baseline:
                row += f"  {share - baseline.get(anchor, 0.0):+.3f}"
            lines.append(row)
        if len(ranked) > 20:
            lines.append(f"  (+{len(ranked) - 20} more anchors)")
    if has_shadow:
        sampled = _as_num(shadow["sampled"])
        flips = _as_num(shadow["flips"])
        lines.append(
            f"  shadow: sampled={int(sampled)} flips={int(flips)}"
            + (f" flip_rate={flips / sampled:.4f}" if sampled else "")
            + f" errors={int(_as_num(shadow['errors']))}"
            + f" dropped={int(_as_num(shadow['dropped']))}"
        )
    return lines


def _as_num(v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


def _load_programs(
    run_dir: Path, events: List[Dict[str, Any]]
) -> Dict[str, Any]:
    """The compiled-program table for the PROGRAMS/ROOFLINE sections.

    Preferred source: ``programs.json`` (telemetry/programs.py
    ``write_programs`` — full records incl. invocation counts and the
    roofline aggregate).  A run killed before that file landed still
    has its per-compile ``program`` events in the stream, so those
    reconstruct a partial table (no invocation/roofline data).  A
    pre-registry run dir has neither and renders "(no programs
    recorded)"."""
    import json

    path = run_dir / "programs.json"
    if path.exists():
        try:
            payload = json.loads(path.read_text())
            programs = payload.get("programs") or []
            if isinstance(programs, list):
                return {
                    "source": "programs.json",
                    "programs": programs,
                    "roofline": payload.get("roofline"),
                }
        except (OSError, ValueError):  # torn write → fall back to events
            pass
    rows: List[Dict[str, Any]] = []
    for ev in events:
        if ev.get("kind") != "program":
            continue
        rows.append({
            "key": ev.get("key"),
            "scope": ev.get("scope"),
            "compile_s": ev.get("compile_s"),
            "flops": ev.get("flops"),
            "bytes_accessed": ev.get("bytes_accessed"),
            "hbm_bytes": ev.get("hbm_bytes"),
            "device_kind": ev.get("device_kind"),
        })
    return {
        "source": "events" if rows else None,
        "programs": rows,
        "roofline": None,
    }


def _programs_section(programs: Dict[str, Any]) -> List[str]:
    """PROGRAMS + ROOFLINE text rendering; always emits the PROGRAMS
    header so an operator sees explicitly when a run predates the
    program registry."""
    lines = ["PROGRAMS (score shapes, bank chunks and the kernel library)"]
    rows = programs["programs"]
    if not rows:
        lines.append("  (no programs recorded)")
        return lines
    if programs["source"] == "events":
        lines.append(
            "  (reconstructed from program events — programs.json "
            "missing; invocation counts unavailable)"
        )
    lines.append(
        f"  {'key':<40} {'scope':<7} {'compile':>9} {'flops':>12}"
        f" {'hbm_bytes':>12} {'calls':>7}"
    )
    for row in rows[:20]:
        lines.append(
            f"  {str(row.get('key'))[:40]:<40}"
            f" {str(row.get('scope', '-')):<7}"
            f" {_fmt_s(row.get('compile_s')):>9}"
            f" {_fmt_num(row.get('flops', '-')):>12}"
            f" {_fmt_num(row.get('hbm_bytes', '-')):>12}"
            f" {_fmt_num(row.get('invocations', '-')):>7}"
        )
    if len(rows) > 20:
        lines.append(f"  (+{len(rows) - 20} more programs)")
    roof = programs.get("roofline")
    if roof:
        lines.append("")
        lines.append("ROOFLINE")
        lines.append(
            f"  device: {roof.get('device_kind', '?')}"
            + ("  (interpret-only — no peak spec, busy_util unavailable)"
               if roof.get("interpret_only") else "")
        )
        lines.append(
            f"  programs: {_fmt_num(roof.get('programs', 0))}"
            f"  flops_total: {_fmt_num(roof.get('flops_total', 0))}"
            f"  device_time: {_fmt_s(roof.get('device_time_s'))}"
        )
        if roof.get("busy_util") is not None:
            lines.append(
                f"  busy_util: {_as_num(roof.get('busy_util')):.4f}"
                f"  membw_util: {_fmt_num(roof.get('membw_util', '-'))}"
                f"  achieved_flops_per_s:"
                f" {_fmt_num(roof.get('achieved_flops_per_s', '-'))}"
            )
    return lines


# the per-request journey stages (serving/service.py tracing): together
# they partition enqueued→resolved, so their totals decompose serve
# latency into WHERE a request spent its time
_LATENCY_STAGES = (
    ("queue_wait", "serve.queue_wait_s"),
    ("pack", "serve.pack_s"),
    ("device", "serve.device_s"),
    ("resolve", "serve.resolve_s"),
)


def _latency_decomposition(
    histograms: Dict[str, Any],
) -> Dict[str, Dict[str, Any]]:
    """Stage rows (count/mean/p50/p95/share) from the serve stage
    histograms; empty when the run never traced (sampling off)."""
    rows: Dict[str, Dict[str, Any]] = {}
    total = 0.0
    for stage, metric in _LATENCY_STAGES:
        h = histograms.get(metric) or {}
        if not _as_num(h.get("count")):
            continue
        rows[stage] = {
            "metric": metric,
            "count": int(_as_num(h.get("count"))),
            "total_s": _as_num(h.get("total")),
            "mean_s": _as_num(h.get("mean")),
            "p50_s": h.get("p50"),
            "p95_s": h.get("p95"),
        }
        total += _as_num(h.get("total"))
    for row in rows.values():
        row["share"] = row["total_s"] / total if total > 0 else 0.0
    return rows


def _latency_section(histograms: Dict[str, Any]) -> List[str]:
    rows = _latency_decomposition(histograms)
    if not rows:
        return []
    lines = ["LATENCY DECOMPOSITION (request-journey stages)"]
    lines.append(
        f"  {'stage':<12} {'count':>7} {'mean':>10} {'p50':>10}"
        f" {'p95':>10} {'share':>7}"
    )
    for stage, _metric in _LATENCY_STAGES:
        row = rows.get(stage)
        if row is None:
            continue
        lines.append(
            f"  {stage:<12} {row['count']:>7}"
            f" {_fmt_s(row['mean_s']):>10}"
            f" {_fmt_s(row['p50_s']):>10}"
            f" {_fmt_s(row['p95_s']):>10}"
            f" {row['share']:>6.1%}"
        )
    return lines


def _derived_metrics(counters: Dict[str, Any]) -> Dict[str, float]:
    """The report-derived ratios (documented as ``derived`` in the
    metric catalog) — shared by the text COUNTERS section and the
    ``--json`` report."""
    out: Dict[str, float] = {}
    hits = _as_num(counters.get("data.encode_cache_hits"))
    misses = _as_num(counters.get("data.encode_cache_misses"))
    if hits + misses > 0:
        out["data.encode_cache_hit_rate"] = hits / (hits + misses)
    real = _as_num(counters.get("serve.tokens_real"))
    padded = _as_num(counters.get("serve.tokens_padded"))
    if padded > 0:
        out["serve.real_token_utilization"] = real / padded
    topups = _as_num(counters.get("serve.pack_topups"))
    served = _as_num(counters.get("serve.served"))
    if topups > 0 and served > 0:
        # continuous admission only: the fraction of served requests
        # that joined a pack while the device was busy with another —
        # how much of the load actually overlapped the round-trip
        out["serve.admission_efficiency"] = topups / served
    rescored = _as_num(counters.get("serve.cascade_rescored"))
    shortcut = _as_num(counters.get("serve.cascade_shortcircuit"))
    if rescored + shortcut > 0:
        # cascade dispatch only: the fraction of served requests whose
        # int8 score landed inside the uncertainty band and paid the
        # fp32 rescore
        out["serve.cascade_rescore_rate"] = rescored / (rescored + shortcut)
    cache_hits = _as_num(counters.get("cache.hits"))
    cache_misses = _as_num(counters.get("cache.misses"))
    if cache_hits + cache_misses > 0:
        # admission cache only (serving/admission_cache.py): the share
        # of probed requests answered without a device call
        out["cache.hit_rate"] = cache_hits / (cache_hits + cache_misses)
    return out


def _cascade_block(
    counters: Dict[str, Any], programs: List[Dict[str, Any]]
) -> Optional[Dict[str, Any]]:
    """The ``cascade`` block of the ``--json`` report (and the CASCADE
    text section): the tier split the CascadeDispatcher's counters
    record, plus each tier's share of device time read from the program
    registry's scope split (``score_int8:*`` = the int8 tier,
    ``score:*`` = the fp32 tier).  None when the run never dispatched a
    cascade batch."""
    rescored = _as_num(counters.get("serve.cascade_rescored"))
    shortcut = _as_num(counters.get("serve.cascade_shortcircuit"))
    total = rescored + shortcut
    if total <= 0:
        return None
    tiers: Dict[str, Dict[str, float]] = {}
    for row in programs or []:
        scope = row.get("scope")
        tier = {"score_int8": "int8", "score": "fp32"}.get(scope)
        if tier is None:
            continue
        t = tiers.setdefault(
            tier, {"programs": 0.0, "invocations": 0.0, "device_time_s": 0.0}
        )
        t["programs"] += 1
        t["invocations"] += _as_num(row.get("invocations"))
        t["device_time_s"] += _as_num(row.get("device_time_s"))
    device_total = sum(t["device_time_s"] for t in tiers.values())
    for t in tiers.values():
        t["device_time_share"] = (
            t["device_time_s"] / device_total if device_total > 0 else 0.0
        )
    return {
        "rescored": int(rescored),
        "shortcircuit": int(shortcut),
        "rescore_rate": rescored / total,
        "tiers": tiers,
    }


def _fleet_block(
    counters: Dict[str, Any], gauges: Dict[str, Any]
) -> Optional[Dict[str, Any]]:
    """The ``fleet`` block of the ``--json`` report (and the FLEET text
    section): the cross-host balancer's request/supervision counters
    plus the per-host heartbeat-age gauges its monitor republishes
    (serving/fleet.py).  None when the run had no host balancer."""
    fleet = {
        k.split(".", 1)[1]: v for k, v in counters.items()
        if k.startswith("fleet.")
    }
    heartbeat_ages = {
        k.split("fleet.heartbeat_age_s.", 1)[1]: v
        for k, v in gauges.items()
        if k.startswith("fleet.heartbeat_age_s.")
    }
    hosts = gauges.get("fleet.hosts")
    if not fleet and hosts is None:
        return None
    out: Dict[str, Any] = {
        "hosts": hosts,
        "hosts_alive": gauges.get("fleet.hosts_alive"),
        "counters": fleet,
    }
    if heartbeat_ages:
        out["heartbeat_age_s"] = heartbeat_ages
    return out


def _autoscaler_block(
    counters: Dict[str, Any],
    gauges: Dict[str, Any],
    events: Optional[List[Dict[str, Any]]] = None,
) -> Optional[Dict[str, Any]]:
    """The ``autoscaler`` block of the ``--json`` report (and the
    AUTOSCALER text section): scale_hint actuation totals plus the
    persisted ``scaler_decision`` trajectory (one event per control
    tick — the in-memory decision deque dies with the process; these
    survive in ``events.jsonl``).  None when no autoscaler ran."""
    scaler = {
        k.split(".", 1)[1]: v for k, v in counters.items()
        if k.startswith("scaler.")
    }
    replicas = gauges.get("scaler.replicas")
    decisions = [
        ev for ev in (events or []) if ev.get("kind") == "scaler_decision"
    ]
    if not scaler and replicas is None and not decisions:
        return None
    out: Dict[str, Any] = {
        "replicas": replicas,
        "hint": gauges.get("scaler.hint"),
        "counters": scaler,
    }
    if decisions:
        acted = [d for d in decisions if d.get("action")]
        out["decisions"] = {
            "ticks": len(decisions),
            "acted": len(acted),
            "last_actions": [
                {
                    "t_s": d.get("t_s"),
                    "action": d.get("action"),
                    "replicas": d.get("replicas"),
                    "hint": d.get("hint"),
                    "burn_rate_fast": d.get("burn_rate_fast"),
                }
                for d in acted[-8:]
            ],
        }
    return out


_ALERT_EVENT_KINDS = frozenset({"alert_fired", "alert_resolved"})


def _alerts_block(
    events: List[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """The ``alerts`` block of the ``--json`` report (and the ALERTS
    text section): alert-rule transitions replayed from the event
    stream (telemetry/alerts.py emits one ``alert_fired`` /
    ``alert_resolved`` event per edge).  A rule that fired without a
    matching resolve was still firing when the run ended — exactly the
    post-mortem lead.  None when no alert engine ran."""
    transitions = [
        ev for ev in events if ev.get("kind") in _ALERT_EVENT_KINDS
    ]
    if not transitions:
        return None
    fired = resolved = 0
    open_rules: Dict[str, Dict[str, Any]] = {}
    for ev in transitions:
        rule = str(ev.get("rule", "?"))
        if ev.get("kind") == "alert_fired":
            fired += 1
            open_rules[rule] = ev
        else:
            resolved += 1
            open_rules.pop(rule, None)
    return {
        "fired": fired,
        "resolved": resolved,
        "still_firing": sorted(open_rules),
        "transitions": [
            {
                k: v for k, v in ev.items()
                if k not in ("t", "mono", "phase")
            }
            for ev in transitions[-10:]
        ],
    }


def load_incidents(run_dir: Union[str, Path]) -> List[Dict[str, Any]]:
    """Summarize every incident bundle under ``run_dir/incidents/``
    (serving/incident.py writes them; this reader lives in the
    telemetry layer so ``telemetry-report`` never imports the serving
    package).  Torn or missing bundle files degrade per-bundle — the
    report is the post-mortem tool, it has no one to crash to."""
    import json

    incidents_dir = Path(run_dir) / "incidents"
    out: List[Dict[str, Any]] = []
    if not incidents_dir.is_dir():
        return out
    for bundle in sorted(p for p in incidents_dir.iterdir() if p.is_dir()):
        record: Dict[str, Any] = {"bundle": bundle.name}
        try:
            manifest = json.loads((bundle / "manifest.json").read_text())
            record["trigger"] = manifest.get("trigger")
            record["wall"] = manifest.get("wall")
            alerts = manifest.get("alerts")
            if isinstance(alerts, dict):
                record["firing"] = [
                    str(r.get("rule", "?"))
                    for r in alerts.get("firing") or []
                ]
            record["detail"] = manifest.get("detail")
        except (OSError, ValueError) as exc:
            record["error"] = f"{type(exc).__name__}: {exc}"
        try:
            history = json.loads(
                (bundle / "metrics.json").read_text()
            ).get("history") or {}
            record["series"] = len(history)
        except (OSError, ValueError, AttributeError):
            record["series"] = 0
        try:
            traces = json.loads((bundle / "traces.json").read_text())
            record["traces"] = len(traces) if isinstance(traces, list) else 0
        except (OSError, ValueError):
            record["traces"] = 0
        out.append(record)
    return out


def report_json(
    run_dir: Union[str, Path], now: Optional[float] = None
) -> Dict[str, Any]:
    """The machine-readable report (``telemetry-report --json``) — the
    same sinks the text report renders, as one stable-schema dict so
    bench/CI consume run summaries without scraping table text.  Top
    keys are pinned by tests (the ``lint --json`` pattern): ``schema``,
    ``run_dir``, ``events``, ``heartbeat``, ``spans``, ``counters``,
    ``gauges``, ``histograms``, ``derived``, ``latency_decomposition``,
    ``cascade``, ``fleet``, ``autoscaler``, ``alerts``, ``incidents``,
    ``replicas``, ``shards``, ``programs``, ``roofline``."""
    data = load_run(run_dir)
    now = time.time() if now is None else now
    summary = data["summary"]
    heartbeat = data["heartbeat"]
    counters = dict(summary.get("counters") or {})
    if not counters:
        counters = dict((heartbeat or {}).get("counters") or {})
    histograms = dict(summary.get("histograms") or {})
    try:
        heartbeat_age: Optional[float] = now - float(
            heartbeat.get("written_wall")
        )
    except (TypeError, ValueError):
        heartbeat_age = None
    programs = _load_programs(data["run_dir"], data["events"])
    return {
        "schema": 1,
        "run_dir": str(data["run_dir"]),
        "generated_wall": now,
        "events": {
            "parsed": len(data["events"]),
            "skipped": data["events_skipped"],
        },
        "heartbeat": (
            dict(heartbeat, age_s=heartbeat_age) if heartbeat else None
        ),
        "spans": _span_table(data["events"]),
        "counters": counters,
        "gauges": dict(summary.get("gauges") or {}),
        "histograms": histograms,
        "derived": _derived_metrics(counters),
        "latency_decomposition": _latency_decomposition(histograms),
        "cascade": _cascade_block(counters, programs["programs"]),
        "fleet": _fleet_block(counters, dict(summary.get("gauges") or {})),
        "autoscaler": _autoscaler_block(
            counters, dict(summary.get("gauges") or {}), data["events"]
        ),
        "alerts": _alerts_block(data["events"]),
        "incidents": load_incidents(data["run_dir"]),
        "replicas": _replica_rows(data["run_dir"], data["events"], now),
        "shards": _shard_rows(data["run_dir"], data["events"], now),
        "programs": programs["programs"],
        "roofline": programs["roofline"],
    }


def render_report(run_dir: Union[str, Path], now: Optional[float] = None) -> str:
    """The human summary as one string (the CLI prints it verbatim)."""
    data = load_run(run_dir)
    events = data["events"]
    summary = data["summary"]
    heartbeat = data["heartbeat"]
    now = time.time() if now is None else now

    lines: List[str] = []
    lines.append(f"telemetry report: {data['run_dir']}")
    lines.append(
        f"  events: {len(events)} parsed"
        + (f", {data['events_skipped']} torn/unparseable skipped"
           if data["events_skipped"] else "")
    )
    if not (events or summary or heartbeat):
        # distinguish "this dir never had telemetry" from "a run started
        # but recorded nothing" (empty/blank sink files — e.g. a server
        # that was killed before its first event, or telemetry started
        # and immediately torn) — the operator's next step differs
        sink_files = [
            name for name in ("events.jsonl", "telemetry.json", "HEARTBEAT.json")
            if (data["run_dir"] / name).exists()
        ]
        if sink_files:
            lines.append(
                "  no events recorded (empty sink file(s): "
                + ", ".join(sink_files) + ")"
            )
        else:
            lines.append("  (no telemetry sinks found in this directory)")
        # a fleet run dir may carry per-replica sinks even when the
        # router process itself recorded nothing — still render them
        replica_lines = _replica_section(data["run_dir"], events, now)
        if replica_lines:
            lines.append("")
            lines.extend(replica_lines)
        # likewise shard-<i>/ sinks from a coordinator killed before its
        # first event flush
        shard_data = _shard_rows(data["run_dir"], events, now)
        if shard_data["members"] or shard_data["coordinator_events"]:
            lines.append("")
            lines.extend(_shard_section(data["run_dir"], events, now))
        return "\n".join(lines)
    if not events:
        # heartbeat-/summary-only dirs (a SIGKILL before the first event
        # flush, or events disabled) still render the sections below —
        # but say explicitly that the event stream is empty rather than
        # silently omitting the phase table
        lines.append("  no events recorded — phase table unavailable")

    # -- liveness -------------------------------------------------------------
    if heartbeat:
        try:
            age: Optional[float] = now - float(heartbeat.get("written_wall"))
        except (TypeError, ValueError):
            age = None
        lines.append("")
        lines.append("HEARTBEAT")
        lines.append(
            f"  phase: {heartbeat.get('phase', '?')}"
            f"  pid: {heartbeat.get('pid', '?')}"
            f"  uptime: {_fmt_s(heartbeat.get('uptime_s'))}"
        )
        lines.append(
            f"  last written: {_fmt_s(age)} ago"
            + ("  (stale?)" if age is not None and age > 300 else "")
        )
        for key in ("rows_per_sec", "eta_s"):
            if key in heartbeat and heartbeat[key] is not None:
                lines.append(f"  {key}: {_fmt_num(heartbeat[key])}")

    # -- phases ---------------------------------------------------------------
    spans = _span_table(events)
    if spans:
        lines.append("")
        lines.append("PHASES (spans)")
        lines.append(
            f"  {'name':<28} {'count':>6} {'total':>10} {'mean':>10} {'max':>10}"
        )
        for name in sorted(spans, key=lambda n: -spans[n]["total_s"]):
            row = spans[name]
            lines.append(
                f"  {name:<28} {int(row['count']):>6}"
                f" {_fmt_s(row['total_s']):>10}"
                f" {_fmt_s(row['mean_s']):>10}"
                f" {_fmt_s(row['max_s']):>10}"
            )

    # -- timing histograms ----------------------------------------------------
    hists = {
        name: h
        for name, h in (summary.get("histograms") or {}).items()
        if h and not name.startswith("span.")
    }
    if hists:
        lines.append("")
        lines.append("TIMINGS")
        for name in sorted(hists):
            h = hists[name]
            lines.append(
                f"  {name}: count={int(h.get('count', 0))}"
                f" mean={_fmt_num(h.get('mean'))}"
                f" p50={_fmt_num(h.get('p50'))}"
                f" p95={_fmt_num(h.get('p95'))}"
                f" max={_fmt_num(h.get('max'))}"
            )

    # -- serve latency decomposition (request-journey tracing) -----------------
    latency_lines = _latency_section(summary.get("histograms") or {})
    if latency_lines:
        lines.append("")
        lines.extend(latency_lines)

    # -- counters / gauges ----------------------------------------------------
    counters = dict(summary.get("counters") or {})
    if not counters:
        counters = dict(heartbeat.get("counters") or {})
    if counters:
        lines.append("")
        lines.append("COUNTERS")
        for name in sorted(counters):
            lines.append(f"  {name} = {_fmt_num(counters[name])}")
        # derived: host-side tokenization cache effectiveness — the
        # CachedEncoder counters make host tokenization cost attributable
        # (a low hit rate on a pair-training run means the memo is being
        # evicted or the stream has no repeats to exploit)
        try:
            hits = float(counters["data.encode_cache_hits"])
            misses = float(counters["data.encode_cache_misses"])
            total = hits + misses
        except (KeyError, TypeError, ValueError):
            total = 0.0
        if total > 0:
            lines.append(
                f"  data.encode_cache_hit_rate = {hits / total:.3f}"
                f" ({int(hits)}/{int(total)} lookups)"
            )
        # derived: serve-path padding efficiency — real tokens served vs
        # token slots the dispatched shapes paid for (the ragged path's
        # headline number)
        try:
            real = float(counters["serve.tokens_real"])
            padded = float(counters["serve.tokens_padded"])
        except (KeyError, TypeError, ValueError):
            padded = 0.0
        if padded > 0:
            lines.append(
                f"  serve.real_token_utilization = {real / padded:.3f}"
                f" ({int(real)}/{int(padded)} token slots)"
            )
        # derived: continuous-admission overlap — how much of the served
        # load joined a pack while the device was busy with another
        # (continuous dispatcher only)
        try:
            topups = float(counters["serve.pack_topups"])
            served = float(counters["serve.served"])
        except (KeyError, TypeError, ValueError):
            topups = served = 0.0
        if topups > 0 and served > 0:
            lines.append(
                f"  serve.admission_efficiency = {topups / served:.3f}"
                f" ({int(topups)}/{int(served)} served admitted mid-flight)"
            )
        # derived: cascade uncertainty-band pressure — served requests
        # whose int8 score needed the fp32 rescore
        rescored = _as_num(counters.get("serve.cascade_rescored"))
        shortcut = _as_num(counters.get("serve.cascade_shortcircuit"))
        if rescored + shortcut > 0:
            lines.append(
                f"  serve.cascade_rescore_rate ="
                f" {rescored / (rescored + shortcut):.3f}"
                f" ({int(rescored)}/{int(rescored + shortcut)} rescored fp32)"
            )
        # derived: admission-cache yield — probed requests answered from
        # the content-addressed cache without a device call
        # (serving/admission_cache.py)
        cache_hits = _as_num(counters.get("cache.hits"))
        cache_misses = _as_num(counters.get("cache.misses"))
        if cache_hits + cache_misses > 0:
            lines.append(
                f"  cache.hit_rate ="
                f" {cache_hits / (cache_hits + cache_misses):.3f}"
                f" ({int(cache_hits)}/{int(cache_hits + cache_misses)}"
                " probes hit)"
            )
    gauges = summary.get("gauges") or {}
    if gauges:
        lines.append("")
        lines.append("GAUGES")
        for name in sorted(gauges):
            lines.append(f"  {name} = {_fmt_num(gauges[name])}")

    # -- anchor bank (per-anchor wins / drift / shadow) ------------------------
    anchor_lines = _anchor_bank_section(data["run_dir"], counters, summary)
    if anchor_lines:
        lines.append("")
        lines.extend(anchor_lines)

    # -- compiled programs / roofline (telemetry/programs.py) ------------------
    programs = _load_programs(data["run_dir"], events)
    lines.append("")
    lines.extend(_programs_section(programs))

    # -- quantized cascade tier split -----------------------------------------
    cascade = _cascade_block(counters, programs["programs"])
    if cascade:
        lines.append("")
        lines.append("CASCADE (int8 tier + fp32 rescue band)")
        lines.append(
            f"  shortcircuit(int8): {cascade['shortcircuit']}"
            f"  rescored(fp32): {cascade['rescored']}"
            f"  rescore_rate: {cascade['rescore_rate']:.3f}"
        )
        for tier in ("int8", "fp32"):
            t = cascade["tiers"].get(tier)
            if t is None:
                continue
            lines.append(
                f"  {tier}: programs={int(t['programs'])}"
                f"  invocations={int(t['invocations'])}"
                f"  device_time={_fmt_s(t['device_time_s'])}"
                f"  share={t['device_time_share']:.1%}"
            )

    # -- admission cache (serving/admission_cache.py) --------------------------
    cache_hits = _as_num(counters.get("cache.hits"))
    cache_misses = _as_num(counters.get("cache.misses"))
    if cache_hits + cache_misses > 0:
        lines.append("")
        lines.append("CACHE (content-addressed admission cache)")
        lines.append(
            f"  hits: {int(cache_hits)}  misses: {int(cache_misses)}"
            f"  hit_rate: {cache_hits / (cache_hits + cache_misses):.3f}"
        )
        lines.append(
            f"  evictions: {int(_as_num(counters.get('cache.evictions')))}"
            f"  invalidations:"
            f" {int(_as_num(counters.get('cache.invalidations')))}"
            f"  errors: {int(_as_num(counters.get('cache.errors')))}"
            f"  tokens_saved:"
            f" {int(_as_num(counters.get('cache.tokens_saved')))}"
        )

    # -- cross-host fleet (serving/fleet.py) -----------------------------------
    fleet = _fleet_block(counters, gauges)
    if fleet:
        lines.append("")
        lines.append("FLEET (cross-host balancer)")
        lines.append(
            f"  hosts: {_fmt_num(fleet.get('hosts', '?'))}"
            f"  alive: {_fmt_num(fleet.get('hosts_alive', '?'))}"
        )
        fc = fleet["counters"]
        if fc:
            lines.append(
                f"  requests: {_fmt_num(fc.get('requests', 0))}"
                f"  served: {_fmt_num(fc.get('served', 0))}"
                f"  reroutes: {_fmt_num(fc.get('reroutes', 0))}"
                f"  host_deaths: {_fmt_num(fc.get('host_deaths', 0))}"
                f"  restarts: {_fmt_num(fc.get('host_restarts', 0))}"
                f"  quarantined: {_fmt_num(fc.get('quarantined', 0))}"
            )
        for host, age in sorted(fleet.get("heartbeat_age_s", {}).items()):
            lines.append(f"  {host}: heartbeat_age={_fmt_s(age)}")

    # -- autoscaler (serving/autoscaler.py) ------------------------------------
    scaler = _autoscaler_block(counters, gauges, events)
    if scaler:
        lines.append("")
        lines.append("AUTOSCALER (scale_hint actuation)")
        sc = scaler["counters"]
        lines.append(
            f"  replicas: {_fmt_num(scaler.get('replicas', '?'))}"
            f"  scale_events: {_fmt_num(sc.get('scale_events', 0))}"
            f"  ups: {_fmt_num(sc.get('scale_ups', 0))}"
            f"  downs: {_fmt_num(sc.get('scale_downs', 0))}"
            f"  spawn_failures: {_fmt_num(sc.get('spawn_failures', 0))}"
        )
        decisions = scaler.get("decisions")
        if decisions:
            lines.append(
                f"  decisions: {decisions['ticks']} ticks,"
                f" {decisions['acted']} acted"
            )
            for d in decisions["last_actions"]:
                lines.append(
                    f"    +{_fmt_num(d.get('t_s', '?'))}s"
                    f" {d.get('action')}"
                    f" → {_fmt_num(d.get('replicas', '?'))} replicas"
                    f" (hint={d.get('hint')}"
                    f" burn_fast={_fmt_num(d.get('burn_rate_fast'))})"
                )

    # -- alert-rule transitions (telemetry/alerts.py) --------------------------
    alerts = _alerts_block(events)
    if alerts:
        lines.append("")
        lines.append("ALERTS")
        lines.append(
            f"  fired: {alerts['fired']}  resolved: {alerts['resolved']}"
            + (
                "  STILL FIRING: " + ", ".join(alerts["still_firing"])
                if alerts["still_firing"] else ""
            )
        )
        for ev in alerts["transitions"]:
            if ev.get("kind") == "alert_fired":
                lines.append(
                    f"  fired {ev.get('rule')}:"
                    f" value={_fmt_num(ev.get('value'))}"
                    f" series={ev.get('series')}"
                )
            else:
                lines.append(
                    f"  resolved {ev.get('rule')}:"
                    f" after {_fmt_s(ev.get('duration_s'))}"
                )

    # -- incident bundles (serving/incident.py) --------------------------------
    incidents = load_incidents(data["run_dir"])
    if incidents:
        lines.append("")
        lines.append("INCIDENTS (flight-recorder bundles)")
        for rec in incidents:
            if "error" in rec:
                lines.append(f"  {rec['bundle']}: (torn: {rec['error']})")
                continue
            lines.append(
                f"  {rec['bundle']}: trigger={rec.get('trigger')}"
                f"  series={rec.get('series', 0)}"
                f"  traces={rec.get('traces', 0)}"
                + (
                    "  firing=" + ",".join(rec["firing"])
                    if rec.get("firing") else ""
                )
            )

    # -- replicas (scale-out serving runs) ------------------------------------
    replica_lines = _replica_section(data["run_dir"], events, now)
    if replica_lines:
        lines.append("")
        lines.extend(replica_lines)

    # -- shards (sharded corpus-scoring runs) ---------------------------------
    lines.append("")
    lines.extend(_shard_section(data["run_dir"], events, now))

    # -- last events ----------------------------------------------------------
    if events:
        lines.append("")
        lines.append("LAST EVENTS")
        for ev in events[-5:]:
            kind = ev.get("kind", "?")
            detail = {
                k: v for k, v in ev.items()
                if k not in ("t", "mono", "kind", "phase")
            }
            lines.append(
                f"  +{_fmt_num(ev.get('mono', '?'))}s {kind}"
                + (f" {detail}" if detail else "")
            )
    return "\n".join(lines)

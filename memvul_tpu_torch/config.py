"""Config loading with reference-compatible override merging.

A port-local copy of the JAX package's ``memvul_tpu/config.py`` (the parts
the scoring path uses): ``loads_config`` reads JSON with ``//`` comments,
trailing commas and top-level ``local name = <literal>;`` bindings (the
Jsonnet subset the reference configs use), ``merge_overrides`` deep-merges
overrides with dotted keys reaching into nested objects, and
``evaluation_config`` merges the ``evaluation`` section over its defaults.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import re
from pathlib import Path
from typing import Any, Dict, Optional, Union


def _split_strings(text: str) -> list:
    """Split into alternating ``(is_string, chunk)`` segments — the
    string-aware scanner the locals/body passes below share.  String
    chunks include their quotes and honor backslash escapes; an
    unterminated string runs to end-of-text (json.loads reports it).
    Only valid on COMMENT-STRIPPED text: a quote inside a ``//`` comment
    would otherwise open a phantom string (config_memory_large_tp.json's
    header comment quotes axis names).
    """
    segments = []
    i, n = 0, len(text)
    while i < n:
        if text[i] == '"':
            j = i + 1
            while j < n:
                if text[j] == "\\":
                    j += 2
                elif text[j] == '"':
                    j += 1
                    break
                else:
                    j += 1
            else:
                j = n
            segments.append((True, text[i:j]))
            i = j
        else:
            j = text.find('"', i)
            if j == -1:
                j = n
            segments.append((False, text[i:j]))
            i = j
    return segments


_LOCAL_RE = re.compile(r"\s*local\s+([A-Za-z_]\w*)\s*=")
# the lookbehind keeps substitution off identifier-looking tails of
# numeric literals: with a local named ``e5``, the body literal ``1e5``
# must stay a number, not become ``1<value>``
_IDENT_RE = re.compile(r"(?<![\w.])[A-Za-z_]\w*")
_TRAILING_COMMA_RE = re.compile(r",(?=\s*[}\]])")
_JSON_WORDS = frozenset({"true", "false", "null"})


def _strip_comments(text: str) -> str:
    """Drop ``//`` line comments that are outside JSON strings.

    The reference's configs carry trailing comments, e.g.
    ``"max_length": 512  // different from the data reader``
    (reference: MemVul/config_no_online.json:89), and ``//`` also appears
    inside string values (URLs), so the scan must be string-aware.  This
    one pass cannot reuse ``_split_strings``: comments and strings each
    hide the other's delimiter, so quote- and comment-state must advance
    together; every later pass runs on comment-free text and can.
    """
    out = []
    i, n = 0, len(text)
    in_string = False
    while i < n:
        c = text[i]
        if in_string:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_string = False
        elif c == '"':
            in_string = True
            out.append(c)
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
            continue
        else:
            out.append(c)
        i += 1
    return "".join(out)


def _parse_locals(text: str) -> tuple:
    """Consume leading ``local name = <value>;`` bindings.

    Returns ``(bindings, body)``.  Values are JSON literals (the only
    forms the reference's configs use: strings and numbers,
    config_memory.json:1-3) or references to earlier locals.  The
    terminating ``;`` is found outside strings so string values
    containing semicolons parse correctly.
    """
    bindings: Dict[str, Any] = {}
    pos = 0
    while True:
        m = _LOCAL_RE.match(text, pos)
        if not m:
            break
        end = m.end()
        for is_str, chunk in _split_strings(text[end:]):
            if not is_str and ";" in chunk:
                end += chunk.index(";")
                break
            end += len(chunk)
        else:
            raise ValueError(f"unterminated 'local {m.group(1)} = ...' binding")
        raw = text[m.end() : end].strip()
        if _IDENT_RE.fullmatch(raw) and raw in bindings:
            bindings[m.group(1)] = bindings[raw]
        else:
            bindings[m.group(1)] = json.loads(raw)
        pos = end + 1
    return bindings, text[pos:]


def _jsonnetise_body(body: str, bindings: Dict[str, Any]) -> str:
    """Make the Jsonnet body valid JSON: substitute bare identifiers with
    their bound JSON value and drop trailing commas (both Jsonnet-legal,
    both used by the reference configs — config_memory.json:6,69).

    Body keys are always quoted in the reference configs, so any bare
    identifier outside a string is a reference.  Unbound identifiers are
    left for json.loads to reject with its own error position.  A comma
    is trailing only when whitespace separates it from the closing
    bracket, so the per-chunk regex never crosses a string boundary.
    """

    def substitute(m: "re.Match") -> str:
        word = m.group(0)
        if word in bindings and word not in _JSON_WORDS:
            return json.dumps(bindings[word])
        return word

    return "".join(
        chunk
        if is_str
        else _TRAILING_COMMA_RE.sub("", _IDENT_RE.sub(substitute, chunk))
        for is_str, chunk in _split_strings(body)
    )


def loads_config(text: str) -> Dict[str, Any]:
    stripped = _strip_comments(text)
    bindings, body = _parse_locals(stripped)
    return json.loads(_jsonnetise_body(body, bindings))


def load_config(
    path: Union[str, Path],
    overrides: Optional[Union[str, Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    cfg = loads_config(Path(path).read_text())
    if overrides:
        if isinstance(overrides, str):
            overrides = loads_config(overrides)
        cfg = merge_overrides(cfg, overrides)
    return cfg


def merge_overrides(base: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``overrides`` onto ``base`` (returns a new dict).

    A *top-level* dotted key like ``"trainer.optimizer.lr"`` addresses a
    nested value, matching AllenNLP's override syntax used by the reference
    eval scripts.  Keys inside nested override dicts are taken literally
    and deep-merged (the reference's with_fallback semantics).
    """
    out = copy.deepcopy(base)
    for key, value in overrides.items():
        _assign(out, key.split("."), value)
    return out


def _assign(node: Dict[str, Any], parts: list, value: Any) -> None:
    key = parts[0]
    if len(parts) > 1:
        child = node.setdefault(key, {})
        if not isinstance(child, dict):
            child = node[key] = {}
        _assign(child, parts[1:], value)
    elif isinstance(value, dict) and isinstance(node.get(key), dict):
        _deep_merge(node[key], value)
    else:
        # deepcopy, never alias: the merged config must not share
        # structure with the caller's overrides dict — a later dotted-key
        # assignment (or any downstream edit of the merged config) would
        # otherwise mutate the overrides object the caller still holds
        node[key] = copy.deepcopy(value)


def _deep_merge(node: Dict[str, Any], overrides: Dict[str, Any]) -> None:
    for key, value in overrides.items():
        if isinstance(value, dict) and isinstance(node.get(key), dict):
            _deep_merge(node[key], value)
        else:
            node[key] = copy.deepcopy(value)  # same no-aliasing contract


# The ``evaluation`` config section, with its documented defaults.  The
# eval entry points (build.evaluate_from_archive) read this one merged
# view instead of scattering per-key ``.get`` defaults, so a new knob is
# added exactly once.  ``None`` means "feature off / model default".
EVALUATION_DEFAULTS: Dict[str, Any] = {
    "batch_size": 512,       # rows per batch without a token budget
    "max_length": 512,       # token cap (clamped to the model's positions)
    "buckets": None,         # length-bin boundaries; "auto" derives them
    "n_buckets": 8,          # boundary count for "auto" buckets
    "tokens_per_batch": None,  # constant token budget per batch
    "inflight": 2,           # async device dispatch depth (0 = sync)
    "anchor_match_impl": None,  # None → model config ("auto"|"fused"|"xla")
    "aot_warmup": True,      # precompile every stream shape at startup
    # fault tolerance (docs/fault_tolerance.md) — all off by default so
    # short interactive evals keep their exact historical behavior;
    # docs/full_corpus.md turns the whole block on for the 1.2M job
    "resume": False,         # journal + skip-completed restartable scoring
    "quarantine": False,     # dead-letter malformed/over-long records
    "heartbeat_batches": 0,  # progress log every N batches (0 = off)
    "score_retries": 0,      # transient-failure retries per batch (0 = off)
    # add the winning anchor id/index to every output record
    # (docs/anchor_bank.md) — off so the default output format stays
    # byte-stable with the reference's
    "attribute_anchors": False,
    # sharded corpus scoring: the score-corpus CLI reads these
    # (distributed/coordinator.py); evaluate scores in one process
    "shards": 1,               # supervised worker subprocesses
    "max_shard_attempts": 3,   # launches per shard before quarantine
    "shard_stall_timeout_s": 120.0,  # heartbeat age that counts as wedged
    "shard_poll_interval_s": 1.0,    # supervisor poll cadence
    "shard_backoff_s": 2.0,    # restart backoff base (exponential)
}

def _section_over_defaults(
    cfg: Optional[Dict[str, Any]], key: str, defaults: Dict[str, Any]
) -> Dict[str, Any]:
    """``cfg[key]`` merged over its documented defaults.

    Explicit JSON ``null`` values fall back to the default (matching the
    historical null-tolerant handling of ``tokens_per_batch``/
    ``inflight``; 0 and "" are real values and survive).  Unknown keys
    are kept — they may belong to a newer reader — but logged so a typo
    like ``"ancor_match_impl"`` doesn't silently disable a feature.
    """
    section = dict((cfg or {}).get(key) or {})
    unknown = sorted(set(section) - set(defaults))
    if unknown:
        logging.getLogger(__name__).warning(
            "%s config: unknown key(s) %s (known: %s)",
            key, unknown, sorted(defaults),
        )
    out = dict(defaults)
    out.update({k: v for k, v in section.items() if v is not None})
    return out


def evaluation_config(cfg: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``cfg["evaluation"]`` merged over :data:`EVALUATION_DEFAULTS` (every
    key of the JAX package's evaluation section is honoured)."""
    return _section_over_defaults(cfg, "evaluation", EVALUATION_DEFAULTS)


# The ``telemetry`` section's keys, with the JAX package's defaults: the
# run sinks of the sharded corpus scorer and the serving fleet, the live
# exposition server of a run (``telemetry/live.py``), the serving
# device-memory gauges, the trainers' epoch-0 profiler trace and the
# metrics history (``telemetry/timeseries.py``; 0 = off, nothing built).
TELEMETRY_DEFAULTS: Dict[str, Any] = {
    "enabled": True,         # the run sinks: events.jsonl, heartbeat, summary
    "events": True,          # the append-only events.jsonl stream
    "heartbeat_every_s": 30.0,  # HEARTBEAT.json's most frequent rewrite
    "trace_dir": None,       # the trainers' epoch-0 profiler trace
    "hbm_gauges": True,      # serve.hbm_in_use_bytes / serve.hbm_peak_bytes
    "metrics_port": 0,       # train/pretrain/score-corpus: /metrics (0 = off)
    "tsdb_cadence_s": 0.0,   # metrics-history sampling cadence (0 = off)
    "tsdb_resolution_s": 1.0,   # ring bucket width (points coalesce)
    "tsdb_retention_s": 600.0,  # per-series history span
}

# The ``telemetry`` keys of slice 11 (ROADMAP.md), with their defaults: set
# away from the default, each raises naming that slice.
TELEMETRY_UNPORTED: Dict[str, Any] = {
    "step_events": (True, "switching the per-step trainer events"),
}


def telemetry_config(cfg: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``cfg["telemetry"]`` merged over :data:`TELEMETRY_DEFAULTS`; a key of
    :data:`TELEMETRY_UNPORTED` set away from its default raises
    NotImplementedError naming slice 11, and an out-of-range port or
    history setting raises ValueError."""
    section = dict((cfg or {}).get("telemetry") or {})
    for key, (default, what) in TELEMETRY_UNPORTED.items():
        value = section.pop(key, None)
        if value is not None and value != default:
            raise NotImplementedError(
                f"telemetry.{key}={value!r}: {what} belongs to slice 11, which is "
                "not ported yet (ROADMAP.md)"
            )
    out = _section_over_defaults({"telemetry": section}, "telemetry", TELEMETRY_DEFAULTS)
    if not isinstance(out["hbm_gauges"], bool):
        raise ValueError(f"telemetry.hbm_gauges must be a bool, got {out['hbm_gauges']!r}")
    port = int(out["metrics_port"] or 0)
    if not 0 <= port < 65536:
        raise ValueError(f"telemetry.metrics_port must be in [0, 65536), got {port!r}")
    if float(out["tsdb_cadence_s"] or 0.0) < 0:
        raise ValueError(f"telemetry.tsdb_cadence_s must be >= 0, got {out['tsdb_cadence_s']!r}")
    if float(out["tsdb_cadence_s"] or 0.0) > 0 and not (
            0 < float(out["tsdb_resolution_s"]) <= float(out["tsdb_retention_s"])):
        raise ValueError("telemetry.tsdb_resolution_s must be > 0 and <= tsdb_retention_s")
    return out


# The ``serving`` section's keys, every one of the JAX package's, with its
# defaults.  ``build.serve_from_archive`` sizes the predictor, the
# service's admission-control envelope, the replica fleet, tracing, the SLO
# monitor, the tenants, the admission cache, the autoscaler and the flight
# recorder from them; ``serve --hosts`` the cross-host balancer.
SERVING_DEFAULTS: Dict[str, Any] = {
    "max_batch": 16,         # requests coalesced per micro-batch flush
    "max_wait_ms": 5.0,      # oldest-request coalescing window
    "max_queue": 256,        # bounded queue depth; overflow sheds the oldest
    "default_deadline_ms": 2000.0,  # per-request budget (<= 0 disables)
    "retries": 2,            # transient batch retry attempts (0 = off)
    "max_length": 512,       # token cap (clamped to the model's positions)
    "buckets": None,         # explicit length buckets (bucketed impl)
    "score_impl": "bucketed",    # "bucketed" | "ragged" | "continuous" | "cascade"
    # the cascade's [low, high] band of best-anchor probability (inclusive):
    # rows inside are rescored by the full-precision tier
    "cascade_low": 0.3,
    "cascade_high": 0.7,
    "token_budget": None,        # pack size (None → 4 × max_length)
    "max_rows_per_pack": None,   # rows per pack (None → max_batch)
    "prefix_share": False,   # continuous packs share exact-duplicate segments
    "host": "127.0.0.1",     # HTTP front-end bind address
    "port": 8341,            # HTTP front-end port
    # the replica fleet: > 1 puts that many services, on cuda:{i % cards},
    # behind a ReplicaRouter with this health and eviction policy
    "replicas": 1,
    "heartbeat_timeout_s": 10.0,  # missed-heartbeat eviction threshold
    "max_batch_errors": 3,   # consecutive dead-lettered batches before eviction
    "monitor_interval_s": 0.25,  # router health-check cadence
    "max_reroutes": 2,       # re-enqueue attempts after replica failures
    # request tracing: 0.0 = off; > 0 stamps every request's waypoints
    "trace_sample_rate": 0.0,
    "trace_ring": 256,       # completed traces kept for GET /tracez
    # the SLO monitor: windowed availability and p95 attainment, burn
    # rates and the scale hint (slo.* gauges, /healthz's slo block)
    "slo_enabled": True,
    "slo_availability_objective": 0.999,
    "slo_latency_p95_ms": 1000.0,
    "slo_fast_window_s": 60.0,   # spike-catcher burn window
    "slo_window_s": 300.0,       # confirmation (slow) burn window
    "slo_interval_s": 5.0,       # sampling cadence
    # named tenants, "name=store_dir,...": one bank per tenant from its store
    "tenants": None,
    "cache_capacity": 0,     # admission-cache entries (0: no cache)
    # the cross-host balancer (serving/fleet.py; serve --hosts)
    "hosts": None,           # "host[:port],..." of running serve processes
    "fleet_heartbeat_timeout_s": 10.0,  # a host's stall eviction threshold
    "fleet_monitor_interval_s": 0.25,   # host health-check cadence
    "fleet_max_reroutes": 2,  # re-enqueue attempts after host failures
    "fleet_max_restarts": 2,  # per host, then quarantine
    # the autoscaler (serving/autoscaler.py), fed by the SLO scale hint
    "autoscale_enabled": False,
    "autoscale_min_replicas": 1,
    "autoscale_max_replicas": 4,
    "autoscale_interval_s": 1.0,
    "autoscale_up_cooldown_s": 5.0,
    "autoscale_down_cooldown_s": 30.0,
    "autoscale_up_consecutive": 2,
    "autoscale_down_consecutive": 4,
    "autoscale_drain_timeout_s": 10.0,
    # the alert engine and the incident recorder (with tsdb_cadence_s > 0)
    "alert_interval_s": 5.0,
    "incident_min_interval_s": 30.0,
    "incident_max_bundles": 8,
    "incident_window_s": 120.0,
}

def serving_config(cfg: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``cfg["serving"]`` merged over :data:`SERVING_DEFAULTS`."""
    return _section_over_defaults(cfg, "serving", SERVING_DEFAULTS)


# The ``bankops`` section (the anchor-bank lifecycle), with the JAX
# package's defaults.  ``build.serve_from_archive`` honours ``anchor_stats``,
# ``baseline`` and ``drift_interval_s``; ``bank shadow`` and ``bank promote``
# take ``shadow_threshold`` and the gate's four limits where their flags are
# not given; ``ShadowConfig.from_bankops`` reads the two ``shadow_*`` knobs
# of a live shadow scorer.
BANKOPS_DEFAULTS: Dict[str, Any] = {
    "anchor_stats": True,      # per-anchor win/score counts in serving
    "baseline": None,          # a pinned anchor_baseline.json (drift)
    "drift_interval_s": 30.0,  # DriftMonitor gauge refresh cadence
    "shadow_sample_stride": 1,   # a live shadow scores every Nth served request
    "shadow_max_queue": 512,     # its bounded sample queue; overflow drops
    "shadow_threshold": 0.5,   # the shadow's decision threshold (flips)
    "max_auc_drop": 0.01,      # the gate's golden-set AUC tolerance
    "max_f1_drop": 0.01,       # the gate's golden-set F1 tolerance
    "max_flip_rate": 0.02,     # the gate's shadow flip-rate ceiling
    "min_shadow_samples": 100,  # the gate's shadow evidence volume
}

# The JAX package's ``bankops`` key that no entry point of either package
# reads (the store is ``--store``), with its default: set away from the
# default, it raises rather than being ignored.
BANKOPS_UNREAD: Dict[str, Any] = {
    "store_dir": None,
}


def bankops_config(cfg: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``cfg["bankops"]`` merged over :data:`BANKOPS_DEFAULTS`; a key of
    :data:`BANKOPS_UNREAD` set away from its default raises ValueError."""
    section = dict((cfg or {}).get("bankops") or {})
    changed = sorted(k for k, default in BANKOPS_UNREAD.items()
                     if section.get(k) is not None and section[k] != default)
    if changed:
        raise ValueError(
            f"bankops keys {changed} are read by no entry point: the store is the bank "
            "CLI's --store"
        )
    return _section_over_defaults(
        {"bankops": {k: v for k, v in section.items() if k not in BANKOPS_UNREAD}},
        "bankops", BANKOPS_DEFAULTS)


# The evaluation keys the single-model path (MemVul-m, TextCNN) has no use
# for, with their defaults: the JAX package passes them only to the memory
# model's scorer and ignores them here; the port raises when one is set
# away from its default, so a setting is never silently ignored.
SINGLE_EVALUATION_UNUSED = ("resume", "quarantine", "attribute_anchors", "score_retries",
                            "heartbeat_batches", "anchor_match_impl")


def refuse_single_evaluation_keys(eval_cfg: Dict[str, Any], golden_file=None,
                                  thres: float = 0.5) -> None:
    """Raise ValueError naming every key of :data:`SINGLE_EVALUATION_UNUSED`
    that ``eval_cfg`` (merged over :data:`EVALUATION_DEFAULTS`) sets away
    from its default, and for an anchor file or a threshold other than
    0.5: a single model predicts the argmax class against no bank."""
    changed = sorted(k for k in SINGLE_EVALUATION_UNUSED if eval_cfg[k] != EVALUATION_DEFAULTS[k])
    if changed:
        raise ValueError(
            f"evaluation keys {changed} apply to the memory model only; a single model "
            "(model_single, model_cnn) scores without them: leave them at their defaults"
        )
    if golden_file is not None:
        raise ValueError("a single model scores without an anchor bank: pass no golden file")
    if thres != 0.5:
        raise ValueError(f"a single model predicts the argmax class: threshold {thres} has no use")


def _refuse_unknown(section: Dict[str, Any], cls, name: str) -> None:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(section) - known)
    if unknown:
        raise ValueError(f"{name} section: unknown key(s) {unknown} (known: {sorted(known)})")


def validate_classifier_config(trainer: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Check a single-model config's ``trainer`` section early (returns a
    copy): every key a field of ``ClassifierTrainerConfig``,
    ``prefetch_depth`` >= 1, ``train_buckets`` "pow2", null or a list
    covering ``max_length``."""
    from .data.batching import resolve_train_buckets
    from .training.single_trainer import ClassifierTrainerConfig

    trainer = dict(trainer or {})
    _refuse_unknown(trainer, ClassifierTrainerConfig, "trainer")
    depth = trainer.get("prefetch_depth", 8)
    if int(depth) < 1:
        raise ValueError(f"trainer.prefetch_depth must be >= 1, got {depth!r}")
    resolve_train_buckets(trainer.get("train_buckets", "pow2"), int(trainer.get("max_length", 256)))
    return trainer


def validate_pretrain_config(trainer: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Check a pretrain config's ``trainer`` section early (returns a
    copy): every key a field of ``MLMTrainerConfig``, ``batch_size``,
    ``grad_accum``, ``max_length`` and ``prefetch_depth`` >= 1,
    ``mask_prob`` in (0, 1]."""
    from .pretrain.mlm import MLMTrainerConfig

    trainer = dict(trainer or {})
    _refuse_unknown(trainer, MLMTrainerConfig, "trainer")
    for key, default in (("batch_size", 16), ("grad_accum", 2), ("max_length", 256),
                         ("prefetch_depth", 4)):
        if int(trainer.get(key, default)) < 1:
            raise ValueError(f"trainer.{key} must be >= 1, got {trainer[key]!r}")
    mask_prob = float(trainer.get("mask_prob", 0.15))
    if not 0.0 < mask_prob <= 1.0:
        raise ValueError(f"trainer.mask_prob must be in (0, 1], got {mask_prob!r}")
    return trainer


def validate_training_config(trainer: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Check the config's ``trainer`` section early (returns a copy):
    ``prefetch_depth`` >= 1, ``train_buckets`` "pow2", null or a list
    covering ``max_length``, ``dedup_anchors`` a bool.  The defaults live
    in ``training.trainer.TrainerConfig``."""
    trainer = dict(trainer or {})
    depth = trainer.get("prefetch_depth", 8)
    if int(depth) < 1:
        raise ValueError(f"trainer.prefetch_depth must be >= 1, got {depth!r}")
    from .data.batching import resolve_train_buckets

    resolve_train_buckets(trainer.get("train_buckets", "pow2"), int(trainer.get("max_length", 256)))
    dedup = trainer.get("dedup_anchors", True)
    if not isinstance(dedup, bool):
        raise ValueError(f"trainer.dedup_anchors must be a bool, got {dedup!r}")
    return trainer


# The JAX package's keys that a training run would act on, for features
# this port does not have yet, with their defaults: set away from the
# default, each raises NotImplementedError naming the slice it belongs to.
TRAINING_UNPORTED: Dict[str, Any] = {
    "tuning.profile_dir": (None, "tuned trainer profiles (slice 11)"),
}


def check_training_unported(cfg: Dict[str, Any]) -> None:
    """Raise for a key of :data:`TRAINING_UNPORTED` set away from its
    default; log that the run-dir sinks (``events.jsonl``, heartbeat,
    ``telemetry.json``) are not written."""
    for dotted, (default, what) in TRAINING_UNPORTED.items():
        section, key = dotted.split(".")
        value = (cfg.get(section) or {}).get(key)
        if value is not None and value != default:
            raise NotImplementedError(f"{dotted}={value!r}: {what} is not ported yet (ROADMAP.md)")
    if (cfg.get("telemetry") or {}).get("enabled", True):
        logging.getLogger(__name__).info(
            "telemetry: the events.jsonl/heartbeat sinks are not ported; the run dir gets "
            "config.json, checkpoints, metrics and the archive"
        )

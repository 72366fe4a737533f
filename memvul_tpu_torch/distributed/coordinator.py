"""Shard coordinator: supervise N scoring workers, merge exactly once (the
JAX package's ``distributed/coordinator.py``).

1. **Partition** — :func:`~.partition.partition_rows` splits the corpus
   into contiguous row spans, one supervised worker subprocess per span.
2. **Supervise** — a poll loop watches exit codes and heartbeat age: a
   dead worker (nonzero exit, or exit 0 without its completion marker)
   restarts with exponential backoff; a stalled one (heartbeat older than
   ``shard_stall_timeout_s``) is killed as a process group first.  Resume
   picks up from the shard's journal.  After ``max_shard_attempts`` the
   shard is quarantined and the run ends in a
   :class:`PartialCompletionError` naming the missing spans.
3. **Merge and verify** — the shards' outputs concatenate in partition
   order under a verification pass over their journals (every corpus row
   exactly once, every line's sha256), then ``cal_metrics``.

The auto buckets are computed once here and handed to every shard: byte
identity means nothing unless every shard scores under one geometry.  On
the card the coordinator builds the kernel library once before it spawns
the workers, so N of them do not each run nvcc on a cold build directory;
a build failure raises here.

Per-shard progress goes to the coordinator's ``telemetry.json`` and
``events.jsonl`` (``shard.rows_committed.<shard>``,
``shard.heartbeat_age_s.<shard>``, ``shard.retries.<shard>``,
``shard.restarts``, ``shard.quarantined``, ``merge.rows_verified``);
``telemetry.metrics_port`` serves them live (``telemetry/live.py``), with
``telemetry.tsdb_cadence_s`` also as a history.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from .partition import partition_rows

logger = logging.getLogger(__name__)

WORKER_MODULE = "memvul_tpu_torch.distributed.worker"


class PartialCompletionError(RuntimeError):
    """One or more shards were quarantined: the corpus was not fully
    scored and no merged metrics were computed.  ``payload`` is the
    machine-readable refusal (``status: "partial"``, the quarantined shards
    with their failures, the missing row spans); the CLI prints it as JSON
    and exits 3."""

    def __init__(self, payload: Dict[str, Any]) -> None:
        self.payload = payload
        super().__init__(json.dumps(payload, default=str))


class MergeVerificationError(RuntimeError):
    """The exactly-once verification failed: a journal tail did not verify,
    a row is missing, or a row was scored twice.  ``payload`` names every
    problem per shard."""

    def __init__(self, payload: Dict[str, Any]) -> None:
        self.payload = payload
        super().__init__(json.dumps(payload, default=str))


@dataclasses.dataclass
class _ShardState:
    name: str
    start: int
    end: int
    dir: Path
    spec_path: Path
    out_path: Path
    proc: Optional[subprocess.Popen] = None
    attempts: int = 0
    status: str = "pending"  # pending|running|waiting|done|quarantined
    restart_at: float = 0.0
    launched_wall: float = 0.0
    failures: List[str] = dataclasses.field(default_factory=list)


def heartbeat_age_s(heartbeat: Dict[str, Any], launched_wall: float, now: float) -> float:
    """The stall clock of one worker attempt: seconds since the later of
    the last ``HEARTBEAT.json`` write and this attempt's launch (the file
    survives restarts; a fresh attempt must not inherit a dead one's age)."""
    try:
        written = float(heartbeat.get("written_wall"))
    except (TypeError, ValueError):
        written = 0.0
    base = max(written, launched_wall)
    if base <= 0:
        return 0.0
    return max(0.0, now - base)


def _kill_process_group(proc: subprocess.Popen, grace: float = 5.0) -> None:
    """SIGTERM the worker's whole session, then SIGKILL it."""
    if grace > 0:
        try:
            os.killpg(proc.pid, signal.SIGTERM)
            proc.wait(timeout=grace)
            return
        except (ProcessLookupError, PermissionError, OSError, subprocess.TimeoutExpired):
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        pass
    try:
        proc.wait(timeout=10)
    except Exception:
        pass


def _merge_and_verify(
    states: List[_ShardState],
    corpus_rows: int,
    out_results: Path,
    out_metrics: Path,
    thres: float,
    tel,
) -> Tuple[Dict[str, float], float]:
    """Concatenate the shards' outputs in partition order under the
    exactly-once contract; returns ``(metrics, merge wall s)``."""
    from ..evaluate.measure import cal_metrics
    from ..resilience import faults
    from ..resilience.journal import ScoreJournal, to_spans

    faults.fault_point("merge.verify")
    t0 = time.perf_counter()
    covered: set = set()
    merged_lines: List[str] = []
    problems: List[Dict[str, Any]] = []
    for sh in states:
        journal = ScoreJournal(str(sh.out_path) + ".journal")
        entries = journal.read_entries()
        kept_n, completed, kept_lines = journal.verified_prefix(sh.out_path)
        if kept_n != len(entries):
            problems.append({
                "shard": sh.name,
                "reason": "journal tail failed line-checksum verification",
                "unverified_entries": len(entries) - kept_n,
            })
        expected = set(range(sh.end - sh.start))
        missing = expected - completed
        if missing:
            problems.append({
                "shard": sh.name,
                "reason": "rows missing from the verified journal",
                "missing_spans": [[s + sh.start, e + sh.start] for s, e in to_spans(missing)],
            })
        extra = completed - expected
        if extra:
            problems.append({
                "shard": sh.name,
                "reason": "journal claims rows outside the shard span",
                "extra_spans": to_spans(extra),
            })
        global_rows = {r + sh.start for r in completed if r in expected}
        dup = covered & global_rows
        if dup:
            problems.append({
                "shard": sh.name,
                "reason": "rows already covered by an earlier shard",
                "duplicate_spans": to_spans(dup),
            })
        covered |= global_rows
        merged_lines.extend(kept_lines)
    if not problems and covered != set(range(corpus_rows)):
        problems.append({
            "shard": None,
            "reason": "merged coverage does not equal the corpus",
            "missing_spans": to_spans(set(range(corpus_rows)) - covered),
        })
    if problems:
        raise MergeVerificationError({
            "status": "verification_failed",
            "rows_total": corpus_rows,
            "rows_verified": len(covered),
            "problems": problems,
        })
    with open(out_results, "w", encoding="utf-8") as f:
        for line in merged_lines:
            f.write(line + "\n")
    metrics = cal_metrics(out_results, thres=thres, out_file=out_metrics)
    wall = time.perf_counter() - t0
    tel.counter("merge.rows_verified").inc(len(covered))
    tel.gauge("merge.wall_s").set(round(wall, 3))
    tel.event("merge_verified", rows=len(covered), shards=len(states), wall_s=round(wall, 3))
    return metrics, wall


def _resolved_evaluation(eval_cfg: Dict[str, Any], config: Dict[str, Any], tokenizer, reader,
                         test_path) -> Dict[str, Any]:
    """The evaluation section every worker scores under: the position
    clamp applied and ``buckets: "auto"`` resolved once, here."""
    from ..build import _auto_buckets_for_corpus, encoder_config

    max_length = int(eval_cfg["max_length"])
    encoder = (config.get("model") or {}).get("encoder")
    positions = encoder_config(encoder, tokenizer.vocab_size).max_position_embeddings
    if max_length > positions:
        logger.warning("evaluation max_length %d exceeds the archived model's "
                       "max_position_embeddings %d — clamping", max_length, positions)
        max_length = positions
    buckets = eval_cfg["buckets"]
    if buckets == "auto":
        buckets = _auto_buckets_for_corpus(reader, tokenizer, str(test_path), max_length,
                                           n_buckets=int(eval_cfg["n_buckets"]))
        logger.info("auto buckets for %s: %s", test_path, buckets)
    if buckets is not None:
        buckets = [int(b) for b in buckets]
    tokens_per_batch = eval_cfg["tokens_per_batch"]
    return {
        "batch_size": int(eval_cfg["batch_size"]),
        "max_length": max_length,
        "buckets": buckets,
        "tokens_per_batch": int(tokens_per_batch) if tokens_per_batch is not None else None,
        "inflight": int(eval_cfg["inflight"]),
        "anchor_match_impl": eval_cfg["anchor_match_impl"],
        "aot_warmup": bool(eval_cfg["aot_warmup"]),
        "quarantine": eval_cfg["quarantine"],
        "heartbeat_batches": int(eval_cfg["heartbeat_batches"]),
        "score_retries": int(eval_cfg["score_retries"]),
        "attribute_anchors": bool(eval_cfg["attribute_anchors"]),
    }


def score_corpus(
    archive_path: Union[str, Path],
    test_path: Union[str, Path],
    out_dir: Union[str, Path],
    shards: Optional[int] = None,
    overrides: Optional[Union[str, Dict[str, Any]]] = None,
    golden_file: Optional[Union[str, Path]] = None,
    name: Optional[str] = None,
    thres: float = 0.5,
    split: Optional[str] = None,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Score ``test_path`` across ``shards`` supervised worker subprocesses
    on ``device`` and return the merged, verified result.

    Writes ``{name}_result.json`` and ``{name}_metric_all.json`` in
    ``out_dir`` (``evaluate_from_archive``'s files) and one ``shard-<i>/``
    per shard with that worker's spec, output, journal, heartbeat,
    telemetry and ``worker.log``.  Raises :class:`PartialCompletionError`
    when a shard exhausts ``max_shard_attempts`` and
    :class:`MergeVerificationError` when the exactly-once pass fails."""
    from ..archive import load_archive_config
    from ..build import build_reader, resolve_device
    from ..config import evaluation_config, telemetry_config
    from ..resilience.retry import RetryPolicy
    from ..telemetry import Registry
    from ..telemetry.sinks import HeartbeatFile

    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    config, tokenizer = load_archive_config(archive_path, overrides=overrides)
    tel_cfg = telemetry_config(config)
    tel = Registry(
        run_dir=out_dir if tel_cfg["enabled"] else None,
        heartbeat_every_s=float(tel_cfg["heartbeat_every_s"]),
        events=bool(tel_cfg["events"]),
    )
    from ..telemetry.live import start_run_exposition

    exposition = start_run_exposition(tel_cfg, parts=lambda: [({}, tel.snapshot())])
    try:
        model_type = (config.get("model") or {}).get("type", "model_memory")
        if model_type != "model_memory":
            raise ValueError(
                f"score-corpus supports memory-model archives only, got model type {model_type!r}"
            )
        name = name or model_type
        golden = golden_file or (config.get("dataset_reader") or {}).get("anchor_path")
        if golden is None:
            raise ValueError("memory-model corpus scoring needs a golden anchor file")
        eval_cfg = evaluation_config(config)
        n_shards = int(shards if shards is not None else eval_cfg["shards"])
        if n_shards < 1:
            raise ValueError(f"shards must be >= 1, got {n_shards}")
        max_shard_attempts = max(1, int(eval_cfg["max_shard_attempts"]))
        stall_timeout = float(eval_cfg["shard_stall_timeout_s"])
        poll_interval = float(eval_cfg["shard_poll_interval_s"])
        policy = RetryPolicy(attempts=max_shard_attempts, backoff=float(eval_cfg["shard_backoff_s"]),
                             exponential=True)
        reader = build_reader(config.get("dataset_reader"))
        resolved_eval = _resolved_evaluation(eval_cfg, config, tokenizer, reader, test_path)

        # one counting pass pins the partition input; the same reader
        # configuration streams in every worker, so the numbering agrees
        corpus_rows = sum(1 for _ in reader.read(str(test_path), split=split))
        spans = partition_rows(corpus_rows, n_shards)
        logger.info("scoring %d corpus rows across %d shards on %s: %s",
                    corpus_rows, n_shards, dev, spans)
        if dev.type == "cuda":
            # build the kernel library once, before N workers would each
            # run nvcc on a cold build dir; a failure raises here
            from ..ops import _kernels

            t0 = time.perf_counter()
            _kernels.build()
            tel.event("kernels_built", wall_s=round(time.perf_counter() - t0, 3))
        worker_heartbeat_s = float(tel_cfg["heartbeat_every_s"])
        if stall_timeout > 0:
            worker_heartbeat_s = min(worker_heartbeat_s, max(1.0, stall_timeout / 4.0))

        states: List[_ShardState] = []
        for i, (s, e) in enumerate(spans):
            shard_name = f"shard-{i}"
            shard_dir = out_dir / shard_name
            shard_dir.mkdir(parents=True, exist_ok=True)
            sh = _ShardState(name=shard_name, start=s, end=e, dir=shard_dir,
                             spec_path=shard_dir / "spec.json",
                             out_path=shard_dir / f"{name}_result.json")
            sh.spec_path.write_text(json.dumps({
                "name": shard_name,
                "shard_dir": str(shard_dir),
                "archive": str(archive_path),
                "overrides": overrides,
                "test_path": str(test_path),
                "split": split,
                "golden_file": str(golden),
                "out_path": str(sh.out_path),
                "start": s,
                "end": e,
                "device": dev.type,
                "evaluation": resolved_eval,
                "heartbeat_every_s": worker_heartbeat_s,
            }, indent=2))
            states.append(sh)

        def _launch(sh: _ShardState) -> None:
            env = dict(os.environ)
            if sh.attempts > 0:
                # injected faults are first-attempt-only: a restarted worker
                # re-reading MEMVUL_FAULTS would die the same way forever
                env.pop("MEMVUL_FAULTS", None)
            sh.attempts += 1
            with open(sh.dir / "worker.log", "ab") as log:
                sh.proc = subprocess.Popen(
                    [sys.executable, "-m", WORKER_MODULE, str(sh.spec_path)],
                    stdout=log, stderr=subprocess.STDOUT, env=env, start_new_session=True,
                )
            sh.launched_wall = time.time()
            sh.status = "running"
            if sh.attempts == 1:
                tel.event("shard_start", shard=sh.name)
            else:
                tel.counter("shard.restarts").inc()
                tel.event("shard_restart", shard=sh.name, attempt=sh.attempts)
            logger.info("launched %s pid=%d attempt=%d span=[%d,%d)",
                        sh.name, sh.proc.pid, sh.attempts, sh.start, sh.end)

        def _fail(sh: _ShardState, reason: str) -> None:
            sh.failures.append(reason)
            if sh.attempts >= max_shard_attempts:
                sh.status = "quarantined"
                tel.counter("shard.quarantined").inc()
                tel.event("shard_quarantined", shard=sh.name, attempts=sh.attempts, reason=reason)
                logger.error("%s quarantined after %d attempts: %s", sh.name, sh.attempts, reason)
            else:
                delay = policy.delay(sh.attempts)
                sh.status = "waiting"
                sh.restart_at = time.time() + delay
                logger.warning("%s failed (%s); restart %d/%d in %.1fs", sh.name, reason,
                               sh.attempts, max_shard_attempts - 1, delay)

        def _publish(now: float) -> None:
            for sh in states:
                hb = HeartbeatFile(sh.dir / "HEARTBEAT.json").read()
                counters = hb.get("counters") or {}
                rows = hb.get("rows_scored")
                if rows is None:
                    rows = counters.get("journal.rows_committed", 0)
                tel.gauge(f"shard.rows_committed.{sh.name}").set(float(rows or 0))
                tel.gauge(f"shard.retries.{sh.name}").set(
                    float(counters.get("resilience.retries", 0) or 0))
                tel.gauge(f"shard.heartbeat_age_s.{sh.name}").set(
                    round(heartbeat_age_s(hb, sh.launched_wall, now), 3))
            tel.gauge("shard.alive").set(float(sum(sh.status == "running" for sh in states)))

        try:
            for sh in states:
                if sh.end > sh.start:
                    _launch(sh)
                else:
                    # a shard past the corpus tail owns no rows: done as is
                    sh.status = "done"
                    tel.event("shard_done", shard=sh.name, rows=0)
            while True:
                now = time.time()
                active = False
                for sh in states:
                    if sh.status == "running":
                        rc = sh.proc.poll()
                        if rc is None:
                            hb = HeartbeatFile(sh.dir / "HEARTBEAT.json").read()
                            age = heartbeat_age_s(hb, sh.launched_wall, now)
                            if 0 < stall_timeout < age:
                                tel.event("shard_stalled", shard=sh.name, age_s=round(age, 1))
                                _kill_process_group(sh.proc, grace=5.0)
                                _fail(sh, f"stalled (heartbeat age {age:.0f}s)")
                                active = active or sh.status == "waiting"
                            else:
                                active = True
                        elif rc == 0 and (sh.dir / "shard_metrics.json").exists():
                            sh.status = "done"
                            tel.event("shard_done", shard=sh.name, attempt=sh.attempts)
                            logger.info("%s done", sh.name)
                        else:
                            reason = (f"exit code {rc}" if rc != 0
                                      else "exit 0 without completion marker")
                            tel.event("shard_dead", shard=sh.name, exit_code=rc)
                            _fail(sh, reason)
                            active = active or sh.status == "waiting"
                    elif sh.status == "waiting":
                        if now >= sh.restart_at:
                            _launch(sh)
                        active = True
                _publish(now)
                tel.heartbeat(
                    force=True,
                    shards_done=sum(s.status == "done" for s in states),
                    shards_running=sum(s.status == "running" for s in states),
                    shards_quarantined=sum(s.status == "quarantined" for s in states),
                )
                if not active:
                    break
                time.sleep(poll_interval)
        finally:
            # a coordinator that dies (or is interrupted) takes its workers along
            for sh in states:
                if sh.proc is not None and sh.proc.poll() is None:
                    _kill_process_group(sh.proc, grace=5.0)

        shard_summaries = [
            {"shard": sh.name, "span": [sh.start, sh.end], "rows": sh.end - sh.start,
             "attempts": sh.attempts, "restarts": max(0, sh.attempts - 1), "status": sh.status,
             "failures": sh.failures}
            for sh in states
        ]
        quarantined = [sh for sh in states if sh.status == "quarantined"]
        if quarantined:
            missing = [[sh.start, sh.end] for sh in quarantined]
            raise PartialCompletionError({
                "status": "partial",
                "rows_total": corpus_rows,
                "rows_missing": sum(e - s for s, e in missing),
                "missing_spans": missing,
                "quarantined": [s for s in shard_summaries if s["status"] == "quarantined"],
                "shards": shard_summaries,
            })

        out_results = out_dir / f"{name}_result.json"
        out_metrics = out_dir / f"{name}_metric_all.json"
        metrics, merge_wall = _merge_and_verify(states, corpus_rows, out_results, out_metrics,
                                                thres, tel)
        return {
            "metrics": metrics,
            "out_results": str(out_results),
            "out_metrics": str(out_metrics),
            "corpus_rows": corpus_rows,
            "device": dev.type,
            "buckets": resolved_eval["buckets"],
            "verification": {"rows": corpus_rows, "shards": n_shards, "exactly_once": True},
            "merge_wall_s": merge_wall,
            "restarts": sum(max(0, sh.attempts - 1) for sh in states),
            "shards": shard_summaries,
        }
    finally:
        tel.close()
        if exposition is not None:
            exposition.close()

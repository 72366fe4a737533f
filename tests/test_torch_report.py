"""The port's ``telemetry/report.py`` against the JAX package's.

Both readers get the same sink files at a fixed ``now``: ``report_json``
must be equal less ``run_dir`` and ``generated_wall``, and ``render_report``
equal line for line but for the PROGRAMS header, which names the port's
programs.  The sink files are written by the port (its registry, program
registry, incident recorder and coordinator-style events) and then torn,
staled or emptied by hand where a scenario says so, and by the port's own
runs: a served run with the flight recorder and an incident bundle, and a
sharded ``score-corpus`` run (the train and evaluate dirs are
``test_torch_runsinks.py``'s).
"""

from __future__ import annotations

import json
import os

import pytest

from memvul_tpu.telemetry import report as jax_report
from memvul_tpu_torch import __main__ as cli
from memvul_tpu_torch.serving.incident import IncidentRecorder
from memvul_tpu_torch.telemetry import Registry
from memvul_tpu_torch.telemetry import report as port_report
from memvul_tpu_torch.telemetry.programs import ProgramRegistry, write_programs

NOW = 1_800_000_000.0
HEADERS = ("PROGRAMS (compiled XLA executables)",
           "PROGRAMS (score shapes, bank chunks and the kernel library)")


def _assert_same_report(run_dir):
    want = jax_report.report_json(run_dir, now=NOW)
    got = port_report.report_json(run_dir, now=NOW)
    assert got["schema"] == want["schema"] == 1
    assert list(got) == list(want)
    for payload in (want, got):
        payload.pop("run_dir")
        payload.pop("generated_wall")
    assert got == want
    jax_lines = jax_report.render_report(run_dir, now=NOW).splitlines()
    port_lines = port_report.render_report(run_dir, now=NOW).splitlines()
    assert len(port_lines) == len(jax_lines)
    # the port names the JAX package's "mfu" busy_util (a busy-time utilization)
    differing = [(a, b) for a, b in zip(jax_lines, port_lines)
                 if a.replace("MFU unavailable", "busy_util unavailable") != b]
    assert differing in ([], [HEADERS])
    return got, port_lines


def _train_like(run_dir):
    """A train run's sinks, closed cleanly: spans, step events, counters,
    a step-time histogram and the program table."""
    tel = Registry(run_dir=run_dir, heartbeat_every_s=0.0)
    with tel.span("train_epoch", epoch=0):
        for step in range(3):
            tel.event("train_step", step=step, loss=0.7 - 0.1 * step, lr=1e-4, grad_norm=1.5)
            tel.histogram("train.step_s").observe(0.2 + 0.01 * step)
        tel.counter("train.steps").inc(3)
        tel.counter("train.tokens").inc(3072)
        tel.gauge("train.tokens_per_sec").set(15000.0)
    with tel.span("validate", epoch=0):
        tel.counter("score.rows").inc(24)
        tel.counter("data.encode_cache_hits").inc(40)
        tel.counter("data.encode_cache_misses").inc(8)
    tel.event("train_epoch", epoch=0, loss=0.6, num_steps=3)
    programs = ProgramRegistry(telemetry=tel)
    programs.register("score:8x48", scope="score", compile_s=0.25, flops=6e7,
                      bytes_accessed=2e6, argument_bytes=1000, output_bytes=64)
    programs.record_invocation("score:8x48", seconds=0.01)
    programs.register("bank:128x48", scope="score", compile_s=0.5, flops=9e8)
    write_programs(run_dir, programs)
    tel.close()


def _serve_like(run_dir):
    """A serving run: latency stages, cascade and cache counters, a fleet,
    an autoscaler, alert transitions, the anchor bank with a pinned
    baseline, replica subdirs (one never flushed) and an incident bundle."""
    tel = Registry(run_dir=run_dir, heartbeat_every_s=0.0)
    for stage, value in (("queue_wait", 0.004), ("pack", 0.001), ("device", 0.006),
                         ("resolve", 0.0005)):
        for i in range(5):
            tel.histogram(f"serve.{stage}_s").observe(value * (1 + i))
    for i in range(5):
        tel.histogram("serve.latency_s").observe(0.012 * (1 + i))
    counters = {"serve.served": 90, "serve.shed": 2, "serve.errors": 1,
                "serve.tokens_real": 7000, "serve.tokens_padded": 9000,
                "serve.pack_topups": 12, "serve.cascade_rescored": 7,
                "serve.cascade_shortcircuit": 83, "cache.hits": 30, "cache.misses": 60,
                "bank.anchor_wins.CWE-79": 50, "bank.anchor_wins.CWE-89": 30,
                "bank.anchor_wins.CWE-22": 10, "bank.shadow_sampled": 40,
                "bank.shadow_flips": 2, "fleet.reroutes": 3, "fleet.host_restarts": 1,
                "scaler.scale_ups": 1, "scaler.scale_downs": 0}
    for name, value in counters.items():
        tel.counter(name).inc(value)
    for i in range(4):
        tel.histogram("bank.anchor_score.CWE-79").observe(0.6 + 0.1 * i)
    for name, value in {"bank.anchor_drift": 0.12, "fleet.hosts": 2, "fleet.hosts_alive": 2,
                        "fleet.heartbeat_age_s.host-0": 0.3, "scaler.replicas": 2,
                        "scaler.hint": 1}.items():
        tel.gauge(name).set(value)
    (run_dir / "anchor_baseline.json").write_text(
        json.dumps({"CWE-79": 0.5, "CWE-89": 0.4, "CWE-22": 0.1}))
    tel.event("router_start", replicas=2)
    tel.event("replica_dead", replica="replica-1")
    tel.event("replica_restart", replica="replica-1", n=1)
    tel.event("scaler_decision", action="scale_up", replicas=2, reason="queue")
    tel.event("alert_fired", rule="serve_error_rate", value=0.2, threshold=0.05)
    tel.event("alert_resolved", rule="serve_error_rate", value=0.0)
    tel.event("alert_fired", rule="serve_p99_latency", value=0.4, threshold=0.25)
    member = Registry(run_dir=run_dir / "replica-0", heartbeat_every_s=0.0)
    member.counter("serve.served").inc(60)
    member.counter("replica.restarts").inc(0)
    member.close()
    (run_dir / "replica-1").mkdir()  # killed before its first flush
    recorder = IncidentRecorder(object(), run_dir, registry=tel, start=False,
                                min_interval_s=0.0)
    recorder.trigger("alert-serve_error_rate", {"rule": "serve_error_rate"})
    assert recorder.drain() == 1
    tel.close()


def _score_corpus_like(run_dir):
    """A sharded scoring run: coordinator events and shard subdirs, one
    done, one quarantined and one that never wrote telemetry."""
    tel = Registry(run_dir=run_dir, heartbeat_every_s=0.0)
    for shard in ("shard-0", "shard-1"):
        tel.event("shard_start", shard=shard)
    tel.event("shard_restart", shard="shard-1", exit_code=-9)
    tel.event("shard_done", shard="shard-0", rows=64)
    tel.event("shard_quarantined", shard="shard-1")
    tel.event("merge_verified", rows=64)
    worker = Registry(run_dir=run_dir / "shard-0", heartbeat_every_s=0.0)
    worker.counter("resilience.retries").inc(1)
    worker.counter("journal.rows_committed").inc(64)
    worker.heartbeat(force=True, rows_scored=64)
    worker.close()
    stale = Registry(run_dir=run_dir / "shard-1", heartbeat_every_s=0.0)
    stale.counter("journal.rows_committed").inc(10)
    stale.heartbeat(force=True)  # never closed: no telemetry.json
    (run_dir / "shard-2").mkdir()
    tel.close()


def _killed(run_dir):
    """A SIGKILLed train: a torn last event line, a heartbeat from long
    ago, no summary, and program events but no programs.json."""
    tel = Registry(run_dir=run_dir, heartbeat_every_s=0.0)
    with tel.span("train_epoch", epoch=0):
        tel.counter("train.steps").inc(2)
        tel.heartbeat(force=True)
    ProgramRegistry(telemetry=tel).register("score:8x48", scope="score", compile_s=0.1,
                                            flops=1e7)
    tel._events.close()
    with open(run_dir / "events.jsonl", "a") as f:
        f.write('{"t": 1.0, "kind": "train_st')
    beat = json.loads((run_dir / "HEARTBEAT.json").read_text())
    beat["written_wall"] = NOW - 3600.0
    (run_dir / "HEARTBEAT.json").write_text(json.dumps(beat))


def _empty_sinks(run_dir):
    run_dir.mkdir(parents=True, exist_ok=True)
    for name in ("events.jsonl", "telemetry.json", "HEARTBEAT.json"):
        (run_dir / name).write_text("")


def _heartbeat_only(run_dir):
    tel = Registry(run_dir=run_dir, heartbeat_every_s=0.0, events=False)
    tel.counter("score.rows").inc(5)
    tel.heartbeat(force=True, rows_scored=5)


def _programs_torn(run_dir):
    _train_like(run_dir)
    (run_dir / "programs.json").write_text('{"programs": [')


SCENARIOS = {
    "train": _train_like,
    "serve": _serve_like,
    "score_corpus": _score_corpus_like,
    "killed": _killed,
    "empty_sinks": _empty_sinks,
    "heartbeat_only": _heartbeat_only,
    "programs_torn": _programs_torn,
    "no_telemetry": lambda run_dir: run_dir.mkdir(parents=True, exist_ok=True),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_report_equals_the_jax_report_on_the_same_sinks(tmp_path, scenario):
    run_dir = tmp_path / scenario
    SCENARIOS[scenario](run_dir)
    got, lines = _assert_same_report(run_dir)
    if scenario == "killed":
        assert got["events"]["skipped"] == 1
        assert got["heartbeat"]["age_s"] >= 3600.0
        assert [row["key"] for row in got["programs"]] == ["score:8x48"]
    if scenario == "serve":
        assert got["incidents"] and got["incidents"][0]["trigger"] == "alert-serve_error_rate"
        assert any(line.startswith("ANCHOR BANK") for line in lines)
        assert got["replicas"]["members"][1] == {"name": "replica-1", "recorded": False}
    if scenario == "score_corpus":
        assert [row["name"] for row in got["shards"]["members"]] == ["shard-0", "shard-1",
                                                                    "shard-2"]
    if scenario == "train":
        assert got["spans"]["train_epoch"]["count"] == 1.0
        assert got["counters"]["train.steps"] == 3
        assert HEADERS[1] in lines


def test_telemetry_report_cli_text_json_and_usage(tmp_path, capsys):
    run_dir = tmp_path / "run"
    _train_like(run_dir)
    assert cli.main(["telemetry-report", str(run_dir)]) == 0
    assert "PHASES (spans)" in capsys.readouterr().out
    assert cli.main(["telemetry-report", str(run_dir), "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["schema"] == 1 and payload["counters"]["train.steps"] == 3
    assert cli.main(["telemetry-report", str(tmp_path / "missing")]) == 2
    assert "is not a directory" in capsys.readouterr().err


def test_report_reads_a_live_writer_without_tearing(tmp_path):
    """A report taken while a run still appends (no summary yet, the
    heartbeat rewritten atomically) renders and agrees with the JAX one."""
    run_dir = tmp_path / "live"
    tel = Registry(run_dir=run_dir, heartbeat_every_s=0.0)
    for step in range(50):
        tel.event("train_step", step=step, loss=1.0)
        if step % 10 == 0:
            tel.heartbeat(force=True)
    got, _ = _assert_same_report(run_dir)
    assert got["events"]["parsed"] == 51 and got["events"]["skipped"] == 0
    tel.close()
    assert os.path.exists(run_dir / "telemetry.json")


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A tiny port archive trained on a ``build_workspace`` corpus."""
    import torch

    from memvul_tpu_torch import build
    from memvul_tpu_torch.data.synthetic import build_workspace, selfcheck_config

    root = tmp_path_factory.mktemp("report_runs")
    ws = build_workspace(root / "ws", seed=9)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = build.train_from_config(selfcheck_config(ws, steps_per_epoch=1),
                                         root / "train", device="cpu")
    finally:
        torch.set_num_threads(threads)
        from memvul_tpu_torch import telemetry

        telemetry.reset()
    return {"archive": result["archive"], "ws": ws}


def _serve_run(archive, run_dir):
    """A served run with the flight recorder on: requests, one incident
    bundle, the drain."""
    import time

    from memvul_tpu_torch import build

    service = build.serve_from_archive(
        archive["archive"], out_dir=run_dir, device="cpu", tsdb_cadence=0.05,
        overrides={"serving": {"incident_min_interval_s": 0.0}})
    try:
        texts = [r["Issue_Body"] for r in archive["ws"]["splits"]["test"][:4]]
        for text in texts:
            assert service.submit(text).result(timeout=30)["status"] == "ok"
        service.incident_recorder.trigger("manual", {"why": "report test"})
        deadline = time.monotonic() + 20
        incidents = run_dir / "incidents"
        while time.monotonic() < deadline and not (
                incidents.is_dir() and any((p / "traces.json").exists()
                                           for p in incidents.iterdir())):
            time.sleep(0.05)
    finally:
        service.drain()


def _score_corpus_run(archive, run_dir):
    from memvul_tpu_torch.distributed import score_corpus

    score_corpus(archive["archive"], archive["ws"]["paths"]["test"], run_dir, shards=2,
                 device="cpu")


@pytest.mark.parametrize("run", ["serve", "score_corpus"])
def test_report_reads_the_ports_own_serve_and_score_corpus_dirs(archive, tmp_path, run):
    run_dir = tmp_path / run
    {"serve": _serve_run, "score_corpus": _score_corpus_run}[run](archive, run_dir)
    got, lines = _assert_same_report(run_dir)
    if run == "serve":
        assert got["incidents"] and got["incidents"][0]["trigger"] == "manual"
        assert got["counters"].get("serve.served") == 4
    else:
        assert [row["name"] for row in got["shards"]["members"]] == ["shard-0", "shard-1"]
        assert all(row["done"] for row in got["shards"]["members"])
        assert any(line.startswith("SHARDS") for line in lines)

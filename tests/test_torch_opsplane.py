"""The port's serving ops plane against the JAX package's, on the CPU: the
metrics history (``telemetry/timeseries.py``), the alert rules
(``telemetry/alerts.py``), the program registry (``telemetry/programs.py``),
the flight recorder (``serving/incident.py``), profiling
(``utils/profiling.py``), the live exposition server (``telemetry/live.py``)
and the front end's ``/programz``, ``/metricsz``, ``/alertz`` and ``POST
/profilez``.

* **exact on a fake clock**: the same snapshot parts, drawn from a seed
  with numpy, observed at the same timestamps give the same history, the
  same windows and stats in both packages' stores, and the same alert
  firings and resolutions in both engines;
* **names**: the program registry books the JAX package's ``xla.*`` rows
  as ``program.*``, one to one; the shipped rules are the JAX package's,
  ``recompile_after_warm`` watching ``program.recompiles``;
* **bundles**: an incident bundle holds the JAX package's files and keys;
  suppression, pruning and the ``incident.dump`` fault
  (``incident.dump_errors``);
* **the wired paths**: a CPU predictor's programs, a served flight
  recorder whose dead-lettered batch fires ``serve_error_rate`` and writes
  one bundle, the endpoints' status codes, a training run with
  ``metrics_port``, ``tsdb_cadence_s`` and ``trace_dir``.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from memvul_tpu.serving import incident as jax_incident
from memvul_tpu.telemetry import alerts as jax_alerts
from memvul_tpu.telemetry import programs as jax_programs
from memvul_tpu.telemetry import timeseries as jax_timeseries
from memvul_tpu.telemetry.registry import TelemetryRegistry
from memvul_tpu.utils import profiling as jax_profiling
from memvul_tpu_torch import build, telemetry
from memvul_tpu_torch.archive import load_archive
from memvul_tpu_torch.config import check_training_unported, telemetry_config
from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
from memvul_tpu_torch.resilience import faults
from memvul_tpu_torch.serving import ScoringService, ServiceConfig
from memvul_tpu_torch.serving.frontend import run_http_server
from memvul_tpu_torch.serving.incident import BUNDLE_FILES, IncidentRecorder, attach_flight_recorder
from memvul_tpu_torch.telemetry import Registry
from memvul_tpu_torch.telemetry import alerts, programs, timeseries
from memvul_tpu_torch.telemetry.live import start_metrics_server
from memvul_tpu_torch.utils import profiling

from test_torch_hosts import setup  # noqa: F401 (the tiny archive fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.reset()
    telemetry.reset()


def _parts_sequence(seed, n=48, t0=1000.0):
    """(timestamp, parts) samples: monotone counters, gauges and histogram
    summaries for an unlabeled and a replica-labelled part, a growing
    memory gauge, and one 40 s silence (the absence rule's gap)."""
    rng = np.random.default_rng(seed)
    totals = {"serve.requests": 0, "serve.errors": 0, "serve.dead_letters": 0,
              "program.recompiles": 0, "xla.recompiles": 0}
    now, out, hbm = t0, [], 1e9
    for k in range(n):
        now += 40.0 if k == n // 2 else float(rng.uniform(0.2, 1.6))
        totals["serve.requests"] += int(rng.integers(0, 30))
        if rng.random() < 0.3:
            totals["serve.errors"] += int(rng.integers(1, 3))
            totals["serve.dead_letters"] += 1
        if k == 7:
            totals["program.recompiles"] += 1
            totals["xla.recompiles"] += 1
        hbm *= float(rng.uniform(1.0, 1.05))
        snap = {
            "counters": dict(totals),
            "gauges": {"serve.queue_depth": float(rng.integers(0, 9)),
                       "slo.burn_rate_fast": float(rng.uniform(0.0, 2.0)),
                       "serve.hbm_in_use_bytes": hbm},
            "histograms": {"serve.latency_s": {"mean": float(rng.random()),
                                               "p50": float(rng.random()),
                                               "p95": float(rng.random()), "count": 3.0},
                           "empty": {}},
        }
        replica = {"counters": {"serve.served": int(k * 3)},
                   "gauges": {"serve.queue_depth": float(k % 4)}, "histograms": {}}
        out.append((now, [({}, snap), ({"replica": "replica-0"}, replica)]))
    return out


@pytest.mark.parametrize("resolution,retention", [(1.0, 600.0), (0.5, 4.0), (2.0, 10.0)])
def test_store_history_matches_jax_on_a_fake_clock(resolution, retention):
    port = timeseries.TimeSeriesStore(resolution_s=resolution, retention_s=retention)
    ref = jax_timeseries.TimeSeriesStore(resolution_s=resolution, retention_s=retention)
    samples = _parts_sequence(seed=int(resolution * 10))
    for now, parts in samples:
        port.observe(parts, now=now)
        ref.observe(parts, now=now)
    end = samples[-1][0]
    assert port.history(now=end) == ref.history(now=end)
    for window in (3.0, 30.0):
        assert port.history(window_s=window, now=end) == ref.history(window_s=window, now=end)
    assert port.history(metric="serve.", now=end) == ref.history(metric="serve.", now=end)
    names = ["serve.requests.rate", "serve.queue_depth", "serve.latency_s.p95"]
    assert port.window(names, 20.0, now=end) == ref.window(names, 20.0, now=end)
    assert port.stats() == ref.stats() and port.series_count == ref.series_count
    key = (("replica", "replica-0"),)
    assert timeseries.series_name("m", key) == jax_timeseries.series_name("m", key)
    assert timeseries.series_name("m", ()) == "m"


def test_store_and_sampler_validation_and_own_cost():
    for kw in ({"resolution_s": 0}, {"resolution_s": 2.0, "retention_s": 1.0}):
        with pytest.raises(ValueError):
            timeseries.TimeSeriesStore(**kw)
        with pytest.raises(ValueError):
            jax_timeseries.TimeSeriesStore(**kw)
    with pytest.raises(ValueError, match="cadence_s"):
        timeseries.MetricsSampler(Registry(), cadence_s=0.0, start=False)
    tel = Registry()
    target = Registry()
    target.counter("serve.requests").inc(3)
    sampler = timeseries.MetricsSampler(target, cadence_s=1.0, registry=tel, start=False)
    sampler.sample(now=10.0)
    target.counter("serve.requests").inc(4)
    sampler.sample(now=12.0)
    assert sampler.history()["serve.requests.rate"] == [[12.0, 2.0]]
    # a callable of parts and a target's metrics_snapshots() sample too

    class _Target:
        def metrics_snapshots(self):
            return [({"replica": "r0"}, {"gauges": {"g": 1.0}})]

    for source in (_Target(), lambda: [({}, {"gauges": {"h": 2.0}})]):
        other = timeseries.MetricsSampler(source, cadence_s=1.0, registry=tel, start=False)
        other.sample(now=1.0)
        assert other.store.series_count == 1

    class _Broken:
        def metrics_snapshots(self):
            raise RuntimeError("replica half dead")

    timeseries.MetricsSampler(_Broken(), cadence_s=1.0, registry=tel, start=False).sample()
    snap = tel.snapshot()
    assert snap["counters"]["tsdb.samples"] == 4 and snap["counters"]["tsdb.sample_errors"] == 1
    assert "tsdb.series" in snap["gauges"] and snap["histograms"]["tsdb.sample_s"]["count"] == 4
    status = sampler.status()
    assert status["enabled"] is True and status["samples"] == 2


def test_default_rules_are_the_jax_rules_and_validation():
    port, ref = alerts.default_rules(), jax_alerts.default_rules()
    assert [(r.name, r.kind, r.threshold, r.window_s) for r in port] == \
        [(r.name, r.kind, r.threshold, r.window_s) for r in ref]
    metrics = {r.name: r.metric for r in port}
    assert metrics.pop("recompile_after_warm") == "program.recompiles"
    assert metrics == {r.name: r.metric for r in ref if r.name != "recompile_after_warm"}
    with pytest.raises(ValueError, match="unknown kind"):
        alerts.AlertRule("x", "bogus", "m")
    with pytest.raises(ValueError, match="needs a metric"):
        alerts.AlertRule("x", alerts.KIND_RATE)
    with pytest.raises(ValueError, match="duplicate"):
        alerts.AlertEngine(timeseries.TimeSeriesStore(), registry=Registry(),
                           rules=[alerts.AlertRule("a", "absence")] * 2, start=False)


@pytest.mark.parametrize("seed", [3, 4])
def test_alert_firings_and_resolutions_match_jax(seed):
    samples = _parts_sequence(seed)
    port_store, ref_store = timeseries.TimeSeriesStore(), jax_timeseries.TimeSeriesStore()
    tel = Registry()
    port = alerts.AlertEngine(port_store, registry=tel, start=False)
    ref = jax_alerts.AlertEngine(ref_store, registry=TelemetryRegistry(), start=False)
    port._started_wall = ref._started_wall = samples[0][0]
    fired = {"port": [], "ref": []}
    port.add_listener(lambda r: fired["port"].append((r["rule"], r["value"], r["series"])))
    # the one rule that watches another name: program.* where the JAX package has xla.*
    ref.add_listener(lambda r: fired["ref"].append(
        (r["rule"], r["value"], (r["series"] or "").replace("xla.", "program.", 1) or None)))
    trail = []
    ticks = []  # after each sample; inside the silence too, where the absence rule fires
    for (now, parts), (later, _) in zip(samples, samples[1:] + [(samples[-1][0] + 1.0, None)]):
        ticks.append((now, parts, now + 0.5))
        if later - now > 30.0:
            ticks.append((None, None, now + 35.0))
    for now, parts, at in ticks:
        if parts is not None:
            port_store.observe(parts, now=now)
            ref_store.observe(parts, now=now)
        got, want = port.tick(now=at), ref.tick(now=at)
        firing = lambda s: sorted((f["rule"], f["value"]) for f in s["firing"])  # noqa: E731
        assert firing(got) == firing(want)
        assert [r["firing"] for r in got["rules"]] == [r["firing"] for r in want["rules"]]
        trail.append(firing(got))
    assert fired["port"] == fired["ref"]
    rules_seen = {name for tick in trail for name, _ in tick}
    assert {"serve_error_rate", "heartbeat_stalled", "hbm_growth",
            "recompile_after_warm"} <= rules_seen
    counters = tel.snapshot()["counters"]
    assert counters["alert.fired"] == len(fired["port"]) and counters.get("alert.resolved", 0) >= 1


# -- the program registry -------------------------------------------------------------


def _jax_registry_with_one_program():
    ref = jax_programs.ProgramRegistry(telemetry=TelemetryRegistry())
    lowered = jax.jit(lambda x: x @ x).lower(jnp.ones((8, 8), jnp.float32))
    ref.compile_and_register("score:8x8", lowered, scope="score")
    ref.record_invocation("score:8x8", 0.001)
    ref.record_invocation("missing")
    ref.mark_warm("score")
    ref.note_trace("score", "score:16x8")
    return ref


def test_program_rows_and_names_match_jax_as_program_star():
    tel = Registry()
    port = programs.ProgramRegistry(telemetry=tel)
    port.register("score:8x8", scope="score", compile_s=0.01, flops=1024.0, bytes_accessed=512.0,
                  device="cpu")
    port.record_invocation("score:8x8", 0.001)
    port.record_invocation("missing")
    port.mark_warm("score")
    port.note_trace("score", "score:16x8")
    ref = _jax_registry_with_one_program()
    got, want = port.metrics_part(), ref.metrics_part()
    for table in ("counters", "gauges", "histograms"):
        assert set(got[table]) == {k.replace("xla.", "program.", 1) for k in want[table]}
    assert got["counters"]["program.recompiles"] == want["counters"]["xla.recompiles"] == 1
    assert got["counters"]["program.invocations"] == want["counters"]["xla.invocations"] == 2
    assert set(port.snapshot()[0]) == set(ref.snapshot()[0])
    assert set(port.roofline()) >= set(ref.roofline())
    assert port.snapshot()[0]["interpret_only"] is True and port.roofline()["mfu"] is None
    events = []
    port._tel = lambda override=None: type("T", (), {"event": lambda self, k, **f: events.append(
        (k, f))})()
    port.note_trace("score", "score:32x8")
    assert events == [("rcompile", {"scope": "score", "key": "score:32x8"})]
    assert programs.peak_spec("NVIDIA H100 80GB HBM3")["flops_per_s"] == 989e12
    assert programs.peak_spec("cpu") is None and programs.device_info("cpu") == ("cpu", "cpu")
    assert programs.shape_key("ragged", (1, 2048)) == "ragged:1x2048"
    assert programs.ProgramRegistry().metrics_part() == {}


def test_program_mfu_on_a_known_peak():
    reg = programs.ProgramRegistry(telemetry=Registry())
    reg.register("ragged:1x2048", scope="score", compile_s=0.5, flops=2e12, bytes_accessed=1e9)
    for rec in reg._records.values():  # as if it had been registered on an H100
        rec.device_kind, rec.interpret_only = "NVIDIA H100 80GB HBM3", False
    reg.record_invocation("ragged:1x2048", 0.004, flops=1e12, bytes_accessed=5e8)
    reg.record_invocation("ragged:1x2048")  # untimed: work counted, not in the MFU
    roof = reg.roofline()
    assert roof["flops_total"] == 1e12 + 2e12 and roof["timed_flops"] == 1e12
    assert roof["mfu"] == pytest.approx(1e12 / 0.004 / 989e12)
    assert 0 < reg.metrics_part()["gauges"]["program.mfu"] <= 1


def test_score_cost_counts_live_attention_and_the_match():
    cfg = build.encoder_config({"preset": "tiny"}, vocab_size=128)
    f_one, _ = programs.score_cost(cfg, 16, [8, 8], rows=2)
    f_two, _ = programs.score_cost(cfg, 16, [16], rows=2)
    assert f_two - f_one == cfg.num_layers * 4 * cfg.hidden_size * (256 - 128)
    f_match, b_match = programs.score_cost(cfg, 16, [16], rows=2, n_anchors=5, header_dim=32,
                                           bank_bytes=640)
    f_plain, b_plain = programs.score_cost(cfg, 16, [16], rows=2, header_dim=32)
    assert f_match - f_plain == 2 * 5 * 32 * 5 + 2 * 32 * 2 * 7
    assert b_match - b_plain == 640 + 2 * 5 * 4 - 2 * 32 * 2


def test_predictor_registers_its_programs_and_counts_a_recompile(setup, tmp_path):  # noqa: F811
    arch = load_archive(setup["archive"], device="cpu")
    reg = programs.ProgramRegistry(telemetry=Registry())
    predictor = SiamesePredictor(arch.model, arch.tokenizer, batch_size=8, max_length=48,
                                 score_impl="ragged", token_budget=96, max_rows_per_pack=4,
                                 program_registry=reg)
    predictor.encode_anchors(setup["anchors"])
    predictor.warmup_compile()
    keys = {row["key"] for row in reg.snapshot()}
    assert keys == {"bank:128x48", "ragged:1x96"}
    assert reg.is_warm("score")
    predictor.score_texts(setup["texts"][:6])
    rows = {row["key"]: row for row in reg.snapshot()}
    assert rows["ragged:1x96"]["invocations"] >= 3 and rows["ragged:1x96"]["flops"] > 0
    assert rows["ragged:1x96"]["interpret_only"] is True
    assert reg.metrics_part()["counters"]["program.recompiles"] == 0
    predictor.score_texts(setup["texts"][:2], impl="bucketed")  # a shape the warmup never ran
    assert reg.metrics_part()["counters"]["program.recompiles"] == 1
    assert "score:8x48" in {row["key"] for row in reg.snapshot()}
    programs.write_programs(tmp_path, reg)
    written = json.loads((tmp_path / "programs.json").read_text())
    assert written["schema"] == 1 and len(written["programs"]) == 3 and written["roofline"]
    programs.write_programs(tmp_path / "empty", programs.ProgramRegistry())
    assert not (tmp_path / "empty" / "programs.json").exists()


# -- the incident recorder ----------------------------------------------------------------


class _Target:
    def health_summary(self):
        return {"status": "ok", "queue_depth": 0}

    def recent_traces(self):
        return [{"trace_id": "t-1", "cause": "ok"}]

    def programs_snapshot(self):
        return [{"key": "ragged:1x2048", "invocations": 3}]


def _bundle(recorder):
    bundles = sorted(p for p in recorder.incidents_dir.iterdir() if p.is_dir())
    return bundles


def test_incident_bundle_files_and_keys_match_jax(tmp_path):
    tel = Registry()
    store, ref_store = timeseries.TimeSeriesStore(), jax_timeseries.TimeSeriesStore()
    for now, parts in _parts_sequence(seed=5, n=6, t0=time.time() - 10):
        store.observe(parts, now=now)
        ref_store.observe(parts, now=now)
    engine = alerts.AlertEngine(store, registry=tel, start=False)
    ref_engine = jax_alerts.AlertEngine(ref_store, registry=TelemetryRegistry(), start=False)
    port = IncidentRecorder(_Target(), tmp_path / "port", store=store, engine=engine,
                            registry=tel, start=False)
    ref = jax_incident.IncidentRecorder(_Target(), tmp_path / "ref", store=ref_store,
                                        engine=ref_engine, registry=TelemetryRegistry(),
                                        start=False)
    for recorder in (port, ref):
        assert recorder.trigger("alert-serve_error_rate", {"rule": "serve_error_rate"})
        assert recorder.drain() == 1
    got, want = _bundle(port), _bundle(ref)
    assert len(got) == len(want) == 1 and got[0].name.endswith("alert-serve_error_rate")
    assert sorted(p.name for p in got[0].iterdir()) == sorted(p.name for p in want[0].iterdir()) \
        == sorted(BUNDLE_FILES)
    for name in BUNDLE_FILES:
        a = json.loads((got[0] / name).read_text())
        b = json.loads((want[0] / name).read_text())
        assert type(a) is type(b)
        if isinstance(a, dict):
            assert set(a) == set(b), name
    assert json.loads((got[0] / "metrics.json").read_text())["history"] == \
        json.loads((want[0] / "metrics.json").read_text())["history"]
    assert tel.snapshot()["counters"]["incident.dumps"] == 1


def test_incident_suppression_pruning_and_dump_fault(tmp_path):
    tel = Registry()
    limited = IncidentRecorder(_Target(), tmp_path / "a", registry=tel, min_interval_s=30.0,
                               start=False)
    assert limited.trigger("one") and limited.trigger("two")
    limited.drain()
    assert len(_bundle(limited)) == 1 and tel.snapshot()["counters"]["incident.suppressed"] == 1
    pruned = IncidentRecorder(_Target(), tmp_path / "b", registry=tel, min_interval_s=0.0,
                              max_bundles=2, queue_size=1, start=False)
    assert pruned.trigger("x") and not pruned.trigger("overflow")  # bounded queue
    for k in range(3):
        pruned.trigger(f"k{k}")
        pruned.drain()
    assert len(_bundle(pruned)) == 2 and pruned.status()["max_bundles"] == 2
    faults.configure("incident.dump=raise:RuntimeError:disk on fire")
    broken = IncidentRecorder(_Target(), tmp_path / "c", registry=tel, min_interval_s=0.0,
                              start=False)
    broken.trigger("boom")
    assert broken.drain() == 1  # counted, never raised
    assert tel.snapshot()["counters"]["incident.dump_errors"] == 1
    assert not broken.incidents_dir.exists() or not _bundle(broken)
    with pytest.raises(ValueError, match="max_bundles"):
        IncidentRecorder(_Target(), tmp_path, max_bundles=0, start=False)


def test_attach_gate_builds_nothing_when_off(tmp_path):
    target = _Target()
    assert attach_flight_recorder(target, run_dir=tmp_path, cadence_s=0.0) is target
    assert not any(hasattr(target, a) for a in ("metrics_sampler", "alert_engine",
                                                "incident_recorder"))


# -- the served flight recorder and the front end -----------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode("utf-8"))


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    return _get(req)


def test_flight_recorder_served_alert_bundle_and_endpoints(setup, tmp_path):  # noqa: F811
    # a rate spike survives only as the newest point of its bucket: the
    # history's resolution is the sampler's cadence here
    overrides = {"serving": {"alert_interval_s": 0.05, "incident_min_interval_s": 0.0,
                             "retries": 0, "default_deadline_ms": 30000},
                 "telemetry": {"tsdb_resolution_s": 0.05}}
    service = build.serve_from_archive(setup["archive"], out_dir=tmp_path, device="cpu",
                                       overrides=overrides, tsdb_cadence=0.05)
    server = run_http_server(service, port=0, profile_dir=tmp_path / "profiles")
    base = "http://%s:%d" % server.server_address[:2]
    try:
        assert service.metrics_sampler.cadence_s == 0.05
        for text in setup["texts"][:4]:
            assert service.submit(text).result(timeout=30)["status"] == "ok"
        # the first dead letter creates serve.errors, which the history can
        # only turn into a rate from its second sample on (as in the JAX
        # package): a second one, a few samples later, shows as a rate
        for text in setup["texts"][5:7]:
            faults.configure("serve.batch=raise:RuntimeError:injected batch fault")
            assert service.submit(text).result(timeout=30)["status"] == "error"
            time.sleep(0.3)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not (
                service.incident_recorder.incidents_dir.is_dir()
                and any(p.name.endswith("alert-serve_error_rate")
                        for p in service.incident_recorder.incidents_dir.iterdir())):
            time.sleep(0.05)
        bundle = [p for p in service.incident_recorder.incidents_dir.iterdir()
                  if p.name.endswith("alert-serve_error_rate")]
        assert len(bundle) == 1
        assert sorted(p.name for p in bundle[0].iterdir()) == sorted(BUNDLE_FILES)
        manifest = json.loads((bundle[0] / "manifest.json").read_text())
        assert manifest["trigger"] == "alert-serve_error_rate" and "health" in manifest
        assert json.loads((bundle[0] / "programs.json").read_text())
        status, body = _get(base + "/metricsz?metric=serve.&window=60")
        assert status == 200 and body["enabled"] is True and body["history"]
        assert all(name.startswith("serve.") for name in body["history"])
        assert _get(base + "/metricsz?window=abc")[0] == 400
        status, body = _get(base + "/alertz")
        assert status == 200 and len(body["rules"]) == 6
        assert "serve_error_rate" in {f["rule"] for f in body["firing"]}
        status, body = _get(base + "/programz")
        assert status == 200 and body["count"] >= 2 and body["roofline"]["interpret_only"]
        assert "serve.hbm_in_use_bytes" not in service.registry.snapshot()["gauges"]  # the CPU
        # /profilez: 400 on a bad body, 200, then 409 while it runs
        assert _post(base + "/profilez", b'{"secs": 1}')[0] == 400
        assert _post(base + "/profilez", b'{"seconds": -1}')[0] == 400
        status, body = _post(base + "/profilez", b'{"seconds": 0.5}')
        assert status == 200 and body["trace_dir"].endswith("profile-001")
        assert _post(base + "/profilez", b'{"seconds": 0.5}')[0] == 409
        deadline = time.monotonic() + 20
        trace = tmp_path / "profiles" / "profile-001" / profiling.TRACE_FILE
        while time.monotonic() < deadline and not trace.exists():
            time.sleep(0.05)
        assert json.loads(trace.read_text())["traceEvents"] is not None
        assert telemetry.get_registry().counter("serve.profile_captures").value == 1
    finally:
        server.shutdown()
        service.drain()
    assert service.metrics_sampler._stop.is_set() and service.alert_engine._stop.is_set()


# -- profiling ---------------------------------------------------------------------------------


def test_step_timer_and_memory_stats_match_jax(tmp_path):
    durations = [0.9, 0.1, 0.12, 0.2, 0.11]
    port, ref = profiling.StepTimer(), jax_profiling.StepTimer()
    port._durations, ref._durations = list(durations), list(durations)
    assert port.summary() == ref.summary() and len(port) == len(ref) == 5
    with port.distribute_over_last(2), ref.distribute_over_last(2):
        time.sleep(0.01)
    assert len(port.durations) == 5
    assert profiling.StepTimer().summary() == jax_profiling.StepTimer().summary() == {}
    assert profiling.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {} == profiling.device_memory_stats(
            all_devices=True)
    with profiling.trace_context(None):
        pass
    with profiling.trace_context(str(tmp_path / "t")):
        torch.ones(4) @ torch.ones(4)
    assert "traceEvents" in json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())


def test_profiler_capture_one_at_a_time(tmp_path):
    capture = profiling.ProfilerCapture(tmp_path, max_seconds=5.0)
    release = threading.Event()
    capture._wait = lambda seconds: release.wait(10)
    with pytest.raises(ValueError):
        capture.start(0)
    with pytest.raises(ValueError):
        capture.start(6.0)
    info = capture.start(1.0)
    assert info["trace_dir"].endswith("profile-001") and capture.busy
    with pytest.raises(profiling.CaptureInProgress):
        capture.start(1.0)
    release.set()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and capture.busy:
        time.sleep(0.02)
    assert not capture.busy and capture.captures == 1
    assert (tmp_path / "profile-001" / profiling.TRACE_FILE).exists()


# -- the live exposition server and a training run ---------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_live_server_endpoints_and_close():
    programs.get_program_registry().register("kernels:test", scope="build", compile_s=0.1)
    store = timeseries.TimeSeriesStore()
    sampler = timeseries.MetricsSampler(Registry(), store=store, cadence_s=1.0, start=False)
    engine = alerts.AlertEngine(store, registry=Registry(), start=False)
    server = start_metrics_server(0, sampler=sampler, engine=engine)
    base = "http://%s:%d" % server.server_address[:2]
    try:
        with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
            assert "program_programs" in resp.read().decode("utf-8")
        status, body = _get(base + "/programz")
        assert status == 200 and "kernels:test" in {r["key"] for r in body["programs"]}
        assert _get(base + "/healthz")[1]["status"] == "ok"
        assert _get(base + "/metricsz")[1]["enabled"] is True
        assert len(_get(base + "/alertz")[1]["rules"]) == 6
        assert _get(base + "/nope")[0] == 404
    finally:
        server.close()
        server.close()
    assert sampler._stop.is_set() and engine._stop.is_set()
    programs.get_program_registry().reset()


def test_train_with_live_metrics_history_and_epoch_trace(tmp_path):
    from memvul_tpu_torch.data.synthetic import build_workspace, selfcheck_config

    ws = build_workspace(tmp_path / "ws", seed=3)
    port = _free_port()
    cfg = dict(selfcheck_config(ws), telemetry={
        "metrics_port": port, "tsdb_cadence_s": 0.05, "trace_dir": str(tmp_path / "trace")})
    result = build.train_from_config(cfg, tmp_path / "run", device="cpu")
    assert (tmp_path / "run" / "model.tar.gz").exists() and result["archive"]
    written = json.loads((tmp_path / "run" / "programs.json").read_text())
    assert any(row["key"].startswith("bank:") for row in written["programs"])
    assert "traceEvents" in json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    with socket.socket() as s:  # the exposition released its port
        s.bind(("127.0.0.1", port))
    with pytest.raises(NotImplementedError, match="slice 11"):
        telemetry_config({"telemetry": {"step_events": False}})
    with pytest.raises(NotImplementedError, match="slice 11"):
        check_training_unported({"tuning": {"profile_dir": "p/"}})
    with pytest.raises(ValueError, match="metrics_port"):
        telemetry_config({"telemetry": {"metrics_port": 70000}})

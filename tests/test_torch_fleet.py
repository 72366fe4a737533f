"""The port's replica fleet (``memvul_tpu_torch/serving/router.py``,
``replica.py``, ``loadgen.py``) against the JAX package's, on the CPU.

* **parity**: 120 concurrent requests through a 2-replica port router on a
  tiny archive (JAX-initialised weights) against the same requests through
  the JAX package's 2-replica router on the same archive: rtol 1e-4 /
  atol 1e-5, both replicas used, the fleet invariant ``Σ served + Σ shed +
  Σ errors == Σ requests`` exact;
* **routing and health**: least-loaded picking, no healthy replica
  resolves "error" (not a hang), drain, ``check_health`` on an error
  streak and on a dead batcher, the dead replica's sweep;
* **recovery**: a ``replica.kill`` fault reroutes, restarts the replica
  and keeps the invariant; a reroute keeps its trace id and counts hops;
  a restarted replica re-installs the fleet's bank;
* **rolling swap** under load: one bank version per response;
* **exposition**: per-replica labels on ``/metrics``;
* ``serve_from_archive(replicas=2, device="cpu")`` and ``python -m
  memvul_tpu_torch serve --replicas 2`` with an HTTP round trip; a
  subprocess whose replica is killed mid-load (``chaos``).

Every future is collected with a bounded ``result(timeout=...)``, so a hang
fails instead of stalling the suite.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from memvul_tpu import archive as jax_archive
from memvul_tpu import serving as jax_serving
from memvul_tpu import telemetry as jax_telemetry
from memvul_tpu.data.synthetic import build_workspace
from memvul_tpu.evaluate.predict_memory import SiamesePredictor as JaxPredictor
from memvul_tpu.models import BertConfig as JaxBertConfig
from memvul_tpu.models import MemoryModel as JaxMemoryModel
from memvul_tpu_torch import telemetry
from memvul_tpu_torch.archive import load_archive
from memvul_tpu_torch.build import serve_from_archive
from memvul_tpu_torch.data.readers import MemoryReader
from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
from memvul_tpu_torch.resilience import faults
from memvul_tpu_torch.serving import (
    REPLICA_DEAD,
    REPLICA_HEALTHY,
    REPLICA_UNHEALTHY,
    STATUS_DRAIN,
    STATUS_OK,
    HTTPClient,
    LoadConfig,
    Replica,
    ReplicaRouter,
    RouterConfig,
    ScoringService,
    ServiceConfig,
    fleet_snapshot,
    rolling_swap,
    run_slo_harness,
)
from memvul_tpu_torch.serving.frontend import run_http_server
from memvul_tpu_torch.telemetry.exposition import parse_exposition, render_target

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 30.0  # every future is collected within this


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.reset()
    telemetry.reset()


# -- a fake predictor (no model, no timing races) ------------------------------


class _FakeEncoder:
    pad_id = 0

    def __init__(self, max_length=8):
        self.max_length = max_length

    def encode_many(self, texts):
        return [[1] * max(1, min(len(t), self.max_length)) for t in texts]

    def encodes_beyond(self, text, cap):
        return len(text) > cap


class _FakePredictor:
    """The predictor surface a service reads, with a swappable bank; the
    scores depend on the bank's size only, so label and version tearing
    shows without a model.  ``hold`` (an Event) blocks every score."""

    score_impl = "bucketed"
    encoder_precision = "fp32"

    def __init__(self, n_anchors=3, rows=4, length=8):
        self.encoder = _FakeEncoder(length)
        self.n_anchors = n_anchors
        self.anchor_labels = [f"A{i}" for i in range(n_anchors)]
        self.anchor_bank = np.zeros((n_anchors, 2), np.float32)
        self._shapes = [(rows, length)]
        self.hold = None

    def stream_shapes(self):
        return list(self._shapes)

    def encode_bank(self, instances):
        labels = [inst["meta"]["label"] for inst in instances]
        return np.zeros((len(labels), 2), np.float32), labels, len(labels)

    def warmup_bank_shapes(self, bank):
        return 1

    def score_block(self, sample, bank):
        if self.hold is not None:
            assert self.hold.wait(timeout=TIMEOUT), "the test forgot to release hold"
        rows = sample["input_ids"].shape[0]
        return np.tile(np.linspace(0.1, 0.9, bank.shape[0], dtype=np.float32), (rows, 1))


def fake_fleet(n=2, monitor_interval_s=0.05, service_overrides=None, **router_kw):
    overrides = dict(max_batch=4, max_wait_ms=1.0, max_queue=1000, default_deadline_ms=30000.0)
    overrides.update(service_overrides or {})

    def make_factory(i):
        def factory(registry):
            return ScoringService(_FakePredictor(), config=ServiceConfig(**overrides),
                                  registry=registry)
        return factory

    replicas = [Replica(i, make_factory(i)) for i in range(n)]
    router = ReplicaRouter(replicas, config=RouterConfig(monitor_interval_s=monitor_interval_s,
                                                         **router_kw))
    return router, replicas


def assert_fleet_invariant(replicas):
    """Per replica and fleet-wide: served + shed + errors == requests."""
    snap = fleet_snapshot(replicas)
    assert snap["invariant_ok"], snap
    totals = {k: sum(m[k] for m in snap["replicas"])
              for k in ("served", "shed", "errors", "requests")}
    assert totals["served"] + totals["shed"] + totals["errors"] == totals["requests"], totals
    return snap


def _wait_for(predicate, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not predicate():
        time.sleep(0.02)
    return predicate()


# -- the real fleet against the JAX package's ----------------------------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """One tiny archive (JAX-initialised weights), its anchors and texts."""
    tmp = tmp_path_factory.mktemp("fleet")
    ws = build_workspace(tmp / "ws", seed=11)
    vocab = ws["tokenizer"].vocab_size
    cfg = JaxBertConfig.tiny(vocab_size=vocab, scan_layers=True)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(JaxMemoryModel(cfg, header_dim=32).init(jax.random.PRNGKey(0), dummy,
                                                                    dummy))
    config = {
        "tokenizer": {"type": "wordpiece"},
        "dataset_reader": {"type": "reader_memory", "cve_path": ws["paths"]["cve"],
                           "anchor_path": ws["paths"]["anchors"]},
        "model": {"type": "model_memory", "header_dim": 32,
                  "encoder": {"preset": "tiny", "vocab_size": vocab, "scan_layers": True}},
        "serving": {"max_length": 48, "max_batch": 8, "buckets": [16, 48],
                    "default_deadline_ms": 30000},
    }
    archive = jax_archive.save_archive(tmp / "model.tar.gz", config, params,
                                       tokenizer_file=ws["paths"]["tokenizer"])
    reader = MemoryReader(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"])
    anchors = list(reader.read_anchors())
    texts = [inst["text1"] for inst in reader.read(ws["paths"]["test"], split="test")]
    return {"archive": archive, "anchors": anchors, "texts": texts, "ws": ws}


def _drive(router, picks, threads=8):
    results = {}
    lock = threading.Lock()

    def worker(indices):
        for i in indices:
            response = router.submit(picks[i]).result(timeout=TIMEOUT)
            with lock:
                results[i] = response

    pool = [threading.Thread(target=worker, args=(range(k, len(picks), threads),))
            for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(120)
    assert not any(t.is_alive() for t in pool)
    return results


def test_routed_scores_match_the_jax_router(setup):
    """120 concurrent requests through each package's 2-replica router on
    one archive: the same probabilities within rtol 1e-4 / atol 1e-5."""
    picks = [setup["texts"][(7 * i) % len(setup["texts"])] for i in range(120)]
    arch = load_archive(setup["archive"], device="cpu")
    jarch = jax_archive.load_archive(setup["archive"])

    def port_factory(registry):
        predictor = SiamesePredictor(arch.model, arch.tokenizer, batch_size=8, max_length=48,
                                     buckets=[16, 48])
        predictor.encode_anchors(setup["anchors"])
        return ScoringService(predictor, config=ServiceConfig(
            max_batch=8, max_wait_ms=3.0, max_queue=1000, default_deadline_ms=30000.0),
            registry=registry)

    def jax_factory(registry):
        predictor = JaxPredictor(jarch.model, jarch.params, jarch.tokenizer, batch_size=8,
                                 max_length=48, buckets=[16, 48])
        predictor.encode_anchors(setup["anchors"])
        return jax_serving.ScoringService(predictor, config=jax_serving.ServiceConfig(
            max_batch=8, max_wait_ms=3.0, max_queue=1000, default_deadline_ms=30000.0),
            registry=registry)

    port = ReplicaRouter([Replica(i, port_factory) for i in range(2)])
    ref = jax_serving.ReplicaRouter(
        [jax_serving.Replica(i, jax_factory, telemetry_enabled=True) for i in range(2)])
    try:
        got, want = _drive(port, picks), _drive(ref, picks)
    finally:
        port.drain()
        ref.drain()
        jax_telemetry.reset()
    labels = [a["meta"]["label"] for a in setup["anchors"]]
    by_replica = {}
    for i in range(len(picks)):
        assert got[i]["status"] == want[i]["status"] == STATUS_OK, (got[i], want[i])
        assert got[i]["bank_version"] == want[i]["bank_version"] == 1
        np.testing.assert_allclose([got[i]["predict"][a] for a in labels],
                                   [want[i]["predict"][a] for a in labels], rtol=1e-4, atol=1e-5)
        by_replica[got[i]["replica"]] = by_replica.get(got[i]["replica"], 0) + 1
    assert set(by_replica) == {"replica-0", "replica-1"}
    assert assert_fleet_invariant(port.replicas)["served_total"] == len(picks)


def test_fleet_counters_exact_under_many_client_threads():
    """32 client threads (more than the host's cores) against a 2-replica
    fleet with a short switch interval: every request answered, the
    router's counters and the fleet invariant exact (a lost update in a
    shared counter breaks one of them)."""
    router, replicas = fake_fleet(n=2)
    n_threads, per_thread = 32, 12
    statuses = []
    lock = threading.Lock()

    def client(k):
        for i in range(per_thread):
            status = router.submit(f"c{k} r{i}").result(timeout=TIMEOUT)["status"]
            with lock:
                statuses.append(status)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    router.drain()
    assert not any(t.is_alive() for t in threads)
    n = n_threads * per_thread
    assert statuses.count(STATUS_OK) == n
    counters = telemetry.get_registry().snapshot()["counters"]
    assert counters["router.requests"] == counters["router.routed"] == \
        counters["router.served"] == n
    assert assert_fleet_invariant(replicas)["served_total"] == n


# -- routing policy --------------------------------------------------------------


def test_router_picks_least_loaded_healthy_replica():
    router, replicas = fake_fleet(n=2, heartbeat_timeout_s=60.0)
    hold = threading.Event()
    replicas[0].service.predictor.hold = hold
    stuck = []
    try:
        stuck = [replicas[0].submit(f"stuck {i}", deadline_ms=0) for i in range(6)]
        assert _wait_for(lambda: replicas[0].queue_depth > 0, 5)
        routed = [router.submit(f"r {i}").result(timeout=TIMEOUT) for i in range(8)]
        assert all(r["status"] == STATUS_OK for r in routed)
        assert all(r["replica"] == "replica-1" for r in routed)
    finally:
        hold.set()
        for f in stuck:
            f.result(timeout=TIMEOUT)
        router.drain()


def test_router_no_healthy_replica_resolves_error_not_hang():
    router, replicas = fake_fleet(n=2, auto_restart=False)
    for replica in replicas:
        replica.kill(reason="test")
    response = router.submit("nobody home").result(timeout=5)
    assert response["status"] == "error" and "no healthy replica" in response["reason"]
    router.drain()


def test_router_drain_resolves_everything_and_invariant_holds():
    router, replicas = fake_fleet(n=2)
    hold = threading.Event()
    for replica in replicas:
        replica.service.predictor.hold = hold
    futures = [router.submit(f"r {i}", deadline_ms=0) for i in range(16)]
    hold.set()
    router.drain()
    assert {f.result(timeout=TIMEOUT)["status"] for f in futures} <= {STATUS_OK, STATUS_DRAIN}
    assert_fleet_invariant(replicas)
    late = router.submit("late").result(timeout=5)
    assert late["status"] == STATUS_DRAIN


# -- health ------------------------------------------------------------------------


def test_check_health_flags_batch_error_streak_and_recovers():
    router, replicas = fake_fleet(n=1, monitor_interval_s=3600.0, auto_restart=False)
    replica = replicas[0]
    assert replica.check_health(60.0, max_batch_errors=3) == REPLICA_HEALTHY
    replica.registry.counter("serve.dead_letters").inc(3)
    assert replica.check_health(60.0, max_batch_errors=3) == REPLICA_UNHEALTHY
    replica.registry.counter("serve.batches").inc()  # a successful batch ends the streak
    assert replica.check_health(60.0, max_batch_errors=3) == REPLICA_HEALTHY
    router.drain()


def test_check_health_flags_dead_batcher():
    router, replicas = fake_fleet(n=1, monitor_interval_s=3600.0, auto_restart=False)
    replica = replicas[0]
    # a batcher thread that exited without a drain
    replica.service._draining.set()
    replica.service._thread.join(5)
    replica.service._draining.clear()
    assert not replica.service.batcher_alive
    assert replica.check_health(60.0, 3) == REPLICA_DEAD
    assert not replica.accepting.is_set()
    router.drain()


def test_dead_replica_sweep_accounts_lost_requests():
    router, replicas = fake_fleet(n=1, auto_restart=False, monitor_interval_s=3600.0)
    hold = threading.Event()
    replicas[0].service.predictor.hold = hold
    futures = [router.submit(f"r {i}", deadline_ms=0) for i in range(6)]
    assert _wait_for(lambda: replicas[0].service._inflight, 5)
    replicas[0].kill(reason="test")
    hold.set()  # the batcher sees the kill and resolves nothing
    swept = replicas[0].sweep_unresolved()
    assert swept
    snap = assert_fleet_invariant(replicas)
    assert snap["replicas"][0]["errors_lost"] == len(swept)
    router._reclaim(replicas[0], reason="test kill")
    assert all(f.result(timeout=5)["status"] == "error" for f in futures)
    router.drain()


# -- death, reroute, restart ---------------------------------------------------------


@pytest.mark.chaos
def test_replica_kill_fault_reroutes_restarts_and_invariant_holds():
    router, replicas = fake_fleet(n=2, max_reroutes=3)
    warm = [router.submit(f"warm {i}").result(timeout=TIMEOUT) for i in range(8)]
    assert all(r["status"] == STATUS_OK for r in warm)
    faults.configure("replica.kill.replica-0=raise:RuntimeError:chaos kill")
    responses = [router.submit(f"post-kill {i}").result(timeout=TIMEOUT) for i in range(24)]
    assert all(r["status"] == STATUS_OK for r in responses), responses
    assert replicas[0].registry.counter("replica.kills").value == 1
    assert _wait_for(lambda: replicas[0].restart_count == 1
                     and replicas[0].state == REPLICA_HEALTHY)
    served_after = None
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and served_after is None:
        response = router.submit("after restart").result(timeout=TIMEOUT)
        assert response["status"] == STATUS_OK
        if response["replica"] == "replica-0":
            served_after = response
    assert served_after is not None, "the restarted replica never served"
    assert telemetry.get_registry().counter("router.replica_restarts").value == 1
    router.drain()
    assert_fleet_invariant(replicas)


def test_rerouted_request_keeps_trace_id_and_carries_hops():
    router, replicas = fake_fleet(n=2, auto_restart=False,
                                  service_overrides={"trace_sample_rate": 1.0})
    warm = [router.submit(f"warm {i}").result(timeout=TIMEOUT) for i in range(4)]
    assert all(r["status"] == STATUS_OK and "reroutes" not in r for r in warm)
    faults.configure("replica.kill.replica-0=raise:RuntimeError:chaos")
    responses = [router.submit(f"post-kill {i}").result(timeout=TIMEOUT) for i in range(8)]
    assert all(r["status"] == STATUS_OK for r in responses)
    rerouted = [r for r in responses if r.get("reroutes")]
    assert rerouted and all(r["replica"] == "replica-1" for r in rerouted)
    hopped = [t for t in replicas[1].service.recent_traces() if t["hops"] > 0]
    assert len(hopped) == len(rerouted)
    assert all(t["trace_id"].startswith("r-") and t["cause"] == STATUS_OK for t in hopped)
    merged = router.recent_traces()
    assert len(merged) == len(replicas[0].service.recent_traces()) + len(
        replicas[1].service.recent_traces())
    resolved = [t["waypoints"]["resolved"] for t in merged]
    assert resolved == sorted(resolved, reverse=True)
    assert len(router.recent_traces(limit=2)) == 2
    # the four stages partition each served journey
    for t in hopped:
        assert abs(sum(t["stages"].values()) - t["total_s"]) < 1e-6
    router.drain()
    assert_fleet_invariant(replicas)


# -- rolling swap --------------------------------------------------------------------


def test_rolling_swap_under_load_single_version_per_response():
    router, replicas = fake_fleet(n=2)
    old_labels = frozenset(replicas[0].service.bank_labels)
    new_bank = [{"text1": f"sentinel {i}", "meta": {"label": f"S#{i}"}}
                for i in range(len(old_labels))]
    new_labels = frozenset(inst["meta"]["label"] for inst in new_bank)
    counts = {"old": 0, "new": 0, "torn": 0}
    lock = threading.Lock()
    stop = threading.Event()

    def load():
        i = 0
        while not stop.is_set():
            response = router.submit(f"report {i}").result(timeout=TIMEOUT)
            if response["status"] == STATUS_OK:
                keys = frozenset(response["predict"])
                if keys == old_labels and response["bank_version"] == 1:
                    kind = "old"
                elif keys == new_labels and response["bank_version"] == 2:
                    kind = "new"
                else:
                    kind = "torn"
                with lock:
                    counts[kind] += 1
            i += 1

    loaders = [threading.Thread(target=load) for _ in range(4)]
    for t in loaders:
        t.start()
    assert _wait_for(lambda: counts["old"] >= 8, 10)
    version = rolling_swap(router, new_bank, drain_timeout_s=10.0)
    assert _wait_for(lambda: counts["new"] >= 8, 10)
    stop.set()
    for t in loaders:
        t.join(TIMEOUT)
    router.drain()
    assert version == 2 and router.bank_version == 2
    assert counts["torn"] == 0, counts
    assert counts["old"] > 0 and counts["new"] > 0, counts
    assert [r.bank_version for r in replicas] == [2, 2]
    assert assert_fleet_invariant(replicas)


def test_restarted_replica_reinstalls_fleet_bank():
    router, replicas = fake_fleet(n=2, max_reroutes=3)
    new_bank = [{"text1": f"s{i}", "meta": {"label": f"S#{i}"}} for i in range(3)]
    assert rolling_swap(router, new_bank, drain_timeout_s=10.0) == 2
    faults.configure("replica.kill.replica-0=raise:RuntimeError:die")
    for i in range(24):
        assert router.submit(f"r {i}").result(timeout=TIMEOUT)["status"] == STATUS_OK
    assert _wait_for(lambda: replicas[0].restart_count == 1
                     and replicas[0].state == REPLICA_HEALTHY)
    assert replicas[0].bank_version == 2
    assert frozenset(replicas[0].service.bank_labels) == frozenset(
        inst["meta"]["label"] for inst in new_bank)
    assert replicas[0].service.bank_snapshot().source == "rolling_swap"
    router.drain()
    assert_fleet_invariant(replicas)


def test_replica_killed_during_its_install_is_restarted_on_the_fleet_bank():
    """A replica killed while the rolling swap installs into it stays dead
    (the swap does not readmit a dead service); its recovery restarts it
    and re-installs the new fleet bank, and it serves again."""
    router, replicas = fake_fleet(n=2, max_reroutes=3)
    new_bank = [{"text1": f"s{i}", "meta": {"label": f"S#{i}"}} for i in range(3)]
    real_install = replicas[1].install_bank

    def killed_mid_install(*args, **kwargs):
        replicas[1].kill(reason="killed during its install")
        return real_install(*args, **kwargs)

    replicas[1].install_bank = killed_mid_install
    try:
        assert rolling_swap(router, new_bank, drain_timeout_s=10.0) == 2
        replicas[1].install_bank = real_install
        assert _wait_for(lambda: replicas[1].restart_count == 1
                         and replicas[1].state == REPLICA_HEALTHY
                         and replicas[1].bank_version == 2)
        served = {router.submit(f"r {i}").result(timeout=TIMEOUT)["replica"] for i in range(16)}
        assert served == {"replica-0", "replica-1"}
    finally:
        router.drain()
    assert_fleet_invariant(replicas)


# -- the harness, exposition and the front end over a fleet ------------------------------


def test_slo_harness_record_shape_and_invariant():
    router, replicas = fake_fleet(n=2)
    record = run_slo_harness(router, ["a short report", "a rather longer issue report text"],
                             config=LoadConfig(pattern="poisson", requests=64, rps=2000.0, seed=5))
    router.drain()
    load = record["load"]
    assert load["requests"] == 64 and load["outcomes"]["hang"] == 0
    assert load["outcomes"]["ok"] == 64
    assert load["latency_ms"]["p99"] >= load["latency_ms"]["p50"]
    assert record["fleet"]["invariant_ok"] and len(record["fleet"]["replicas"]) == 2
    assert abs(sum(m["utilization"] for m in record["fleet"]["replicas"]) - 1.0) < 1e-6
    assert record["router"]["routed"] == 64
    json.dumps(record)


def test_router_metrics_fan_out_per_replica_labels():
    router, replicas = fake_fleet(n=2)
    try:
        for i in range(12):
            assert router.submit(f"r {i}").result(timeout=TIMEOUT)["status"] == STATUS_OK
        parsed = parse_exposition(render_target(router))
        total = 0
        for replica in replicas:
            label = '{replica="%s"}' % replica.name
            served = replica.registry.snapshot()["counters"]["serve.served"]
            assert parsed["serve_served"][label] == served
            total += served
        assert total == 12
        routed = telemetry.get_registry().snapshot()["counters"]["router.routed"]
        assert parsed["router_routed"][""] == routed == 12
        server = run_http_server(router, port=0)
        try:
            base = "http://%s:%d" % server.server_address[:2]
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                body = r.read().decode()
            assert parse_exposition(body)["serve_requests"].keys() == {
                '{replica="replica-0"}', '{replica="replica-1"}'}
        finally:
            server.shutdown()
    finally:
        router.drain()


def test_http_front_end_serves_router_healthz_fleet_view():
    router, replicas = fake_fleet(n=2, auto_restart=False)
    server = run_http_server(router, port=0)
    try:
        client = HTTPClient("http://127.0.0.1:%d" % server.server_address[1])
        health = client.health()
        assert health["status"] == "ok" and health["bank_version"] == 1
        assert health["replicas"]["total"] == health["replicas"]["healthy"] == 2
        rows = {m["name"]: m for m in health["replicas"]["members"]}
        assert set(rows) == {"replica-0", "replica-1"}
        response = client.score("one routed request")
        assert response["status"] == STATUS_OK and response["replica"] in rows
        replicas[0].kill(reason="test")
        health = client.health()
        assert health["status"] == "degraded" and health["replicas"]["healthy"] == 1
        router.request_drain()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(client.base_url + "/healthz", timeout=10)
        assert err.value.code == 503
    finally:
        server.shutdown()
        router.drain()


def test_http_client_timeout_derived_from_deadline_not_flat():
    fake = _FakePredictor()
    fake.hold = threading.Event()  # wedged until cleanup
    service = ScoringService(fake, config=ServiceConfig(max_batch=4, max_wait_ms=1.0,
                                                        default_deadline_ms=60000.0))
    server = run_http_server(service, port=0)
    try:
        client = HTTPClient("http://127.0.0.1:%d" % server.server_address[1], timeout_s=60.0,
                            deadline_slack_s=0.3)
        t0 = time.monotonic()
        response = client.score("wedge me", deadline_ms=300.0)
        elapsed = time.monotonic() - t0
        assert response["status"] == "error" and "client_timeout" in response["reason"]
        assert elapsed < 10.0, elapsed
    finally:
        fake.hold.set()
        server.shutdown()
        service.drain()


# -- the archive entry point and the CLI -----------------------------------------------


def test_serve_from_archive_replica_fan_out(setup, tmp_path):
    out_dir = tmp_path / "fleet_run"
    router = serve_from_archive(setup["archive"], out_dir=out_dir, device="cpu", replicas=2,
                                overrides={"serving": {"trace_sample_rate": 1.0}})
    try:
        assert isinstance(router, ReplicaRouter) and len(router.replicas) == 2
        # each replica has its own predictor over the one set of weights
        p0, p1 = (r.service.predictor for r in router.replicas)
        assert p0 is not p1 and p0.model is p1.model and p0.stream is None
        assert p0.anchor_bank is not p1.anchor_bank
        for i in range(2):
            assert (out_dir / f"replica-{i}" / "anchor_bank_manifest.json").exists()
        text = setup["texts"][0]
        response = router.submit(text).result(timeout=TIMEOUT)
        assert response["status"] == STATUS_OK
        assert response["replica"] in {"replica-0", "replica-1"}
        want = p0.score_texts([text])[0]
        got = [response["predict"][label] for label in p0.anchor_labels]
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        health = router.health_summary()
        assert health["status"] == "ok" and health["replicas"]["healthy"] == 2
        assert router.slo_monitor is not None and router.recent_traces()
    finally:
        router.drain()
        telemetry.get_registry().close()
    assert not router.slo_monitor._thread.is_alive()
    assert (out_dir / "replica-0" / "events.jsonl").exists()
    with pytest.raises(ValueError, match="replicas"):
        serve_from_archive(setup["archive"], device="cpu", replicas=0)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a host without CUDA")
def test_fleet_for_cuda_raises_on_a_host_without_cuda(setup):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_from_archive(setup["archive"], replicas=2)


def test_cli_serve_replicas_http_round_trip(setup):
    proc = subprocess.Popen(
        [sys.executable, "-m", "memvul_tpu_torch", "serve", str(setup["archive"]), "--port", "0",
         "--device", "cpu", "--replicas", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    try:
        first = proc.stdout.readline()
        assert first, proc.stderr.read()[-2000:]
        line = json.loads(first)
        assert line["replicas"] == 2
        client = HTTPClient(line["serving"])
        responses = [client.score(setup["texts"][i]) for i in range(4)]
        assert all(r["status"] == STATUS_OK for r in responses), responses
        health = client.health()
        assert health["replicas"]["total"] == 2 and "slo" in health
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0, proc.stderr.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


_CHAOS_DRIVER = """
import json, sys, threading, time

sys.path.insert(0, {test_dir!r})
import torch
torch.set_num_threads(1)
from test_torch_fleet import fake_fleet, fleet_snapshot

from memvul_tpu_torch.resilience import faults

router, replicas = fake_fleet(n=2, max_reroutes=3)
for i in range(8):
    assert router.submit(f"warm {{i}}").result(timeout=30)["status"] == "ok"
faults.configure("replica.kill.replica-1=raise:RuntimeError:SIGKILL chaos")

DEADLINE_MS = 10000.0
overdue = []
statuses = {{}}
lock = threading.Lock()

def client(k):
    for i in range(k, 96, 8):
        t0 = time.monotonic()
        response = router.submit(f"report {{i}}", deadline_ms=DEADLINE_MS).result(
            timeout=DEADLINE_MS / 1000.0 + 30.0)
        waited = time.monotonic() - t0
        with lock:
            statuses[response["status"]] = statuses.get(response["status"], 0) + 1
            if waited > DEADLINE_MS / 1000.0 + 5.0:
                overdue.append(round(waited, 3))

threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
for t in threads: t.start()
for t in threads: t.join()
deadline = time.monotonic() + 20
while time.monotonic() < deadline and replicas[1].restart_count == 0:
    time.sleep(0.05)
router.drain()
snapshot = fleet_snapshot(replicas)
counters = replicas[1].registry.snapshot()["counters"]
print(json.dumps({{
    "statuses": statuses,
    "overdue": overdue,
    "invariant_ok": snapshot["invariant_ok"],
    "kills": counters.get("replica.kills", 0),
    "restarts": replicas[1].restart_count,
    "replicas": snapshot["replicas"],
}}))
"""


@pytest.mark.chaos
def test_subprocess_replica_sigkill_mid_load_invariant_and_no_hang(tmp_path):
    """A fresh interpreter runs a 2-replica fleet whose replica-1 is killed
    by the fault point mid-load: from outside, the invariant held and no
    client waited past its deadline."""
    driver = tmp_path / "chaos_driver.py"
    driver.write_text(_CHAOS_DRIVER.format(test_dir=str(Path(__file__).resolve().parent)))
    proc = subprocess.run(
        [sys.executable, str(driver)], capture_output=True, text=True, timeout=240,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.pathsep.join(sys.path)},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert record["kills"] == 1 and record["restarts"] == 1
    assert record["overdue"] == []
    assert sum(record["statuses"].values()) == 96 and record["statuses"].get("ok", 0) > 0
    assert record["invariant_ok"], record["replicas"]
    for member in record["replicas"]:
        assert member["served"] + member["shed"] + member["errors"] == member["requests"], member

"""The port's cross-host balancer (``memvul_tpu_torch/serving/fleet.py``)
against the JAX package's, on the CPU.

* **answers**: a ``HostBalancer`` over two ``LocalHost`` services on a tiny
  archive (JAX-initialised weights) answers 64 requests within rtol 1e-4 /
  atol 1e-5 of the JAX balancer over the same hosts, both hosts used;
* **enumeration**: ``enumerate_hosts`` resolves specs and
  ``MEMVUL_FLEET_HOSTS`` as the JAX package does, and expands
  ``MEMVUL_FLEET_HOST_TEMPLATE`` only over an initialized
  ``torch.distributed`` world;
* **routing, merged endpoints, drain, quarantine, a dead host**, as the
  reference's ``test_serving_fleet.py`` pins them;
* **chaos**: ``host.kill`` (re-routed, restarted) and ``host.stall``
  (caught by the heartbeat age) keep the cross-host invariant ``Σ served +
  shed + errors == Σ requests`` exact;
* **processes**: two ``serve --device cpu`` hosts started at once, host-1's
  process group SIGKILLed while it owes requests: every request answered
  ok and none past its deadline, host-1 restarted; then ``serve --hosts``
  fronts the two hosts over HTTP.

Every future is collected with a bounded ``result(timeout=...)`` and every
wait has a deadline.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
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
from memvul_tpu.serving import fleet as jax_fleet
from memvul_tpu_torch import telemetry
from memvul_tpu_torch.archive import load_archive
from memvul_tpu_torch.data.readers import MemoryReader
from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
from memvul_tpu_torch.resilience import faults
from memvul_tpu_torch.resilience.retry import RetryPolicy
from memvul_tpu_torch.serving import (
    STATUS_OK,
    FleetConfig,
    HostBalancer,
    HostDead,
    HTTPClient,
    LocalHost,
    ProcessHost,
    Replica,
    ReplicaRouter,
    RouterConfig,
    ScoringService,
    ServiceConfig,
    enumerate_hosts,
    fleet_snapshot,
    start_process_hosts,
)
from memvul_tpu_torch.serving.fleet import HOST_DEAD, HOST_HEALTHY, HOST_QUARANTINED

from test_torch_fleet import _FakePredictor

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 30.0


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


def _router_factory(n_replicas=1):
    """A fresh fake-predictor router: one host's target, rebuilt on restart."""

    def build():
        def make_factory(i):
            def factory(registry):
                return ScoringService(_FakePredictor(), config=ServiceConfig(
                    max_batch=4, max_wait_ms=1.0, max_queue=1000, default_deadline_ms=30000.0),
                    registry=registry)
            return factory

        return ReplicaRouter([Replica(i, make_factory(i)) for i in range(n_replicas)],
                             config=RouterConfig(monitor_interval_s=3600.0))

    return build


def local_fleet(n_hosts=2, n_replicas=1, registry=None, **config_kw):
    config_kw.setdefault("monitor_interval_s", 0.05)
    config_kw.setdefault("heartbeat_timeout_s", 60.0)
    hosts = [LocalHost(i, _router_factory(n_replicas)) for i in range(n_hosts)]
    balancer = HostBalancer(hosts, config=FleetConfig(**config_kw), registry=registry,
                            retry_policy=RetryPolicy(attempts=2, backoff=0.01))
    return balancer, hosts


def assert_cross_host_invariant(balancer):
    snap = fleet_snapshot(balancer.members())
    assert snap["invariant_ok"], snap
    return snap


def _wait_for(predicate, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not predicate():
        time.sleep(0.02)
    return predicate()


# -- the tiny archive ------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hosts")
    ws = build_workspace(tmp / "ws", seed=13)
    vocab = ws["tokenizer"].vocab_size
    cfg = JaxBertConfig.tiny(vocab_size=vocab, scan_layers=True)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(JaxMemoryModel(cfg, header_dim=32).init(jax.random.PRNGKey(1), dummy,
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
    return {"archive": archive, "anchors": list(reader.read_anchors()),
            "texts": [inst["text1"] for inst in reader.read(ws["paths"]["test"], split="test")]}


def _drive(balancer, picks, threads=8):
    results = {}
    lock = threading.Lock()

    def worker(indices):
        for i in indices:
            response = balancer.submit(picks[i]).result(timeout=TIMEOUT)
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


def test_balanced_scores_match_the_jax_balancer(setup):
    """64 concurrent requests through each package's balancer over two
    in-process hosts: the same probabilities within rtol 1e-4 / atol 1e-5."""
    picks = [setup["texts"][(5 * i) % len(setup["texts"])] for i in range(64)]
    arch = load_archive(setup["archive"], device="cpu")
    jarch = jax_archive.load_archive(setup["archive"])
    service_kw = dict(max_batch=8, max_wait_ms=3.0, max_queue=1000, default_deadline_ms=30000.0)

    def port_host():
        predictor = SiamesePredictor(arch.model, arch.tokenizer, batch_size=8, max_length=48,
                                     buckets=[16, 48])
        predictor.encode_anchors(setup["anchors"])
        return ScoringService(predictor, config=ServiceConfig(**service_kw))

    def jax_host():
        predictor = JaxPredictor(jarch.model, jarch.params, jarch.tokenizer, batch_size=8,
                                 max_length=48, buckets=[16, 48])
        predictor.encode_anchors(setup["anchors"])
        return jax_serving.ScoringService(predictor,
                                          config=jax_serving.ServiceConfig(**service_kw))

    port = HostBalancer([LocalHost(i, port_host) for i in range(2)],
                        config=FleetConfig(monitor_interval_s=3600.0))
    ref = jax_fleet.HostBalancer([jax_fleet.LocalHost(i, jax_host) for i in range(2)],
                                 config=jax_fleet.FleetConfig(monitor_interval_s=3600.0))
    try:
        got, want = _drive(port, picks), _drive(ref, picks)
    finally:
        port.drain()
        ref.drain()
        jax_telemetry.reset()
    labels = [a["meta"]["label"] for a in setup["anchors"]]
    hosts = set()
    for i in range(len(picks)):
        assert got[i]["status"] == want[i]["status"] == STATUS_OK, (got[i], want[i])
        np.testing.assert_allclose([got[i]["predict"][a] for a in labels],
                                   [want[i]["predict"][a] for a in labels], rtol=1e-4, atol=1e-5)
        hosts.add(got[i]["host"])
    assert hosts == {"host-0", "host-1"}


# -- enumeration -------------------------------------------------------------------


def test_enumerate_hosts_spec_env_and_template(monkeypatch):
    for spec, port in (("a,b:9000,http://c:8080/", 8341), ("a", 9), (" x:1 , ,y ", 7)):
        assert enumerate_hosts(spec, default_port=port) == jax_fleet.enumerate_hosts(
            spec, default_port=port)
    monkeypatch.setenv("MEMVUL_FLEET_HOSTS", "x:1, y:2")
    assert enumerate_hosts() == jax_fleet.enumerate_hosts() == ["http://x:1", "http://y:2"]
    assert enumerate_hosts("z:3") == ["http://z:3"]
    monkeypatch.delenv("MEMVUL_FLEET_HOSTS")
    monkeypatch.setenv("MEMVUL_FLEET_HOST_TEMPLATE", "serve-{i}.svc:8343")
    assert not torch.distributed.is_initialized()
    assert enumerate_hosts() == []  # no process group: never probed
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 3)
    assert enumerate_hosts() == ["http://serve-0.svc:8343", "http://serve-1.svc:8343",
                                 "http://serve-2.svc:8343"]
    monkeypatch.setenv("MEMVUL_FLEET_HOSTS", "x:1")
    assert enumerate_hosts() == ["http://x:1"]


# -- routing and merged endpoints ------------------------------------------------------


def test_balancer_routes_and_stamps_host():
    balancer, _ = local_fleet(n_hosts=2)
    try:
        responses = [balancer.submit(f"r {i}").result(timeout=15) for i in range(16)]
        assert all(r["status"] == STATUS_OK for r in responses)
        assert {r["host"] for r in responses} == {"host-0", "host-1"}
        assert assert_cross_host_invariant(balancer)["served_total"] == 16
    finally:
        balancer.drain()


def test_balancer_merged_healthz_metrics_traces_programs():
    registry = telemetry.configure()
    balancer, _ = local_fleet(n_hosts=2, registry=registry)
    try:
        for i in range(8):
            assert balancer.submit(f"r {i}").result(timeout=15)["status"] == STATUS_OK
        health = balancer.health_summary()
        assert health["status"] == "ok"
        assert (health["hosts"]["total"], health["hosts"]["alive"]) == (2, 2)
        rows = {m["host"]: m for m in health["hosts"]["members"]}
        assert set(rows) == {"host-0", "host-1"}
        assert all(m["target"]["status"] == "ok" for m in rows.values())
        parts = balancer.metrics_snapshots()
        labels = [dict(lbl) for lbl, _ in parts]
        assert {} in labels and any(lbl.get("host") == "host-0" for lbl in labels)
        own = parts[0][1]["counters"]
        assert own.get("fleet.requests") == own.get("fleet.served") == 8
        assert isinstance(balancer.recent_traces(limit=4), list)
        assert all(row["host"] in {"host-0", "host-1"} for row in balancer.programs_snapshot())
    finally:
        balancer.drain()


def test_balancer_drain_sheds_and_resolves():
    balancer, _ = local_fleet(n_hosts=2)
    balancer.drain()
    assert balancer.submit("late").result(timeout=5)["status"] == "drain"


# -- host death and stall ------------------------------------------------------------------


@pytest.mark.chaos
def test_host_kill_fault_reroutes_restarts_and_invariant_holds():
    registry = telemetry.configure()
    balancer, hosts = local_fleet(n_hosts=2, registry=registry)
    try:
        assert all(balancer.submit(f"warm {i}").result(timeout=15)["status"] == STATUS_OK
                   for i in range(8))
        faults.configure("host.kill.host-0=raise:RuntimeError:chaos kill")
        responses = [balancer.submit(f"post-kill {i}", deadline_ms=20000.0).result(timeout=30)
                     for i in range(24)]
        assert all(r["status"] == STATUS_OK for r in responses), responses
        rerouted = [r for r in responses if r.get("host_reroutes")]
        assert rerouted and all(r["host"] == "host-1" for r in rerouted)
        assert _wait_for(lambda: hosts[0].restart_count == 1)
        assert hosts[0].state == HOST_HEALTHY
        counters = registry.snapshot()["counters"]
        assert counters.get("fleet.host_deaths") == counters.get("fleet.host_restarts") == 1
        # the restarted host serves again (requests alternate on an idle fleet)
        after = [balancer.submit(f"after {i}").result(timeout=15) for i in range(4)]
        assert all(r["status"] == STATUS_OK for r in after)
        assert "host-0" in {r["host"] for r in after}
    finally:
        balancer.drain()
    assert_cross_host_invariant(balancer)


@pytest.mark.chaos
def test_host_stall_caught_by_heartbeat_age_and_rerouted():
    registry = telemetry.configure()
    balancer, hosts = local_fleet(n_hosts=2, registry=registry, heartbeat_timeout_s=0.2,
                                  monitor_interval_s=0.05)
    try:
        assert all(balancer.submit(f"warm {i}").result(timeout=15)["status"] == STATUS_OK
                   for i in range(8))
        faults.configure("host.stall.host-0=raise:RuntimeError:wedge")
        futures = [balancer.submit(f"stall {i}", deadline_ms=20000.0) for i in range(8)]
        assert hosts[0]._stalled_at is not None
        responses = [f.result(timeout=30) for f in futures]
        assert all(r["status"] == STATUS_OK for r in responses), responses
        assert any(r.get("host_reroutes") for r in responses)
        assert registry.snapshot()["counters"].get("fleet.host_deaths") == 1
    finally:
        balancer.drain()
    assert_cross_host_invariant(balancer)


def test_quarantine_refusal_is_machine_readable():
    registry = telemetry.configure()
    balancer, hosts = local_fleet(n_hosts=1, registry=registry, auto_restart=False)
    try:
        assert balancer.submit("warm").result(timeout=15)["status"] == STATUS_OK
        hosts[0].kill(reason="test")
        assert _wait_for(lambda: hosts[0].state == HOST_QUARANTINED, timeout=10)
        response = balancer.submit("nobody home").result(timeout=5)
        assert response["status"] == "error"
        assert response["refusal"] == {"error": "fleet_unavailable", "hosts_alive": 0,
                                       "hosts_total": 1, "quarantined": ["host-0"]}
        assert balancer.health_summary()["status"] == "unavailable"
        assert registry.snapshot()["counters"].get("fleet.quarantined") == 1
    finally:
        balancer.drain()


def test_dead_host_submit_raises_hostdead_directly():
    balancer, hosts = local_fleet(n_hosts=2, auto_restart=False)
    try:
        hosts[0].kill(reason="test")
        with pytest.raises(HostDead):
            hosts[0].submit("direct")
        assert hosts[0].state == HOST_DEAD
        response = balancer.submit("routed").result(timeout=15)
        assert response["status"] == STATUS_OK and response["host"] == "host-1"
    finally:
        balancer.drain()


def test_process_host_attach_mode_and_unreachable_reroute():
    with pytest.raises(ValueError, match="exactly one"):
        ProcessHost(0)
    dead = ProcessHost(0, url="http://127.0.0.1:9/")  # the discard port: refused
    assert dead.base_url == "http://127.0.0.1:9"
    response = dead.submit("hello").result(timeout=30)
    assert response["status"] == "error" and response["reason"].startswith("host_unreachable")
    with pytest.raises(HostDead, match="attach-only"):
        dead.restart()
    balancer = HostBalancer([ProcessHost(0, url="http://127.0.0.1:9"),
                             LocalHost(1, _router_factory(1))],
                            config=FleetConfig(monitor_interval_s=3600.0, max_reroutes=2))
    try:
        responses = [balancer.submit(f"r {i}", deadline_ms=20000.0).result(timeout=30)
                     for i in range(8)]
        assert all(r["status"] == STATUS_OK and r["host"] == "host-1" for r in responses)
    finally:
        balancer.drain()


def test_serve_without_archive_balances_the_configured_hosts(setup, monkeypatch, capsys):
    """``serve`` without an archive balances ``--hosts``, else the
    overrides' ``serving.hosts``, else ``MEMVUL_FLEET_HOSTS``, with the
    ``fleet_*`` keys and ``telemetry.tsdb_cadence_s`` of the overrides;
    no hosts at all, or an archive beside ``--hosts``, is a usage error,
    and an archive's config may not set ``serving.hosts``."""
    from memvul_tpu_torch.__main__ import main
    from memvul_tpu_torch.build import serve_from_archive, serve_from_hosts

    monkeypatch.delenv("MEMVUL_FLEET_HOSTS", raising=False)
    assert main(["serve"]) == 2
    assert "an archive is required" in capsys.readouterr().err
    assert main(["serve", str(setup["archive"]), "--hosts", "127.0.0.1:9"]) == 2
    assert "loads no archive" in capsys.readouterr().err
    with pytest.raises(ValueError, match="serving.hosts"):
        serve_from_archive(setup["archive"], device="cpu",
                           overrides={"serving": {"hosts": "127.0.0.1:9"}})
    overrides = json.dumps({"serving": {"hosts": ["127.0.0.1:9", "127.0.0.1:10"],
                                        "fleet_max_restarts": 5},
                            "telemetry": {"tsdb_cadence_s": 60.0}})
    balancer = serve_from_hosts(overrides=overrides)
    try:
        assert [h.base_url for h in balancer.hosts] == ["http://127.0.0.1:9", "http://127.0.0.1:10"]
        assert balancer.config == FleetConfig(max_restarts=5)
        assert balancer.metrics_sampler.cadence_s == 60.0
        assert not hasattr(balancer, "incident_recorder")  # no run dir
    finally:
        balancer.drain(timeout=1.0)
    # the explicit argument wins over the overrides, the environment is last
    monkeypatch.setenv("MEMVUL_FLEET_HOSTS", "127.0.0.1:11")
    balancer = serve_from_hosts("127.0.0.1:12", overrides=overrides)
    assert [h.base_url for h in balancer.hosts] == ["http://127.0.0.1:12"]
    balancer.drain(timeout=1.0)
    balancer = serve_from_hosts()
    assert [h.base_url for h in balancer.hosts] == ["http://127.0.0.1:11"]
    assert not hasattr(balancer, "metrics_sampler")
    balancer.drain(timeout=1.0)


def test_process_host_banner_wait_is_bounded(tmp_path):
    """A host that never prints its banner is killed at the startup
    timeout and raises, instead of blocking its caller."""
    argv = [sys.executable, "-c", "import time; print('not json', flush=True); time.sleep(60)"]
    t0 = time.monotonic()
    with pytest.raises(HostDead, match="no serving banner"):
        ProcessHost(0, argv=argv, startup_timeout_s=1.0)
    assert time.monotonic() - t0 < 15.0


# -- real processes: SIGKILL mid-load, then serve --hosts ------------------------------------


@pytest.mark.chaos
def test_process_hosts_sigkill_mid_load_rerouted_restarted_none_lost(setup, tmp_path):
    """Two ``serve --device cpu`` processes behind the balancer.  Host-1
    coalesces for 1.5 s a batch, so requests wait there; its process group
    is SIGKILLed while it owes some: they are re-routed with their
    original deadlines, every client gets "ok" in time, host-1 restarts.
    Then ``serve --hosts`` fronts both over HTTP."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")

    def argv(max_wait_ms):
        overrides = {"serving": {"max_wait_ms": max_wait_ms, "max_batch": 64,
                                 "default_deadline_ms": 30000}}
        return [sys.executable, "-m", "memvul_tpu_torch", "serve", str(setup["archive"]),
                "--port", "0", "--device", "cpu", "--overrides", json.dumps(overrides)]

    hosts = start_process_hosts([argv(1.0), argv(1500.0)], startup_timeout_s=120.0,
                                env=env, log_path=str(tmp_path / "hosts.log"))
    balancer = HostBalancer(hosts, config=FleetConfig(monitor_interval_s=0.1,
                                                      heartbeat_timeout_s=20.0, max_reroutes=3))
    cli = None
    try:
        assert all(len(h.start_seconds) == 1 for h in hosts)
        deadline_ms = 60000.0
        statuses, overdue, lock = {}, [], threading.Lock()
        responses = []

        def client(k):
            for i in range(k, 48, 8):
                t0 = time.monotonic()
                r = balancer.submit(setup["texts"][i % len(setup["texts"])],
                                    deadline_ms=deadline_ms).result(timeout=deadline_ms / 1e3 + 30)
                with lock:
                    statuses[r["status"]] = statuses.get(r["status"], 0) + 1
                    responses.append(r)
                    if time.monotonic() - t0 > deadline_ms / 1e3:
                        overdue.append(time.monotonic() - t0)

        pool = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in pool:
            t.start()
        # host-1 owes requests (it holds each batch 1.5 s): kill its session
        assert _wait_for(lambda: len(balancer._outstanding["host-1"]) >= 2, timeout=60)
        os.killpg(hosts[1].proc.pid, signal.SIGKILL)
        for t in pool:
            t.join(180)
        assert not any(t.is_alive() for t in pool)
        assert statuses == {"ok": 48} and not overdue, (statuses, overdue)
        assert any(r.get("host_reroutes") for r in responses)
        assert _wait_for(lambda: hosts[1].restart_count == 1 and hosts[1].state == HOST_HEALTHY,
                         timeout=120)
        assert len(hosts[1].start_seconds) == 2
        counters = balancer._tel.snapshot()["counters"]
        assert counters.get("fleet.host_deaths") == counters.get("fleet.host_restarts") == 1
        assert counters.get("fleet.reroutes", 0) >= 1

        # serve --hosts: a balancer process over the two running hosts
        cli = subprocess.Popen(
            [sys.executable, "-m", "memvul_tpu_torch", "serve", "--hosts",
             ",".join(h.base_url for h in hosts), "--port", "0"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        from memvul_tpu_torch.serving.fleet import _read_banner

        banner = _read_banner(cli, 60.0)
        assert banner and banner["hosts"] == 2, cli.stderr.read()[-2000:] if cli.poll() else ""
        front = HTTPClient(banner["serving"])
        r = front.score(setup["texts"][0], deadline_ms=30000)
        assert r["status"] == STATUS_OK and r["host"] in {"host-0", "host-1"}
        health = front.health()
        assert health["hosts"]["total"] == 2
        cli.send_signal(signal.SIGTERM)
        assert cli.wait(60) == 0
    finally:
        if cli is not None and cli.poll() is None:
            cli.kill()
            cli.wait(10)
        balancer.drain()
        for host in hosts:
            host.stop(timeout=10.0)
    assert all(h.proc.poll() is not None for h in hosts)

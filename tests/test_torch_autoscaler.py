"""The port's autoscaler (``memvul_tpu_torch/serving/autoscaler.py``)
against the JAX package's, on the CPU.

* **decisions**: one sequence of scale hints, drawn from a seed with numpy,
  ticked on the same fake clock through both packages' controllers over a
  fake fleet: the same action at every tick, the same replica counts and
  streaks (exact);
* **policy**: hysteresis, cooldowns, bounds, a flapping hint;
* **scale-up**: the spawned replica serves the fleet's current bank;
* **scale-down**: a retire mid-burst completes every in-flight request and
  the invariant holds over the retired member;
* **spawn failure**: a transient ``scaler.spawn`` fault retried, a
  permanent one refused machine-readably;
* ``serve_from_archive`` with ``autoscale_enabled`` on a tiny archive: a
  router from one replica, a spawned replica answering as the first does
  (rtol 1e-4 / atol 1e-5), a scale-down back to one.
"""

import threading
import time

import numpy as np
import pytest
import torch

from memvul_tpu import serving as jax_serving
from memvul_tpu import telemetry as jax_telemetry
from memvul_tpu_torch import telemetry
from memvul_tpu_torch.build import serve_from_archive
from memvul_tpu_torch.resilience import faults
from memvul_tpu_torch.resilience.retry import RetryPolicy
from memvul_tpu_torch.serving import (
    REPLICA_RETIRED,
    STATUS_OK,
    Autoscaler,
    AutoscalerConfig,
    ScoringService,
    ServiceConfig,
    fleet_snapshot,
    rolling_swap,
)

from test_serving_router import _FakePredictor as _JaxFakePredictor
from test_serving_router import fake_fleet as jax_fake_fleet
from test_torch_fleet import _FakePredictor, assert_fleet_invariant, fake_fleet
from test_torch_hosts import setup  # noqa: F401 (the tiny archive fixture)


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


class _ScriptedMonitor:
    """A stand-in SLO monitor whose scale hint the test sets."""

    def __init__(self, hint="hold"):
        self.hint = hint

    def status(self):
        return {"scale_hint": self.hint, "burn_rate_fast": 0.0, "backlog": 0}


SERVICE_KW = dict(max_batch=4, max_wait_ms=1.0, max_queue=1000, default_deadline_ms=30000.0)


def _service_factory(index):
    def factory(registry):
        return ScoringService(_FakePredictor(), config=ServiceConfig(**SERVICE_KW),
                              registry=registry)
    return factory


def _jax_service_factory(index):
    def factory(registry):
        return jax_serving.ScoringService(_JaxFakePredictor(),
                                          config=jax_serving.ServiceConfig(**SERVICE_KW),
                                          registry=registry)
    return factory


def _config(**kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("up_consecutive", 1)
    kw.setdefault("down_consecutive", 1)
    kw.setdefault("up_cooldown_s", 0.0)
    kw.setdefault("down_cooldown_s", 0.0)
    kw.setdefault("drain_timeout_s", 30.0)
    return kw


def make_scaler(router, monitor, registry=None, retry_policy=None, **cfg_kw):
    return Autoscaler(router, replica_factory=_service_factory, slo_monitor=monitor,
                      config=AutoscalerConfig(**_config(**cfg_kw)), registry=registry,
                      retry_policy=retry_policy, start=False)


# -- decisions against the JAX controller ----------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_decisions_match_the_jax_autoscaler(seed):
    rng = np.random.default_rng(seed)
    # runs of one hint, so the streaks, cooldowns and bounds all bind
    hints = []
    while len(hints) < 60:
        hints += [str(rng.choice(["up", "hold", "down"], p=[0.45, 0.2, 0.35]))] * int(
            rng.integers(1, 5))
    cfg = dict(min_replicas=1, max_replicas=4, up_consecutive=2, down_consecutive=3,
               up_cooldown_s=1.0, down_cooldown_s=2.0)
    port_router, _ = fake_fleet(n=1, monitor_interval_s=3600.0)
    jax_router, _ = jax_fake_fleet(n=1, monitor_interval_s=3600.0)
    port_monitor, jax_monitor = _ScriptedMonitor(), _ScriptedMonitor()
    port = make_scaler(port_router, port_monitor, **cfg)
    ref = jax_serving.Autoscaler(jax_router, replica_factory=_jax_service_factory,
                                 slo_monitor=jax_monitor,
                                 config=jax_serving.AutoscalerConfig(**_config(**cfg)),
                                 start=False)
    try:
        got, want = [], []
        for k, hint in enumerate(hints):
            port_monitor.hint = jax_monitor.hint = hint
            now = 100.0 + 0.5 * k
            got.append((port.tick(now=now, sync=True), port.replicas, port.status()["streak"]))
            want.append((ref.tick(now=now, sync=True), ref.replicas, ref.status()["streak"]))
        assert got == want
        assert {a for a, _, _ in got} >= {"up", "down"}
        assert [(p["hint"], p["action"], p["replicas"]) for p in port.history] == \
            [(p["hint"], p["action"], p["replicas"]) for p in ref.history]
    finally:
        port_router.drain()
        jax_router.drain()
        jax_telemetry.reset()
    assert_fleet_invariant(list(port_router.replicas) + list(port_router.retired_replicas))


# -- policy -------------------------------------------------------------------------


def test_hysteresis_cooldowns_and_bounds():
    router, _ = fake_fleet(n=1, monitor_interval_s=3600.0)
    monitor = _ScriptedMonitor("up")
    scaler = make_scaler(router, monitor, up_consecutive=2, down_consecutive=2,
                         up_cooldown_s=10.0, down_cooldown_s=10.0)
    base = time.monotonic()
    try:
        assert scaler.tick(now=base, sync=True) is None
        assert scaler.status()["streak"] == 1
        assert scaler.tick(now=base + 0.1, sync=True) == "up" and scaler.replicas == 2
        assert scaler.tick(now=base + 0.2, sync=True) is None
        assert scaler.status()["cooldown_remaining_s"]["up"] > 0
        assert scaler.tick(now=base + 11.0, sync=True) == "up" and scaler.replicas == 3
        assert scaler.tick(now=base + 22.0, sync=True) is None and scaler.replicas == 3
        monitor.hint = "down"
        assert scaler.tick(now=base + 22.1, sync=True) is None
        assert scaler.tick(now=base + 22.2, sync=True) == "down" and scaler.replicas == 2
        assert scaler.tick(now=base + 33.0, sync=True) == "down" and scaler.replicas == 1
        assert scaler.tick(now=base + 44.0, sync=True) is None and scaler.replicas == 1
        monitor.hint = "hold"
        assert scaler.tick(now=base + 55.0, sync=True) is None
    finally:
        router.drain()


def test_hint_flap_resets_streak_and_config_validation():
    router, _ = fake_fleet(n=1, monitor_interval_s=3600.0)
    monitor = _ScriptedMonitor("up")
    scaler = make_scaler(router, monitor, up_consecutive=3)
    try:
        for now, hint in ((0.0, "up"), (0.1, "up"), (0.2, "hold"), (0.3, "up")):
            monitor.hint = hint
            assert scaler.tick(now=now, sync=True) is None
        assert scaler.replicas == 1
        assert [p["hint"] for p in scaler.history] == ["up", "up", "hold", "up"]
    finally:
        router.drain()
    with pytest.raises(ValueError, match="min_replicas"):
        AutoscalerConfig(min_replicas=0)
    with pytest.raises(ValueError, match="max_replicas"):
        AutoscalerConfig(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError, match="streaks"):
        AutoscalerConfig(up_consecutive=0)


# -- scale-up and scale-down ----------------------------------------------------------


def test_scale_up_spawned_replica_serves_current_bank():
    registry = telemetry.configure()
    router, _ = fake_fleet(n=1, monitor_interval_s=3600.0)
    try:
        new_bank = [{"text1": f"s{i}", "meta": {"label": f"S#{i}"}} for i in range(3)]
        assert rolling_swap(router, new_bank, drain_timeout_s=10.0) == 2
        scaler = make_scaler(router, _ScriptedMonitor("up"), registry=registry)
        assert scaler.tick(now=1.0, sync=True) == "up"
        spawned = router.replicas[-1]
        assert spawned.name == "replica-1" and spawned.bank_version == 2
        served_by = set()
        for i in range(16):
            response = router.submit(f"r {i}").result(timeout=15)
            assert response["status"] == STATUS_OK and response["bank_version"] == 2
            served_by.add(response["replica"])
        assert "replica-1" in served_by
        counters = registry.snapshot()["counters"]
        assert counters.get("scaler.scale_ups") == counters.get("scaler.scale_events") == 1
        assert registry.snapshot()["gauges"].get("scaler.replicas") == 2.0
    finally:
        router.drain()
    assert_fleet_invariant(router.replicas)


def test_retire_mid_burst_completes_every_inflight_request():
    registry = telemetry.configure()
    router, replicas = fake_fleet(n=2, monitor_interval_s=3600.0)
    try:
        hold = threading.Event()
        victim = replicas[-1]
        victim.service.predictor.hold = hold
        futures = [router.submit(f"burst {i}", deadline_ms=0) for i in range(12)]
        time.sleep(0.05)
        scaler = make_scaler(router, _ScriptedMonitor("down"), registry=registry)
        threading.Timer(0.2, hold.set).start()
        assert scaler.tick(now=1.0, sync=True) == "down"
        responses = [f.result(timeout=15) for f in futures]
        assert all(r["status"] == STATUS_OK for r in responses), responses
        assert scaler.replicas == 1 and victim.state == REPLICA_RETIRED
        assert list(router.retired_replicas) == [victim]
        assert registry.snapshot()["counters"].get("scaler.scale_downs") == 1
        snap = assert_fleet_invariant(list(router.replicas) + list(router.retired_replicas))
        assert snap["served_total"] == 12
        after = router.submit("after retire").result(timeout=15)
        assert after["status"] == STATUS_OK and after["replica"] == "replica-0"
    finally:
        router.drain()


def test_retire_refuses_below_min_replicas():
    router, _ = fake_fleet(n=1, monitor_interval_s=3600.0)
    try:
        scaler = make_scaler(router, _ScriptedMonitor("down"), min_replicas=1)
        assert scaler.tick(now=1.0, sync=True) is None and scaler.replicas == 1
        with pytest.raises(ValueError, match="last replica"):
            router.retire_replica(router.replicas[0])
    finally:
        router.drain()


def test_spawn_transient_failure_retried_then_permanent_refused():
    registry = telemetry.configure()
    router, _ = fake_fleet(n=1, monitor_interval_s=3600.0)
    try:
        scaler = make_scaler(router, _ScriptedMonitor("up"), registry=registry, max_replicas=4,
                             retry_policy=RetryPolicy(attempts=3, backoff=0.01))
        faults.configure("scaler.spawn=raise:RuntimeError:UNAVAILABLE injected")
        assert scaler.tick(now=1.0, sync=True) == "up"
        assert scaler.replicas == 2 and scaler.last_refusal is None
        faults.configure("scaler.spawn=raise:RuntimeError:warmup exploded")
        assert scaler.tick(now=2.0, sync=True) == "up"
        assert scaler.replicas == 2
        refusal = scaler.last_refusal
        assert refusal["error"] == "spawn_failed" and refusal["replica"] == "replica-2"
        assert "warmup exploded" in refusal["reason"]
        assert scaler.status()["last_refusal"] == refusal and scaler.status()["scaling"] is False
        counters = registry.snapshot()["counters"]
        assert counters.get("scaler.spawn_failures") == 1
        assert counters.get("scaler.scale_ups") == 1
        assert router.submit("still here").result(timeout=15)["status"] == STATUS_OK
    finally:
        router.drain()


# -- the build path on a tiny archive -------------------------------------------------


def test_serve_from_archive_autoscales_from_one_replica(setup):  # noqa: F811
    overrides = {"serving": {"autoscale_enabled": True, "autoscale_min_replicas": 1,
                             "autoscale_max_replicas": 2, "autoscale_interval_s": 3600.0,
                             "autoscale_up_consecutive": 1, "autoscale_down_consecutive": 1,
                             "autoscale_down_cooldown_s": 0.0,
                             "slo_interval_s": 3600.0, "default_deadline_ms": 30000}}
    with pytest.raises(ValueError, match="requires serving.slo_enabled"):
        serve_from_archive(setup["archive"], device="cpu", overrides={
            "serving": dict(overrides["serving"], slo_enabled=False)})
    router = serve_from_archive(setup["archive"], device="cpu", overrides=overrides)
    try:
        scaler = router.autoscaler
        assert len(router.replicas) == 1 and scaler.config.max_replicas == 2
        scaler.slo_monitor = _ScriptedMonitor("up")
        assert scaler.tick(now=1.0, sync=True) == "up"
        r0, r1 = router.replicas
        assert r1.service.predictor.model is r0.service.predictor.model  # shared weights
        assert r1.service.predictor.programs is not r0.service.predictor.programs
        labels = list(r0.service.predictor.anchor_labels)
        texts = setup["texts"][:6]
        a = [r0.submit(t).result(timeout=30) for t in texts]
        b = [r1.submit(t).result(timeout=30) for t in texts]
        np.testing.assert_allclose([[r["predict"][k] for k in labels] for r in b],
                                   [[r["predict"][k] for k in labels] for r in a],
                                   rtol=1e-4, atol=1e-5)
        assert any(row["replica"] == "replica-1" for row in router.programs_snapshot())
        scaler.slo_monitor = _ScriptedMonitor("down")
        assert scaler.tick(now=2.0, sync=True) == "down"
        assert [r.name for r in router.replicas] == ["replica-0"]
        assert [r.name for r in router.retired_replicas] == ["replica-1"]
        snap = fleet_snapshot(list(router.replicas) + list(router.retired_replicas))
        assert snap["invariant_ok"] and snap["served_total"] == 12
    finally:
        router.drain()

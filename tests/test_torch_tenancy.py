"""The port's named tenants, admission cache, SLO monitor, load generator,
Prometheus exposition and shadow sampling against the JAX package's, on
the CPU.

* ``parse_tenant_spec`` / ``validate_tenant_name``: the same results and
  the same refusals as the JAX functions;
* two tenants on one service of a tiny real model (JAX-initialised
  weights), the scores against the JAX service's (rtol 1e-4 / atol 1e-5),
  and the per-tenant ledgers summing to the service's; the ``bank.resolve``
  fault errors one request only;
* a tenant's rolling swap under load on a fleet leaves the other tenant's
  answers unchanged; ``configure_tenants``, ``promote_tenant`` and
  ``demote_tenant`` over per-tenant stores;
* the admission cache: a hit is bitwise the miss's answer with no device
  call, the LRU is bounded, a swap invalidates one tenant, an armed
  ``cache.lookup`` degrades to a miss, a ``dedup`` harness run reports it;
* ``SLOMonitor.tick(now=)`` on scripted counters: ``status()`` equal to the
  JAX monitor's key for key;
* ``arrival_offsets``, ``request_texts``, ``request_deadlines`` equal to
  the JAX functions for every pattern and three seeds;
* ``render_exposition`` parsed back by both packages to the same series;
* ``ShadowConfig.sample_stride``: the JAX tap's sampled set.
"""

import dataclasses
import hashlib
import threading
import time

import numpy as np
import pytest
import torch

import jax

from memvul_tpu import archive as jax_archive
from memvul_tpu import serving as jax_serving
from memvul_tpu import telemetry as jax_telemetry
from memvul_tpu.bankops import shadow as jax_shadow
from memvul_tpu.data.synthetic import build_workspace
from memvul_tpu.evaluate.predict_memory import SiamesePredictor as JaxPredictor
from memvul_tpu.models import BertConfig as JaxBertConfig
from memvul_tpu.models import MemoryModel as JaxMemoryModel
from memvul_tpu.serving import loadgen as jax_loadgen
from memvul_tpu.serving import slo as jax_slo
from memvul_tpu.serving import tenancy as jax_tenancy
from memvul_tpu.telemetry import exposition as jax_exposition
from memvul_tpu_torch import telemetry
from memvul_tpu_torch.archive import load_archive
from memvul_tpu_torch.bankops import BankDiff, BankStore, PromotionRefused, evaluate_gate
from memvul_tpu_torch.bankops import shadow as port_shadow
from memvul_tpu_torch.data.readers import MemoryReader
from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
from memvul_tpu_torch.resilience import faults
from memvul_tpu_torch.serving import (
    STATUS_ERROR,
    STATUS_OK,
    LoadConfig,
    Replica,
    ReplicaRouter,
    RouterConfig,
    ScoringService,
    ServiceConfig,
    TenantSpecError,
    configure_tenants,
    demote_tenant,
    fleet_snapshot,
    promote_tenant,
    rolling_swap,
    run_slo_harness,
)
from memvul_tpu_torch.serving import loadgen as port_loadgen
from memvul_tpu_torch.serving import slo as port_slo
from memvul_tpu_torch.serving import tenancy as port_tenancy
from memvul_tpu_torch.telemetry import Registry
from memvul_tpu_torch.telemetry import exposition as port_exposition

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


# -- a fake predictor whose scores carry the bank's identity ---------------------


class _CharEncoder:
    """Tokens from the text's characters: identical texts get identical
    sequences, distinct texts distinct ones."""

    pad_id = 0

    def __init__(self, max_length=8):
        self.max_length = max_length

    def encode_many(self, texts):
        return [[(ord(c) % 53) + 2 for c in t[: self.max_length]] or [2] for t in texts]

    def encodes_beyond(self, text, cap):
        return len(text) > cap


def _bank_base(labels):
    digest = hashlib.sha256("|".join(labels).encode("utf-8")).hexdigest()
    return 0.1 + (int(digest[:4], 16) % 600) / 1000.0


class _TenantPredictor:
    """``encode_bank`` writes a label-derived constant into the bank and
    ``score_block`` reads it back, so every response shows which bank
    scored it; ``device_calls`` counts the score calls."""

    score_impl = "bucketed"
    encoder_precision = "fp32"

    def __init__(self, n_anchors=3, rows=4, length=8):
        self.encoder = _CharEncoder(length)
        self.n_anchors = n_anchors
        self.anchor_labels = [f"A{i}" for i in range(n_anchors)]
        self.anchor_bank = np.zeros((n_anchors, 2), np.float32)
        self._shapes = [(rows, length)]
        self.device_calls = 0

    def stream_shapes(self):
        return list(self._shapes)

    def encode_bank(self, instances):
        labels = [inst["meta"]["label"] for inst in instances]
        return np.full((len(labels), 2), _bank_base(labels), np.float32), labels, len(labels)

    def warmup_bank_shapes(self, bank):
        return 1

    def score_block(self, sample, bank):
        self.device_calls += 1
        rows = sample["input_ids"].shape[0]
        return np.tile(float(bank[0, 0]) + np.linspace(0.0, 0.05, bank.shape[0],
                                                        dtype=np.float32), (rows, 1))


ORG_A_BANK = [{"text1": f"alpha anchor {i}", "meta": {"label": f"ALPHA-{i}"}} for i in range(3)]
ORG_B_BANK = [{"text1": f"beta anchor {i}", "meta": {"label": f"BETA-{i}"}} for i in range(3)]
BASE_A = _bank_base([inst["meta"]["label"] for inst in ORG_A_BANK])
BASE_B = _bank_base([inst["meta"]["label"] for inst in ORG_B_BANK])
TOP = 0.05  # every bank's reported score is its base + the linspace max
ANCHORS_V1 = {"CWE-79": "cross-site scripting", "CWE-89": "sql injection",
              "CWE-22": "path traversal"}


def _make_service(**overrides):
    cfg = dict(max_batch=4, max_wait_ms=1.0, max_queue=1000, default_deadline_ms=30000.0)
    cfg.update(overrides)
    predictor = _TenantPredictor()
    return predictor, ScoringService(predictor, config=ServiceConfig(**cfg))


def _tenant_fleet(n=2):
    def factory(registry):
        return ScoringService(_TenantPredictor(), config=ServiceConfig(
            max_batch=4, max_wait_ms=1.0, max_queue=1000, default_deadline_ms=30000.0),
            registry=registry)

    replicas = [Replica(i, factory) for i in range(n)]
    return ReplicaRouter(replicas, config=RouterConfig(monitor_interval_s=0.05)), replicas


def _assert_tenant_ledger_sums(counters, tenants=("default", "orga", "orgb")):
    for what in ("requests", "served", "errors"):
        per_tenant = sum(counters.get(f"serve.{t}.{what}", 0) for t in tenants)
        assert per_tenant == counters.get(f"serve.{what}", 0), (what, counters)


# -- the tenant spec -----------------------------------------------------------------

SPECS = ["orga=/banks/a, orgb=/banks/b,", "org-1_x=/x", "orga", "orga=", "Org=/x",
         "default=/x", "orga=/x,orga=/y", "", ",,", "a b=/x", "x" * 65 + "=/x"]
NAMES = ["org-1_x", "orga", "Org", "a b", "-lead", "", "x" * 64, "x" * 65, "default"]


def _outcome(fn, arg):
    try:
        return ("ok", fn(arg))
    except ValueError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_tenant_spec_matches_jax(spec):
    assert _outcome(port_tenancy.parse_tenant_spec, spec) == _outcome(
        jax_tenancy.parse_tenant_spec, spec)


@pytest.mark.parametrize("name", NAMES)
def test_validate_tenant_name_matches_jax(name):
    assert _outcome(port_tenancy.validate_tenant_name, name) == _outcome(
        jax_tenancy.validate_tenant_name, name)


# -- two tenants on one real service, against the JAX service ---------------------------


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tenancy")
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
    }
    archive = jax_archive.save_archive(tmp / "model.tar.gz", config, params,
                                       tokenizer_file=ws["paths"]["tokenizer"])
    reader = MemoryReader(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"])
    anchors = list(reader.read_anchors())
    texts = [inst["text1"] for inst in reader.read(ws["paths"]["test"], split="test")]
    return {"archive": archive, "anchors": anchors, "texts": texts}


def test_two_tenant_isolation_and_ledger_matches_jax(real):
    anchors, texts = real["anchors"], real["texts"][:12]
    bank_a, bank_b = anchors[:3], anchors[3:7]
    arch = load_archive(real["archive"], device="cpu")
    port_pred = SiamesePredictor(arch.model, arch.tokenizer, batch_size=8, max_length=48,
                                 buckets=[16, 48])
    port_pred.encode_anchors(anchors)
    jarch = jax_archive.load_archive(real["archive"])
    jax_pred = JaxPredictor(jarch.model, jarch.params, jarch.tokenizer, batch_size=8,
                            max_length=48, buckets=[16, 48])
    jax_pred.encode_anchors(anchors)
    cfg = dict(max_batch=8, max_wait_ms=2.0, max_queue=1000, default_deadline_ms=30000.0)
    port = ScoringService(port_pred, config=ServiceConfig(**cfg))
    ref = jax_serving.ScoringService(jax_pred, config=jax_serving.ServiceConfig(**cfg),
                                     registry=jax_telemetry.TelemetryRegistry(enabled=True))
    try:
        for service in (port, ref):
            service.swap_bank(bank_a, tenant="orga")
            service.swap_bank(bank_b, tenant="orgb")
        plan = [(t, tenant) for t in texts for tenant in ("orga", "orgb", None)]
        got = [port.submit(t, tenant=tenant) for t, tenant in plan]
        want = [ref.submit(t, tenant=tenant) for t, tenant in plan]
        for (text, tenant), g, w in zip(plan, got, want):
            g, w = g.result(TIMEOUT), w.result(TIMEOUT)
            assert g["status"] == w["status"] == STATUS_OK
            labels = {"orga": bank_a, "orgb": bank_b, None: anchors}[tenant]
            labels = [a["meta"]["label"] for a in labels]
            assert sorted(g["predict"]) == sorted(labels)
            np.testing.assert_allclose([g["predict"][a] for a in labels],
                                       [w["predict"][a] for a in labels], rtol=1e-4, atol=1e-5)
            assert g["bank_version"] == w["bank_version"] == 1
        ghost = port.submit("x", tenant="ghost").result(TIMEOUT)
        assert ghost["status"] == STATUS_ERROR and "ghost" in ghost["reason"]
    finally:
        port.drain()
        ref.drain()
    counters = port.registry.snapshot()["counters"]
    for tenant in ("orga", "orgb", "default"):
        assert counters[f"serve.{tenant}.requests"] == counters[f"serve.{tenant}.served"] \
            == len(texts)
    assert counters["serve.ghost.errors"] == 1
    _assert_tenant_ledger_sums(counters, ("default", "orga", "orgb", "ghost"))
    assert counters["bank.orga.swaps"] == counters["bank.orgb.swaps"] == 1
    health = port.health_summary()
    assert set(health["tenants"]) == {"orga", "orgb"} and health["bank_version"] == 1


def test_bank_resolve_fault_errors_one_request_only():
    predictor, service = _make_service()
    service.swap_bank(ORG_A_BANK, tenant="orga")
    faults.configure("bank.resolve=raise:RuntimeError:resolver down")
    bad = service.submit("r0", tenant="orga").result(TIMEOUT)
    assert bad["status"] == STATUS_ERROR and "resolver down" in bad["reason"]
    assert service.submit("r1", tenant="orga").result(TIMEOUT)["status"] == STATUS_OK
    service.drain()
    counters = service.registry.snapshot()["counters"]
    assert counters["serve.errors"] == counters["serve.orga.errors"] == 1
    _assert_tenant_ledger_sums(counters, ("default", "orga"))


def test_tenant_swap_never_changes_other_tenant_mid_load():
    router, replicas = _tenant_fleet(n=2)
    try:
        rolling_swap(router, ORG_A_BANK, tenant="orga")
        rolling_swap(router, ORG_B_BANK, tenant="orgb")
        default_version = router.bank_version
        stop = threading.Event()
        b_responses = []

        def hammer_b():
            i = 0
            while not stop.is_set():
                b_responses.append(router.submit(f"b load {i}", tenant="orgb").result(TIMEOUT))
                i += 1

        thread = threading.Thread(target=hammer_b)
        thread.start()
        deadline = time.monotonic() + 10
        while len(b_responses) < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
        new_a = [{"text1": f"alpha prime {i}", "meta": {"label": f"ALPHA2-{i}"}} for i in range(3)]
        assert rolling_swap(router, new_a, tenant="orga") == 2
        seen = len(b_responses)
        while len(b_responses) < seen + 8 and time.monotonic() < deadline + 10:
            time.sleep(0.01)
        stop.set()
        thread.join(TIMEOUT)
        assert b_responses and not thread.is_alive()
        assert all(r["status"] == STATUS_OK for r in b_responses)
        assert {r["bank_version"] for r in b_responses} == {1}
        assert {round(r["score"], 6) for r in b_responses} == {round(BASE_B + TOP, 6)}
        assert router.bank_version == default_version
        rolled = router.submit("post roll", tenant="orga").result(TIMEOUT)
        assert rolled["bank_version"] == 2
        assert rolled["score"] == pytest.approx(
            _bank_base([i["meta"]["label"] for i in new_a]) + TOP, abs=1e-6)
    finally:
        router.drain()
    assert fleet_snapshot(replicas)["invariant_ok"]
    for replica in replicas:
        _assert_tenant_ledger_sums(replica.registry.snapshot()["counters"])


def test_configure_tenants_installs_active_banks(tmp_path):
    store_a = BankStore(tmp_path / "orga")
    store_a.create(ANCHORS_V1, source="build")
    store_b = BankStore(tmp_path / "orgb")
    store_b.create(ANCHORS_V1, source="build")
    store_b.create({"CWE-502": "deserialization of untrusted data"})
    store_b.set_active("v1")  # ACTIVE wins over the latest
    predictor, service = _make_service()
    try:
        manager = configure_tenants(service, f"orga={tmp_path / 'orga'},orgb={tmp_path / 'orgb'}")
        assert service.tenant_manager is manager and manager.tenants == ("orga", "orgb")
        assert manager.live_version("orga") == manager.live_version("orgb") == "v1"
        banks = service.tenant_banks()
        assert set(banks) == {"default", "orga", "orgb"}
        assert (banks["orga"].store_version, banks["orga"].source) == ("v1", "startup")
        assert service.health_summary()["tenancy"] == manager.summary()
        with pytest.raises(TenantSpecError):
            manager.store("ghost")
        with pytest.raises(TenantSpecError):
            configure_tenants(service, f"empty={tmp_path / 'empty'}")
    finally:
        service.drain()


@pytest.mark.parametrize("on_fleet", [False, True])
def test_promote_and_demote_tenant_scoped(tmp_path, on_fleet):
    store = BankStore(tmp_path / "orga")
    store.create(ANCHORS_V1, source="build")
    store.derive("v1", BankDiff.from_json([
        {"op": "add", "category": "CWE-502", "description": "deserialization of untrusted data"}]))
    store.set_active("v1")  # serve v1; v2 is the candidate
    if on_fleet:
        target, replicas = _tenant_fleet(n=2)
    else:
        _, target = _make_service()
    registry = Registry()
    try:
        manager = configure_tenants(target, f"orga={tmp_path / 'orga'}")
        v1 = target.submit("r", tenant="orga").result(TIMEOUT)
        shadow = {"sampled": 200, "flips": 0, "flip_rate": 0.0}
        approved = evaluate_gate({"auc": 0.9, "f1": 0.8}, {"auc": 0.9, "f1": 0.8}, shadow,
                                 candidate="v2", parent="v1")
        assert promote_tenant(target, manager, "orga", approved, registry=registry) == 2
        assert manager.live_version("orga") == "v2" and store.active()["version"] == "v2"
        assert store.promotions()[-1]["tenant"] == "orga"
        v2 = target.submit("r", tenant="orga").result(TIMEOUT)
        assert v2["bank_version"] == 2 and v2["score"] != v1["score"]
        assert target.bank_version == 1  # the default tenant's bank never moved
        if on_fleet:
            assert [r.service.tenant_banks()["orga"].version for r in replicas] == [2, 2]
        assert demote_tenant(target, manager, "orga", registry=registry) == {
            "version": "v1", "serving_version": 3}
        assert manager.live_version("orga") == "v1"
        assert target.submit("r", tenant="orga").result(TIMEOUT)["score"] == v1["score"]
        refused = evaluate_gate({"auc": 0.9, "f1": 0.8}, {"auc": 0.5, "f1": 0.2}, shadow,
                                candidate="v2", parent="v1")
        with pytest.raises(PromotionRefused):
            promote_tenant(target, manager, "orga", refused, registry=registry)
        assert manager.live_version("orga") == "v1"
        assert store.promotions()[-1]["kind"] == "promotion_refused"
        counters = registry.snapshot()["counters"]
        assert counters["bank.promotions"] == counters["bank.demotions"] == 1
    finally:
        target.drain()


# -- the admission cache ---------------------------------------------------------------


def test_cache_hit_is_bitwise_identical_and_skips_device():
    predictor, service = _make_service(cache_capacity=8)
    try:
        cold = service.submit("dup report").result(TIMEOUT)
        assert cold["status"] == STATUS_OK and "cached" not in cold
        calls = predictor.device_calls
        warm = service.submit("dup report").result(TIMEOUT)
        assert warm["status"] == STATUS_OK and warm["cached"] is True
        assert predictor.device_calls == calls  # the hit never reached the scorer
        for field in ("predict", "score", "anchor", "bank_version"):
            assert warm[field] == cold[field], field
        assert "cached" not in service.submit("dup report!").result(TIMEOUT)
    finally:
        service.drain()
    counters = service.registry.snapshot()["counters"]
    assert (counters["cache.hits"], counters["cache.misses"]) == (1, 2)
    assert counters["cache.tokens_saved"] >= 1
    assert counters["serve.served"] == counters["serve.requests"] == 3


def test_cache_lru_eviction_is_bounded():
    predictor, service = _make_service(cache_capacity=1)
    try:
        for text in ("a report", "b report", "a report"):
            assert service.submit(text).result(TIMEOUT)["status"] == STATUS_OK
        assert len(service.admission_cache) == 1
    finally:
        service.drain()
    snap = service.registry.snapshot()
    assert snap["counters"].get("cache.hits", 0) == 0  # "a" was evicted by "b"
    assert snap["counters"]["cache.misses"] == 3 and snap["counters"]["cache.evictions"] >= 1
    assert snap["gauges"]["cache.size"] == 1


def test_cache_invalidation_is_per_tenant_on_swap():
    predictor, service = _make_service(cache_capacity=8)
    try:
        service.swap_bank(ORG_A_BANK, tenant="orga")
        service.swap_bank(ORG_B_BANK, tenant="orgb")
        for tenant in ("orga", "orgb"):
            assert "cached" not in service.submit("t", tenant=tenant).result(TIMEOUT)
            assert service.submit("t", tenant=tenant).result(TIMEOUT)["cached"] is True
        new_b = [{"text1": f"beta prime {i}", "meta": {"label": f"BETA2-{i}"}} for i in range(3)]
        service.swap_bank(new_b, tenant="orgb")
        assert service.submit("t", tenant="orga").result(TIMEOUT)["cached"] is True
        fresh_b = service.submit("t", tenant="orgb").result(TIMEOUT)
        assert "cached" not in fresh_b and fresh_b["bank_version"] == 2
        assert fresh_b["score"] == pytest.approx(
            _bank_base([i["meta"]["label"] for i in new_b]) + TOP, abs=1e-6)
    finally:
        service.drain()
    assert service.registry.snapshot()["counters"]["cache.invalidations"] >= 1


def test_cache_lookup_fault_degrades_to_miss():
    predictor, service = _make_service(cache_capacity=8)
    try:
        first = service.submit("c report").result(TIMEOUT)
        faults.configure("cache.lookup=raise:RuntimeError:cache on fire")
        degraded = service.submit("c report").result(TIMEOUT)
        assert degraded["status"] == STATUS_OK and "cached" not in degraded
        assert degraded["score"] == first["score"]
        assert service.submit("c report").result(TIMEOUT)["cached"] is True
    finally:
        service.drain()
    counters = service.registry.snapshot()["counters"]
    assert counters["cache.errors"] == counters["cache.hits"] == 1
    assert counters["serve.served"] == counters["serve.requests"] == 3


def test_slo_harness_dedup_load_reports_cache_block():
    predictor, service = _make_service(cache_capacity=64)
    try:
        record = run_slo_harness(service, [f"text {i}" for i in range(16)], config=LoadConfig(
            pattern="dedup", requests=64, rps=2000.0, dedup_unique=4, seed=3))
    finally:
        service.drain()
    assert record["load"]["outcomes"]["hang"] == 0
    cache = record["cache"]
    assert cache["hits"] > 0 and cache["hits"] + cache["misses"] == 64
    assert cache["hit_rate"] == pytest.approx(cache["hits"] / 64, abs=1e-4)
    assert cache["device_calls_avoided"] == cache["hits"] and cache["hit_rate"] >= 0.5


# -- the SLO monitor against the JAX monitor ----------------------------------------------


class _StubTarget:
    """``metrics_snapshots()`` and ``queue_depth`` with counters, a p95 and
    a batch occupancy the test writes."""

    def __init__(self):
        self.counters = {name: 0 for name in ("serve.requests", "serve.served", "serve.shed",
                                              "serve.errors", "serve.shed_overflow",
                                              "serve.shed_deadline")}
        self.p95_s = None
        self.occupancy = None
        self.queue_depth = 0

    def metrics_snapshots(self):
        hists = {}
        if self.p95_s is not None:
            hists["serve.latency_s"] = {"count": 1.0, "total": self.p95_s, "mean": self.p95_s,
                                        "min": self.p95_s, "max": self.p95_s, "p50": self.p95_s,
                                        "p95": self.p95_s}
        if self.occupancy is not None:
            count, total = self.occupancy
            hists["serve.batch_occupancy"] = {"count": count, "total": total}
        return [({}, {"counters": dict(self.counters), "gauges": {}, "histograms": hists})]


def _serve(t, n):
    t.counters["serve.requests"] += n
    t.counters["serve.served"] += n


def _fail(t, n):
    t.counters["serve.requests"] += n
    t.counters["serve.errors"] += n


def _overflow(t, n):
    t.counters["serve.requests"] += n
    t.counters["serve.shed"] += n
    t.counters["serve.shed_overflow"] += n


def _set(attr, value):
    return lambda t: setattr(t, attr, value)


# each scenario: (seconds after the previous tick, the change before the tick)
SLO_SCENARIOS = {
    "no_traffic": [(0, None), (5, None), (5, None)],
    "errors_burn": [(0, None), (10, lambda t: _serve(t, 90)), (10, lambda t: _fail(t, 10))],
    "recovers_after_aging_out": [(0, lambda t: _fail(t, 50)), (10, lambda t: _serve(t, 10)),
                                 (200, lambda t: _serve(t, 100)), (200, lambda t: _serve(t, 100)),
                                 (200, lambda t: _serve(t, 50))],
    "backlog_and_overflow": [(0, None), (5, _set("queue_depth", 70)),
                             (5, _set("queue_depth", 0)), (5, lambda t: _overflow(t, 3))],
    "latency_breach": [(0, None), (5, lambda t: (_serve(t, 10), _set("p95_s", 0.5)(t))),
                       (5, lambda t: (_serve(t, 10), _set("p95_s", 0.01)(t)))],
    "quiet_underfilled_scales_down": [(0, _set("occupancy", (1.0, 0.1))),
                                      (5, lambda t: (_serve(t, 4),
                                                     _set("occupancy", (5.0, 0.6))(t))),
                                      (5, lambda t: _serve(t, 2))],
    "inflight_clamp": [(0, lambda t: t.counters.__setitem__("serve.requests", 3)),
                       (10, lambda t: (t.counters.__setitem__("serve.served", 3),
                                       _serve(t, 10)))],
}


@pytest.mark.parametrize("scenario", sorted(SLO_SCENARIOS))
def test_slo_monitor_status_matches_jax(scenario):
    config = dict(availability_objective=0.99, latency_p95_ms=100.0, fast_window_s=60.0,
                  window_s=300.0, interval_s=5.0)
    port_target, jax_target = _StubTarget(), _StubTarget()
    port_reg = Registry()
    jax_reg = jax_telemetry.TelemetryRegistry(enabled=True)
    port_mon = port_slo.SLOMonitor(port_target, registry=port_reg,
                                   config=port_slo.SLOConfig(**config), capacity=100, start=False)
    jax_mon = jax_slo.SLOMonitor(jax_target, registry=jax_reg, config=jax_slo.SLOConfig(**config),
                                 capacity=100, start=False)
    now = 1000.0
    for dt, change in SLO_SCENARIOS[scenario]:
        now += dt
        if change is not None:
            change(port_target)
            change(jax_target)
        got, want = port_mon.tick(now=now), jax_mon.tick(now=now)
        assert got == want, (scenario, now)
        assert port_mon.status() == jax_mon.status()
    gauges = port_reg.snapshot()["gauges"]
    assert {k: v for k, v in gauges.items() if k.startswith("slo.")} == \
        {k: v for k, v in jax_reg.snapshot()["gauges"].items() if k.startswith("slo.")}


def test_slo_config_validation_and_capacity_match_jax():
    for kw in (dict(availability_objective=1.0), dict(fast_window_s=600.0, window_s=300.0)):
        with pytest.raises(ValueError) as port_err:
            port_slo.SLOConfig(**kw)
        with pytest.raises(ValueError) as jax_err:
            jax_slo.SLOConfig(**kw)
        assert str(port_err.value) == str(jax_err.value)
    _, service = _make_service(max_queue=64)
    router, _ = _tenant_fleet(n=2)
    try:
        assert port_slo._infer_capacity(service) == jax_slo._infer_capacity(service) == 64
        assert port_slo._infer_capacity(router) == 2000
        assert port_slo._infer_capacity(object()) == 256
    finally:
        service.drain()
        router.drain()


# -- the load generator against the JAX package's --------------------------------------


@pytest.mark.parametrize("seed", [0, 4, 9])
@pytest.mark.parametrize("pattern", ["closed", "poisson", "burst", "diurnal", "slowloris",
                                     "dedup"])
def test_loadgen_schedules_match_jax(pattern, seed):
    kw = dict(pattern=pattern, requests=96, rps=500.0, seed=seed, deadline_ms=5000.0,
              abuser_frac=0.25, burst_size=16, dedup_unique=8, template_prefix="TPL: ")
    port_cfg, jax_cfg = port_loadgen.LoadConfig(**kw), jax_loadgen.LoadConfig(**kw)
    texts = [f"text {i}" for i in range(40)]
    assert port_loadgen.arrival_offsets(port_cfg) == jax_loadgen.arrival_offsets(jax_cfg)
    assert port_loadgen.request_texts(port_cfg, texts) == jax_loadgen.request_texts(jax_cfg,
                                                                                    texts)
    assert port_loadgen.request_deadlines(port_cfg) == jax_loadgen.request_deadlines(jax_cfg)


def test_loadgen_refusals_match_jax():
    for kw in (dict(pattern="sawtooth"), dict(requests=0)):
        with pytest.raises(ValueError) as port_err:
            port_loadgen.LoadConfig(**kw)
        with pytest.raises(ValueError) as jax_err:
            jax_loadgen.LoadConfig(**kw)
        assert str(port_err.value) == str(jax_err.value)
    cfg = port_loadgen.LoadConfig(pattern="dedup", requests=200, dedup_unique=8, seed=7)
    first = port_loadgen.request_texts(cfg, [f"text {i}" for i in range(50)])
    assert sorted((first.count(t) for t in set(first)), reverse=True)[0] > 200 // 8
    assert port_loadgen.request_texts(dataclasses.replace(cfg, seed=8),
                                      [f"text {i}" for i in range(50)]) != first
    with pytest.raises(ValueError):
        port_loadgen.request_texts(cfg, [])


# -- exposition against the JAX package's ----------------------------------------------


def test_exposition_parses_back_to_the_same_series_in_both_packages():
    registry = Registry()
    registry.counter("serve.served").inc(7)
    registry.counter("bank.anchor_wins.CWE-79").inc(3)
    registry.gauge("serve.queue_depth").set(2)
    registry.gauge("slo.scale_hint").set(-1.0)
    for v in (0.001, 0.004, 0.009, 0.25):
        registry.histogram("serve.latency_s").observe(v)
    other = Registry()
    other.counter("serve.served").inc(5)
    other.gauge("weird\nlabel").set(1.5)
    parts = [({}, registry.snapshot()), ({"replica": 'replica-"1"\\'}, other.snapshot())]
    text = port_exposition.render_exposition(parts)
    assert text == jax_exposition.render_exposition(parts)
    series = port_exposition.parse_exposition(text)
    assert series == jax_exposition.parse_exposition(text)
    assert series["serve_served"][""] == 7.0
    assert series["bank_anchor_wins_CWE_79"][""] == 3.0
    assert series["serve_latency_s_count"][""] == 4.0
    assert series["serve_latency_s"]['{quantile="0.95"}'] == pytest.approx(0.25)
    assert len(series["serve_served"]) == 2
    for bad in ("not a sample line at all !", "x{a=\"b\"} "):
        with pytest.raises(ValueError):
            port_exposition.parse_exposition(bad)
    assert port_exposition.sanitize_metric_name("9x.y") == jax_exposition.sanitize_metric_name(
        "9x.y") == "_9x_y"


# -- shadow sampling against the JAX tap ------------------------------------------------


class _RecordingPredictor:
    def __init__(self):
        self.scored = []

    def encode_bank(self, instances):
        return np.zeros((len(instances), 2), np.float32), [i["meta"]["label"] for i in instances], \
            len(instances)

    def score_texts(self, texts, bank, n):
        self.scored.extend(texts)
        return np.full((len(texts), n), 0.5, np.float32)


class _ShadowTarget:
    def __init__(self):
        self.predictor = _RecordingPredictor()
        self.registry = Registry()

    def bank_snapshot(self):
        return type("Bank", (), {"array": np.zeros((2, 2), np.float32)})()

    def set_shadow_tap(self, tap):
        self.tap = tap

    def clear_shadow_tap(self):
        self.tap = None


@pytest.mark.parametrize("stride", [1, 3, 7])
def test_shadow_sample_stride_samples_the_jax_taps_set(stride):
    candidate = [{"text1": "c0", "meta": {"label": "C0"}}, {"text1": "c1", "meta": {"label": "C1"}}]
    bank = type("Bank", (), {"labels": ("A0", "A1"), "version": 1})()
    chunks = [[f"t{i}-{j}" for j in range(n)] for i, n in enumerate((1, 4, 2, 9, 3, 5))]
    sampled = {}
    for name, shadow in (("port", port_shadow), ("jax", jax_shadow)):
        target = _ShadowTarget()
        scorer = shadow.ShadowScorer(target, candidate,
                                     config=shadow.ShadowConfig(sample_stride=stride, max_queue=512))
        for chunk in chunks:
            target.tap(chunk, np.full((len(chunk), 2), 0.7, np.float32), bank)
        summary = scorer.stop()
        sampled[name] = (target.predictor.scored, summary["sampled"])
    assert sampled["port"] == sampled["jax"]
    n = sum(len(c) for c in chunks)
    assert sampled["port"][1] == -(-n // stride)
    with pytest.raises(ValueError, match="sample_stride"):
        port_shadow.ShadowScorer(_ShadowTarget(), candidate,
                                 config=port_shadow.ShadowConfig(sample_stride=0))

"""The port's serving path against the JAX package's: the ragged
predictor's ``score_texts`` against the JAX ragged predictor on one
archive (rtol 1e-4 / atol 1e-5), the port's ragged and bucketed paths
against each other (1e-6), the scoring service under 200 concurrent
mixed-length requests for every dispatch strategy, its admission statuses
(deadline, shed, drain), the continuous packer's page table, and
``serve_from_archive`` / ``python -m memvul_tpu_torch serve`` on the CPU
with an HTTP round trip."""

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
from memvul_tpu.data.synthetic import build_workspace
from memvul_tpu.evaluate.predict_memory import SiamesePredictor as JaxPredictor
from memvul_tpu.models import BertConfig as JaxBertConfig
from memvul_tpu.models import MemoryModel as JaxMemoryModel
from memvul_tpu_torch.archive import load_archive
from memvul_tpu_torch.build import serve_from_archive
from memvul_tpu_torch.config import serving_config
from memvul_tpu_torch.data.batching import collate_ragged
from memvul_tpu_torch.data.readers import MemoryReader
from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
from memvul_tpu_torch.serving import HTTPClient, InprocessClient, ScoringService, ServiceConfig
from memvul_tpu_torch.serving.frontend import run_http_server

ROOT = Path(__file__).resolve().parents[1]
PACK = dict(token_budget=96, max_rows_per_pack=8)
SERVE_OVERRIDES = {"serving": {"score_impl": "ragged", "max_length": 48, "max_batch": 8,
                               "token_budget": 96, "default_deadline_ms": 30000}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from many intra-op threads, and the test
    workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """One tiny archive (JAX-initialised weights), the port's bucketed,
    ragged and continuous predictors on it, and its test texts."""
    tmp = tmp_path_factory.mktemp("serving")
    ws = build_workspace(tmp / "ws", seed=11)
    vocab = ws["tokenizer"].vocab_size
    cfg = JaxBertConfig.tiny(vocab_size=vocab, scan_layers=True)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(JaxMemoryModel(cfg, header_dim=32).init(jax.random.PRNGKey(0), dummy, dummy))
    config = {
        "tokenizer": {"type": "wordpiece"},
        "dataset_reader": {"type": "reader_memory", "cve_path": ws["paths"]["cve"],
                           "anchor_path": ws["paths"]["anchors"]},
        "model": {"type": "model_memory", "header_dim": 32,
                  "encoder": {"preset": "tiny", "vocab_size": vocab, "scan_layers": True}},
    }
    archive = jax_archive.save_archive(tmp / "model.tar.gz", config, params,
                                       tokenizer_file=ws["paths"]["tokenizer"])
    arch = load_archive(archive, device="cpu")
    reader = MemoryReader(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"])
    anchors = list(reader.read_anchors())
    texts = [inst["text1"] for inst in reader.read(ws["paths"]["test"], split="test")]

    def predictor(**kw):
        p = SiamesePredictor(arch.model, arch.tokenizer, batch_size=8, max_length=48, **kw)
        p.encode_anchors(anchors)
        return p

    return {
        "archive": archive, "anchors": anchors, "texts": texts,
        "bucketed": predictor(buckets=[16, 48]),
        "ragged": predictor(score_impl="ragged", **PACK),
        "continuous": predictor(score_impl="continuous", **PACK),
        "predictor": predictor,
    }


def _picks(texts, n):
    return [texts[(7 * i) % len(texts)] for i in range(n)]


def _probs(response, labels):
    return np.array([response["predict"][label] for label in labels], np.float32)


# -- predictor ----------------------------------------------------------------


def test_ragged_score_texts_matches_jax(setup):
    texts = _picks(setup["texts"], 60)
    jarch = jax_archive.load_archive(setup["archive"])
    jpred = JaxPredictor(jarch.model, jarch.params, jarch.tokenizer, batch_size=8, max_length=48,
                         aot_warmup=False, score_impl="ragged", **PACK)
    jpred.encode_anchors(setup["anchors"])
    want = np.asarray(jpred.score_texts(texts))
    got = setup["ragged"].score_texts(texts)
    assert got.shape == want.shape == (60, len(setup["anchors"]))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_ragged_score_texts_matches_bucketed(setup):
    texts = _picks(setup["texts"], 60)
    want = setup["bucketed"].score_texts(texts)
    for impl in ("ragged", "continuous"):
        np.testing.assert_allclose(setup[impl].score_texts(texts), want, atol=1e-6, rtol=0)
    # impl="bucketed" routes a packed predictor through bucket blocks
    np.testing.assert_allclose(setup["ragged"].score_texts(texts, impl="bucketed"), want,
                               atol=1e-6, rtol=0)


def test_predictor_shapes_and_warmup(setup):
    ragged, bucketed = setup["ragged"], setup["bucketed"]
    assert ragged.ragged_shape() == (96, 8) and ragged.uses_ragged_program
    assert not bucketed.uses_ragged_program
    assert bucketed.stream_shapes() == [(8, 16), (8, 48)]
    assert ragged.warmup_compile() == 1
    assert bucketed.warmup_compile() == 2
    assert ragged.score_texts([]).shape == (0, len(setup["anchors"]))


def test_predictor_ragged_validation(setup):
    with pytest.raises(ValueError, match="score_impl"):
        setup["predictor"](score_impl="raggedy")
    with pytest.raises(ValueError, match="token_budget"):
        setup["predictor"](score_impl="ragged", token_budget=32)
    with pytest.raises(ValueError, match="int8 tier"):
        setup["predictor"](score_impl="cascade")
    with pytest.raises(ValueError, match="not cascadable"):
        setup["predictor"](score_impl="ragged", encoder_precision="int8", **PACK)
    with pytest.raises(ValueError, match="cascade band"):
        setup["predictor"](score_impl="cascade", encoder_precision="int8", cascade_low=0.8,
                           cascade_high=0.2)
    with pytest.raises(RuntimeError, match="encoder_precision='int8'"):
        setup["ragged"].score_texts(["x"], impl="int8")
    with pytest.raises(ValueError, match="impl"):
        setup["ragged"].score_texts(["x"], impl="int4")


# -- service ------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["bucketed", "ragged", "continuous"])
def test_service_concurrent_mixed_load_matches_bucketed(setup, impl):
    """200 concurrent mixed-length requests from 16 threads: every
    response ok and within 1e-6 of the bucketed ``score_texts``."""
    n = 200
    picks = _picks(setup["texts"], n)
    expected = setup["bucketed"].score_texts(picks)
    predictor = setup[impl]
    service = ScoringService(predictor, config=ServiceConfig(
        max_batch=8, max_wait_ms=3.0, max_queue=1000, default_deadline_ms=30000.0))
    client = InprocessClient(service)
    results = {}
    lock = threading.Lock()

    def worker(indices):
        for i in indices:
            response = client.score(picks[i])
            with lock:
                results[i] = response

    threads = [threading.Thread(target=worker, args=(range(k, n, 16),)) for k in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # more thread switches: a lost update shows in the counters
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    service.drain()
    assert not any(t.is_alive() for t in threads)
    assert len(results) == n
    for i in range(n):
        assert results[i]["status"] == "ok", results[i]
        np.testing.assert_allclose(_probs(results[i], predictor.anchor_labels), expected[i],
                                   atol=1e-6, rtol=0)
    counters = service.registry.snapshot()["counters"]
    assert counters["serve.served"] == counters["serve.requests"] == n
    assert 0 < counters["serve.tokens_real"] <= counters["serve.tokens_padded"]
    if impl != "bucketed":
        assert counters["serve.tokens_padded"] == 96 * counters["serve.batches"]


class _Gate:
    """Wraps a predictor's score function so the first device call blocks
    until released: the rest of the traffic then queues behind it."""

    def __init__(self, predictor, name):
        self.inner = getattr(predictor, name)
        self.entered = threading.Event()
        self.release = threading.Event()
        self.samples = []

    def __call__(self, sample, bank):
        self.samples.append({k: v.copy() for k, v in sample.items()})
        self.entered.set()
        assert self.release.wait(30)
        return self.inner(sample, bank)


def _gated_service(setup, impl, monkeypatch, **cfg):
    predictor = setup[impl]
    name = "score_block" if impl == "bucketed" else "score_ragged_sample"
    gate = _Gate(predictor, name)
    monkeypatch.setattr(predictor, name, gate)
    config = dict(max_batch=8, max_wait_ms=1.0, default_deadline_ms=30000.0)
    config.update(cfg)
    return ScoringService(predictor, config=ServiceConfig(**config)), gate


@pytest.mark.parametrize("impl", ["bucketed", "ragged"])
def test_deadline_expires_at_the_pull(setup, impl, monkeypatch):
    service, gate = _gated_service(setup, impl, monkeypatch)
    first = service.submit(setup["texts"][0])
    assert gate.entered.wait(30)
    late = service.submit(setup["texts"][1], deadline_ms=1.0)
    time.sleep(0.05)
    gate.release.set()
    assert first.result(30)["status"] == "ok"
    assert late.result(30) == {"status": "deadline"}
    service.drain()
    counters = service.registry.snapshot()["counters"]
    assert counters["serve.shed_deadline"] == 1 and counters["serve.served"] == 1


@pytest.mark.parametrize("impl", ["ragged", "continuous"])
def test_overflow_sheds_the_oldest_and_drain_resolves_the_queue(setup, impl, monkeypatch):
    service, gate = _gated_service(setup, impl, monkeypatch, max_queue=2, max_batch=1)
    texts = setup["texts"]
    pulled = [service.submit(texts[0])]
    assert gate.entered.wait(30)
    if impl == "continuous":
        # behind the pack on the card: one sealed pack in the handoff, and
        # one more that the admission loop holds while the handoff is full
        for i in (1, 2):
            pulled.append(service.submit(texts[i]))
            deadline = time.monotonic() + 10
            while service.queue_depth and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.05)  # its pack seals after max_wait_ms
    queued = [service.submit(texts[i]) for i in range(3, 6)]
    assert queued[0].result(5) == {"status": "shed"}
    service.request_drain()
    gate.release.set()
    service.drain()
    assert [f.result(30)["status"] for f in pulled] == ["ok"] * len(pulled)
    assert [f.result(30)["status"] for f in queued[1:]] == ["drain", "drain"]
    assert service.submit(texts[0]).result(5) == {"status": "drain"}
    counters = service.registry.snapshot()["counters"]
    assert counters["serve.shed_overflow"] == 1 and counters["serve.shed_drain"] == 3
    assert counters["serve.served"] + counters["serve.shed"] == counters["serve.requests"]


@pytest.mark.parametrize("impl", ["ragged", "continuous"])
def test_hard_kill_leaves_work_unresolved_for_the_sweep(setup, impl, monkeypatch):
    service, gate = _gated_service(setup, impl, monkeypatch, max_batch=1)
    texts = setup["texts"]
    futures = [service.submit(texts[0])]
    assert gate.entered.wait(30)
    futures += [service.submit(texts[i]) for i in (1, 2)]
    service.hard_kill()
    gate.release.set()
    pending = service.take_unresolved(timeout=30)
    assert sorted(id(r.future) for r in pending) == sorted(id(f) for f in futures)
    assert not any(f.done() for f in futures)


def test_continuous_pack_equals_collate_of_its_admissions(setup, monkeypatch):
    """Each pack the device worker scores is ``collate_ragged`` of the
    requests admitted into it, in admission (submission) order."""
    service, gate = _gated_service(setup, "continuous", monkeypatch, max_wait_ms=20.0)
    gate.release.set()
    picks = _picks(setup["texts"], 24)
    futures = [service.submit(text) for text in picks]
    assert all(f.result(30)["status"] == "ok" for f in futures)
    service.drain()
    encoder = setup["continuous"].encoder
    want_rows = encoder.encode_many(picks)
    rows = []
    for sample in gate.samples:
        n = int(np.count_nonzero(sample["row_starts"][1:])) + 1
        pack = want_rows[len(rows) : len(rows) + n]
        want = collate_ragged(pack, 96, 8, encoder.pad_id)
        for key in want:
            np.testing.assert_array_equal(sample[key], want[key], err_msg=key)
        rows += pack
    assert rows == want_rows
    assert len(gate.samples) == service.registry.snapshot()["counters"]["serve.batches"]


def test_continuous_prefix_share_aliases_duplicates_and_keeps_scores(setup, monkeypatch):
    """``prefix_share``: duplicates admitted into one open pack alias the
    first copy's row (no tokens written, ``row_starts`` pointing back, the
    segment ids then skipping values), and every response stays within
    1e-6 of the unshared bucketed scores."""
    service, gate = _gated_service(setup, "continuous", monkeypatch, prefix_share=True,
                                   max_wait_ms=200.0)
    warm = service.submit("warmup text")
    assert gate.entered.wait(30)  # the card holds the warmup pack
    texts = ["template body"] * 4 + ["unique one", "other text", "template body"]
    futures = [service.submit(t) for t in texts]
    time.sleep(0.1)  # every text joins the one open pack
    gate.release.set()
    assert warm.result(30)["status"] == "ok"
    results = [f.result(30) for f in futures]
    service.drain()
    expected = setup["bucketed"].score_texts(texts)
    labels = setup["continuous"].anchor_labels
    for response, want in zip(results, expected):
        assert response["status"] == "ok", response
        np.testing.assert_allclose(_probs(response, labels), want, atol=1e-6, rtol=0)
    counters = service.registry.snapshot()["counters"]
    assert counters["serve.prefix_rows_aliased"] == 4
    assert counters["serve.prefix_tokens_saved"] > 0
    shared = gate.samples[1]
    starts = shared["row_starts"][: len(texts)]
    assert len(set(starts.tolist())) == 3  # 7 rows over 3 written segments
    live_ids = np.unique(shared["segment_ids"][shared["segment_ids"] > 0])
    assert live_ids.tolist() == [1, 5, 6]  # ids skip the aliased rows


def test_health_summary_and_named_tenant(setup):
    """A tenant without a bank resolves "error" naming it (the queue is not
    touched); once its bank is installed the tenant scores against it and
    /healthz carries its row."""
    service = ScoringService(setup["ragged"])
    health = service.health_summary()
    assert health["status"] == "ok" and health["score_impl"] == "ragged"
    assert health["n_anchors"] == len(setup["anchors"])
    assert "tenants" not in health
    unknown = service.submit("x", tenant="acme").result(10)
    assert unknown["status"] == "error" and "acme" in unknown["reason"]
    assert service.swap_bank(setup["anchors"][:3], tenant="acme") == 1
    scored = service.submit(setup["texts"][0], tenant="acme").result(30)
    assert scored["status"] == "ok" and len(scored["predict"]) == 3
    assert service.health_summary()["tenants"]["acme"]["n_anchors"] == 3
    service.drain()
    assert service.health_summary()["status"] == "draining"


# -- config, serve_from_archive, front end, CLI ---------------------------------


def test_serving_config_refuses_unported_settings():
    """Every serving key of the JAX package is honoured now: the ops-plane
    keys pass through like the others."""
    assert serving_config({})["token_budget"] is None
    assert serving_config({"serving": {"slo_enabled": True, "replicas": 1}})["max_batch"] == 16
    assert serving_config({"serving": {"slo_enabled": False}})["slo_enabled"] is False
    for key, value in (("replicas", 2), ("tenants", "a=/x"), ("cache_capacity", 8),
                       ("trace_sample_rate", 0.5), ("hosts", "a:1,b:2"),
                       ("autoscale_enabled", True), ("fleet_max_restarts", 5),
                       ("incident_max_bundles", 2)):
        assert serving_config({"serving": {key: value}})[key] == value


# the keys of the ops-plane slice, honoured since it was ported
OPS_PLANE_SERVING_KEYS = (
    "alert_interval_s", "autoscale_down_consecutive", "autoscale_down_cooldown_s",
    "autoscale_drain_timeout_s", "autoscale_enabled", "autoscale_interval_s",
    "autoscale_max_replicas", "autoscale_min_replicas", "autoscale_up_consecutive",
    "autoscale_up_cooldown_s", "fleet_heartbeat_timeout_s", "fleet_max_reroutes",
    "fleet_max_restarts", "fleet_monitor_interval_s", "hosts", "incident_max_bundles",
    "incident_min_interval_s", "incident_window_s")

MOVED_SERVING_KEYS = ("replicas", "heartbeat_timeout_s", "max_batch_errors", "monitor_interval_s",
                      "max_reroutes", "trace_sample_rate", "trace_ring", "slo_enabled",
                      "slo_availability_objective", "slo_latency_p95_ms", "slo_fast_window_s",
                      "slo_window_s", "slo_interval_s", "tenants",
                      "cache_capacity") + OPS_PLANE_SERVING_KEYS


@pytest.mark.parametrize("key", MOVED_SERVING_KEYS)
def test_moved_serving_key_has_the_jax_default(key):
    from memvul_tpu.config import SERVING_DEFAULTS as JAX_SERVING_DEFAULTS
    from memvul_tpu_torch.config import SERVING_DEFAULTS

    assert SERVING_DEFAULTS[key] == JAX_SERVING_DEFAULTS[key]
    assert serving_config({})[key] == JAX_SERVING_DEFAULTS[key]


@pytest.mark.parametrize("key", OPS_PLANE_SERVING_KEYS)
def test_unported_serving_key_raises_naming_its_slice(key, tmp_path):
    """The ops-plane keys raised until their slice was ported; now each
    is honoured, at the JAX default and away from it, and a value away
    from the default reaches the object the key configures: the balancer
    of ``serve --hosts`` (``hosts``, ``fleet_*``), its flight recorder
    (``alert_interval_s``, ``incident_*``) or the autoscaler's config
    (``autoscale_*``; ``autoscale_enabled`` is held by
    test_torch_autoscaler's ``serve_from_archive`` test)."""
    from memvul_tpu.config import SERVING_DEFAULTS as JAX_SERVING_DEFAULTS
    from memvul_tpu_torch.build import serve_from_hosts
    from memvul_tpu_torch.config import SERVING_DEFAULTS
    from memvul_tpu_torch.serving.autoscaler import AutoscalerConfig

    assert key.startswith(("hosts", "fleet_", "autoscale_", "alert_", "incident_"))
    # the port's table is the JAX package's serving section
    assert set(SERVING_DEFAULTS) == set(JAX_SERVING_DEFAULTS)
    default = JAX_SERVING_DEFAULTS[key]
    assert serving_config({"serving": {key: default}})[key] == default
    # unbound local ports: the balancer only ever finds them refusing
    changed = "127.0.0.1:9,127.0.0.1:10" if key == "hosts" else \
        (not default if isinstance(default, bool) else default + 1)
    assert serving_config({"serving": {key: changed}})[key] == changed
    if key.startswith("autoscale_"):
        if key != "autoscale_enabled":
            config = AutoscalerConfig.from_serving(serving_config({"serving": {key: changed}}))
            assert getattr(config, key[len("autoscale_"):]) == changed
        return
    serving = {"hosts": "127.0.0.1:9", key: changed}
    balancer = serve_from_hosts(overrides={"serving": serving}, out_dir=tmp_path,
                                tsdb_cadence=60.0)
    try:
        if key == "hosts":
            assert [h.base_url for h in balancer.hosts] == [
                "http://127.0.0.1:9", "http://127.0.0.1:10"]
        elif key.startswith("fleet_"):
            assert getattr(balancer.config, key[len("fleet_"):]) == changed
        elif key == "alert_interval_s":
            assert balancer.alert_engine.interval_s == changed
        else:
            assert getattr(balancer.incident_recorder, key[len("incident_"):]) == changed
    finally:
        balancer.drain(timeout=1.0)


# the telemetry keys the ops-plane slice and slice 11 (step_events) ported
TELEMETRY_KEYS = ("hbm_gauges", "metrics_port", "step_events", "trace_dir", "tsdb_cadence_s",
                  "tsdb_resolution_s", "tsdb_retention_s")


@pytest.mark.parametrize("key", TELEMETRY_KEYS)
def test_unported_telemetry_key_raises_naming_its_slice(key):
    """Every telemetry key is honoured with the JAX package's default; none
    raises any more (``step_events`` was the last, ported in slice 11)."""
    from memvul_tpu.config import TELEMETRY_DEFAULTS as JAX_TELEMETRY_DEFAULTS
    from memvul_tpu_torch.config import telemetry_config

    default = JAX_TELEMETRY_DEFAULTS[key]
    assert telemetry_config({"telemetry": {key: default}})["enabled"] is True
    changed = "trace/" if default is None else \
        (not default if isinstance(default, bool) else default + 1)
    assert telemetry_config({})[key] == default
    assert telemetry_config({"telemetry": {key: changed}})[key] == changed


@pytest.mark.parametrize("path", ["/programz", "/metricsz", "/alertz", "/profilez"])
def test_ops_plane_endpoints_answer_naming_their_slice(setup, path):
    """The ops-plane endpoints are ported: without a flight recorder
    /metricsz and /alertz answer ``{"enabled": false}``, /programz the
    rows, and /profilez without a run dir 503 (the JAX front end's codes)."""
    import urllib.error
    import urllib.request

    service = ScoringService(setup["ragged"])
    server = run_http_server(service, port=0)
    try:
        url = "http://%s:%d%s" % (*server.server_address[:2], path)
        method = "POST" if path == "/profilez" else "GET"
        data = b'{"seconds": 1}' if method == "POST" else None
        request = urllib.request.Request(url, data=data, method=method)
        if path == "/profilez":
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(request, timeout=10)
            assert err.value.code == 503
            assert "run dir" in json.loads(err.value.read().decode("utf-8"))["reason"]
            return
        with urllib.request.urlopen(request, timeout=10) as resp:
            assert resp.status == 200
            body = json.loads(resp.read().decode("utf-8"))
        if path == "/programz":
            assert body["count"] == len(body["programs"]) and "roofline" in body
            assert set(body["kernels"]) == {"anchor_match", "flash_attention",
                                            "flash_attention_causal", "ragged_flash_attention",
                                            "plain_attention", "grouped_gemm"}
            assert body["plain_on_card"] == 0
        else:
            assert body["enabled"] is False
    finally:
        server.shutdown()
        service.drain()


def test_serve_from_archive_on_cpu_with_http(setup, tmp_path):
    service = serve_from_archive(setup["archive"], out_dir=tmp_path, overrides=SERVE_OVERRIDES,
                                 device="cpu")
    server = run_http_server(service, port=0)
    try:
        host, port = server.server_address[:2]
        http = HTTPClient(f"http://{host}:{port}")
        text = setup["texts"][3]
        over_http = http.score(text)
        in_process = InprocessClient(service).score(text)
        assert over_http["status"] == in_process["status"] == "ok"
        assert over_http["predict"] == pytest.approx(in_process["predict"], abs=1e-6)
        assert http.health()["score_impl"] == "ragged"
    finally:
        server.shutdown()
        service.drain()
    saved = json.loads((tmp_path / "telemetry.json").read_text())
    assert saved["counters"]["serve.served"] == 2
    with pytest.raises(ValueError, match="score_impl"):
        serve_from_archive(setup["archive"], device="cpu",
                           overrides={"serving": {"score_impl": "raggedy"}})


def test_cli_serve_on_cpu_drains_on_sigterm(setup):
    proc = subprocess.Popen(
        [sys.executable, "-m", "memvul_tpu_torch", "serve", str(setup["archive"]), "--port", "0",
         "--device", "cpu", "--overrides", json.dumps(SERVE_OVERRIDES)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"),  # one core, as the fixture sets
    )
    try:
        first = proc.stdout.readline()
        assert first, proc.stderr.read()[-2000:]
        line = json.loads(first)
        response = HTTPClient(line["serving"]).score(setup["texts"][0])
        assert response["status"] == "ok"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0, proc.stderr.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

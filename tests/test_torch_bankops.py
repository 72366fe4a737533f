"""The port's anchor-bank lifecycle (``memvul_tpu_torch/bankops/``) against
the JAX package's, on the CPU.

* **store** — lineage, diff validation, integrity, crash remnants, the
  ``ACTIVE`` pointer and the promotions trail; ``anchor_sha256`` equal to
  the JAX package's, and each package reads a store the other wrote;
* **gate** — decisions (``approved``, reason codes, observed values and
  limits) equal to ``memvul_tpu.bankops.evaluate_gate`` on the same
  evidence; ``golden_metrics``, ``evaluate_cascade`` (on a CPU int8
  predictor) and ``evaluate_reweight`` against the JAX package's on the
  same weights;
* **drift** — win shares, total variation and the pinned baseline;
* **shadow** — ``replay_results`` against the JAX package's on the same
  recorded run: the same sample count, flips and anchor changes, deltas
  within rtol 1e-4 / atol 1e-5 (``tests/test_torch_predict.py``'s
  tolerance); a live ``ShadowScorer`` on a CPU ``ScoringService`` (bucketed
  and ragged) leaves the served answers bitwise unchanged and writes one
  delta row per request; a failing shadow worker never reaches a client;
* **promote / demote** on one service, with provenance; a fleet target
  rolls through ``rolling_swap`` and ``tenant=`` scopes the install; a
  promoted reweighted bank
  serves the same winners as the JAX package's service after its own
  promote (scores within the tolerance above);
* the ``bank`` CLI through ``main([...])``.
"""

import json
import time

import numpy as np
import pytest
import torch

import jax

from memvul_tpu import archive as jax_archive
from memvul_tpu import bankops as jax_bankops
from memvul_tpu import telemetry as jax_telemetry
from memvul_tpu.data.synthetic import build_workspace
from memvul_tpu.evaluate.predict_memory import SiamesePredictor as JaxPredictor
from memvul_tpu.models import BertConfig as JaxBertConfig
from memvul_tpu.models import MemoryModel as JaxMemoryModel
from memvul_tpu_torch import __main__ as cli
from memvul_tpu_torch.archive import load_archive
from memvul_tpu_torch.bankops import (
    BankDiff,
    BankIntegrityError,
    BankStore,
    BankStoreError,
    GateThresholds,
    PromotionRefused,
    ShadowConfig,
    ShadowScorer,
    anchor_sha256,
    canonical_anchor_text,
    demote,
    evaluate_candidate,
    evaluate_cascade,
    evaluate_gate,
    evaluate_reweight,
    golden_metrics,
    load_baseline,
    pin_baseline,
    promote,
    replay_results,
    total_variation,
    update_drift_gauge,
    win_counts,
    win_shares,
)
from memvul_tpu_torch.bankops.promote import REASON_SHADOW_MISSING, REASON_SHADOW_SAMPLES
from memvul_tpu_torch.bankops.shadow import SHADOW_DELTAS_NAME
from memvul_tpu_torch.data.cwe import load_anchors
from memvul_tpu_torch.data.readers import MemoryReader
from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
from memvul_tpu_torch.resilience import faults
from memvul_tpu_torch.serving import ScoringService, ServiceConfig
from memvul_tpu_torch.telemetry import Registry
from memvul_tpu_torch.telemetry.sinks import read_jsonl

# tests/test_torch_predict.py's tolerance for the port against the JAX package
RTOL, ATOL = 1e-4, 1e-5
PRED = dict(batch_size=8, max_length=48)
PACK = dict(score_impl="ragged", token_budget=96, max_rows_per_pack=8)

ANCHORS_V1 = {
    "CWE-79": "cross site scripting description",
    "CWE-89": "sql injection description",
    "CWE-22": "path traversal description",
}


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
    jax_telemetry.reset()


# -- store ---------------------------------------------------------------------


def test_store_create_derive_lineage(tmp_path):
    store = BankStore(tmp_path / "banks")
    m1 = store.create(ANCHORS_V1, source="build", note="seed bank")
    assert m1["version"] == "v1" and m1["parent"] is None
    assert m1["n_anchors"] == 3 and m1["diff"] == []
    diff = BankDiff.from_json([
        {"op": "add", "category": "CWE-502", "description": "deserialization of untrusted data"},
        {"op": "retire", "category": "CWE-89"},
        {"op": "reweight", "category": "CWE-79", "weight": 2.0},
        {"op": "edit", "category": "CWE-22", "description": "path traversal, edited"},
    ])
    assert diff.summary() == {"add": 1, "retire": 1, "reweight": 1, "edit": 1}
    m2 = store.derive("v1", diff, note="rotate")
    assert m2["version"] == "v2" and m2["parent"] == "v1"
    anchors = store.anchors("v2")
    assert "CWE-502" in anchors and "CWE-89" not in anchors
    assert anchors["CWE-22"] == "path traversal, edited"
    assert m2["weights"] == {"CWE-79": 2.0} and m2["diff"] == diff.to_json()
    assert [m["version"] for m in store.log("v2")] == ["v1", "v2"]
    assert store.versions() == ["v1", "v2"] and store.latest() == "v2"
    by_label = {inst["meta"]["label"]: inst for inst in store.instances("v2")}
    assert by_label["CWE-79"]["meta"]["weight"] == 2.0
    assert by_label["CWE-502"]["meta"]["weight"] == 1.0
    assert by_label["CWE-502"]["meta"]["bank_version"] == "v2"
    assert by_label["CWE-502"]["text1"].startswith("deserialization")


@pytest.mark.parametrize("bad", [
    [{"op": "add", "category": "CWE-79", "description": "dup"}],
    [{"op": "retire", "category": "CWE-404"}],
    [{"op": "edit", "category": "CWE-404", "description": "x"}],
    [{"op": "reweight", "category": "CWE-79"}],
    [{"op": "add", "category": "CWE-1"}],
])
def test_store_diff_validation(bad):
    with pytest.raises(BankStoreError):
        BankDiff.from_json(bad).apply(dict(ANCHORS_V1), {})
    with pytest.raises(jax_bankops.BankStoreError):
        jax_bankops.BankDiff.from_json(bad).apply(dict(ANCHORS_V1), {})


@pytest.mark.parametrize("bad", [[{"op": "nuke", "category": "CWE-79"}],
                                 [{"op": "add", "category": "CWE-1", "typo": 1}],
                                 [{"op": "retire", "category": ""}], ["not an object"]])
def test_store_diff_refuses_malformed_ops(bad):
    with pytest.raises(BankStoreError):
        BankDiff.from_json(bad)


def test_store_integrity_and_crash_remnants(tmp_path):
    store = BankStore(tmp_path)
    store.create(ANCHORS_V1)
    anchors_path = tmp_path / "v1" / "anchors.json"
    anchors_path.write_text(anchors_path.read_text().replace("sql", "SQL"))
    with pytest.raises(BankIntegrityError):
        store.anchors("v1")
    with pytest.raises(BankIntegrityError):
        store.verify("v1")
    assert store.anchors("v1", verify=False)["CWE-89"].startswith("SQL")
    # a manifest-less dir (a crash before the commit) is invisible, its id never reused
    (tmp_path / "v2").mkdir()
    assert store.versions() == ["v1"]
    assert store.create(ANCHORS_V1)["version"] == "v3"
    with pytest.raises(BankStoreError):
        store.manifest("v9")
    with pytest.raises(BankStoreError):
        store.manifest("latest")
    with pytest.raises(BankStoreError):
        store.create({})
    with pytest.raises(BankStoreError):
        store.derive("v3", BankDiff([]))
    with pytest.raises(BankStoreError):
        store.derive("v3", BankDiff.from_json([{"op": "retire", "category": c}
                                               for c in ANCHORS_V1]))


def test_store_active_pointer_and_promotions(tmp_path):
    store = BankStore(tmp_path)
    store.create(ANCHORS_V1)
    assert store.active() is None
    with pytest.raises(BankStoreError):
        store.set_active("v7")
    record = store.set_active("v1", source="promotion")
    assert store.active()["version"] == "v1" and record["source"] == "promotion"
    store.record_promotion(kind="promotion", candidate="v1")
    store.record_promotion(kind="demotion", restored="v1")
    assert [r["kind"] for r in store.promotions()] == ["promotion", "demotion"]
    # a torn last line of the trail is skipped, not fatal
    with open(tmp_path / "promotions.jsonl", "a") as f:
        f.write('{"kind": "prom')
    assert [r["kind"] for r in store.promotions()] == ["promotion", "demotion"]


ANCHOR_SETS = {
    "three": ANCHORS_V1,
    "unicode": {"CWE-ü": "naïve façade — “quotes” ✓", "CWE-1": "plain", "CWE-0": "日本語"},
    "order": dict(reversed(list(ANCHORS_V1.items()))),
    "workspace": None,  # the synthetic workspace's own bank
}


@pytest.mark.parametrize("name", sorted(ANCHOR_SETS))
def test_anchor_sha256_matches_jax(name, ws):
    anchors = ANCHOR_SETS[name] or load_anchors(ws["paths"]["anchors"])
    assert canonical_anchor_text(anchors) == jax_bankops.canonical_anchor_text(anchors)
    assert anchor_sha256(anchors) == jax_bankops.anchor_sha256(anchors)


def test_each_package_reads_the_others_store(tmp_path):
    mine, theirs = BankStore(tmp_path / "port"), jax_bankops.BankStore(tmp_path / "jax")
    ops = [{"op": "add", "category": "CWE-502", "description": "deser"},
           {"op": "reweight", "category": "CWE-79", "weight": 0.5}]
    for store, diff in ((mine, BankDiff), (theirs, jax_bankops.BankDiff)):
        store.create(ANCHORS_V1)
        store.derive("v1", diff.from_json(ops))
        store.set_active("v2")
    cross = [(BankStore(tmp_path / "jax"), theirs), (jax_bankops.BankStore(tmp_path / "port"), mine)]
    for reader, writer in cross:
        for version in ("v1", "v2"):
            assert reader.verify(version)
            assert reader.manifest(version)["anchors_sha256"] == \
                writer.manifest(version)["anchors_sha256"]
            assert reader.instances(version) == writer.instances(version)
        assert reader.active()["version"] == "v2"
    assert (tmp_path / "port" / "v2" / "anchors.json").read_bytes() == \
        (tmp_path / "jax" / "v2" / "anchors.json").read_bytes()


# -- gate (pure) ---------------------------------------------------------------

GOOD = {"auc": 0.91, "f1": 0.80}
GATE_CASES = {
    "approve": (GOOD, {"auc": 0.905, "f1": 0.795}, {"sampled": 500, "flip_rate": 0.004}, {}),
    "auc": (GOOD, {"auc": 0.80, "f1": 0.80}, {"sampled": 500, "flip_rate": 0.0}, {}),
    "f1": (GOOD, {"auc": 0.91, "f1": 0.5}, {"sampled": 500, "flip_rate": 0.0}, {}),
    "samples_and_flips": (GOOD, GOOD, {"sampled": 10, "flip_rate": 0.5}, {}),
    "missing_shadow": (GOOD, GOOD, None, {}),
    "waived_shadow": (GOOD, GOOD, None, {"require_shadow": False}),
    "edge_flip_rate": (GOOD, GOOD, {"sampled": 100, "flip_rate": 0.02}, {}),
    "rounding": (GOOD, GOOD, {"sampled": 48, "flip_rate": 1 / 48},
                 {"max_flip_rate": 0.0, "min_shadow_samples": 1}),
    "everything": ({"auc": 0.99, "f1": 0.99}, {}, {"sampled": 0, "flip_rate": 1.0},
                   {"max_auc_drop": 0.0, "max_f1_drop": 0.0}),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_decisions_match_jax(case):
    active, candidate, shadow, limits = GATE_CASES[case]
    mine = evaluate_gate(active, candidate, shadow, GateThresholds(**limits),
                         candidate="v2", parent="v1")
    theirs = jax_bankops.evaluate_gate(active, candidate, shadow,
                                       jax_bankops.GateThresholds(**limits),
                                       candidate="v2", parent="v1")
    assert mine.to_json() == theirs.to_json()
    assert mine.approved == (case in ("approve", "waived_shadow", "edge_flip_rate"))
    for reason in mine.reasons:
        assert set(reason) == {"code", "observed", "limit"}


def test_promote_refuses_unapproved_decision(tmp_path):
    store = BankStore(tmp_path)
    store.create(ANCHORS_V1)
    decision = evaluate_gate(GOOD, GOOD, None, GateThresholds(), candidate="v1")
    service = _NoService()
    with pytest.raises(PromotionRefused) as excinfo:
        promote(service, store, decision)
    assert [r["code"] for r in excinfo.value.decision.reasons] == [REASON_SHADOW_MISSING]
    audit = store.promotions()
    assert audit[-1]["kind"] == "promotion_refused"
    assert audit[-1]["reasons"][0]["code"] == REASON_SHADOW_MISSING
    assert service.registry.counter("bank.promotions_refused").value == 1


class _NoService:
    """A target that must not be installed into."""

    def __init__(self) -> None:
        self.registry = Registry()

    def swap_bank(self, *args, **kwargs):
        raise AssertionError("a refused decision must install nothing")


class _Fleet(_NoService):
    replicas = ()


class _Recorder(_NoService):
    """A service that records its installs."""

    def __init__(self) -> None:
        super().__init__()
        self.installs = []

    def swap_bank(self, instances, **kwargs):
        self.installs.append((len(list(instances)), kwargs))
        return len(self.installs) + 1


def test_fleet_and_tenant_targets_raise_naming_the_slice(tmp_path, monkeypatch):
    """A fleet target rolls through ``rolling_swap`` and ``tenant=`` scopes
    the install (both raised before the serving plane was ported); what
    still raises naming its slice is the cross-host fleet."""
    from memvul_tpu_torch.config import serving_config
    from memvul_tpu_torch.serving import router as router_mod

    store = BankStore(tmp_path)
    store.create(ANCHORS_V1)
    store.derive("v1", BankDiff.from_json([{"op": "retire", "category": "CWE-22"}]))
    store.set_active("v2")
    approved = evaluate_gate(GOOD, GOOD, None, GateThresholds(require_shadow=False),
                             candidate="v2", parent="v1")
    rolled = []
    monkeypatch.setattr(router_mod, "rolling_swap",
                        lambda target, instances, **kw: rolled.append((len(instances), kw)) or 7)
    assert promote(_Fleet(), store, approved) == 7
    assert rolled[-1] == (2, {"source": "promotion", "store_version": "v2", "tenant": None})
    assert demote(_Fleet(), store, tenant="orga") == {"version": "v1", "serving_version": 7}
    assert rolled[-1] == (3, {"source": "demotion", "store_version": "v1", "tenant": "orga"})
    service = _Recorder()
    assert promote(service, store, approved, tenant="orga") == 2
    assert service.installs == [(2, {"source": "promotion", "store_version": "v2",
                                     "tenant": "orga"})]
    assert [r["tenant"] for r in store.promotions()] == [None, "orga", "orga"]
    assert serving_config({"serving": {"hosts": "a:8341,b:8341"}})["hosts"] == "a:8341,b:8341"


# -- drift ---------------------------------------------------------------------


@pytest.mark.parametrize("current,baseline", [
    ({"a": 1.0}, {"a": 1.0}), ({"a": 1.0}, {"b": 1.0}), ({"a": 0.5, "b": 0.5}, {"a": 1.0}),
    ({}, {"a": 0.25, "b": 0.75}), ({"a": 0.1, "b": 0.2, "c": 0.7}, {"c": 0.3, "d": 0.7}),
])
def test_total_variation_matches_jax(current, baseline):
    assert total_variation(current, baseline) == jax_bankops.total_variation(current, baseline)


def test_drift_math_and_baseline_roundtrip(tmp_path):
    assert win_shares({}) == {}
    registry = Registry(run_dir=tmp_path / "run")
    registry.counter("bank.anchor_wins.CWE-79").inc(3)
    registry.counter("bank.anchor_wins.CWE-89").inc(1)
    registry.counter("serve.served").inc(4)
    assert win_counts(registry.snapshot()["counters"]) == {"CWE-79": 3, "CWE-89": 1}
    baseline = pin_baseline(registry, tmp_path / "anchor_baseline.json")
    assert baseline == {"CWE-79": 0.75, "CWE-89": 0.25}
    assert load_baseline(tmp_path / "anchor_baseline.json") == baseline
    assert jax_bankops.load_baseline(tmp_path / "anchor_baseline.json") == baseline
    assert load_baseline(tmp_path / "missing.json") is None
    assert update_drift_gauge(Registry(), baseline) is None  # no wins yet
    assert update_drift_gauge(registry, baseline) == 0.0
    registry.counter("bank.anchor_wins.CWE-22").inc(96)
    drift = update_drift_gauge(registry, baseline)
    assert drift == pytest.approx(0.96)
    assert registry.snapshot()["gauges"]["bank.anchor_drift"] == drift


# -- real-model fixtures -------------------------------------------------------


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return build_workspace(tmp_path_factory.mktemp("bankops_ws"), seed=13)


@pytest.fixture(scope="module")
def setup(ws, tmp_path_factory):
    """One tiny archive with JAX-initialised weights (layers unscanned, so
    the JAX package's int8 twin works) that both packages load; the port's
    bucketed and ragged predictors and the JAX package's bucketed one."""
    tmp = tmp_path_factory.mktemp("bankops")
    vocab = ws["tokenizer"].vocab_size
    cfg = JaxBertConfig.tiny(vocab_size=vocab)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(JaxMemoryModel(cfg, header_dim=32).init(jax.random.PRNGKey(0), dummy,
                                                                    dummy))
    config = {
        "tokenizer": {"type": "wordpiece"},
        "dataset_reader": {"type": "reader_memory", "cve_path": ws["paths"]["cve"],
                           "anchor_path": ws["paths"]["anchors"]},
        "model": {"type": "model_memory", "header_dim": 32,
                  "encoder": {"preset": "tiny", "vocab_size": vocab}},
        "serving": {"max_batch": 8, "max_length": 48, "buckets": [16, 48]},
    }
    archive = jax_archive.save_archive(tmp / "model.tar.gz", config, params,
                                       tokenizer_file=ws["paths"]["tokenizer"])
    arch = load_archive(archive, device="cpu")
    jarch = jax_archive.load_archive(archive)
    reader = MemoryReader(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"])
    anchors = list(reader.read_anchors())

    def predictor(**kw):
        p = SiamesePredictor(arch.model, arch.tokenizer, **dict(PRED, **kw))
        p.encode_anchors(anchors)
        return p

    def jax_predictor(**kw):
        p = JaxPredictor(jarch.model, jarch.params, jarch.tokenizer, aot_warmup=False,
                         **dict(PRED, **kw))
        p.encode_anchors(anchors)
        return p

    instances = list(reader.read(ws["paths"]["test"], split="test"))
    return {
        "archive": archive, "reader": reader, "anchors": anchors, "instances": instances,
        "texts": [inst["text1"] for inst in instances], "predictor": predictor,
        "jax_predictor": jax_predictor,
        "bucketed": predictor(buckets=[16, 48]), "ragged": predictor(**PACK),
        "jax": jax_predictor(buckets=[16, 48]),
    }


def _store_v2(ws, root):
    """A store whose v1 is the workspace's bank and whose v2 retires one
    anchor and adds two (a new bank geometry)."""
    store = BankStore(root)
    anchors = load_anchors(ws["paths"]["anchors"])
    store.create(anchors, source="build")
    store.derive("v1", BankDiff.from_json([
        {"op": "retire", "category": sorted(anchors)[0]},
        {"op": "add", "category": "CWE-NEW-1",
         "description": "a brand new weakness class about parsing"},
        {"op": "add", "category": "CWE-NEW-2", "description": "another new weakness about memory"},
    ]))
    return store


def _service(predictor, **overrides):
    kw = dict(max_batch=8, max_wait_ms=3.0, max_queue=1000, default_deadline_ms=30000.0)
    kw.update(overrides)
    return ScoringService(predictor, config=ServiceConfig(**kw))


def _score_all(service, texts, timeout=60.0):
    futures = [service.submit(t) for t in texts]
    return [f.result(timeout) for f in futures]


def _wait_counter(registry, names, target, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        counters = registry.snapshot()["counters"]
        if sum(counters.get(n, 0) for n in names) >= target:
            break
        time.sleep(0.01)
    counters = registry.snapshot()["counters"]
    return sum(counters.get(n, 0) for n in names)


# -- golden metrics and the model gates ------------------------------------------


def test_score_texts_takes_an_explicit_bank(setup, ws, tmp_path):
    store = _store_v2(ws, tmp_path / "banks")
    texts = setup["texts"][:20]
    for name in ("bucketed", "ragged"):
        p = setup[name]
        bank, labels, n = p.encode_bank(store.instances("v2"))
        p.warmup_bank_shapes(bank)
        got = p.score_texts(texts, bank, n)
        assert got.shape == (20, n) and labels == list(store.anchors("v2"))
        jp = setup["jax"]
        jbank, _, jn = jp.encode_bank(store.instances("v2"))
        np.testing.assert_allclose(got, np.asarray(jp.score_texts(texts, jbank, jn)),
                                   rtol=RTOL, atol=ATOL)
        # the predictor's own bank by default
        np.testing.assert_array_equal(p.score_texts(texts), p.score_texts(texts, p.anchor_bank,
                                                                          p.n_anchors))


def test_golden_metrics_match_jax(setup, ws, tmp_path):
    store = _store_v2(ws, tmp_path / "banks")
    for version in ("v1", "v2"):
        mine = golden_metrics(setup["bucketed"], store.instances(version), setup["instances"])
        theirs = jax_bankops.golden_metrics(setup["jax"], store.instances(version),
                                            setup["instances"])
        assert mine["n_eval"] == theirs["n_eval"] == len(setup["instances"])
        # the swept threshold's counts, as ratios: equal when the decisions are
        for key in ("f1", "precision", "recall", "auc", "ave_precision_score"):
            assert mine[key] == pytest.approx(theirs[key], abs=1e-9), key
        assert mine["thres"] == pytest.approx(theirs["thres"], rel=RTOL, abs=ATOL)


def test_evaluate_candidate_matches_jax(setup, ws, tmp_path):
    store = _store_v2(ws, tmp_path / "banks")
    jstore = jax_bankops.BankStore(tmp_path / "banks")
    shadow = {"sampled": 200, "flips": 1, "flip_rate": 0.005}
    limits = dict(max_auc_drop=0.5, max_f1_drop=0.5)
    mine = evaluate_candidate(setup["bucketed"], store, "v2", setup["instances"],
                              shadow_summary=shadow, thresholds=GateThresholds(**limits))
    theirs = jax_bankops.evaluate_candidate(setup["jax"], jstore, "v2", setup["instances"],
                                            shadow_summary=shadow,
                                            thresholds=jax_bankops.GateThresholds(**limits))
    assert (mine.approved, mine.candidate, mine.parent) == \
        (theirs.approved, theirs.candidate, theirs.parent) == (True, "v2", "v1")
    assert [r["code"] for r in mine.reasons] == [r["code"] for r in theirs.reasons]


@pytest.fixture(scope="module")
def cascade(setup):
    def make(low, high):
        kw = dict(buckets=[48], encoder_precision="int8", score_impl="cascade",
                  cascade_low=low, cascade_high=high)
        return setup["predictor"](**kw), setup["jax_predictor"](**kw)

    return make


def test_evaluate_cascade_requires_int8_predictor(setup):
    with pytest.raises(ValueError, match="int8"):
        evaluate_cascade(setup["bucketed"], [])


def test_evaluate_cascade_on_int8_approves_as_jax(setup, cascade):
    mine, theirs = cascade(0.3, 0.7)
    instances = setup["instances"]
    thresholds = dict(min_shadow_samples=10)
    got = evaluate_cascade(mine, instances, thresholds=GateThresholds(**thresholds))
    want = jax_bankops.evaluate_cascade(theirs, instances,
                                        thresholds=jax_bankops.GateThresholds(**thresholds))
    assert got.approved and want.approved and got.reasons == want.reasons == []
    assert (got.candidate, got.parent) == ("cascade", "fp32")
    for key in ("sampled", "flips", "anchor_changes"):
        assert got.metrics["shadow"][key] == want.metrics["shadow"][key]
    assert got.metrics["shadow"]["max_abs_delta"] < 0.01
    live = {"sampled": 500, "flips": 1, "flip_rate": 0.002}
    assert evaluate_cascade(mine, instances, shadow_summary=live).metrics["shadow"] == live


def test_evaluate_cascade_refuses_a_lossy_band(setup, cascade):
    """A band that rescues nothing refuses once the decision threshold sits
    in the int8 tier's gap, with the record the JAX package writes."""
    mine, theirs = cascade(0.0, 0.0)
    texts = setup["texts"]
    fp32 = mine.score_texts(texts, impl="bucketed").max(axis=1)
    int8 = mine.score_texts(texts, impl="int8").max(axis=1)
    row = int(np.abs(fp32 - int8).argmax())
    assert fp32[row] != int8[row]
    cut = float((fp32[row] + int8[row]) / 2.0)  # a flip by construction
    limits = dict(max_flip_rate=0.0, min_shadow_samples=1)
    got = evaluate_cascade(mine, setup["instances"], threshold=cut,
                           thresholds=GateThresholds(**limits))
    want = jax_bankops.evaluate_cascade(theirs, setup["instances"], threshold=cut,
                                        thresholds=jax_bankops.GateThresholds(**limits))
    assert not got.approved and not want.approved
    assert [r["code"] for r in got.reasons] == [r["code"] for r in want.reasons] == \
        ["flip_rate_exceeded"]
    assert got.metrics["shadow"]["flips"] >= 1


@pytest.mark.parametrize("weights", [{}, {"first": 5.0}, {"first": 0.01, "last": 3.0}])
def test_evaluate_reweight_matches_jax(setup, ws, tmp_path, weights):
    store = BankStore(tmp_path / "banks")
    anchors = load_anchors(ws["paths"]["anchors"])
    labels = sorted(anchors)
    store.create(anchors, weights={labels[0] if k == "first" else labels[-1]: w
                                   for k, w in weights.items()})
    jstore = jax_bankops.BankStore(tmp_path / "banks")
    limits = dict(min_shadow_samples=1, max_flip_rate=1.0, max_auc_drop=1.0, max_f1_drop=1.0)
    got = evaluate_reweight(setup["bucketed"], store, "v1", setup["instances"],
                            thresholds=GateThresholds(**limits))
    want = jax_bankops.evaluate_reweight(setup["jax"], jstore, "v1", setup["instances"],
                                         thresholds=jax_bankops.GateThresholds(**limits))
    assert got.approved == want.approved and got.candidate == want.candidate == "v1+reweight"
    for key in ("sampled", "flips", "anchor_changes"):
        assert got.metrics["shadow"][key] == want.metrics["shadow"][key]
    if not weights:
        assert got.metrics["shadow"]["flips"] == got.metrics["shadow"]["anchor_changes"] == 0


# -- offline shadow --------------------------------------------------------------


def test_replay_results_matches_jax(setup, ws, tmp_path):
    store = _store_v2(ws, tmp_path / "banks")
    results = tmp_path / "memory_result.json"
    setup["bucketed"].predict_file(setup["reader"], ws["paths"]["test"], results, split="test")
    common = dict(corpus_path=ws["paths"]["test"], results_path=results, split="test",
                  candidate_version="v2")
    mine = replay_results(setup["bucketed"], store.instances("v2"), setup["reader"],
                          out_dir=tmp_path / "port", **common)
    theirs = jax_bankops.replay_results(setup["jax"], store.instances("v2"), setup["reader"],
                                        out_dir=tmp_path / "jax", **common)
    for key in ("sampled", "flips", "anchor_changes", "recorded_rows", "corpus_rows_unmatched",
                "candidate_version", "mode"):
        assert mine[key] == theirs[key], key
    assert mine["sampled"] == len(setup["instances"])
    for key in ("mean_abs_delta", "max_abs_delta", "flip_rate"):
        assert mine[key] == pytest.approx(theirs[key], rel=RTOL, abs=ATOL)
    rows, torn = read_jsonl(tmp_path / "port" / SHADOW_DELTAS_NAME)
    jrows, _ = read_jsonl(tmp_path / "jax" / SHADOW_DELTAS_NAME)
    assert torn == 0 and len(rows) == len(jrows) == mine["sampled"]
    for r, j in zip(rows, jrows):
        assert (r["i"], r["flip"], r["active_anchor"], r["shadow_anchor"]) == \
            (j["i"], j["flip"], j["active_anchor"], j["shadow_anchor"])
        np.testing.assert_allclose(r["shadow_score"], j["shadow_score"], rtol=RTOL, atol=ATOL)


def test_replay_against_the_same_bank_has_no_delta(setup, ws, tmp_path):
    """The recorded run replayed against its own bank: no delta, no flips,
    one row per report, on the bucketed and on the ragged predictor."""
    store = BankStore(tmp_path / "banks")
    store.create(load_anchors(ws["paths"]["anchors"]))
    results = tmp_path / "memory_result.json"
    metrics = setup["bucketed"].predict_file(setup["reader"], ws["paths"]["test"], results,
                                             split="test")
    for name in ("bucketed", "ragged"):
        summary = replay_results(setup[name], store.instances("v1"), setup["reader"],
                                 corpus_path=ws["paths"]["test"], results_path=results,
                                 out_dir=tmp_path / name, split="test", candidate_version="v1")
        assert summary["sampled"] == int(metrics["num_samples"])
        assert summary["flips"] == summary["anchor_changes"] == 0
        assert summary["max_abs_delta"] < 1e-6


# -- live shadow, promote and demote on one service ---------------------------------


@pytest.mark.parametrize("impl", ["bucketed", "ragged"])
def test_lifecycle_shadow_promote_demote(setup, ws, tmp_path, impl):
    """v1 → v2 (a new geometry) shadowed under live load: the served answers
    bitwise those without the tap, one delta row per request; the gate
    refuses, then promotes; demote restores the parent."""
    predictor = setup["predictor"](**({"buckets": [16, 48]} if impl == "bucketed" else PACK))
    store = _store_v2(ws, tmp_path / "banks")
    service = _service(predictor)
    registry = service.registry
    texts = setup["texts"][:24]
    try:
        baseline = _score_all(service, texts)
        assert all(r["status"] == "ok" and r["bank_version"] == 1 for r in baseline)
        scorer = ShadowScorer(service, store.instances("v2"), out_dir=tmp_path / "run",
                              config=ShadowConfig(max_queue=10_000), candidate_version="v2")
        shadowed = _score_all(service, texts)
        for a, b in zip(baseline, shadowed):
            assert a["predict"] == b["predict"] and a["anchor"] == b["anchor"]
        assert _wait_counter(registry, ["bank.shadow_sampled"], len(texts)) == len(texts)
        summary = scorer.stop()
        assert service._shadow_tap is None
        rows, torn = read_jsonl(tmp_path / "run" / SHADOW_DELTAS_NAME)
        assert torn == 0 and len(rows) == summary["sampled"] == len(texts)
        assert all(r["candidate_version"] == "v2" and r["active_version"] == 1 for r in rows)
        # the deltas are the candidate's offline scores of the same texts
        bank, labels, n = predictor.encode_bank(store.instances("v2"))
        offline = predictor.score_texts(texts, bank, n).max(axis=1)
        by_text = {}
        for text, row in zip(texts, offline):
            by_text.setdefault(text, float(row))
        assert sorted(r["shadow_score"] for r in rows) == \
            pytest.approx(sorted(by_text[t] for t in texts), abs=1e-6)

        strict = GateThresholds(min_shadow_samples=10 ** 6)
        refused = evaluate_gate(GOOD, GOOD, summary, strict, candidate="v2", parent="v1")
        assert refused.reasons[0]["code"] == REASON_SHADOW_SAMPLES
        with pytest.raises(PromotionRefused):
            promote(service, store, refused)
        assert service.bank_version == 1

        lenient = GateThresholds(max_auc_drop=1.0, max_f1_drop=1.0, max_flip_rate=1.0,
                                 min_shadow_samples=1)
        approved = evaluate_gate(GOOD, GOOD, summary, lenient, candidate="v2", parent="v1")
        assert promote(service, store, approved) == 2 and service.bank_version == 2
        snapshot = service.bank_snapshot()
        assert (snapshot.source, snapshot.store_version, snapshot.parent_version) == \
            ("promotion", "v2", 1)
        assert store.active()["version"] == "v2"
        assert service.health_summary()["bank"]["store_version"] == "v2"
        promoted = _score_all(service, texts[:8])
        assert all(r["bank_version"] == 2 for r in promoted)
        assert set(promoted[0]["predict"]) == set(store.anchors("v2"))
        # served answers are the candidate's offline scores
        for text, response in zip(texts[:8], promoted):
            want = predictor.score_texts([text], bank, n)[0]
            got = np.array([response["predict"][label] for label in labels])
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

        result = demote(service, store)
        assert result == {"version": "v1", "serving_version": 3}
        assert service.bank_snapshot().source == "demotion"
        assert set(_score_all(service, texts[:1])[0]["predict"]) == set(store.anchors("v1"))
        assert store.active()["version"] == "v1"
        assert [r["kind"] for r in store.promotions()] == \
            ["promotion_refused", "promotion", "demotion"]
        counters = registry.snapshot()["counters"]
        assert counters["bank.promotions"] == counters["bank.demotions"] == 1
        assert counters["serve.bank_swaps"] == 2
        wins = win_counts(counters)
        assert sum(wins.values()) == counters["serve.served"]
    finally:
        service.drain()


def test_shadow_fault_never_touches_active_path(setup, tmp_path):
    predictor = setup["bucketed"]
    service = _service(predictor)
    registry = service.registry
    texts = setup["texts"][:12]
    faults.configure("bank.shadow=raise:RuntimeError:shadow boom")
    try:
        scorer = ShadowScorer(service, setup["anchors"], out_dir=tmp_path / "run",
                              config=ShadowConfig(max_queue=10_000))
        responses = _score_all(service, texts)
        assert all(r["status"] == "ok" for r in responses)
        done = _wait_counter(registry, ["bank.shadow_sampled", "bank.shadow_errors"], len(texts))
        assert done == len(texts)
        summary = scorer.stop()
        errors = registry.counter("bank.shadow_errors").value
        assert errors >= 1 and summary["errors"] == errors
        counters = registry.snapshot()["counters"]
        assert counters.get("serve.errors", 0) == 0
        assert counters["serve.served"] == counters["serve.requests"] == len(texts)
        rows, torn = read_jsonl(tmp_path / "run" / SHADOW_DELTAS_NAME)
        assert torn == 0 and len(rows) == summary["sampled"] == len(texts) - errors
    finally:
        service.drain()


def test_shadow_queue_overflow_drops_and_counts(setup):
    """One tapped chunk larger than the queue: the tap holds the queue's
    lock for the whole chunk, so exactly ``max_queue`` rows are kept and
    the rest are counted as dropped."""
    predictor = setup["bucketed"]
    service = _service(predictor)
    texts = setup["texts"][:20]
    try:
        scorer = ShadowScorer(service, setup["anchors"], config=ShadowConfig(max_queue=4))
        scorer._tap(texts, predictor.score_texts(texts), service.bank_snapshot())
        assert _wait_counter(service.registry, ["bank.shadow_sampled"], 4) == 4
        summary = scorer.stop()
        assert (summary["sampled"], summary["dropped"]) == (4, 16)
    finally:
        service.drain()


def test_swap_bank_warms_a_new_geometry_first(setup, ws, tmp_path):
    predictor = setup["predictor"](buckets=[16, 48])
    store = _store_v2(ws, tmp_path / "banks")
    service = _service(predictor)
    warmed = []
    real = predictor.warmup_bank_shapes

    def counting(bank):
        warmed.append(tuple(bank.shape))
        return real(bank)

    predictor.warmup_bank_shapes = counting
    try:
        assert service.swap_bank(store.instances("v1"), source="manual") == 2
        assert warmed == []  # the startup geometry is warm already
        assert service.swap_bank(store.instances("v2"), store_version="v2") == 3
        assert len(warmed) == 1
        snapshot = service.bank_snapshot()
        assert (snapshot.version, snapshot.parent_version, snapshot.store_version) == (3, 2, "v2")
        assert snapshot.weights is None  # an all-1.0 bank selects by the plain argmax
        # a named tenant's slot: its own version line, the default untouched
        assert service.swap_bank(store.instances("v1"), tenant="orga") == 1
        assert service.tenant_banks()["orga"].n_anchors == len(store.instances("v1"))
        assert service.bank_snapshot() is snapshot
    finally:
        service.drain()


def _reweighted_stores(ws, root, weights):
    """The same v1 → v2 (a reweight) in a store of each package."""
    anchors = load_anchors(ws["paths"]["anchors"])
    ops = [{"op": "reweight", "category": cat, "weight": w} for cat, w in sorted(weights.items())]
    stores = []
    for store_cls, diff_cls, name in ((BankStore, BankDiff, "torch"),
                                      (jax_bankops.BankStore, jax_bankops.BankDiff, "jax")):
        store = store_cls(root / name)
        store.create(anchors, source="build")
        store.derive("v1", diff_cls.from_json(ops))
        stores.append(store)
    return stores


@pytest.mark.parametrize("impl", ["bucketed", "ragged"])
def test_promoted_reweighted_bank_serves_as_jax(setup, ws, tmp_path, impl):
    """Promote a reweighted v2 on the port's service and on the JAX
    package's: the same winning anchors (where the weighted top two are
    apart by more than the tolerance), scores within rtol 1e-4 / atol 1e-5,
    the raw probabilities reported; the winners are the weighted ``argmax``
    and differ from the plain one for some texts."""
    from memvul_tpu.serving import ScoringService as JaxService
    from memvul_tpu.serving import ServiceConfig as JaxServiceConfig

    texts = setup["texts"][:24]
    predictor = setup["predictor"](**({"buckets": [16, 48]} if impl == "bucketed" else PACK))
    # damp the category that wins most often and boost another, so the
    # weighted winners differ from the plain ones
    plain = predictor.score_texts(texts)
    labels = list(predictor.anchor_labels)
    wins = np.bincount(plain.argmax(axis=1), minlength=len(labels))
    top = labels[int(wins.argmax())]
    runner_up = labels[int(np.argsort(plain.mean(axis=0))[-2])]
    weights = {top: 0.05, **({runner_up: 3.0} if runner_up != top else {})}
    store, jax_store = _reweighted_stores(ws, tmp_path, weights)
    thresholds = dict(max_auc_drop=1.0, max_f1_drop=1.0, max_flip_rate=1.0, min_shadow_samples=1)
    evidence = {"sampled": 1, "flip_rate": 0.0}

    service = _service(predictor)
    jax_service = JaxService(setup["jax_predictor"](buckets=[16, 48]), config=JaxServiceConfig(
        max_batch=8, max_wait_ms=3.0, max_queue=1000, default_deadline_ms=30000.0))
    try:
        approved = evaluate_gate(GOOD, GOOD, evidence, GateThresholds(**thresholds),
                                 candidate="v2", parent="v1")
        jax_approved = jax_bankops.evaluate_gate(
            GOOD, GOOD, evidence, jax_bankops.GateThresholds(**thresholds),
            candidate="v2", parent="v1")
        assert promote(service, store, approved) == 2
        assert jax_bankops.promote(jax_service, jax_store, jax_approved) == 2
        snapshot = service.bank_snapshot()
        want_w = np.array([weights.get(label, 1.0) for label in snapshot.labels], np.float32)
        np.testing.assert_array_equal(snapshot.weights, want_w)
        np.testing.assert_array_equal(snapshot.weights, jax_service.bank_snapshot().weights)
        assert service.health_summary()["bank"]["weighted"] is True

        got = _score_all(service, texts)
        want = _score_all(jax_service, texts)
        raw = np.array([[r["predict"][label] for label in snapshot.labels] for r in got])
        weighted = raw * want_w
        winners = weighted.argmax(axis=1)
        assert [r["anchor"] for r in got] == [snapshot.labels[i] for i in winners]
        assert [r["score"] for r in got] == [float(raw[i, w]) for i, w in enumerate(winners)]
        assert (winners != raw.argmax(axis=1)).any()
        checked = 0
        for row, mine, ref in zip(weighted, got, want):
            assert mine["status"] == ref["status"] == "ok" and ref["bank_version"] == 2
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] > 10 * ATOL:
                assert mine["anchor"] == ref["anchor"]
                assert mine["score"] == pytest.approx(ref["score"], rel=RTOL, abs=ATOL)
                checked += 1
        assert checked >= len(texts) // 2
    finally:
        service.drain()
        jax_service.drain()


# -- CLI -----------------------------------------------------------------------------


def test_bank_cli_build_diff_log_roundtrip(tmp_path, capsys):
    anchors_path = tmp_path / "anchors.json"
    anchors_path.write_text(json.dumps(ANCHORS_V1))
    store_dir = tmp_path / "banks"
    assert cli.main(["bank", "build", "--store", str(store_dir), "--anchors", str(anchors_path),
                     "--note", "seed"]) == 0
    built = json.loads(capsys.readouterr().out)
    assert built["version"] == "v1" and built["n_anchors"] == 3
    assert built["anchors_sha256"] == jax_bankops.anchor_sha256(ANCHORS_V1)
    ops = [{"op": "add", "category": "CWE-502", "description": "deser"}]
    assert cli.main(["bank", "diff", "--store", str(store_dir), "--ops", json.dumps(ops),
                     "--retire", "CWE-89", "--reweight", "CWE-79=2.5"]) == 0
    derived = json.loads(capsys.readouterr().out)
    assert derived["version"] == "v2" and derived["parent"] == "v1"
    assert derived["weights"] == {"CWE-79": 2.5}
    assert cli.main(["bank", "log", "--store", str(store_dir)]) == 0
    log = json.loads(capsys.readouterr().out)
    assert log["versions"] == ["v1", "v2"] and log["active"] is None
    assert [m["version"] for m in log["lineage"]] == ["v1", "v2"]
    # usage errors exit 2 with a message, not a traceback
    assert cli.main(["bank", "diff", "--store", str(store_dir), "--retire", "CWE-404"]) == 2
    assert cli.main(["bank", "diff", "--store", str(tmp_path / "empty"), "--retire", "x"]) == 2
    # --tenant scopes the store to <store>/<tenant>; a name that cannot be a
    # telemetry label is a usage error
    assert cli.main(["bank", "log", "--store", str(store_dir), "--tenant", "orgA"]) == 2
    assert "must match" in capsys.readouterr().err
    assert cli.main(["bank", "build", "--store", str(store_dir), "--tenant", "orga",
                     "--anchors", str(anchors_path)]) == 0
    assert json.loads(capsys.readouterr().out)["version"] == "v1"
    assert BankStore(store_dir / "orga").versions() == ["v1"]


def test_bank_cli_shadow_and_promote(setup, ws, tmp_path, capsys):
    store = _store_v2(ws, tmp_path / "banks")
    results = tmp_path / "memory_result.json"
    setup["bucketed"].predict_file(setup["reader"], ws["paths"]["test"], results, split="test")
    base = ["--store", str(tmp_path / "banks"), "--candidate", "v2", "--archive",
            str(setup["archive"]), "--device", "cpu"]
    assert cli.main(["bank", "shadow", *base, "--corpus", ws["paths"]["test"], "--results",
                     str(results), "-o", str(tmp_path / "shadow"), "--split", "test"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["sampled"] == len(setup["instances"]) and summary["mode"] == "replay"
    assert json.loads((tmp_path / "shadow" / "shadow_summary.json").read_text()) == summary
    gate = ["bank", "promote", *base, "--golden-set", ws["paths"]["test"], "--split", "test",
            "--shadow-summary", str(tmp_path / "shadow" / "shadow_summary.json")]
    # too little evidence for the default 100 samples: refused, exit 1
    assert cli.main(gate) == 1
    refused = json.loads(capsys.readouterr().out)
    assert not refused["approved"]
    assert "insufficient_shadow_samples" in [r["code"] for r in refused["reasons"]]
    assert store.active() is None
    lenient = ["--min-shadow-samples", "1", "--max-flip-rate", "1", "--max-auc-drop", "1",
               "--max-f1-drop", "1"]
    assert cli.main([*gate, *lenient, "--apply"]) == 0
    approved = json.loads(capsys.readouterr().out)
    assert approved["approved"] and approved["candidate"] == "v2" and approved["parent"] == "v1"
    assert store.active()["version"] == "v2"
    assert [r["kind"] for r in store.promotions()] == ["gate_decision", "gate_decision"]
    assert cli.main([*gate[:-2], "--no-shadow", "--active", "v9", *lenient]) == 2


def test_bank_cli_default_device_refuses_a_host_without_cuda(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for CUDA-less hosts")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["bank", "shadow", "--store", str(tmp_path), "--candidate", "v1", "--archive",
                  str(setup["archive"]), "--corpus", "c.json", "--results", "r.json", "-o",
                  str(tmp_path / "out")])


# -- the bankops config section --------------------------------------------------------


def test_bankops_section_honoured_or_refused():
    from memvul_tpu.config import BANKOPS_DEFAULTS as JAX_BANKOPS_DEFAULTS
    from memvul_tpu_torch.config import BANKOPS_DEFAULTS, BANKOPS_UNREAD, bankops_config

    assert dict(BANKOPS_DEFAULTS, **BANKOPS_UNREAD) == JAX_BANKOPS_DEFAULTS
    assert bankops_config({"bankops": {"max_flip_rate": 0.5}})["max_flip_rate"] == 0.5
    assert bankops_config({"bankops": {"store_dir": None}}) == BANKOPS_DEFAULTS
    assert bankops_config({"bankops": {"shadow_sample_stride": 4}})["shadow_sample_stride"] == 4
    assert ShadowConfig.from_bankops(bankops_config({"bankops": {
        "shadow_sample_stride": 4, "shadow_max_queue": 8}})) == ShadowConfig(sample_stride=4,
                                                                               max_queue=8)
    with pytest.raises(ValueError, match="store_dir"):
        bankops_config({"bankops": {"store_dir": "banks/"}})


def test_serve_counts_anchor_wins_and_publishes_drift(setup, tmp_path):
    """``bankops.baseline`` starts a DriftMonitor over the served decisions'
    winning anchors; ``anchor_stats: false`` counts none."""
    from memvul_tpu_torch.build import serve_from_archive

    baseline = tmp_path / "anchor_baseline.json"
    baseline.write_text(json.dumps({"win_shares": {setup["anchors"][0]["meta"]["label"]: 1.0}}))
    texts = setup["texts"][:16]
    service = serve_from_archive(setup["archive"], device="cpu", overrides={"bankops": {
        "baseline": str(baseline), "drift_interval_s": 0.05}})
    try:
        _score_all(service, texts)
        deadline = time.monotonic() + 10
        while "bank.anchor_drift" not in service.registry.snapshot()["gauges"] \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        snap = service.registry.snapshot()
        assert sum(win_counts(snap["counters"]).values()) == len(texts)
        assert 0.0 <= snap["gauges"]["bank.anchor_drift"] <= 1.0
    finally:
        service.drain()
    assert not service.drift_monitor._thread.is_alive()
    quiet = serve_from_archive(setup["archive"], device="cpu",
                               overrides={"bankops": {"anchor_stats": False}})
    try:
        _score_all(quiet, texts)
        assert win_counts(quiet.registry.snapshot()["counters"]) == {}
        assert quiet.drift_monitor is None
    finally:
        quiet.drain()

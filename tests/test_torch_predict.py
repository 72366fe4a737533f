"""Corpus scoring end to end through both packages on one archive:
per-anchor probabilities agree to rtol 1e-4 / atol 1e-5, decisions and
the ``cal_metrics`` counts are identical, and AUC/AP agree to 1e-9."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from memvul_tpu import archive as jax_archive
from memvul_tpu.build import evaluate_from_archive as jax_evaluate
from memvul_tpu.data.synthetic import build_workspace
from memvul_tpu.models import BertConfig, MemoryModel
from memvul_tpu_torch.build import evaluate_from_archive as port_evaluate
from memvul_tpu_torch.evaluate import metrics as port_metrics
from memvul_tpu_torch.evaluate.measure import read_result_lines

ROOT = Path(__file__).resolve().parents[1]
EVAL_CASES = {
    "bucketed": {"batch_size": 8, "max_length": 64, "buckets": [16, 32, 64],
                 "tokens_per_batch": 256, "aot_warmup": False},
    "pad_to_max": {"batch_size": 8, "max_length": 48, "aot_warmup": False},
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("predict")
    ws = build_workspace(tmp / "ws", seed=3)
    vocab = ws["tokenizer"].vocab_size
    cfg = BertConfig.tiny(vocab_size=vocab, scan_layers=True, attention_impl="flash")
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(MemoryModel(cfg, header_dim=32).init(jax.random.PRNGKey(1), dummy, dummy))
    config = {
        "tokenizer": {"type": "wordpiece"},
        "dataset_reader": {
            "type": "reader_memory", "cve_path": ws["paths"]["cve"],
            "anchor_path": ws["paths"]["anchors"], "sample_neg": 0.1,
        },
        "model": {
            "type": "model_memory",
            "encoder": {"preset": "tiny", "vocab_size": vocab, "scan_layers": True,
                        "attention_impl": "flash"},
            "header_dim": 32,
        },
    }
    archive = jax_archive.save_archive(
        tmp / "model.tar.gz", config, params, tokenizer_file=ws["paths"]["tokenizer"]
    )
    return ws, archive, tmp


def _by_url(path):
    return {r["Issue_Url"]: r for r in read_result_lines(path)}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_matches_jax(setup, case):
    ws, archive, tmp = setup
    overrides = {"evaluation": EVAL_CASES[case]}
    jax_dir, port_dir = tmp / f"jax_{case}", tmp / f"port_{case}"
    want = jax_evaluate(archive, ws["paths"]["test"], jax_dir, overrides=overrides, use_mesh=False)
    got = port_evaluate(archive, ws["paths"]["test"], port_dir, overrides=overrides, device="cpu")

    jrec, prec = _by_url(jax_dir / "model_memory_result.json"), _by_url(port_dir / "model_memory_result.json")
    assert set(jrec) == set(prec)
    assert len(prec) == len(json.loads(Path(ws["paths"]["test"]).read_text()))
    for url, rec in jrec.items():
        mine = prec[url]
        assert mine["label"] == rec["label"]
        assert list(mine["predict"]) == list(rec["predict"])  # anchor order
        np.testing.assert_allclose(
            list(mine["predict"].values()), list(rec["predict"].values()), rtol=1e-4, atol=1e-5
        )
        assert (max(mine["predict"].values()) >= 0.5) == (max(rec["predict"].values()) >= 0.5)
    saved_j = json.loads((jax_dir / "model_memory_metric_all.json").read_text())
    saved_p = json.loads((port_dir / "model_memory_metric_all.json").read_text())
    assert set(saved_p) == set(saved_j)
    for key in ("TP", "FN", "TN", "FP"):
        assert saved_p[key] == saved_j[key] == got[key] == want[key]
    for key in ("auc", "ap"):
        assert abs(saved_p[key] - saved_j[key]) < 1e-9
    assert got["s_num_samples"] == want["s_num_samples"]
    assert abs(got["s_auc"] - want["s_auc"]) < 1e-9


def test_cli_evaluate_on_cpu(setup):
    ws, archive, tmp = setup
    out = tmp / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "memvul_tpu_torch", "evaluate", str(archive), ws["paths"]["test"],
         "-o", str(out), "--device", "cpu", "--overrides", json.dumps({"evaluation": EVAL_CASES["bucketed"]})],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert metrics["TP"] + metrics["FN"] + metrics["TN"] + metrics["FP"] == metrics["s_num_samples"]
    assert (out / "model_memory_metric_all.json").exists()


def test_predict_single_matches_file_scores(setup):
    from memvul_tpu_torch.archive import load_archive
    from memvul_tpu_torch.data.readers import MemoryReader
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor

    ws, archive, tmp = setup
    arch = load_archive(archive, device="cpu")
    predictor = SiamesePredictor(arch.model, arch.tokenizer, batch_size=8, max_length=64,
                                 buckets=[16, 32, 64], tokens_per_batch=256)
    reader = MemoryReader(anchor_path=ws["paths"]["anchors"])
    predictor.encode_anchors(reader.read_anchors())
    inst = next(iter(reader.read(ws["paths"]["test"])))
    single = predictor.predict_single(inst["text1"])
    probs, metas = next(predictor.score_instances([inst]))
    assert list(single["predict"]) == predictor.anchor_labels
    np.testing.assert_allclose(list(single["predict"].values()), probs[0], rtol=1e-5, atol=1e-6)
    assert single["anchor"] == predictor.anchor_labels[single["anchor_index"]]
    assert single["score"] == max(single["predict"].values())


@pytest.mark.parametrize("seed", range(4))
def test_numpy_roc_ap_match_sklearn_with_ties(seed):
    from sklearn import metrics as skm

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=200)
    scores = np.round(rng.random(200), 1)  # heavy ties
    fpr, tpr, thr = skm.roc_curve(labels, scores, pos_label=1)
    pfpr, ptpr, pthr = port_metrics.roc_curve(labels, scores)
    np.testing.assert_array_equal(pthr, thr)
    np.testing.assert_allclose(pfpr, fpr, rtol=0, atol=1e-15)
    np.testing.assert_allclose(ptpr, tpr, rtol=0, atol=1e-15)
    assert abs(port_metrics.auc(pfpr, ptpr) - skm.auc(fpr, tpr)) < 1e-12
    assert abs(
        port_metrics.average_precision_score(labels, scores)
        - skm.average_precision_score(labels, scores, pos_label=1)
    ) < 1e-12
    preds = (scores >= 0.5).astype(int)
    from memvul_tpu.training.metrics import model_measure, find_best_threshold

    assert port_metrics.model_measure(labels, preds, scores) == pytest.approx(
        model_measure(labels, preds, scores), rel=0, abs=1e-12
    )
    assert port_metrics.find_best_threshold(labels, scores) == find_best_threshold(labels, scores)

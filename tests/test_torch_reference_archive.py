"""Reference-archive loading and the parity chain of the port
(``memvul_tpu_torch/evaluate/reference_archive.py``, ``parity.py`` and the
``parity`` CLI) against the JAX package's, on the CPU.

A tiny HF ``BertModel`` (H = 64, 2 layers, 4 heads, the vocabulary of the
synthetic workspace) with the reference's heads, its weights drawn with
numpy from a seed, is saved as a reference-format ``model.tar.gz``
(``config.json`` + ``weights.th``) and as an HF directory.  Both packages
load them; the pooled and header outputs and the per-anchor scores must
agree within 1e-5 (f32), the metric files key for key and equal, and
``run_parity``'s report must have the JAX report's shape, skips and
errors.  Stage (a) runs with ``transformers`` (the oracle on this host)
and with its import hidden (skipped, ``ok`` false, exit 1)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import test_reference_archive_parity as refarc  # noqa: E402

from memvul_tpu.data.synthetic import build_workspace, corpus_texts, generate_corpus  # noqa: E402
from memvul_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece  # noqa: E402
from memvul_tpu.evaluate import parity as jax_parity  # noqa: E402
from memvul_tpu.evaluate.reference_archive import (  # noqa: E402
    load_reference_archive as jax_load_reference_archive,
)
from memvul_tpu_torch.__main__ import main as port_cli  # noqa: E402
from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer  # noqa: E402
from memvul_tpu_torch.evaluate import parity as port_parity  # noqa: E402
from memvul_tpu_torch.evaluate.reference_archive import (  # noqa: E402
    TRANSFORMER_PREFIX,
    convert_memory_state_dict,
    load_reference_archive,
)
from memvul_tpu_torch.models.convert import convert_bert_state_dict  # noqa: E402

ATOL = 1e-5
MAX_LEN, BATCH = 64, 16


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return build_workspace(tmp_path_factory.mktemp("port_refarc"), seed=21)


@pytest.fixture(scope="module")
def corpus(ws, tmp_path_factory):
    """The workspace's test split with each positive's ``CWE_ID`` resolved
    from the CVE dict onto the record, as a labelled corpus carries it:
    ``parity``'s reader has no CVE dict and drops a positive without one."""
    cve = json.loads(Path(ws["paths"]["cve"]).read_text())
    records = json.loads(Path(ws["paths"]["test"]).read_text())
    for rec in records:
        if str(rec.get("Security_Issue_Full")) in ("1", "1.0"):
            rec["CWE_ID"] = cve[rec["CVE_ID"]]["CWE_ID"]
    path = tmp_path_factory.mktemp("port_refarc_corpus") / "test_project.json"
    path.write_text(json.dumps(records))
    return str(path)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(reference-shaped torch model, its archive, an HF dir of its own
    transformer with the workspace's vocab.txt): weights from numpy."""
    reports, _ = generate_corpus(seed=21)
    tok = JaxWordPiece.train_from_corpus(corpus_texts(reports), vocab_size=1024)
    model = refarc.TorchMemoryModel(vocab_size=tok.vocab_size).eval()
    rng = np.random.default_rng(2021)
    with torch.no_grad():
        for name, param in model.named_parameters():
            if "LayerNorm.weight" in name:
                values = 1.0 + rng.normal(0.0, 0.05, param.shape)
            else:
                values = rng.normal(0.0, 0.02, param.shape)
            param.copy_(torch.from_numpy(values.astype(np.float32)))
    root = tmp_path_factory.mktemp("port_refarc_model")
    archive = refarc._save_reference_archive(model, root / "model.tar.gz")
    hf_dir = root / "tiny-bert"
    model._text_field_embedder.token_embedder_tokens.transformer_model.save_pretrained(str(hf_dir))
    vocab = sorted(tok._tok.get_vocab().items(), key=lambda kv: kv[1])
    (hf_dir / "vocab.txt").write_text("\n".join(w for w, _ in vocab) + "\n")
    return model, archive, hf_dir


def _sample(tokenizer, texts):
    ids = [tokenizer.encode(t, max_length=MAX_LEN) for t in texts]
    width = max(map(len, ids))
    block = np.zeros((len(ids), width), np.int32)
    mask = np.zeros_like(block)
    for i, row in enumerate(ids):
        block[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return block, mask


def test_loaded_archive_encodes_like_jax(ws, reference):
    """The port's model from the archive against the JAX package's: the
    pooled output and the header's, and the anchor-match scores."""
    _, archive, hf_dir = reference
    port_model, stored = load_reference_archive(archive, port_parity.hf_geometry(hf_dir),
                                                device="cpu")
    jax_model, params, jax_stored = jax_load_reference_archive(
        archive, jax_parity.hf_geometry(hf_dir))
    assert stored == jax_stored and stored["model"]["use_header"] is True
    assert port_model.use_header and port_model.temperature == jax_model.temperature

    tokenizer = WordPieceTokenizer(vocab_path=hf_dir / "vocab.txt")
    reports, _ = generate_corpus(seed=21)
    ids, mask = _sample(tokenizer, corpus_texts(reports)[:12])
    sample = {"input_ids": ids, "attention_mask": mask}

    theirs_pooled = np.asarray(jax_model.apply(
        params, sample, method=lambda m, s: m.pooler(m.encoder(s["input_ids"],
                                                               s["attention_mask"]))))
    theirs = np.asarray(jax_model.apply(params, sample, method=jax_model.encode))
    with torch.no_grad():
        hidden = port_model.bert(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
        ours_pooled = port_model.pooler(hidden).numpy()
        ours = port_model.header(port_model.pooler(hidden)).numpy()
        ours_scores = port_model.match_anchors(
            torch.from_numpy(ours), torch.from_numpy(ours[:5])).numpy()
    np.testing.assert_allclose(ours_pooled, theirs_pooled, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=0)
    theirs_scores = np.asarray(jax_model.apply(
        params, theirs, theirs[:5], method=jax_model.match_anchors))
    np.testing.assert_allclose(ours_scores, theirs_scores, atol=ATOL, rtol=0)


def _records(path):
    out = {}
    for line in Path(path).read_text().splitlines():
        for rec in json.loads(line):
            out[rec["Issue_Url"]] = rec
    return out


def test_archive_scoring_matches_jax(ws, corpus, reference, tmp_path):
    """Stage (b) of both packages over the same corpus: per-report
    per-anchor scores within 1e-5, the metric files key for key and equal."""
    _, archive, hf_dir = reference
    kw = dict(max_length=MAX_LEN, batch_size=BATCH)
    theirs = jax_parity.archive_scoring(archive, hf_dir, corpus,
                                        ws["paths"]["anchors"], tmp_path / "jax", **kw)
    ours = port_parity.archive_scoring(archive, hf_dir, corpus,
                                       ws["paths"]["anchors"], tmp_path / "port", device="cpu",
                                       **kw)
    assert set(ours) == set(theirs)
    assert ours["archive_config_model"] == theirs["archive_config_model"] == "model_memory"
    mine, jax_recs = _records(ours["result_file"]), _records(theirs["result_file"])
    assert set(mine) == set(jax_recs) and len(mine) > 0
    for url, rec in jax_recs.items():
        assert mine[url]["label"] == rec["label"]
        assert set(mine[url]["predict"]) == set(rec["predict"])
        for anchor, p in rec["predict"].items():
            assert abs(mine[url]["predict"][anchor] - p) <= ATOL, (url, anchor)
    m_ours = json.loads(Path(ours["metric_file"]).read_text())
    m_theirs = json.loads(Path(theirs["metric_file"]).read_text())
    assert list(m_ours) == list(m_theirs)
    assert m_ours == m_theirs
    assert m_ours["TP"] + m_ours["FN"] == 12 and m_ours["TN"] + m_ours["FP"] == 36
    assert {k for k in ours["metrics"] if not k.startswith("s_")} == {
        k for k in theirs["metrics"] if not k.startswith("s_")}


def test_convert_checks_every_key_and_shape(reference):
    model, _, hf_dir = reference
    config = port_parity.hf_geometry(hf_dir)
    sd = model.state_dict()
    converted = convert_memory_state_dict(sd, config)
    assert converted["pair_kernel"].shape == (3 * 512, 2)
    np.testing.assert_array_equal(converted["pair_kernel"].numpy(),
                                  sd["_projector.weight"].numpy().T)
    missing = {k: v for k, v in sd.items() if not k.endswith("layer.1.output.dense.bias")}
    with pytest.raises(KeyError, match="encoder.layer.1.output.dense.bias"):
        convert_memory_state_dict(missing, config)
    bad = dict(sd)
    key = TRANSFORMER_PREFIX + "encoder.layer.0.intermediate.dense.weight"
    bad[key] = bad[key][:, :32]
    with pytest.raises(ValueError, match="encoder.layer.0.intermediate.dense.weight"):
        convert_memory_state_dict(bad, config)
    hf_sd = {k[len(TRANSFORMER_PREFIX):]: v for k, v in sd.items()
             if k.startswith(TRANSFORMER_PREFIX)}
    with pytest.raises(ValueError, match="encoder layers"):
        convert_bert_state_dict(hf_sd, config.replace(num_layers=1))
    with pytest.raises(KeyError, match="not a model_memory"):
        convert_memory_state_dict({"_projector.weight": sd["_projector.weight"]}, config)
    # a "bert." prefix is stripped; the HF pooler is reported, not loaded
    encoder, pooler = convert_bert_state_dict({"bert." + k: v for k, v in hf_sd.items()}, config)
    assert set(pooler) == {"dense.weight", "dense.bias"}
    assert not any(k.startswith("pooler") for k in encoder)


def _shape(obj, skip_prefix="s_"):
    """The key structure of a report (values' types, not their numbers)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items() if not str(k).startswith(skip_prefix)}
    if isinstance(obj, bool):
        return bool
    if isinstance(obj, (int, float)):
        return float
    return type(obj)


def test_run_parity_report_matches_jax_shape(ws, corpus, reference, tmp_path):
    _, archive, hf_dir = reference
    kw = dict(archive=archive, corpus=corpus, anchors=ws["paths"]["anchors"],
              max_length=MAX_LEN, batch_size=BATCH, seq_len=24, atol=1e-3)
    theirs = jax_parity.run_parity(hf_dir, out_dir=tmp_path / "jax", **kw)
    ref_metrics = theirs["archive_scoring"]["metric_file"]
    theirs_diff = jax_parity.run_parity(hf_dir, out_dir=tmp_path / "jax2", ref_metrics=ref_metrics,
                                        **kw)
    ours = port_parity.run_parity(hf_dir, out_dir=tmp_path / "port", device="cpu", **kw)
    ours_diff = port_parity.run_parity(hf_dir, out_dir=tmp_path / "port2", ref_metrics=ref_metrics,
                                       device="cpu", **kw)
    assert _shape(ours) == _shape(theirs)
    assert _shape(ours_diff) == _shape(theirs_diff)
    assert ours["ok"] and ours["convert_parity"]["ok"]
    assert ours["convert_parity"]["max_abs_err"] < 1e-4
    assert ours["metric_diff"] == theirs["metric_diff"]  # the same skip
    # the JAX package's metric file diffs clean against the port's scoring
    assert ours_diff["ok"] and ours_diff["metric_diff"]["f1_delta"] == 0.0
    assert set(ours_diff["metric_diff"]["deltas"]) == set(theirs_diff["metric_diff"]["deltas"])

    # no scoring inputs: the same skips
    ours_skip = port_parity.run_parity(hf_dir, seq_len=24, atol=1e-3, device="cpu")
    theirs_skip = jax_parity.run_parity(hf_dir, seq_len=24, atol=1e-3)
    assert _shape(ours_skip) == _shape(theirs_skip)
    for stage in ("archive_scoring", "metric_diff"):
        assert ours_skip[stage]["skipped"] is True and theirs_skip[stage]["skipped"] is True


@pytest.mark.parametrize("partial", [
    {"archive": "whatever.tar.gz", "corpus": "test.json"},
    {"anchors": "golden.json"},
    {"ref_metrics": "ref_metric.json"},
])
def test_partial_scoring_inputs_raise_like_jax(reference, partial):
    _, _, hf_dir = reference
    with pytest.raises(ValueError) as theirs:
        jax_parity.run_parity(hf_dir, seq_len=24, **partial)
    with pytest.raises(ValueError) as ours:
        port_parity.run_parity(hf_dir, seq_len=24, device="cpu", **partial)
    flags = [f for f in ("--archive", "--corpus", "--anchors", "--ref-metrics")
             if f in str(theirs.value)]
    assert flags and all(f in str(ours.value) for f in flags)


def test_stage_a_without_transformers_is_skipped_not_passed(ws, corpus, reference, tmp_path,
                                                            monkeypatch, capsys):
    """The card's machine has no ``transformers``: stage (a) reports
    skipped with ``ok`` false, the report's ``ok`` is false and the CLI
    exits 1, while stages (b) and (c) still run."""
    _, archive, hf_dir = reference
    monkeypatch.setitem(sys.modules, "transformers", None)  # its import now raises
    stage = port_parity.convert_logit_parity(hf_dir, seq_len=24, device="cpu")
    assert stage == {"skipped": True, "reason": port_parity.NO_ORACLE, "ok": False}
    out = tmp_path / "out"
    rc = port_cli(["parity", "--hf-dir", str(hf_dir), "--archive", str(archive),
                   "--corpus", corpus, "--anchors", ws["paths"]["anchors"],
                   "-o", str(out), "--max-length", str(MAX_LEN), "--batch-size", str(BATCH),
                   "--seq-len", "24", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1 and report["ok"] is False
    assert report["convert_parity"]["skipped"] is True
    assert "f1" in report["archive_scoring"]["metrics"]
    assert Path(report["archive_scoring"]["metric_file"]).exists()
    rc = port_cli(["parity", "--hf-dir", str(hf_dir), "--archive", str(archive),
                   "--corpus", corpus, "--anchors", ws["paths"]["anchors"],
                   "-o", str(out), "--max-length", str(MAX_LEN), "--batch-size", str(BATCH),
                   "--ref-metrics", report["archive_scoring"]["metric_file"],
                   "--seq-len", "24", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1 and report["metric_diff"]["ok"] is True and report["ok"] is False


def test_parity_cli_exit_codes(ws, corpus, reference, tmp_path, capsys):
    """0 ok (and a matching metric file), 1 a drifted metric file, 2 partial
    inputs or a missing vocabulary, the JAX command's codes."""
    model, archive, hf_dir = reference
    base = ["parity", "--hf-dir", str(hf_dir), "--archive", str(archive),
            "--corpus", corpus, "--anchors", ws["paths"]["anchors"],
            "-o", str(tmp_path / "out"), "--max-length", str(MAX_LEN),
            "--batch-size", str(BATCH), "--seq-len", "24", "--atol", "1e-3", "--device", "cpu"]
    assert port_cli(base) == 0
    report = json.loads(capsys.readouterr().out)
    metric_file = Path(report["archive_scoring"]["metric_file"])
    assert report["convert_parity"]["ok"] and report["metric_diff"]["skipped"] is True
    drifted = json.loads(metric_file.read_text())
    drifted["f1"] = float(drifted["f1"]) + 0.1
    bad = tmp_path / "drifted.json"
    bad.write_text(json.dumps(drifted))
    assert port_cli(base + ["--ref-metrics", str(bad)]) == 1
    assert json.loads(capsys.readouterr().out)["metric_diff"]["ok"] is False
    assert port_cli(["parity", "--hf-dir", str(hf_dir), "--archive", "x.tar.gz",
                     "--corpus", "t.json", "--device", "cpu"]) == 2
    assert "--anchors" in capsys.readouterr().err
    no_vocab = tmp_path / "no_vocab"
    no_vocab.mkdir()
    (no_vocab / "config.json").write_text((hf_dir / "config.json").read_text())
    for name in ("model.safetensors", "pytorch_model.bin"):
        if (hf_dir / name).exists():
            (no_vocab / name).write_bytes((hf_dir / name).read_bytes())
    argv = list(base)
    argv[argv.index("--hf-dir") + 1] = str(no_vocab)
    assert port_cli(argv) == 2
    assert "vocab.txt" in capsys.readouterr().err


def test_entry_points_default_to_the_card(reference, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for CUDA-less hosts")
    _, archive, hf_dir = reference
    config = port_parity.hf_geometry(hf_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_reference_archive(archive, config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_parity.run_parity(hf_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_parity.convert_logit_parity(hf_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_parity.archive_scoring(archive, hf_dir, "t.json", "g.json", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["parity", "--hf-dir", str(hf_dir)])

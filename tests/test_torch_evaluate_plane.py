"""The evaluate plane of the port against the JAX package's, on the CPU:
``auto_buckets`` (the same tuple), the score journal and dead-letter file,
restartable corpus scoring (a crash and a resume give the bytes of an
uninterrupted run), quarantine, transient retries, the heartbeat log,
the ``_anchor`` stamps, the evaluation keys that raise, the reference's
CLI flags, and ``evaluate_from_archive`` with the reference's own
evaluation override files verbatim."""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from memvul_tpu import archive as jax_archive
from memvul_tpu.build import _auto_buckets_for_corpus as jax_auto_buckets_for_corpus
from memvul_tpu.build import evaluate_from_archive as jax_evaluate
from memvul_tpu.data.batching import auto_buckets as jax_auto_buckets
from memvul_tpu.data.readers import MemoryReader as JaxReader
from memvul_tpu.data.synthetic import build_workspace
from memvul_tpu.evaluate.predict_memory import SiamesePredictor as JaxPredictor
from memvul_tpu.models import BertConfig, MemoryModel
from memvul_tpu.resilience import journal as jax_journal
from memvul_tpu_torch import __main__ as cli
from memvul_tpu_torch.archive import load_archive
from memvul_tpu_torch.build import _auto_buckets_for_corpus, evaluate_from_archive
from memvul_tpu_torch.config import EVALUATION_DEFAULTS, evaluation_config
from memvul_tpu_torch.data.batching import auto_buckets
from memvul_tpu_torch.data.readers import MemoryReader
from memvul_tpu_torch.evaluate.measure import read_result_lines
from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
from memvul_tpu_torch.resilience import journal
from memvul_tpu_torch.resilience.retry import RetryPolicy

ROOT = Path(__file__).resolve().parents[1]
PRED = dict(batch_size=8, max_length=64, buckets=[16, 32, 64], tokens_per_batch=256)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny archive with JAX-initialised weights (f32, flash attention),
    its reader and its test corpus."""
    tmp = tmp_path_factory.mktemp("evaluate_plane")
    ws = build_workspace(tmp / "ws", seed=3)
    vocab = ws["tokenizer"].vocab_size
    cfg = BertConfig.tiny(vocab_size=vocab, scan_layers=True, attention_impl="flash")
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(MemoryModel(cfg, header_dim=32).init(jax.random.PRNGKey(1), dummy, dummy))
    config = {
        "tokenizer": {"type": "wordpiece"},
        "dataset_reader": {"type": "reader_memory", "cve_path": ws["paths"]["cve"],
                           "anchor_path": ws["paths"]["anchors"]},
        "model": {"type": "model_memory", "header_dim": 32,
                  "encoder": {"preset": "tiny", "vocab_size": vocab, "scan_layers": True,
                              "attention_impl": "flash"}},
    }
    archive = jax_archive.save_archive(tmp / "model.tar.gz", config, params,
                                       tokenizer_file=ws["paths"]["tokenizer"])
    arch = load_archive(archive, device="cpu")
    reader = MemoryReader(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"])
    return {"ws": ws, "archive": archive, "arch": arch, "reader": reader, "tmp": tmp}


def _predictor(setup, **kw):
    arch = setup["arch"]
    predictor = SiamesePredictor(arch.model, arch.tokenizer, **dict(PRED, **kw))
    predictor.encode_anchors(setup["reader"].read_anchors())
    return predictor


def _crash_after(predictor, n_calls, message):
    """Make the predictor's batch scoring raise ``RuntimeError(message)`` on
    its ``n_calls + 1``-th call (once), as a kill or a device fault would."""
    real = predictor._score
    calls = {"n": 0}

    def score(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == n_calls + 1:
            raise RuntimeError(message)
        return real(*args, **kwargs)

    predictor._score = score
    return calls


# -- auto_buckets ---------------------------------------------------------------


def _samples():
    rng = np.random.default_rng(0)
    return {
        "skewed": np.concatenate([rng.integers(20, 60, 800), rng.integers(90, 130, 150),
                                  np.full(50, 512)]).tolist(),
        "lognormal": np.minimum(rng.lognormal(4.6, 0.9, 2048).astype(int) + 2, 700).tolist(),
        "two_clusters": [30, 31, 32, 120, 121, 122],
        "empty": [],
        "all_at_cap": [512] * 40,
        "above_cap": [5, 9, 17, 200, 600, 900],
    }


@pytest.mark.parametrize("name", sorted(_samples()))
@pytest.mark.parametrize("n_buckets,align", [(8, 8), (4, 8), (3, 16), (1, 8), (0, 8)])
def test_auto_buckets_match_jax(name, n_buckets, align):
    lengths = _samples()[name]
    got = auto_buckets(lengths, 512, n_buckets=n_buckets, align=align)
    assert got == jax_auto_buckets(lengths, 512, n_buckets=n_buckets, align=align)
    assert got[-1] == 512 and list(got) == sorted(set(got)) and len(got) <= max(1, n_buckets)


def test_auto_buckets_two_clusters_exact():
    assert auto_buckets([30, 31, 32, 120, 121, 122], 512, n_buckets=3) == (32, 128, 512)
    assert auto_buckets([], 512) == (512,)


def test_auto_buckets_for_corpus_match_jax(setup):
    jarch = jax_archive.load_archive(setup["archive"])
    test = setup["ws"]["paths"]["test"]
    want = jax_auto_buckets_for_corpus(JaxReader(), jarch.tokenizer, test, 64, n_buckets=4)
    got = _auto_buckets_for_corpus(MemoryReader(), setup["arch"].tokenizer, test, 64, n_buckets=4)
    assert got == want and len(got) > 1


# -- journal and dead-letter file -----------------------------------------------


def _write_out_and_journal(tmp_path, batches, module=journal):
    out = tmp_path / "result.json"
    jr = module.ScoreJournal(tmp_path / "result.json.journal")
    with open(out, "w") as f:
        for i, rows in enumerate(batches):
            text = json.dumps([{"Issue_Url": f"u{r}", "label": "neg", "predict": {"a": 0.5}}
                               for r in rows])
            f.write(text + "\n")
            f.flush()
            jr.append(i, rows, text)
    jr.close()
    return out


def test_spans_and_digest_match_jax():
    for idx in ([0, 1, 2, 5, 7, 8, 9], [], [3], list(range(40, 0, -3))):
        assert journal.to_spans(idx) == jax_journal.to_spans(idx)
        assert journal.from_spans(journal.to_spans(idx)) == set(idx)
    text = json.dumps([{"predict": {"a": 0.123456}}])
    assert journal.line_digest(text) == jax_journal.line_digest(text)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_verified_prefix_matches_jax(tmp_path, writer):
    """Either package's journal verifies the same prefix in both: whole,
    after a torn output line, after a torn final entry, after a corrupt
    entry in the middle."""
    module = journal if writer == "port" else jax_journal
    batches = [[0, 1], [2, 3], [4], [5, 6, 7]]

    def both(case_dir):
        out = case_dir / "result.json"
        jpath = case_dir / "result.json.journal"
        mine = journal.ScoreJournal(jpath).verified_prefix(out)
        theirs = jax_journal.ScoreJournal(jpath).verified_prefix(out)
        assert mine == theirs
        return mine

    cases = {}
    for case in ("whole", "torn_line", "torn_entry", "corrupt_middle"):
        d = tmp_path / case
        d.mkdir()
        out = _write_out_and_journal(d, batches, module)
        jpath = d / "result.json.journal"
        if case == "torn_line":
            out.write_bytes(out.read_bytes()[:-10])
        elif case == "torn_entry":
            jpath.write_text(jpath.read_text()[:-15])
        elif case == "corrupt_middle":
            lines = jpath.read_text().splitlines()
            lines[1] = lines[1][:20]
            jpath.write_text("\n".join(lines) + "\n")
        cases[case] = both(d)
    assert cases["whole"][0] == 4 and cases["whole"][1] == set(range(8))
    assert cases["torn_line"][:2] == (3, {0, 1, 2, 3, 4})
    assert cases["torn_entry"][:2] == (3, {0, 1, 2, 3, 4})
    assert cases["corrupt_middle"][:2] == (1, {0, 1})
    # truncation cuts the output to the verified lines
    d = tmp_path / "torn_line"
    jr = journal.ScoreJournal(d / "result.json.journal")
    jr.truncate_to(3, d / "result.json")
    assert len((d / "result.json").read_text().splitlines()) == 3
    assert len(jr.read_entries()) == 3 and jr.entries_written == 3
    assert journal.ScoreJournal(tmp_path / "none.journal").verified_prefix(
        tmp_path / "none.json") == (0, set(), [])


def test_dead_letter_and_reader_quarantine_match_jax(setup, tmp_path):
    """A malformed line and an over-long record: both readers keep the same
    instances and dead-letter the same reasons."""
    ws = setup["ws"]
    src = json.loads(Path(ws["paths"]["test"]).read_text())
    monster = dict(src[0], Issue_Url="https://github.com/org0/repo0/issues/999",
                   Issue_Body="core dump follows " * 8_000)
    corpus = tmp_path / "test_dirty.jsonl"
    with open(corpus, "w") as f:
        for i, rec in enumerate(src + [monster]):
            f.write(json.dumps(rec) + "\n")
            if i == 2:
                f.write("{definitely not json\n")
    kept, reasons = {}, {}
    for name, reader_cls, module in (("port", MemoryReader, journal),
                                     ("jax", JaxReader, jax_journal)):
        dead = module.DeadLetter(tmp_path / f"{name}.deadletter", max_text_chars=100_000)
        kept[name] = [inst["meta"]["Issue_Url"] for inst in reader_cls(
            cve_path=ws["paths"]["cve"]).read(str(corpus), split="test", quarantine=dead)]
        dead.close()
        reasons[name] = [json.loads(line)["reason"]
                         for line in dead.path.read_text().splitlines()]
    assert kept["port"] == kept["jax"] and len(kept["port"]) == len(src)
    assert reasons["port"] == reasons["jax"] and len(reasons["port"]) == 2
    assert "JSONDecodeError" in reasons["port"][0] and "over-long" in reasons["port"][1]
    with pytest.raises(json.JSONDecodeError):
        list(MemoryReader(cve_path=ws["paths"]["cve"]).read(str(corpus), split="test"))


# -- restartable scoring ------------------------------------------------------


def test_crash_and_resume_is_byte_identical(setup, tmp_path):
    reader, test = setup["reader"], setup["ws"]["paths"]["test"]
    whole, cut = tmp_path / "whole.json", tmp_path / "cut.json"
    m_whole = _predictor(setup).predict_file(reader, test, whole, resume=True)
    plain = tmp_path / "plain.json"
    _predictor(setup).predict_file(reader, test, plain)
    assert plain.read_bytes() == whole.read_bytes()  # the journal changes no output byte

    crashing = _predictor(setup)
    _crash_after(crashing, 3, "injected hard crash")
    with pytest.raises(RuntimeError, match="injected hard crash"):
        crashing.predict_file(reader, test, cut, resume=True)
    committed = cut.read_text().splitlines()
    entries = len((tmp_path / "cut.json.journal").read_text().splitlines())
    assert 0 < entries == len(committed) < len(whole.read_text().splitlines())
    # a torn tail written after the last entry is cut away on resume
    with open(cut, "a") as f:
        f.write('[{"Issue_Url": "torn')

    resumed = _predictor(setup)
    calls = _crash_after(resumed, 10**9, "never")
    m_cut = resumed.predict_file(reader, test, cut, resume=True)
    assert cut.read_bytes() == whole.read_bytes()
    assert cut.read_text().splitlines()[:entries] == committed
    assert calls["n"] == m_whole["batches"] - entries  # the committed batches were skipped
    for key, value in m_whole.items():
        if key in ("elapsed_s", "batches") or key.startswith("bucket_") or key.endswith("_s"):
            continue
        assert m_cut[key] == value, key
    assert resumed.telemetry.snapshot()["counters"]["journal.lines_committed"] == \
        m_whole["batches"] - entries
    # a fresh run without resume deletes the stale journal
    _predictor(setup).predict_file(reader, test, cut)
    assert not (tmp_path / "cut.json.journal").exists()


def test_quarantine_completes_the_stream(setup, tmp_path):
    ws = setup["ws"]
    src = json.loads(Path(ws["paths"]["test"]).read_text())
    monster = dict(src[1], Issue_Url="https://github.com/org0/repo0/issues/998",
                   Issue_Body="x" * 1_000_001)
    corpus = tmp_path / "test_dirty.jsonl"
    with open(corpus, "w") as f:
        for i, rec in enumerate(src):
            f.write(json.dumps(rec) + "\n")
            if i == 4:
                f.write("{not json either\n")
                f.write(json.dumps(monster) + "\n")
    out = tmp_path / "q.json"
    predictor = _predictor(setup)
    metrics = predictor.predict_file(setup["reader"], corpus, out, split="test", quarantine=True)
    assert metrics["num_samples"] == len(src) and metrics["num_quarantined"] == 2
    dead = [json.loads(line) for line in (tmp_path / "q.json.deadletter").read_text().splitlines()]
    assert "JSONDecodeError" in dead[0]["reason"] and "over-long" in dead[1]["reason"]
    assert predictor.telemetry.snapshot()["counters"]["score.dead_letters"] == 2
    custom = tmp_path / "elsewhere" / "dead.jsonl"
    _predictor(setup).predict_file(setup["reader"], corpus, tmp_path / "q2.json", split="test",
                                   quarantine=str(custom))
    assert len(custom.read_text().splitlines()) == 2


def test_transient_failure_is_retried_and_others_raise(setup, tmp_path):
    reader, test = setup["reader"], setup["ws"]["paths"]["test"]
    want = _predictor(setup).predict_file(reader, test, tmp_path / "a.json")
    flaky = _predictor(setup)
    _crash_after(flaky, 2, "UNAVAILABLE: tunnel flake")
    got = flaky.predict_file(reader, test, tmp_path / "b.json",
                             retry_policy=RetryPolicy(attempts=3, backoff=0.0))
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    assert got["num_samples"] == want["num_samples"] and got["f1"] == want["f1"]
    assert flaky.telemetry.snapshot()["counters"]["resilience.retries"] == 1
    broken = _predictor(setup)
    _crash_after(broken, 2, "a bug, not a flake")
    with pytest.raises(RuntimeError, match="a bug"):
        broken.predict_file(reader, test, tmp_path / "c.json",
                            retry_policy=RetryPolicy(attempts=3, backoff=0.0))


def test_heartbeat_logged(setup, tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="memvul_tpu_torch.evaluate.predict_memory"):
        _predictor(setup).predict_file(setup["reader"], setup["ws"]["paths"]["test"],
                                       tmp_path / "h.json", heartbeat_batches=2,
                                       quarantine=True, resume=True)
    beats = [r.getMessage() for r in caplog.records if "scoring heartbeat" in r.getMessage()]
    assert beats
    assert all(k in beats[0] for k in ("rows/s", "journal total", "quarantined"))


# the stamps are an argmax over anchors: a row whose two best anchors lie
# within 1e-5 (the port and JAX agree to about 1e-6 here) may name either,
# so such rows are exempt
ANCHOR_TIE_GAP = 1e-5


def test_anchor_stamps_match_jax(setup):
    ws = setup["ws"]
    insts = list(setup["reader"].read(ws["paths"]["test"], split="test"))
    jarch = jax_archive.load_archive(setup["archive"])
    jpred = JaxPredictor(jarch.model, jarch.params, jarch.tokenizer, aot_warmup=False, **PRED)
    jpred.encode_anchors(JaxReader().read_anchors(ws["paths"]["anchors"]))
    want = {}
    for probs, metas in jpred.score_instances([dict(i, meta=dict(i["meta"])) for i in insts],
                                              with_anchors=True):
        for row, meta in zip(probs, metas):
            want[meta["Issue_Url"]] = (meta["_anchor"], meta["_anchor_index"], np.sort(row)[-2:])
    got = {}
    for probs, metas in _predictor(setup).score_instances(insts, with_anchors=True):
        for meta in metas:
            got[meta["Issue_Url"]] = (meta["_anchor"], meta["_anchor_index"])
    assert set(got) == set(want) and len(got) == len(insts)
    checked = 0
    for url, (anchor, index, top2) in want.items():
        if top2[1] - top2[0] < ANCHOR_TIE_GAP:
            continue
        assert got[url] == (anchor, index), url
        checked += 1
    assert checked >= len(want) // 2


# -- config and CLI -----------------------------------------------------------------


def test_evaluation_keys_honoured_or_refused():
    assert set(EVALUATION_DEFAULTS) == {
        "batch_size", "max_length", "buckets", "n_buckets", "tokens_per_batch", "inflight",
        "anchor_match_impl", "aot_warmup", "resume", "quarantine", "heartbeat_batches",
        "score_retries", "attribute_anchors", "shards", "max_shard_attempts",
        "shard_stall_timeout_s", "shard_poll_interval_s", "shard_backoff_s"}
    from memvul_tpu.config import EVALUATION_DEFAULTS as JAX_EVALUATION_DEFAULTS

    assert EVALUATION_DEFAULTS == JAX_EVALUATION_DEFAULTS
    assert evaluation_config({"evaluation": {"shards": 1, "resume": True}})["resume"] is True
    # the shard keys are score-corpus's, honoured since the sharded scorer
    for key, value in (("shards", 2), ("max_shard_attempts", 5), ("shard_backoff_s", 0.5)):
        assert evaluation_config({"evaluation": {key: value}})[key] == value


def test_cli_takes_the_reference_flags(setup, tmp_path, monkeypatch, capsys):
    ws = setup["ws"]
    overrides = json.dumps({"evaluation": dict(PRED, aot_warmup=False)})
    assert cli.main(["evaluate", str(setup["archive"]), ws["paths"]["test"], "-o",
                     str(tmp_path / "ref"), "--golden-file", ws["paths"]["anchors"],
                     "--threshold", "0.4", "--overrides", overrides, "--device", "cpu"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref["s_num_samples"] == 48
    assert cli.main(["evaluate", str(setup["archive"]), ws["paths"]["test"], "-o",
                     str(tmp_path / "alias"), "--golden", ws["paths"]["anchors"],
                     "--thres", "0.4", "--overrides", overrides, "--device", "cpu"]) == 0
    alias = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (tmp_path / "ref" / "model_memory_result.json").read_bytes() == \
        (tmp_path / "alias" / "model_memory_result.json").read_bytes()
    assert alias["TP"] == ref["TP"] and alias["FP"] == ref["FP"]
    seen = {}
    monkeypatch.setattr(cli, "cmd_train", lambda args: seen.update(vars(args)) or 0)
    assert cli.main(["train", "cfg.json", "-s", "run", "-o", '{"trainer": {}}', "--device",
                     "cpu"]) == 0
    assert seen["overrides"] == '{"trainer": {}}' and seen["serialization_dir"] == "run"


# -- the reference's evaluation override files, verbatim ---------------------------


# bf16 (test_config_memory_int8.json) moves a probability of this tiny
# random-weight model by up to a few 1e-3 between XLA's and PyTorch's bf16
# rounding on the CPU; f32 agrees to the predict tests' rtol 1e-4 / atol 1e-5
CONFIG_TOL = {"test_config_memory.json": dict(rtol=1e-4, atol=1e-5),
              "test_config_memory_int8.json": dict(rtol=0.0, atol=2e-2)}


@pytest.mark.parametrize("config", sorted(CONFIG_TOL))
def test_evaluate_reference_configs_verbatim(setup, config):
    ws, archive, tmp = setup["ws"], setup["archive"], setup["tmp"]
    text = (ROOT / "configs" / config).read_text()
    jax_dir, port_dir = tmp / f"jax_{config}", tmp / f"port_{config}"
    want = jax_evaluate(archive, ws["paths"]["test"], jax_dir, overrides=text, use_mesh=False)
    got = evaluate_from_archive(archive, ws["paths"]["test"], port_dir, overrides=text,
                                device="cpu")
    jrec = {r["Issue_Url"]: r for r in read_result_lines(jax_dir / "model_memory_result.json")}
    prec = {r["Issue_Url"]: r for r in read_result_lines(port_dir / "model_memory_result.json")}
    assert set(prec) == set(jrec) and len(prec) == 48
    for url, rec in jrec.items():
        assert list(prec[url]["predict"]) == list(rec["predict"])
        np.testing.assert_allclose(list(prec[url]["predict"].values()),
                                   list(rec["predict"].values()), **CONFIG_TOL[config])
    assert got["s_num_samples"] == want["s_num_samples"] == 48
    # the auto buckets: the same tuple as the JAX package's over this corpus
    jarch = jax_archive.load_archive(archive)
    buckets = jax_auto_buckets_for_corpus(JaxReader(), jarch.tokenizer, ws["paths"]["test"],
                                          jarch.model.config.max_position_embeddings, n_buckets=8)
    assert [length for _, length in got["s_stream_shapes"]] == list(buckets)
    assert {int(b) for b in got["s_bucket_batches"]} <= set(buckets)
    assert got["s_warmup_s"] > 0  # aot_warmup ran every stream shape
    if config == "test_config_memory.json":
        for key in ("TP", "FN", "TN", "FP"):
            assert got[key] == want[key]
        assert abs(got["auc"] - want["auc"]) < 1e-9


def _dirty_corpus(setup) -> Path:
    """The test corpus as JSON lines with a malformed line after the first
    record."""
    corpus = setup["tmp"] / "test_dirty_eval.jsonl"
    with open(corpus, "w") as f:
        for i, rec in enumerate(json.loads(Path(setup["ws"]["paths"]["test"]).read_text())):
            f.write(json.dumps(rec) + "\n")
            if i == 0:
                f.write("{not json\n")
    return corpus


def test_evaluate_attribute_anchors_and_resume_keys(setup):
    """The fault-tolerance keys of the evaluation section reach
    ``predict_file`` on a corpus with a malformed line: every record carries
    its anchor, the bad line is dead-lettered, and the journal lies beside
    the result."""
    ws, archive, tmp = setup["ws"], setup["archive"], setup["tmp"]
    corpus = _dirty_corpus(setup)
    overrides = {"evaluation": dict(PRED, aot_warmup=False,
                                    attribute_anchors=True, resume=True, quarantine=True,
                                    heartbeat_batches=1, score_retries=2)}
    out = tmp / "attribute"
    got = evaluate_from_archive(archive, corpus, out, overrides=overrides, device="cpu")
    records = read_result_lines(out / "model_memory_result.json")
    labels = [a for a in json.loads(Path(ws["paths"]["anchors"]).read_text())]
    assert len(records) == 48 and got["s_num_quarantined"] == 1
    assert {length for _, length in got["s_stream_shapes"]} <= set(PRED["buckets"])
    for rec in records:
        assert rec["anchor"] == labels[rec["anchor_index"]]
        assert rec["predict"][rec["anchor"]] == max(rec["predict"].values())
    assert (out / "model_memory_result.json.journal").exists()
    assert len((out / "model_memory_result.json.deadletter").read_text().splitlines()) == 1


def test_auto_bucket_sample_raises_on_malformed_as_jax(setup):
    """The auto-bucket sample reads the corpus head without the quarantine,
    as the JAX package's does: a malformed record there raises the same
    error in both, whatever ``quarantine`` says."""
    corpus = _dirty_corpus(setup)
    jarch = jax_archive.load_archive(setup["archive"])
    with pytest.raises(Exception) as want:
        jax_auto_buckets_for_corpus(JaxReader(), jarch.tokenizer, corpus, 64, n_buckets=3)
    with pytest.raises(type(want.value)):
        _auto_buckets_for_corpus(MemoryReader(), setup["arch"].tokenizer, corpus, 64, n_buckets=3)
    overrides = {"evaluation": dict(PRED, buckets="auto", n_buckets=3, quarantine=True)}
    with pytest.raises(type(want.value)):
        evaluate_from_archive(setup["archive"], corpus, setup["tmp"] / "auto_dirty",
                              overrides=overrides, device="cpu")

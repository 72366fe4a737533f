"""The port's sharded corpus scorer (``memvul_tpu_torch/distributed/``,
``score-corpus``) against the JAX package's, on the CPU.

* ``partition_rows`` equals the JAX package's for every (length, shards);
* the fault grammar (``MEMVUL_FAULTS``) parses every spec as the JAX
  package's does;
* the merge verifier rejects tampered lines, missing rows (naming their
  global spans), rows outside a span and rows covered twice, and the
  ``merge.verify`` fault point fires;
* a chaos run (one worker SIGKILLed mid-span, a transient ``score.batch``
  fault in the other) restarts, is exactly-once, and its merged records and
  metrics are byte-identical to the port's single-process ``evaluate``;
  its records agree with the JAX package's ``score_corpus`` on the same
  archive within ``tests/test_torch_predict.py``'s tolerance (rtol 1e-4,
  atol 1e-5), with the same decisions;
* a stalled worker is caught by its heartbeat age and restarted;
* a quarantined shard ends ``score-corpus`` with exit code 3 and the
  machine-readable refusal.

The workers run on the CPU (``device="cpu"``), one torch thread each.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from memvul_tpu import archive as jax_archive
from memvul_tpu.data.synthetic import build_workspace
from memvul_tpu.distributed import partition as jax_partition
from memvul_tpu.distributed import score_corpus as jax_score_corpus
from memvul_tpu.models import BertConfig, MemoryModel
from memvul_tpu.resilience import faults as jax_faults
from memvul_tpu_torch import __main__ as cli
from memvul_tpu_torch.build import evaluate_from_archive
from memvul_tpu_torch.distributed import MergeVerificationError, partition_rows, score_corpus
from memvul_tpu_torch.distributed.coordinator import _merge_and_verify, _ShardState, heartbeat_age_s
from memvul_tpu_torch.evaluate.measure import read_result_lines
from memvul_tpu_torch.resilience import faults
from memvul_tpu_torch.resilience.journal import ScoreJournal
from memvul_tpu_torch.telemetry import Registry
from memvul_tpu_torch.telemetry.sinks import read_jsonl

pytestmark = pytest.mark.chaos

# the evaluation geometry of the archive, so every worker and the
# single-process run score under one configuration
EVAL_CFG = {
    "batch_size": 8,
    "max_length": 64,
    "buckets": [32, 64],
    "aot_warmup": False,
    "heartbeat_batches": 1,
    "shard_poll_interval_s": 0.2,
    "shard_backoff_s": 0.2,
    "shard_stall_timeout_s": 60.0,
}
CHAOS = ("shard.kill.shard-1@3=sigkill;"
         "score.batch@2=raise:RuntimeError:UNAVAILABLE injected")
# tests/test_torch_predict.py's tolerance for the port against the JAX package
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    from memvul_tpu import telemetry as jax_telemetry

    monkeypatch.delenv("MEMVUL_FAULTS", raising=False)
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()
    jax_telemetry.reset()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny archive with JAX-initialised weights (flash attention) that
    both packages read, its workspace, and the port's uninterrupted
    single-process ``evaluate`` of its test corpus."""
    tmp = tmp_path_factory.mktemp("distributed")
    ws = build_workspace(tmp / "ws", seed=7)
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
        "evaluation": dict(EVAL_CFG),
        "telemetry": {"heartbeat_every_s": 0.5},
    }
    archive = jax_archive.save_archive(tmp / "model.tar.gz", config, params,
                                       tokenizer_file=ws["paths"]["tokenizer"])
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        evaluate_from_archive(archive, ws["paths"]["test"], tmp / "single", device="cpu")
    finally:
        torch.set_num_threads(before)
    single = tmp / "single"
    return {
        "ws": ws, "archive": archive, "tmp": tmp,
        "records": read_result_lines(single / "model_memory_result.json"),
        "metrics": single / "model_memory_metric_all.json",
    }


def _by_url(records):
    out = {r["Issue_Url"]: r for r in records}
    assert len(out) == len(records)  # the urls are unique
    return out


# -- partitioning and the fault grammar -------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 5, 7, 10, 48, 100, 511, 1000])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 16])
def test_partition_rows_matches_jax(n, k):
    spans = partition_rows(n, k)
    assert spans == jax_partition.partition_rows(n, k)
    assert spans == partition_rows(n, k)  # pure
    assert [i for s, e in spans for i in range(s, e)] == list(range(n))
    sizes = [e - s for s, e in spans]
    assert max(sizes) - min(sizes) <= 1


def test_partition_rows_refuses_bad_input():
    for args in ((-1, 2), (5, 0)):
        with pytest.raises(ValueError):
            partition_rows(*args)


FAULT_SPECS = [
    CHAOS,
    "score.batch@3=raise:RuntimeError:UNAVAILABLE injected",
    "shard.stall.shard-0=raise",
    "merge.verify=raise:ValueError:bad merge;bank.shadow@2=sigterm",
    "step.4=sigterm;data.read@2=raise:ValueError:bad record",
    " ; shard.kill=sigkill ; ",
]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_spec_parses_as_jax(spec):
    fields = ("point", "trigger", "action", "exc_name", "message")
    mine = [tuple(getattr(f, k) for k in fields) for f in faults.parse_spec(spec)]
    theirs = [tuple(getattr(f, k) for k in fields) for f in jax_faults.parse_spec(spec)]
    assert mine == theirs and mine


@pytest.mark.parametrize("spec", ["nope", "x@0=raise", "x@y=raise", "=raise", "x=sigkill:now",
                                  "x=explode"])
def test_fault_spec_refusals_match_jax(spec):
    with pytest.raises(ValueError):
        jax_faults.parse_spec(spec)
    with pytest.raises(ValueError):
        faults.parse_spec(spec)


def test_fault_point_fires_once_at_its_trigger(monkeypatch):
    monkeypatch.setenv("MEMVUL_FAULTS", "score.batch@2=raise:KeyError:second hit")
    faults.reset()
    assert faults.active() and faults.describe() == ["score.batch@2=raise"]
    faults.fault_point("score.batch")
    with pytest.raises(KeyError, match="second hit"):
        faults.fault_point("score.batch")
    faults.fault_point("score.batch")  # disarmed after firing
    assert faults.describe() == []
    faults.configure(None)
    assert not faults.active()


# -- the stall clock and the merge verifier ----------------------------------------


def test_heartbeat_age_resets_on_relaunch():
    hb = {"written_wall": 100.0}
    assert heartbeat_age_s(hb, 0.0, 130.0) == 30.0
    assert heartbeat_age_s(hb, 125.0, 130.0) == 5.0
    assert heartbeat_age_s({}, 0.0, 130.0) == 0.0
    assert heartbeat_age_s({"written_wall": "torn"}, 120.0, 130.0) == 10.0


def _write_shard(tmp_path, name, start, end, journal_rows=None):
    """A shard dir whose output and journal claim ``journal_rows`` (the
    whole local span by default), one row a line."""
    shard_dir = tmp_path / name
    shard_dir.mkdir(parents=True, exist_ok=True)
    out = shard_dir / "r.json"
    rows = list(range(end - start)) if journal_rows is None else journal_rows
    lines = [json.dumps([{"Issue_Url": f"u{start + r}", "label": "neg",
                          "predict": {"CWE-1": 0.25}}]) for r in rows]
    out.write_text("".join(line + "\n" for line in lines))
    journal = ScoreJournal(str(out) + ".journal")
    for i, (r, line) in enumerate(zip(rows, lines)):
        journal.append(i, [r], line)
    journal.close()
    return _ShardState(name=name, start=start, end=end, dir=shard_dir,
                       spec_path=shard_dir / "spec.json", out_path=out)


def _merge(tmp_path, states, rows):
    return _merge_and_verify(states, rows, tmp_path / "m.json", tmp_path / "mm.json", 0.5,
                             Registry())


def test_merge_verifier_accepts_exact_coverage(tmp_path):
    states = [_write_shard(tmp_path, "shard-0", 0, 3), _write_shard(tmp_path, "shard-1", 3, 5)]
    metrics, _ = _merge(tmp_path, states, 5)
    assert [r["Issue_Url"] for r in read_result_lines(tmp_path / "m.json")] == \
        [f"u{i}" for i in range(5)]
    assert metrics["TN"] == 5 and (tmp_path / "mm.json").exists()


def test_merge_verifier_rejects_tampered_line(tmp_path):
    sh = _write_shard(tmp_path, "shard-0", 0, 3)
    lines = sh.out_path.read_text().splitlines()
    lines[1] = json.dumps([{"Issue_Url": "tampered"}])
    sh.out_path.write_text("".join(line + "\n" for line in lines))
    with pytest.raises(MergeVerificationError) as exc:
        _merge(tmp_path, [sh], 3)
    assert exc.value.payload["status"] == "verification_failed"
    assert any("checksum" in p["reason"] for p in exc.value.payload["problems"])
    assert not (tmp_path / "mm.json").exists()


def test_merge_verifier_names_missing_global_spans(tmp_path):
    sh0 = _write_shard(tmp_path, "shard-0", 0, 3)
    sh1 = _write_shard(tmp_path, "shard-1", 3, 6, journal_rows=[0])
    with pytest.raises(MergeVerificationError) as exc:
        _merge(tmp_path, [sh0, sh1], 6)
    missing = [p for p in exc.value.payload["problems"] if "missing" in p["reason"]]
    assert missing and missing[0]["missing_spans"] == [[4, 6]]
    assert missing[0]["shard"] == "shard-1"


def test_merge_verifier_rejects_rows_outside_span(tmp_path):
    sh = _write_shard(tmp_path, "shard-0", 0, 2, journal_rows=[0, 1, 2])
    with pytest.raises(MergeVerificationError) as exc:
        _merge(tmp_path, [sh], 2)
    assert any("outside the shard span" in p["reason"] for p in exc.value.payload["problems"])


def test_merge_verifier_rejects_rows_covered_twice(tmp_path):
    # two shards claiming the same global rows (a span handed out twice)
    sh0 = _write_shard(tmp_path, "shard-0", 0, 2)
    sh1 = _write_shard(tmp_path / "again", "shard-1", 0, 2)
    with pytest.raises(MergeVerificationError) as exc:
        _merge(tmp_path, [sh0, sh1], 2)
    dup = [p for p in exc.value.payload["problems"] if "already covered" in p["reason"]]
    assert dup and dup[0]["duplicate_spans"] == [[0, 2]]


def test_merge_verify_fault_point(tmp_path):
    faults.configure("merge.verify=raise:RuntimeError:injected merge fault")
    with pytest.raises(RuntimeError, match="injected merge fault"):
        _merge(tmp_path, [], 0)


# -- end to end --------------------------------------------------------------------


def test_chaos_sigkill_and_transient_fault_byte_identical(setup, tmp_path, monkeypatch):
    monkeypatch.setenv("MEMVUL_FAULTS", CHAOS)
    out_dir = tmp_path / "run"
    result = score_corpus(setup["archive"], setup["ws"]["paths"]["test"], out_dir, shards=2,
                          overrides={"evaluation": {"score_retries": 2}}, device="cpu")

    # the SIGKILLed shard was seen dead and launched again
    assert result["restarts"] >= 1 and result["device"] == "cpu"
    assert result["verification"]["exactly_once"] is True
    assert [s["status"] for s in result["shards"]] == ["done", "done"]
    assert result["shards"][1]["failures"] == ["exit code -9"]

    # exactly once: the merged records are the single-process run's, each
    # byte-identical, and the merged metric file is its bytes
    merged = read_result_lines(result["out_results"])
    assert len(merged) == len(setup["records"]) == result["corpus_rows"]
    single = _by_url(setup["records"])
    for rec in merged:
        assert json.dumps(rec) == json.dumps(single[rec["Issue_Url"]])
    assert Path(result["out_metrics"]).read_bytes() == setup["metrics"].read_bytes()

    # every row of every shard is in its journal exactly once
    for sh in result["shards"]:
        assert _journal_rows(out_dir / sh["shard"]) == list(range(sh["rows"]))

    # the transient score.batch fault was retried inside a worker
    retries = sum(
        int(json.loads((d / "telemetry.json").read_text())["counters"].get("resilience.retries", 0))
        for d in sorted(out_dir.glob("shard-*")))
    assert retries >= 1

    # the supervision loop published the per-shard gauges and the lifecycle
    summary = json.loads((out_dir / "telemetry.json").read_text())
    assert {"shard.rows_committed.shard-0", "shard.rows_committed.shard-1",
            "shard.heartbeat_age_s.shard-1"} <= set(summary["gauges"])
    assert summary["counters"]["merge.rows_verified"] == result["corpus_rows"]
    kinds = [ev["kind"] for ev in read_jsonl(out_dir / "events.jsonl")[0]]
    assert "shard_restart" in kinds and "merge_verified" in kinds
    # the workers counted their kernels' launches (the plain versions on the CPU)
    for d in sorted(out_dir.glob("shard-*")):
        counters = json.loads((d / "telemetry.json").read_text())["counters"]
        assert counters["kernels.launches.anchor_match"] == 0


def _journal_rows(shard_dir):
    entries = ScoreJournal(str(shard_dir / "model_memory_result.json.journal")).read_entries()
    return sorted(r for e in entries for s, t in e["rows"] for r in range(s, t))


def test_resumed_workers_score_no_journaled_row_again(setup, tmp_path, monkeypatch):
    """Each worker is SIGKILLed at its third batch, after its first batches
    were committed (``inflight`` 0: a batch is written before the next is
    launched).  The second attempt resumes from the journal: it scores only
    the rows the first did not commit, and the merge is still the
    single-process run's bytes."""
    monkeypatch.setenv("MEMVUL_FAULTS", "score.batch@3=sigkill")
    out_dir = tmp_path / "run"
    result = score_corpus(setup["archive"], setup["ws"]["paths"]["test"], out_dir, shards=2,
                          overrides={"evaluation": {"inflight": 0}}, device="cpu")
    assert [s["restarts"] for s in result["shards"]] == [1, 1]
    for sh in result["shards"]:
        counters = json.loads((out_dir / sh["shard"] / "telemetry.json").read_text())["counters"]
        # the second attempt's own work: fewer rows than the span, each once
        assert counters["score.rows"] == counters["journal.rows_committed"] < sh["rows"]
        assert _journal_rows(out_dir / sh["shard"]) == list(range(sh["rows"]))
    assert Path(result["out_metrics"]).read_bytes() == setup["metrics"].read_bytes()
    single = _by_url(setup["records"])
    for rec in read_result_lines(result["out_results"]):
        assert json.dumps(rec) == json.dumps(single[rec["Issue_Url"]])


def test_score_corpus_agrees_with_jax(setup, tmp_path):
    """The JAX package's own sharded scorer on the same archive: the same
    reports, probabilities within the tolerance, the same decisions and the
    same metric counts."""
    ws = setup["ws"]
    mine = score_corpus(setup["archive"], ws["paths"]["test"], tmp_path / "port", shards=2,
                        device="cpu")
    theirs = jax_score_corpus(setup["archive"], ws["paths"]["test"], tmp_path / "jax", shards=2)
    assert mine["corpus_rows"] == theirs["corpus_rows"]
    got = _by_url(read_result_lines(mine["out_results"]))
    want = _by_url(read_result_lines(theirs["out_results"]))
    assert set(got) == set(want)
    for url, rec in want.items():
        assert list(got[url]["predict"]) == list(rec["predict"])
        np.testing.assert_allclose(list(got[url]["predict"].values()),
                                   list(rec["predict"].values()), rtol=RTOL, atol=ATOL)
        assert (max(got[url]["predict"].values()) >= 0.5) == (max(rec["predict"].values()) >= 0.5)
    for key in ("TP", "FN", "TN", "FP"):
        assert mine["metrics"][key] == theirs["metrics"][key]


def test_stalled_worker_is_caught_and_restarted(setup, tmp_path, monkeypatch):
    monkeypatch.setenv("MEMVUL_FAULTS", "shard.stall.shard-0@2=raise")
    result = score_corpus(
        setup["archive"], setup["ws"]["paths"]["test"], tmp_path / "run", shards=2, device="cpu",
        overrides={"evaluation": {"shard_stall_timeout_s": 10.0}},
    )
    assert result["shards"][0]["restarts"] == 1
    assert result["shards"][0]["failures"][0].startswith("stalled (heartbeat age")
    assert Path(result["out_metrics"]).read_bytes() == setup["metrics"].read_bytes()


def test_quarantine_partial_completion_exit_3(setup, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MEMVUL_FAULTS", "shard.kill.shard-0=sigkill")
    out_dir = tmp_path / "run"
    rc = cli.main([
        "score-corpus", str(setup["archive"]), setup["ws"]["paths"]["test"], "-o", str(out_dir),
        "--shards", "2", "--device", "cpu",
        "--overrides", json.dumps({"evaluation": {"max_shard_attempts": 1}}),
    ])
    assert rc == 3
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spans = partition_rows(len(setup["records"]), 2)
    assert payload["status"] == "partial"
    assert payload["missing_spans"] == [list(spans[0])]
    assert payload["rows_missing"] == spans[0][1] - spans[0][0]
    assert payload["quarantined"][0]["shard"] == "shard-0"
    assert payload["quarantined"][0]["failures"]
    assert not (out_dir / "model_memory_result.json").exists()
    assert not (out_dir / "model_memory_metric_all.json").exists()


@pytest.mark.parametrize("overrides,needle", [
    ({"evaluation": {"shards": 0}}, "shards must be >= 1"),
    ({"telemetry": {"metrics_port": -1}}, "metrics_port"),
    ({"telemetry": {"step_events": "yes"}}, "telemetry.step_events"),
    ({"telemetry": {"hbm_gauges": "yes"}}, "telemetry.hbm_gauges"),
    ({"model": {"type": "model_single"}}, "memory-model archives only"),
])
def test_score_corpus_usage_errors_exit_2(setup, tmp_path, capsys, overrides, needle):
    rc = cli.main(["score-corpus", str(setup["archive"]), setup["ws"]["paths"]["test"],
                   "-o", str(tmp_path / "run"), "--device", "cpu",
                   "--overrides", json.dumps(overrides)])
    assert rc == 2
    assert needle in capsys.readouterr().err
    assert not list((tmp_path / "run").glob("shard-*"))


def test_cuda_workers_wait_for_one_kernel_build(setup, tmp_path, monkeypatch):
    """On the card the coordinator builds the kernel library once before it
    spawns a worker; a build failure raises there, and no worker starts."""
    import memvul_tpu_torch.build as build
    from memvul_tpu_torch.ops import _kernels

    calls = []

    def failing_build(force=False):
        calls.append(force)
        raise RuntimeError("nvcc failed on ['anchor_match.cu']")

    monkeypatch.setattr(build, "resolve_device", lambda device="cuda": torch.device(device))
    monkeypatch.setattr(_kernels, "build", failing_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        score_corpus(setup["archive"], setup["ws"]["paths"]["test"], tmp_path / "run", shards=2)
    assert calls == [False]
    assert not list((tmp_path / "run").glob("shard-*"))


def test_default_device_refuses_a_host_without_cuda(setup, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for CUDA-less hosts")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        score_corpus(setup["archive"], setup["ws"]["paths"]["test"], tmp_path / "run")

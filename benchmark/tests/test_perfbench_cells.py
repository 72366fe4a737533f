"""Whole runs of a tiny cell on the CPU: a sound run, each planted fault
that the cells can have, a cell added from new files alone, and what the
run imports."""

import json
import shutil

import pytest

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "memvul_tpu"}


def test_sound_run(tiny_copy):
    out = tiny.result(tiny.run(tiny_copy, "tiny.short", seconds=1.5))
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"reports_per_s", "setup_s"}
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("workload, fault", [("tiny.short", "answer_swapped"),
                                             ("tiny.short", "half_batch"),
                                             ("tiny.short", "answer_shifted"),
                                             ("tiny.short.dp2", "no_exchange")])
def test_a_fault_makes_the_run_incorrect(tiny_copy, workload, fault):
    out = tiny.result(tiny.run(tiny_copy, workload, seconds=1.5, fault=fault))
    assert out["correct"] is False and out["failed"] > 0
    assert out["checks"]["answer_mse"]["value"] > out["checks"]["answer_mse"]["limit"]


def test_sound_two_rank_run(tiny_copy):
    out = tiny.result(tiny.run(tiny_copy, "tiny.short.dp2", seconds=1.5))
    assert out["correct"] is True and out["device"]["count"] == 2


def test_a_cell_added_from_files_alone(tiny_copy, tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(tiny_copy, copy, symlinks=True)
    bench = copy / "benchmark"
    m = json.loads((copy / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny-b", vocab_seed=11)
    (bench / "configs" / "tiny-b.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "corpus-short.json").read_text())
    mix["lengths"] = {"law": "lognormal_words", "mu": 2.5, "sigma": 0.6, "clamp_min": 3, "clamp_max": 90}
    (bench / "traffic" / "corpus-words.json").write_text(json.dumps(mix))
    (bench / "cells" / "tinyb.words.json").write_text(json.dumps(tiny.TINY_CELL))
    (bench / "metrics" / "stream_s.score.py").write_text(
        "def read(run):\n    return run['stream']['seconds']\n")
    m["configs"].append({"name": "tiny-b", "source": "test", "file": "benchmark/configs/tiny-b.json",
                         "reduced": [], "why": "added by a test"})
    m["workloads"].append({"name": "tinyb.words", "config": "tiny-b", "traffic": "corpus-words",
                           "chips": 1, "why": "added by a test"})
    m["per_layer"].append({"name": "stream_s.score", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "predictor", "moves": "reports_per_s",
                           "workloads": ["tinyb.words"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(m))
    plain = tiny.result(tiny.run(copy, "tinyb.words", seconds=1.5))
    assert plain["correct"] is True and "reports_per_s" in plain["metrics"]
    traced = tiny.result(tiny.run(copy, "tinyb.words", seconds=1.5, trace=1))
    assert traced["correct"] is True and traced["metrics"]["stream_s.score"]["value"] > 1.5
    assert "breakdown" in traced and traced["device"]["window_s"] > 0


def test_a_run_imports_no_jax(tiny_copy, tmp_path):
    listing = tmp_path / "modules.json"
    out = tiny.result(tiny.run(tiny_copy, "tiny.short", seconds=1.0,
                               env={"PERFBENCH_MODULES_OUT": str(listing)}))
    assert out["correct"] is True
    tops = set(json.loads(listing.read_text()))
    assert "memvul_tpu_torch" in tops and "torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_no_result_without_the_program(tiny_copy, tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    exits non-zero and prints no result."""
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(tiny_copy / "BENCHMARK.json", bare)
    shutil.copytree(tiny_copy / "benchmark", bare / "benchmark")
    proc = tiny.run(bare, "tiny.short", seconds=1.0)
    assert proc.returncode != 0 and not proc.stdout.strip()

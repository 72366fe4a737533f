"""A copy of the benchmark with a tiny cell, for runs on the CPU.

:func:`make_copy` copies ``BENCHMARK.json`` and ``benchmark/`` into a
directory, links the program's package beside them, and adds a BERT of width
64 (``tiny``), a mix of short reports (``corpus-short``) and two cells:
``tiny.short`` on one process and ``tiny.short.dp2`` on a gloo world of two.
:func:`run` drives a cell there through ``cpu_run.py``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "name": "tiny", "reference": "memvul_siamese", "source": "test",
    "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
    "intermediate_size": 128, "vocab_size": 2048, "max_position_embeddings": 128,
    "type_vocab_size": 2, "layer_norm_eps": 1e-12, "header_dim": 32, "temperature": 0.1,
    "num_classes": 2, "vocab_seed": 3,
    "anchors": {"count": 9, "lengths": {"law": "lognormal_words", "mu": 2.5, "sigma": 0.5,
                                        "clamp_min": 4, "clamp_max": 40}},
    "program": {
        "model": {"type": "model_memory",
                  "encoder": {"preset": "tiny", "dtype": "bfloat16", "max_position_embeddings": 128},
                  "use_header": True, "header_dim": 32, "temperature": 0.1},
        "evaluation": {"batch_size": 32, "max_length": 128, "buckets": [32, 64, 128],
                       "tokens_per_batch": 2048},
    },
}
TINY_MIX = {
    "entry": "score_corpus",
    "lengths": {"law": "loguniform_wordpieces", "min": 8, "max": 160},
    "sentences": {"sentences": 256, "words": [3, 12], "zipf": 1.07, "compound": 0.12,
                  "number": 0.04, "punct": 0.12, "end": 1.0},
}
TINY_CELL = {"sample": 48, "limits": {"answer_mse": 1.5e-4}}


def make_copy(dst: Path) -> Path:
    dst = Path(dst)
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "memvul_tpu_torch", dst / "memvul_tpu_torch")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                                "reduced": [], "why": "a CPU rehearsal"})
    for name, chips in (("tiny.short", 1), ("tiny.short.dp2", 2)):
        manifest["workloads"].append({"name": name, "config": "tiny", "traffic": "corpus-short",
                                      "chips": chips, "why": "a CPU rehearsal"})
        (dst / "benchmark" / "cells" / f"{name}.json").write_text(json.dumps(TINY_CELL))
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    (dst / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (dst / "benchmark" / "traffic" / "corpus-short.json").write_text(json.dumps(TINY_MIX))
    return dst


def run(copy: Path, workload: str, seed: int = 5, seconds: float = 2.0, trace: int = 0,
        fault: Optional[str] = None, env: Optional[Dict[str, str]] = None,
        timeout: float = 240.0) -> subprocess.CompletedProcess:
    cmd: List[str] = [sys.executable, str(Path(copy) / "benchmark" / "tests" / "cpu_run.py"),
                      "--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)]
    env = dict(os.environ, PERFBENCH_FAULT=fault or "", OMP_NUM_THREADS="2", **(env or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(cmd, cwd=copy, env=env, capture_output=True, text=True, timeout=timeout)


def result(proc: subprocess.CompletedProcess) -> Dict:
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])

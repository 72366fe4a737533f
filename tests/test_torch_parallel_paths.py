"""The port's multi-device paths on 2-rank gloo worlds of CPU processes,
held against the single-process port on the same inputs:

* ``train --mesh data=2 --device cpu`` (the launcher: rank 0 is the
  command, rank 1 its child) of the memory model with dedup, and
  ``build.train_from_config`` on a ``data=2`` mesh without dedup: an
  epoch of nine steps of K=2 microbatches at dropout 0, whose last stack's
  padding rows fall unevenly over the ranks; losses and final params within f32 1e-5 of the
  single-process runs, and only rank 0 writes the run directory's files;
* ``ClassifierTrainer`` (MemVul-m) on ``data=2``;
* ``evaluate --mesh data=2`` and the int8 dynamic tier on a ``data=2``
  mesh: probabilities within 1e-4/1e-5 of one process, the metric file
  equal; ``test_single`` on ``data=2``;
* the CLI: rank 0 alone prints the JSON line; a bad spec exits 2; a rank
  that dies takes the world down with a non-zero exit inside its timeout.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
INT8 = {"model": {"encoder": {"quant": "int8_dynamic"}}, "evaluation": {"batch_size": 8}}
RESUME = {"evaluation": {"batch_size": 8, "resume": True, "quarantine": True}}
SINGLE_EVAL = {"evaluation": {"batch_size": 8, "max_length": 48}}


def _memory_config(paths, dedup: bool):
    from memvul_tpu_torch.data.synthetic import selfcheck_config

    # 14 pairs a batch: the epoch's 9 stacks end in one whose dead rows
    # sit mostly on rank 1's half
    cfg = selfcheck_config({"paths": paths}, batch_size=14, grad_accum=2, steps_per_epoch=None,
                           dedup_anchors=dedup, sync_every=4)
    cfg["model"]["encoder"].update(hidden_dropout=0.0, attention_dropout=0.0)
    return cfg


def _single_config(paths):
    return {
        "random_seed": 2021,
        "tokenizer": {"type": "wordpiece", "tokenizer_path": paths["tokenizer"]},
        "dataset_reader": {"type": "reader_single", "sample_neg": 0.5},
        "train_data_path": paths["train"], "validation_data_path": paths["validation"],
        "model": {"type": "model_single", "header_dim": 32,
                  "encoder": {"preset": "tiny", "hidden_dropout": 0.0, "attention_dropout": 0.0}},
        "trainer": {"num_epochs": 1, "steps_per_epoch": 3, "batch_size": 6, "max_length": 48,
                    "eval_batch_size": 8, "eval_max_length": 48},
    }


def _losses(result):
    return [x for epoch in result["history"] for x in epoch["training_losses"]]


def paths_world(paths, work, corpus):
    """One rank: the no-dedup memory run, the classifier run, the int8 and
    single-model evaluations, and a quarantined scoring pass cut and
    resumed, on a data=2 mesh."""
    torch.set_num_threads(1)
    from memvul_tpu_torch import build
    from memvul_tpu_torch.parallel import create_mesh

    work = Path(work)
    mesh = create_mesh({"data": 2}, device="cpu")
    out = {}
    for name, cfg in (("mem_nodedup", _memory_config(paths, False)),
                      ("single", _single_config(paths))):
        out[name] = _losses(build.train_from_config(cfg, work / name, device="cpu", mesh=mesh))
    for name, archive, overrides in (("ev_int8", "mem_nodedup", INT8),
                                     ("ev_single", "single", SINGLE_EVAL)):
        metrics = build.evaluate_from_archive(work / archive / "model.tar.gz", paths["test"],
                                              work / name, overrides=overrides, device="cpu",
                                              mesh=mesh)
        out[name] = metrics.get("num_samples", metrics.get("s_num_samples"))
    # restartable scoring on the mesh: a corpus with a malformed line,
    # quarantined; rank 0 cuts the output's last line (a torn pass), and the
    # resumed run scores that batch again on every rank
    resumed = work / "ev_resume"
    for attempt in range(2):
        build.evaluate_from_archive(work / "mem_nodedup" / "model.tar.gz", corpus, resumed,
                                    overrides=RESUME, device="cpu", mesh=mesh)
        if attempt == 0 and mesh.is_primary:
            result = resumed / "model_memory_result.json"
            lines = result.read_text().splitlines(keepends=True)
            result.write_text("".join(lines[:-1]))
        torch.distributed.barrier()
    out["rank"] = mesh.rank
    return out


def _cli(*argv, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "memvul_tpu_torch", *map(str, argv)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})),
    )


def _finish(proc, timeout=150):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from memvul_tpu_torch import build
    from memvul_tpu_torch.data.synthetic import build_workspace
    from memvul_tpu_torch.parallel.launch import run_ranks

    work = tmp_path_factory.mktemp("paths")
    paths = build_workspace(work / "ws", seed=5)["paths"]
    cfg_file = work / "memory.json"
    cfg_file.write_text(json.dumps(_memory_config(paths, True)))
    train_cli = _cli("train", cfg_file, "-s", work / "cli_train", "--mesh", "data=2",
                     "--device", "cpu")
    # a JSON-lines test corpus with one malformed line, for the quarantine
    records = json.loads(Path(paths["test"]).read_text())
    corpus = work / "test_dirty.jsonl"
    lines = [json.dumps(r) for r in records]
    lines.insert(len(lines) // 2, "{not json")
    corpus.write_text("\n".join(lines) + "\n")
    world = run_ranks("test_torch_parallel_paths:paths_world", 2, work / "world",
                      {"paths": paths, "work": str(work / "world"), "corpus": str(corpus)},
                      timeout_s=150,
                      env={"OMP_NUM_THREADS": "1"}, python_path=[Path(__file__).parent])
    train_out = _finish(train_cli)
    eval_cli = _cli("evaluate", work / "cli_train", paths["test"], "-o", work / "cli_eval",
                    "--mesh", "data=2", "--device", "cpu")
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = {}
        for name, cfg in (("mem_dedup", _memory_config(paths, True)),
                          ("mem_nodedup", _memory_config(paths, False)),
                          ("single", _single_config(paths))):
            ref[name] = _losses(build.train_from_config(cfg, work / "ref" / name, device="cpu"))
        for name, archive, overrides in (
                ("ev_fp32", work / "cli_train", None),
                ("ev_int8", work / "world" / "mem_nodedup", INT8),
                ("ev_single", work / "world" / "single", SINGLE_EVAL)):
            build.evaluate_from_archive(archive, paths["test"], work / "ref" / name,
                                        overrides=overrides, device="cpu")
        build.evaluate_from_archive(work / "world" / "mem_nodedup", corpus, work / "ref" / "ev_resume",
                                    overrides=RESUME, device="cpu")
    finally:
        torch.set_num_threads(previous)
    eval_out = _finish(eval_cli)
    return {"work": work, "paths": paths, "world": world, "ref": ref,
            "train_out": train_out, "eval_out": eval_out}


def _params(archive):
    from memvul_tpu_torch.archive import load_archive

    return {k: v.detach().numpy() for k, v in load_archive(archive, device="cpu").model.state_dict().items()}


def _assert_params_close(got_archive, want_archive):
    got, want = _params(got_archive), _params(want_archive)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)


def _records(path):
    from memvul_tpu_torch.evaluate.measure import read_result_lines

    return {r["Issue_Url"]: r for r in read_result_lines(path)}


def test_memory_trainer_dedup_on_data_2_matches_one_process(runs):
    work = runs["work"]
    metrics = json.loads((work / "cli_train" / "metrics.json").read_text())
    np.testing.assert_allclose(_losses(metrics), runs["ref"]["mem_dedup"], rtol=0, atol=1e-5)
    assert len(_losses(metrics)) == 9
    _assert_params_close(work / "cli_train" / "model.tar.gz", work / "ref" / "mem_dedup" / "model.tar.gz")


def test_memory_trainer_without_dedup_on_data_2_matches_one_process(runs):
    work = runs["work"]
    for rank in runs["world"]:
        np.testing.assert_allclose(rank["mem_nodedup"], runs["ref"]["mem_nodedup"], rtol=0, atol=1e-5)
    _assert_params_close(work / "world" / "mem_nodedup" / "model.tar.gz",
                         work / "ref" / "mem_nodedup" / "model.tar.gz")


def test_the_padding_rows_fall_unevenly_over_the_ranks(runs):
    """The loss denominator is global: a batch whose dead rows sit on one
    rank's half is what a mean of per-rank means gets wrong."""
    from memvul_tpu_torch import build
    from memvul_tpu_torch.training.trainer import MemoryTrainer, TrainerConfig

    cfg = _memory_config(runs["paths"], True)
    tok = build.build_tokenizer(cfg["tokenizer"])
    trainer = MemoryTrainer(build.init_params(build.build_model(cfg["model"], tok.vocab_size), 2021),
                            tok, build.build_reader(cfg["dataset_reader"], seed=2021),
                            runs["paths"]["train"], config=TrainerConfig(**cfg["trainer"]),
                            device="cpu")
    halves = [(s["weight"][:, :7].sum(), s["weight"][:, 7:].sum())
              for s, _ in trainer._microbatch_stacks()]
    assert any(a != b for a, b in halves)


def test_classifier_trainer_on_data_2_matches_one_process(runs):
    work = runs["work"]
    for rank in runs["world"]:
        np.testing.assert_allclose(rank["single"], runs["ref"]["single"], rtol=0, atol=1e-5)
    _assert_params_close(work / "world" / "single" / "model.tar.gz",
                         work / "ref" / "single" / "model.tar.gz")


@pytest.mark.parametrize("name,kind", [("ev_fp32", "memory"), ("ev_int8", "memory"),
                                       ("ev_single", "single")])
def test_scoring_on_data_2_matches_one_process(runs, name, kind):
    work = runs["work"]
    got_dir = work / ("cli_eval" if name == "ev_fp32" else f"world/{name}")
    prefix = f"model_{kind}"
    got, want = _records(got_dir / f"{prefix}_result.json"), _records(work / "ref" / name / f"{prefix}_result.json")
    assert got.keys() == want.keys() and got
    for url, rec in want.items():
        if kind == "memory":
            assert got[url]["predict"].keys() == rec["predict"].keys()
            np.testing.assert_allclose([got[url]["predict"][a] for a in rec["predict"]],
                                       list(rec["predict"].values()), rtol=1e-4, atol=1e-5)
        else:
            assert got[url]["predict"] == rec["predict"]
            assert got[url]["prob"] == pytest.approx(rec["prob"], rel=1e-4, abs=1e-5)
    got_m, want_m = (json.loads((d / f"{prefix}_metric_all.json").read_text())
                     for d in (got_dir, work / "ref" / name))
    got_m.pop("elapsed_s", None), want_m.pop("elapsed_s", None)  # wall time, not a metric
    assert got_m == want_m


def test_resumed_quarantined_scoring_on_data_2_matches_one_process(runs):
    work = runs["work"]
    got_dir, want_dir = work / "world" / "ev_resume", work / "ref" / "ev_resume"
    name = "model_memory_result.json"
    # the resumed pass wrote the cut batch again: the same records as one
    # uninterrupted process, the journal covering every line
    got, want = _records(got_dir / name), _records(want_dir / name)
    assert got.keys() == want.keys() and got
    for url, rec in want.items():
        np.testing.assert_allclose([got[url]["predict"][a] for a in rec["predict"]],
                                   list(rec["predict"].values()), rtol=1e-4, atol=1e-5)
    lines = (got_dir / name).read_text().splitlines()
    assert len((got_dir / (name + ".journal")).read_text().splitlines()) >= len(lines)
    # rank 0 alone dead-lettered the malformed line, once
    dead = (got_dir / (name + ".deadletter")).read_text().splitlines()
    assert len(dead) == 1 and dead == (want_dir / (name + ".deadletter")).read_text().splitlines()
    assert not list(got_dir.glob("*.deadletter.*"))


def test_only_rank_0_writes_and_prints(runs):
    work = runs["work"]
    for out in (runs["train_out"], runs["eval_out"]):
        lines = [line for line in out.splitlines() if line.startswith("{")]
        assert len(lines) == 1
    assert json.loads(runs["train_out"].strip().splitlines()[-1])["archive"].endswith("model.tar.gz")
    for run in ("cli_train", "cli_eval"):
        log = work / run / "rank-1.log"
        assert log.exists() and "Traceback" not in log.read_text()
        assert not (work / run / "rank-0.log").exists()
    # the run sinks are rank 0's: one run_start in the run's events
    events = (work / "cli_train" / "events.jsonl").read_text().splitlines()
    assert sum(json.loads(e)["kind"] == "run_start" for e in events) == 1


def test_bad_mesh_specs_exit_2(runs, tmp_path, capsys):
    from memvul_tpu_torch.__main__ import main

    cfg = runs["work"] / "memory.json"
    # a model axis trains now (replicated copies); a malformed spec does not
    for spec, message in (("data=2,seq=2", "unknown axis 'seq'"), ("data=x", "invalid literal"),
                          ("data=1,model=0", "needs a size >= 1")):
        assert main(["train", str(cfg), "-s", str(tmp_path / "r"), "--mesh", spec,
                     "--device", "cpu"]) == 2
        assert message in capsys.readouterr().err
    # serve takes a mesh; a packed strategy on one exits 2 with the JAX
    # package's message, before any rank starts
    assert main(["serve", str(runs["work"] / "cli_train"), "--mesh", "data=2", "--device", "cpu",
                 "--port", "0", "--overrides", '{"serving": {"score_impl": "ragged"}}']) == 2
    assert "scale out with serving replicas, not a mesh" in capsys.readouterr().err


def _children(pid):
    path = Path(f"/proc/{pid}/task/{pid}/children")
    return [int(c) for c in path.read_text().split()] if path.exists() else []


def test_a_rank_that_dies_ends_the_world(runs, tmp_path):
    cfg = _memory_config(runs["paths"], False)
    # epochs enough that the world is still training when rank 1 is killed
    # (one epoch ends when the pair stream does, in about a second)
    cfg["trainer"].update(steps_per_epoch=10_000, num_epochs=1000, patience=None)
    cfg_file = tmp_path / "long.json"
    cfg_file.write_text(json.dumps(cfg))
    proc = _cli("train", cfg_file, "-s", tmp_path / "run", "--mesh", "data=2", "--device", "cpu")
    deadline = time.monotonic() + 60
    kids = []
    while not kids and time.monotonic() < deadline and proc.poll() is None:
        time.sleep(0.2)
        kids = _children(proc.pid)
    assert kids, "rank 1 never started"
    time.sleep(3)  # let the world form and start stepping
    os.kill(kids[0], signal.SIGKILL)
    started = time.monotonic()
    _, err = proc.communicate(timeout=90)
    assert proc.returncode != 0
    assert time.monotonic() - started < 60
    assert "rank 1 exited with -9" in err

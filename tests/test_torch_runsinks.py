"""Run sinks of the port's ``train`` and ``evaluate`` against the JAX
package's, and the reference's ``--mesh`` / ``--no-mesh`` flags.

A tiny ``train`` and ``evaluate`` (``build_workspace`` + ``selfcheck_config``)
run in both packages from a fresh program registry: the same sink files and
the same set of event kinds must appear, the per-step ``train_step`` events
carry the JAX package's fields and its drain cadence, and the JAX package's
``telemetry-report`` reads the port's run dirs as the port's does.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from memvul_tpu import build as jax_build
from memvul_tpu import telemetry as jax_telemetry
from memvul_tpu.telemetry import report as jax_report
from memvul_tpu.telemetry.programs import get_program_registry as jax_programs
from memvul_tpu_torch import __main__ as cli
from memvul_tpu_torch import build, telemetry
from memvul_tpu_torch.data.synthetic import build_workspace, selfcheck_config
from memvul_tpu_torch.telemetry import report as port_report
from memvul_tpu_torch.telemetry.programs import get_program_registry as port_programs
from memvul_tpu_torch.telemetry.sinks import read_jsonl

SINKS = {"events.jsonl", "HEARTBEAT.json", "telemetry.json", "programs.json"}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    telemetry.reset()
    jax_telemetry.reset()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return build_workspace(tmp_path_factory.mktemp("runsinks"), seed=5)


def _kinds(run_dir):
    events, skipped = read_jsonl(Path(run_dir) / "events.jsonl")
    assert skipped == 0
    return events, {ev["kind"] for ev in events}


@pytest.fixture(scope="module")
def runs(ws, tmp_path_factory):
    """The same tiny train and evaluate in both packages."""
    root = tmp_path_factory.mktemp("runs")
    cfg = selfcheck_config(ws, steps_per_epoch=2, sync_every=1)
    out = {}
    for name, pkg, programs, kw in (("jax", jax_build, jax_programs, {}),
                                    ("port", build, port_programs, {"device": "cpu"})):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            programs().reset()
            pkg.train_from_config(cfg, root / name / "train", **kw)
            programs().reset()
            pkg.evaluate_from_archive(root / name / "train" / "model.tar.gz",
                                      ws["paths"]["test"], root / name / "eval", **kw)
        finally:
            torch.set_num_threads(threads)
            telemetry.reset()
            jax_telemetry.reset()
        out[name] = root / name
    return out


@pytest.mark.parametrize("run", ["train", "eval"])
def test_same_sink_files_and_event_kinds_as_the_jax_package(runs, run):
    jax_dir, port_dir = runs["jax"] / run, runs["port"] / run
    assert SINKS <= {p.name for p in port_dir.iterdir()}
    assert SINKS <= {p.name for p in jax_dir.iterdir()}
    jax_events, jax_kinds = _kinds(jax_dir)
    port_events, port_kinds = _kinds(port_dir)
    assert port_kinds == jax_kinds
    assert port_events[0]["kind"] == "run_start" and port_events[-1]["kind"] == "run_end"
    jax_beat = json.loads((jax_dir / "HEARTBEAT.json").read_text())
    port_beat = json.loads((port_dir / "HEARTBEAT.json").read_text())
    assert set(port_beat) == set(jax_beat)
    port_summary = json.loads((port_dir / "telemetry.json").read_text())
    jax_summary = json.loads((jax_dir / "telemetry.json").read_text())
    assert set(port_summary) == set(jax_summary)
    for key in ("score.rows", "score.batches", "train.steps", "train.tokens",
                "train.tokens_real"):
        assert port_summary["counters"].get(key) == jax_summary["counters"].get(key), key
    # every span the port opened, the JAX package's run opened too
    port_spans = {ev["name"] for ev in port_events if ev["kind"] == "span"}
    assert port_spans <= {ev["name"] for ev in jax_events if ev["kind"] == "span"}
    assert {"anchor_encode", "score_stream"} <= port_spans


def test_train_step_events_carry_the_jax_fields(runs):
    jax_events, _ = _kinds(runs["jax"] / "train")
    port_events, _ = _kinds(runs["port"] / "train")
    steps = [ev for ev in port_events if ev["kind"] == "train_step"]
    want = [ev for ev in jax_events if ev["kind"] == "train_step"]
    assert [ev["step"] for ev in steps] == [ev["step"] for ev in want] == [0, 1]
    for got, ref in zip(steps, want):
        assert set(got) == set(ref) == {"t", "mono", "kind", "phase", "step", "loss", "lr",
                                        "grad_norm"}
        assert got["phase"] == ref["phase"] == "train_epoch"
        assert got["lr"] == pytest.approx(ref["lr"])
    epoch = [ev for ev in port_events if ev["kind"] == "train_epoch"]
    assert len(epoch) == 1 and epoch[0]["num_steps"] == 2


@pytest.mark.parametrize("run", ["train", "eval"])
def test_both_reports_read_the_port_run_dirs_alike(runs, run):
    run_dir = runs["port"] / run
    now = 1_900_000_000.0
    want = jax_report.report_json(run_dir, now=now)
    got = port_report.report_json(run_dir, now=now)
    assert got == want
    assert got["spans"]["score_stream"]["count"] == 1.0
    if run == "train":
        assert got["counters"]["train.steps"] == 2
        assert "train.step_s" in got["histograms"]


def test_step_events_and_sinks_switch_off(ws, tmp_path):
    cfg = selfcheck_config(ws, steps_per_epoch=2, num_epochs=1)
    build.train_from_config(dict(cfg, telemetry={"step_events": False}), tmp_path / "quiet",
                            device="cpu")
    events, kinds = _kinds(tmp_path / "quiet")
    assert "train_step" not in kinds and "train_epoch" in kinds
    summary = json.loads((tmp_path / "quiet" / "telemetry.json").read_text())
    assert summary["counters"]["train.steps"] == 2
    build.train_from_config(dict(cfg, telemetry={"enabled": False}), tmp_path / "off",
                            device="cpu")
    written = {p.name for p in (tmp_path / "off").iterdir()}
    assert not written & SINKS
    assert "model.tar.gz" in written


def test_classifier_trainer_writes_the_sinks(ws, tmp_path):
    cfg = selfcheck_config(ws, steps_per_epoch=2, sync_every=1)
    cfg["model"] = {"type": "model_single", "encoder": {"preset": "tiny", "vocab_size": 4096}}
    cfg["dataset_reader"] = {"type": "reader_single"}
    cfg["trainer"] = {"num_epochs": 1, "batch_size": 4, "max_length": 48,
                      "eval_batch_size": 8, "eval_max_length": 48, "steps_per_epoch": 2,
                      "sync_every": 1}
    build.train_from_config(cfg, tmp_path / "single", device="cpu")
    events, kinds = _kinds(tmp_path / "single")
    assert {"run_start", "span_start", "span", "train_step", "train_epoch", "run_end"} <= kinds
    steps = [ev for ev in events if ev["kind"] == "train_step"]
    # the JAX classifier trainer's fields: no learning rate
    assert [ev["step"] for ev in steps] == [0, 1]
    assert {"step", "loss", "grad_norm"} <= set(steps[0]) and "lr" not in steps[0]


@pytest.mark.parametrize("command", ["train", "evaluate", "serve"])
def test_mesh_flag_exits_2_with_the_multi_device_message(ws, tmp_path, capsys, command):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(selfcheck_config(ws)))
    argv = {
        "train": ["train", str(cfg_path), "-s", str(tmp_path / "run")],
        "evaluate": ["evaluate", str(tmp_path / "missing.tar.gz"), ws["paths"]["test"],
                     "-o", str(tmp_path / "ev")],
        "serve": ["serve", str(tmp_path / "missing.tar.gz"), "--port", "0"],
    }[command]
    # every command takes a mesh (serve: one service across its ranks); one
    # of 8 cards on a host with none exits 2, naming the cards it lacks
    assert cli.main(argv + ["--mesh", "data=8"]) == 2
    err = capsys.readouterr().err
    assert "'data=8'" in err and "need 8 devices, have 0" in err
    assert not (tmp_path / "run").exists()
    if command == "serve":
        # a mesh beside replicas is refused before any rank starts
        assert cli.main(argv + ["--mesh", "data=2", "--replicas", "2", "--device", "cpu"]) == 2
        assert "pick one scaling axis" in capsys.readouterr().err


def test_no_mesh_flag_runs_on_one_device(ws, tmp_path, capsys):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(selfcheck_config(ws, steps_per_epoch=1)))
    assert cli.main(["train", str(cfg_path), "-s", str(tmp_path / "run"), "--no-mesh",
                     "--device", "cpu"]) == 0
    archive = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["archive"]
    assert cli.main(["evaluate", archive, ws["paths"]["test"], "-o", str(tmp_path / "ev"),
                     "--no-mesh", "--device", "cpu"]) == 0
    assert (tmp_path / "ev" / "events.jsonl").exists()

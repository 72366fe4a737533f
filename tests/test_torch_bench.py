"""The port's bench harness (``memvul_tpu_torch/bench.py``) against the JAX
package's (``memvul_tpu/bench.py``), on the CPU.

* **supervision**: the 16 cases of ``tests/test_bench_supervisor.py`` run
  against the port's supervisor (result extraction, the phase watchdog's
  record and exit 124, retries of transient failures and watchdog kills,
  process-group kills, harvesting a result printed before a hang, the
  device probe), plus the watchdog record naming the program registry's
  last build, a real bench child wedged in a phase (exit 124 alone, the
  watchdog's error under the supervisor), the
  refusals (no CUDA and no ``BENCH_DEVICE=cpu``;
  ``BENCH_MICRO_INTERPRET``), and ``BENCH_LINT=1``'s lint record before
  the bench's own;
* **records**: the main pass and every micro (``anchor_match``,
  ``train_step``, ``serve`` ab, the router and autoscale records,
  ``corpus``, ``tune``) at tiny geometry with ``BENCH_DEVICE=cpu`` carry
  the same key set as the JAX package's record for the same env (the
  JAX records come from three background processes that run while the
  port's run here), and ``run_tune``'s record has the JAX package's keys
  with the default layouts passing their own parity gate.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from memvul_tpu_torch import bench
from memvul_tpu_torch import telemetry
from memvul_tpu_torch.bench import _extract_result_line, _supervise, _wait_for_device
from memvul_tpu_torch.telemetry.programs import get_program_registry

ROOT = Path(__file__).resolve().parents[1]
RESULT = ('{"metric": "siamese_scoring_throughput", "value": 1.0, "unit": "reports/sec", '
          '"vs_baseline": 1.0}')


def _script_cmd(body: str):
    return [sys.executable, "-c", body]


# -- supervision (the 16 cases of tests/test_bench_supervisor.py) ---------------


def test_extract_result_line_picks_last_json_dict():
    text = "warning noise\n{not json\n" + RESULT + "\ntrailing"
    line = _extract_result_line(text)
    assert json.loads(line)["metric"] == "siamese_scoring_throughput"
    assert _extract_result_line("no json here") is None
    assert _extract_result_line('{"foo": 1}') is None


def test_extract_result_line_skips_error_records():
    watchdog = json.dumps(
        {"metric": "siamese_scoring_throughput", "value": 0.0,
         "error": "watchdog: phase 'timed_pass' exceeded 600s",
         "watchdog_timeout": True}
    )
    assert _extract_result_line(watchdog) is None
    assert _extract_result_line(RESULT + "\n" + watchdog) == RESULT


def test_phase_watchdog_emits_record_and_exits_124():
    """A phase that stops making progress: the watchdog thread emits one
    parseable JSON failure record naming the phase and hard-exits 124 even
    though the stuck call never returns (a child: os._exit would take
    pytest down)."""
    body = (
        "import time\n"
        "from memvul_tpu_torch.bench import _PhaseWatchdog\n"
        "wd = _PhaseWatchdog(0.3, 'siamese_scoring_throughput')\n"
        "with wd.phase('timed_pass'):\n"
        "    time.sleep(30)\n"
        "print('UNREACHABLE')\n"
    )
    proc = subprocess.run(_script_cmd(body), capture_output=True, text=True, timeout=25,
                          cwd=ROOT)
    assert proc.returncode == 124
    assert "UNREACHABLE" not in proc.stdout
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert record["watchdog_timeout"] is True
    assert "timed_pass" in record["error"]
    assert "watchdog" in proc.stderr


def test_phase_watchdog_quiet_when_phase_completes():
    body = (
        "from memvul_tpu_torch.bench import _PhaseWatchdog\n"
        "wd = _PhaseWatchdog(30, 'm')\n"
        "with wd.phase('fast'):\n"
        "    pass\n"
        "with wd.phase('disabled'):\n"
        "    pass\n"
        f"print('{RESULT}')\n"
    )
    proc = subprocess.run(_script_cmd(body), capture_output=True, text=True, timeout=60,
                          cwd=ROOT)
    assert proc.returncode == 0
    assert _extract_result_line(proc.stdout) == RESULT


def test_supervise_retries_watchdog_timeout():
    body = (
        "import sys\n"
        'print(\'{"metric": "siamese_scoring_throughput", "value": 0.0, '
        '"error": "watchdog: phase \\\'timed_pass\\\' exceeded 1s", '
        '"watchdog_timeout": true}\')\n'
        "sys.exit(124)\n"
    )
    line, err = _supervise(_script_cmd(body), attempts=2, attempt_timeout=30, backoff=0)
    assert line is None
    assert "watchdog" in err


def test_supervise_success_first_try():
    line, err = _supervise(_script_cmd(f"print('{RESULT}')"), attempts=1,
                           attempt_timeout=30, backoff=0)
    assert err is None
    assert json.loads(line)["vs_baseline"] == 1.0


def test_supervise_retries_unavailable_then_succeeds(tmp_path):
    flag = tmp_path / "failed_once"
    body = (
        "import os, sys\n"
        f"flag = {str(flag)!r}\n"
        "if not os.path.exists(flag):\n"
        "    open(flag, 'w').close()\n"
        "    sys.stderr.write('RuntimeError: Unable to initialize backend "
        "cuda: UNAVAILABLE: device setup error\\n')\n"
        "    sys.exit(1)\n"
        f"print('{RESULT}')\n"
    )
    line, err = _supervise(_script_cmd(body), attempts=3, attempt_timeout=30, backoff=0)
    assert err is None
    assert json.loads(line)["value"] == 1.0
    assert flag.exists()


def test_supervise_non_retryable_fails_fast(tmp_path):
    counter = tmp_path / "runs"
    body = (
        "import sys\n"
        f"open({str(counter)!r}, 'a').write('x')\n"
        "sys.stderr.write('ValueError: genuine bug\\n')\n"
        "sys.exit(1)\n"
    )
    line, err = _supervise(_script_cmd(body), attempts=3, attempt_timeout=30, backoff=0)
    assert line is None
    assert "genuine bug" in err
    assert counter.read_text() == "x"


def test_supervise_kills_hung_attempt_and_reports_timeout():
    line, err = _supervise(_script_cmd("import time\ntime.sleep(60)\n"), attempts=2,
                           attempt_timeout=1, backoff=0)
    assert line is None
    assert "timed out" in err


def test_result_printed_before_hang_is_harvested():
    body = f"print('{RESULT}', flush=True)\nimport time\ntime.sleep(120)\n"
    line, err = _supervise(_script_cmd(body), attempts=1, attempt_timeout=5, backoff=0)
    assert err is None
    assert json.loads(line)["value"] == 1.0


def test_zero_exit_without_result_fails_fast(tmp_path):
    counter = tmp_path / "runs"
    body = f"open({str(counter)!r}, 'a').write('x')\nprint('no result here')\n"
    line, err = _supervise(_script_cmd(body), attempts=3, attempt_timeout=30, backoff=0)
    assert line is None
    assert "without a result line" in err
    assert counter.read_text() == "x"


def test_error_extraction_skips_trailing_boilerplate(tmp_path):
    """A notice printed AFTER the exception line must not be reported in
    its place."""
    body = (
        "import sys\n"
        "sys.stderr.write('Traceback (most recent call last):\\n')\n"
        "sys.stderr.write('torch.OutOfMemoryError: CUDA out of memory at "
        "sequence length 512\\n')\n"
        "sys.stderr.write('--------------------\\n')\n"
        "sys.stderr.write('For simplicity, frames were removed from the "
        "traceback\\n')\n"
        "sys.exit(1)\n"
    )
    line, err = _supervise(_script_cmd(body), attempts=1, attempt_timeout=30, backoff=0)
    assert line is None
    assert err.startswith("torch.OutOfMemoryError: CUDA out of memory"), err


def test_exhausted_retries_report_last_error(tmp_path):
    body = "import sys\nsys.stderr.write('UNAVAILABLE: still down\\n')\nsys.exit(1)\n"
    line, err = _supervise(_script_cmd(body), attempts=2, attempt_timeout=30, backoff=0)
    assert line is None
    assert "UNAVAILABLE" in err


def test_wait_for_device_succeeds_on_live_backend():
    env = dict(os.environ, BENCH_DEVICE="cpu")
    assert _wait_for_device(90, probe_timeout=80, interval=0.1, env=env)


def test_wait_for_device_gives_up_on_dead_backend():
    """An unanswerable device (a bogus one: the probe errors, never prints
    DEVICE_OK) exhausts the budget and returns False, not loop forever."""
    env = dict(os.environ, BENCH_DEVICE="no_such_device")
    why = []
    assert not _wait_for_device(1, probe_timeout=60, interval=0.1, env=env, why=why)
    assert why  # the last probe's error line (here: its timeout)


def test_main_emits_error_json_when_device_never_answers(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_DEVICE", "no_such_device")
    monkeypatch.setenv("BENCH_DEVICE_WAIT", "1")
    monkeypatch.setenv("BENCH_PROBE_TIMEOUT", "30")
    rc = bench.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 1
    assert len(out) == 1
    report = json.loads(out[0])
    assert report["value"] == 0.0
    assert "device did not answer" in report["error"]


# -- the port's own refusals and the watchdog's attribution ---------------------


def test_watchdog_record_names_last_compile():
    body = (
        "import time\n"
        "from memvul_tpu_torch.bench import _PhaseWatchdog\n"
        "from memvul_tpu_torch.telemetry.programs import get_program_registry\n"
        "get_program_registry().register('score:8x64', scope='score', compile_s=0.5)\n"
        "with _PhaseWatchdog(0.3, 'm').phase('anchor_encode'):\n"
        "    time.sleep(30)\n"
    )
    proc = subprocess.run(_script_cmd(body), capture_output=True, text=True, timeout=25,
                          cwd=ROOT)
    assert proc.returncode == 124
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert record["last_compile_key"] == "score:8x64"
    assert 0.0 <= record["last_compile_age_s"] < 20.0


def test_last_compile_equals_the_jax_package():
    """``ProgramRegistry.last_compile`` (the watchdog's attribution): the
    newest registration, a re-registration moving a key to the head."""
    import jax
    import jax.numpy as jnp

    from memvul_tpu.telemetry.programs import ProgramRegistry as JaxProgramRegistry
    from memvul_tpu_torch.telemetry.programs import ProgramRegistry

    ours, theirs = ProgramRegistry(), JaxProgramRegistry()
    assert ours.last_compile() is None and theirs.last_compile() is None
    lowered = jax.jit(lambda x: x + 1).lower(jnp.ones(4))
    for key in ("score:8x64", "bank:128x64", "score:8x64"):
        ours.register(key, scope="score", compile_s=0.25)
        theirs.compile_and_register(key, lowered, scope="score")
        a, b = ours.last_compile(), theirs.last_compile()
        assert sorted(a) == sorted(b) == ["age_s", "compile_s", "key"]
        assert a["key"] == b["key"] == key and a["compile_s"] == 0.25
        assert 0.0 <= a["age_s"] < 5.0 and 0.0 <= b["age_s"] < 5.0


def _bench_cli(env_extra, timeout=120):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "MEMVUL_"))}
    env.update(env_extra)
    return subprocess.run([sys.executable, "-m", "memvul_tpu_torch", "bench"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=timeout)


# a bench child whose model build never returns (a wedged device call): the
# train-step micro builds its model inside the watched "model_init" phase
WEDGED_CHILD = (
    "import sys, time\n"
    "import memvul_tpu_torch.bench as bench\n"
    "def wedged(*args, **kw):\n"
    "    while True:\n"
    "        time.sleep(60)\n"
    "bench.bench_model = wedged\n"
    "sys.exit(bench.main())\n"
)


def test_wedged_phase_ends_in_watchdog_record_and_supervisor_error():
    """A real bench child wedged in a phase: the child alone exits 124 with
    the watchdog's record; under the supervisor (one attempt) the result is
    the watchdog's error, which ``main`` prints as its one error record."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "MEMVUL_"))}
    env.update(MEMVUL_BENCH_CHILD="1", BENCH_DEVICE="cpu", BENCH_MODEL="tiny",
               BENCH_MICRO="train_step", BENCH_TRAIN_REPORTS="4", BENCH_PHASE_TIMEOUT="2")
    proc = subprocess.run(_script_cmd(WEDGED_CHILD), cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 124, proc.stderr[-2000:]
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert record["metric"] == "train_step_microbench" and record["phase"] == "model_init"
    assert record["watchdog_timeout"] is True
    line, err = _supervise(_script_cmd(WEDGED_CHILD), attempts=1, attempt_timeout=120,
                           backoff=0, env=env)
    assert line is None
    assert "watchdog" in err and "model_init" in err
    assert "watchdog" in bench._error_record(err)["error"]


def test_refusals_without_cuda_lint_and_interpret():
    # no BENCH_DEVICE: the card, which this host lacks — one error record
    proc = _bench_cli({"BENCH_MODEL": "tiny"})
    assert proc.returncode == 1
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert record["value"] == 0.0 and "no CUDA device" in record["error"]
    # BENCH_LINT: the lint record of the port's tree first, then the bench
    # (here its refusal without CUDA), as the JAX package's supervisor does
    proc = _bench_cli({"BENCH_LINT": "1", "BENCH_MODEL": "tiny"})
    assert proc.returncode == 1
    lint, refusal = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    assert lint["metric"] == "lint" and lint["clean"] is True and lint["findings"] == []
    assert "error" not in lint and "no CUDA device" in refusal["error"]
    # BENCH_MICRO_INTERPRET has no meaning without Pallas
    proc = _bench_cli({"BENCH_DEVICE": "cpu", "BENCH_MICRO": "anchor_match",
                       "BENCH_MICRO_INTERPRET": "1", "BENCH_ATTEMPTS": "1"})
    assert proc.returncode == 1
    assert "interpret mode" in json.loads(proc.stdout.strip().splitlines()[-1])["error"]


# -- records: the port's key sets against the JAX package's ----------------------

TUNE_SPACES = {"train_space_kwargs": {"bucket_grids": ["pow2"], "dedup_options": [True],
                                      "prefetch_depths": [8]},
               "serve_space_kwargs": {"impls": ["bucketed"], "batch_caps": [8],
                                      "wait_ms_options": [5.0]}}
TINY = {"BENCH_MODEL": "tiny"}
CASES = {
    "main": dict(TINY, BENCH_REPORTS="64", BENCH_TOKENS="2048", BENCH_SEQ_LEN="128"),
    "anchor_match": dict(BENCH_MICRO="anchor_match", BENCH_MICRO_B="16",
                         BENCH_MICRO_ITERS="2"),
    "train_step": dict(TINY, BENCH_MICRO="train_step", BENCH_TRAIN_STEPS="2",
                       BENCH_TRAIN_BATCH="4", BENCH_TRAIN_ACCUM="1",
                       BENCH_TRAIN_REPORTS="8", BENCH_SEQ_LEN="64"),
    "serve_ab": dict(TINY, BENCH_MICRO="serve", BENCH_SERVE_IMPL="ab",
                     BENCH_MICRO_REQUESTS="24", BENCH_MICRO_CLIENTS="4", BENCH_SEQ_LEN="128"),
    "serve_router": dict(TINY, BENCH_MICRO="serve", BENCH_SERVE_REPLICAS="2",
                         BENCH_MICRO_REQUESTS="24", BENCH_MICRO_CLIENTS="4",
                         BENCH_SEQ_LEN="128"),
    "serve_autoscale": dict(TINY, BENCH_MICRO="serve", BENCH_SERVE_AUTOSCALE="1",
                            BENCH_MICRO_REQUESTS="24", BENCH_MICRO_CLIENTS="4",
                            BENCH_SEQ_LEN="128"),
    "corpus": dict(BENCH_MICRO="corpus", BENCH_CORPUS_REPORTS="4"),
    "tune": dict(TINY, BENCH_MICRO="tune", BENCH_TRAIN_STEPS="1",
                 BENCH_TRAIN_BATCH="4", BENCH_MICRO_REQUESTS="16", BENCH_SEQ_LEN="64"),
}
# three JAX processes of about equal length
JAX_GROUPS = (("tune",), ("train_step", "main", "anchor_match"),
              ("serve_ab", "serve_router", "serve_autoscale", "corpus"))

# runs the JAX package's bench legs in-process, each on a fresh program
# registry (a bench child is a fresh process); the tune leg's spaces are cut
# to one candidate a family, and its run_tune record is kept too
JAX_SCRIPT = r"""
import contextlib, io, json, os, sys
import memvul_tpu.bench as jb
import memvul_tpu.tuning.autotune as ja
from memvul_tpu.telemetry.programs import get_program_registry
cases, spaces, out_path = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
original = ja.run_tune
raw = {}
def small_run_tune(mode, **kw):
    kw.update(spaces)
    raw["record"] = original(mode, **kw)
    return raw["record"]
ja.run_tune = small_run_tune
records = {}
for name, env in cases.items():
    for key in [k for k in os.environ if k.startswith("BENCH_")]:
        del os.environ[key]
    os.environ.update(env)
    get_program_registry().reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jb._run_bench()
    records[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
if "record" in raw:
    records["run_tune"] = raw["record"]
with open(out_path, "w") as f:
    json.dump(records, f, default=float)
os._exit(0)  # skip interpreter teardown: its threads' exit is not under test
"""


@pytest.fixture(scope="module", autouse=True)
def jax_records(tmp_path_factory):
    """The JAX package's records, from three processes started with the
    module's first test (the supervision tests run meanwhile)."""
    tmp = tmp_path_factory.mktemp("jax_bench")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "MEMVUL_"))}
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for i, group in enumerate(JAX_GROUPS):
        out = tmp / f"records-{i}.json"
        cases = {name: CASES[name] for name in group}
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, json.dumps(cases), json.dumps(TUNE_SPACES),
             str(out)],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)))

    def collect():
        records = {}
        for out, proc in procs:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            records.update(json.loads(out.read_text()))
        return records

    yield collect
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def port_records(jax_records):
    """The port's records of the same envs, in this process (the JAX ones
    run meanwhile), with the device the CPU; each leg on fresh registries."""
    import memvul_tpu_torch.tuning.autotune as pa

    original = pa.run_tune
    raw = {}

    def small_run_tune(mode, **kw):
        kw.update(TUNE_SPACES)
        raw["record"] = original(mode, **kw)
        return raw["record"]

    saved = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    records = {}
    pa.run_tune = small_run_tune
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the JAX processes share the cores meanwhile
    try:
        for name, env in CASES.items():
            for key in [k for k in os.environ if k.startswith("BENCH_")]:
                del os.environ[key]
            os.environ.update(env, BENCH_DEVICE="cpu")
            get_program_registry().reset()
            telemetry.reset()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                bench._run_bench()
            records[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    finally:
        torch.set_num_threads(threads)
        pa.run_tune = original
        for key in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[key]
        os.environ.update(saved)
        get_program_registry().reset()
        telemetry.reset()
    records["run_tune"] = raw["record"]
    return records


@pytest.mark.parametrize("name", sorted(CASES) + ["run_tune"])
def test_record_keys_match_the_jax_package(name, port_records, jax_records):
    port = port_records[name]
    jax_rec = jax_records()[name]
    assert "error" not in port
    assert sorted(port) == sorted(jax_rec), name
    # the nested blocks a sweep reads keep the JAX package's shape too
    for key in ("config", "ab", "fleet", "autoscale", "train", "serve", "hbm_bytes_est", "pad_to_max", "bucketed_dedup", "verification", "cascade"):
        if isinstance(jax_rec.get(key), dict) and isinstance(port.get(key), dict):
            assert sorted(port[key]) == sorted(jax_rec[key]), (name, key)
    if "programs" in jax_rec:
        assert sorted(port["programs"][0]) == sorted(jax_rec["programs"][0])
        assert sorted(port["xla"]) == sorted(jax_rec["xla"])


def test_records_on_the_cpu_say_so(port_records):
    assert port_records["anchor_match"]["config"]["fused_backend"] == "plain"
    assert port_records["main"]["xla"]["device_kind"] == "cpu"
    assert port_records["main"]["xla"]["interpret_only"] is True
    assert port_records["tune"]["device_class"] == "cpu"
    assert port_records["serve_autoscale"]["autoscale"]["lost_requests"] == 0
    assert port_records["corpus"]["verification"]["exactly_once"] is True


def test_run_tune_default_layouts_pass_their_own_gate(port_records):
    record = port_records["run_tune"]
    assert record["device_class"] == "cpu" and record["peak_spec"] is None
    for section in ("train", "serve"):
        rows = record[section]["candidates"]
        assert rows and all(r["prune"]["feasible"] for r in rows)
        # the one candidate of each family is the default layout
        assert all(r["parity"]["passed"] and r["parity"]["max_abs_delta"] == 0.0
                   for r in rows), rows
    assert record["profile"]["train"] == {"train_buckets": "pow2", "dedup_anchors": True,
                                          "prefetch_depth": 8}

"""The program's spans on the profiler's clock (``lib/spans.py``), the five
readers that take their numbers from them, and ``tools/span_view.py`` on
the tiny CPU cell."""

import json
import os
import shutil
import subprocess
import sys
import threading

import pytest
import torch

from benchmark.lib import manifest, spans, trace

MS = 1_000_000  # ns
SPAN_METRICS = ("h2d_block.score", "launch_self.score", "feed_busy.score", "pad_share.score",
                "setup_program_s.score")


def test_a_span_from_a_second_thread_lands_inside_its_profiler_range():
    from memvul_tpu_torch.telemetry import spans as recorder

    tracer = spans.SpanTracer(True, torch.device("cpu"))
    recorder.record(True)
    try:
        tracer.start()
        tid = []

        def probe():
            tid.append(threading.get_native_id())
            with recorder.span("probe"):
                torch.ones(64).sum()

        with tracer.range("perfbench.next"):
            worker = threading.Thread(target=probe)
            worker.start()
            worker.join(timeout=10)
        tracer.stop()
    finally:
        recorder.record(False)
    assert not worker.is_alive()
    collected = tracer.collected()
    view = spans.program_view(recorder.recorded(), {}, recorder.dropped(), collected["clock"])
    (got,) = [s for s in view["spans"] if s[spans.NAME] == "probe"]
    assert got[spans.TID] == tid[0]
    (outer,) = [h for h in collected["host"] if h[0] == "perfbench.next"]
    assert outer[1] - MS <= got[spans.START] <= got[spans.END] <= outer[2] + MS
    assert trace.summarize(collected)["window_s"] > 0


def _trace():
    device = [("flash_fwd_wgmma_kernel<2>", 10 * MS, 14 * MS), ("gemm", 12 * MS, 20 * MS),
              ("flash_fwd_wgmma_kernel<2>", 30 * MS, 32 * MS), ("gemm", 95 * MS, 120 * MS)]
    host = [("perfbench.window", 0, 100 * MS, True),
            ("perfbench.next", 0, 35 * MS, True), ("aten::copy_", 21 * MS, 29 * MS, False),
            ("perfbench.agree", 35 * MS, 45 * MS, True), ("perfbench.next", 45 * MS, 100 * MS, True)]
    return {"window": (0, 100 * MS), "device": device, "host": host}


# summarize's output on _trace() before the program's spans existed
SUMMARY = {"window_s": 0.1, "busy_s": 0.017,
           "device_ops": [["gemm", 0.013], ["flash_fwd_wgmma_kernel<2>", 0.006]],
           "idle_gaps": [["perfbench.next/python", 0.073], ["perfbench.next/aten::copy_", 0.010]]}


def _same(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], list):
            assert [k for k, _ in got[key]] == [k for k, _ in want[key]], key
            assert [v for _, v in got[key]] == pytest.approx([v for _, v in want[key]]), key
        else:
            assert got[key] == pytest.approx(want[key]), key


def test_summarize_is_as_before_with_the_clock_pair():
    _same(trace.summarize(_trace()), SUMMARY)
    with_clock = dict(_trace(), clock=[123, 0])
    _same(trace.summarize(with_clock), SUMMARY)


def _run():
    """A window of 100 ms: the card busy 10-20, 30-32 and 95-100 ms; the
    launch thread waits on the feed 0-25, launches 25-60 (copies 25-40),
    syncs 60-90; the feed tokenizes 0-45 and collates 45-55."""
    t = _trace()
    t["clock"] = [5 * MS, 0]
    L, F = 11, 22
    spans_ = [[0, "anchor_encode", L, -900 * MS, -400 * MS, None, None],
              [1, "kernels.load", L, -800 * MS, -700 * MS, 0, None],
              [2, "aot_warmup", L, -300 * MS, -100 * MS, None, None],
              [3, "score.feed_wait", L, 0, 25 * MS, None, 0],
              [5, "score.launch", L, 25 * MS, 60 * MS, None, 0],
              [6, "score.h2d", L, 25 * MS, 40 * MS, 5, 0],
              [7, "score.sync", L, 60 * MS, 90 * MS, None, 0],
              [8, "feed.tokenize", F, 0, 45 * MS, None, 0],
              [9, "feed.collate", F, 45 * MS, 55 * MS, None, 0]]
    return {"trace": t, "stream": {"seconds": 0.2},
            "program": {"spans": spans_, "dropped": 0,
                        "counters": {"score.tokens_real": 300, "score.tokens_padded": 400}}}


def test_the_five_readers_on_hand_made_spans():
    run = _run()
    got = {name: manifest.reader(name).read(run) for name in SPAN_METRICS}
    assert got == pytest.approx({"h2d_block.score": 100 * 0.015 / 0.2,
                                 "launch_self.score": 100 * 0.020 / 0.2,
                                 "feed_busy.score": 100 * 0.055 / 0.2,
                                 "pad_share.score": 25.0,
                                 "setup_program_s.score": 0.5 + 0.2})


def test_idle_by_span_names_each_gap_by_both_threads():
    table = spans.idle_by_span(_run())
    # idle: 0-10 (mid 5), 20-30 (mid 25: the copies open at 25) and 32-95
    # (mid 63.5)
    assert dict(table["pairs"]) == pytest.approx({"score.feed_wait / feed.tokenize": 0.010,
                                                  "score.h2d / feed.tokenize": 0.010,
                                                  "score.sync / -": 0.063})
    assert table["idle_s"] == pytest.approx(0.083) and table["unnamed_s"] == 0.0
    run = _run()
    run["program"]["spans"] = [s for s in run["program"]["spans"] if s[spans.NAME] != "score.sync"]
    table = spans.idle_by_span(run)
    # no program span at 63.5 ms: the harness's own range names it
    assert dict(table["pairs"])["perfbench.next / -"] == pytest.approx(0.063)
    assert table["unnamed_s"] == 0.0
    assert "perfbench.next / -" in spans.format_table(table)


def test_the_readers_find_nothing_without_spans():
    runs = [{"stream": {"seconds": 1.0}, "trace": _trace()},
            {"stream": {"seconds": 1.0}, "program": {"spans": [], "counters": {}, "dropped": 0}}]
    for run in runs:
        for name in SPAN_METRICS:
            assert manifest.reader(name).read(run) is None, name
        assert spans.idle_by_span(run) is None


def test_span_view_on_the_tiny_cell(tiny_copy, tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(tiny_copy, copy, symlinks=True)
    m = json.loads((copy / "BENCHMARK.json").read_text())
    for metric in m["per_layer"]:
        if metric["name"] in ("host_launch.score", "feed_wait.score"):
            metric["workloads"].append("tiny.short")
    (copy / "BENCHMARK.json").write_text(json.dumps(m))
    code = ("import os, sys, time; t = time.perf_counter(); sys.path.insert(0, '.')\n"
            "import torch; torch.set_num_threads(2)\n"
            "from benchmark.tools import span_view\n"
            "os._exit(span_view.main(sys.argv[1:], 'cpu', t))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code, "--workload", "tiny.short", "--seed",
                           "3000000017", "--seconds", "1.5"], cwd=copy, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    metrics = out["metrics"]
    assert set(SPAN_METRICS) <= set(metrics)
    assert all(isinstance(metrics[name], float) for name in SPAN_METRICS)
    # one set of clock reads: the split adds up to the predictor's counter
    assert metrics["h2d_block.score"] + metrics["launch_self.score"] \
        == pytest.approx(metrics["host_launch.score"], abs=1e-6)
    assert 0 < metrics["h2d_block.score"] < metrics["host_launch.score"]
    assert 0 < metrics["setup_program_s.score"] < out["setup_s"]
    assert 0 < metrics["pad_share.score"] < 100 and 0 < metrics["feed_busy.score"] < 100
    assert out["dropped"] == 0 and out["idle_by_span"]["idle_s"] > 0
    assert "idle by span" in proc.stderr

"""The trace reduction and the trace-read metrics, on hand-made events."""

import pytest

from benchmark.lib import manifest, trace

MS = 1_000_000  # ns


def _trace():
    device = [("flash_fwd_wgmma_kernel<2>", 10 * MS, 14 * MS), ("gemm", 12 * MS, 20 * MS),
              ("flash_fwd_wgmma_kernel<2>", 30 * MS, 32 * MS), ("ncclKernel_AllReduce", 40 * MS, 41 * MS),
              ("gemm", 95 * MS, 120 * MS)]
    host = [("perfbench.window", 0, 100 * MS, True),
            ("perfbench.next", 0, 35 * MS, True), ("aten::copy_", 21 * MS, 29 * MS, False),
            ("perfbench.agree", 35 * MS, 45 * MS, True), ("perfbench.next", 45 * MS, 100 * MS, True)]
    return {"window": (0, 100 * MS), "device": device, "host": host}


def test_busy_gaps_and_ops():
    s = trace.summarize(_trace())
    assert s["window_s"] == pytest.approx(0.1)
    # busy: 10-20, 30-32, 40-41, 95-100 (clipped)
    assert s["busy_s"] == pytest.approx(0.018)
    assert s["device_ops"][0] == ["gemm", pytest.approx(0.013)]
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert gaps["perfbench.next/python"] == pytest.approx(0.010 + 0.054)
    assert gaps["perfbench.next/aten::copy_"] == pytest.approx(0.010)
    assert gaps["perfbench.agree/python"] == pytest.approx(0.008)


def test_trace_metrics():
    cfg = {"num_hidden_layers": 2, "num_attention_heads": 12, "hidden_size": 768}
    run = {"trace": _trace(), "config": cfg, "launches": [(64, 4096)],
           "ranks": [{"busy_s": 0.018, "window_s": 0.1}, {"busy_s": 0.05, "window_s": 0.1}]}
    from benchmark.lib import cost

    k2 = manifest.reader("k2_roofline.score").read(run)
    bound = cost.roofline_seconds(*cost.attention_launch(64, 4096, 12, 64))
    assert k2 == pytest.approx(100 * 2 * bound / 0.006)
    assert manifest.reader("collective_share.score").read(run) == pytest.approx(1.0)
    assert manifest.reader("device_idle.score").read(run) == pytest.approx(100 * (0.82 + 0.5) / 2)
    run["launches"] = []
    with pytest.raises(RuntimeError):
        manifest.reader("k2_roofline.score").read(run)


def test_trace_metrics_find_nothing_without_a_trace():
    run = {"trace": None, "ranks": None, "config": {}, "launches": []}
    for name in ("k2_roofline.score", "collective_share.score", "device_idle.score"):
        assert manifest.reader(name).read(run) is None
